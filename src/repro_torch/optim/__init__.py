from repro_torch.optim.adamw import (
    AdamW, OptConfig, clip_by_global_norm, global_norm, make_schedule,
)

__all__ = ["AdamW", "OptConfig", "clip_by_global_norm", "global_norm",
           "make_schedule"]
