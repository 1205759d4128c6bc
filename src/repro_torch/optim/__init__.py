from repro_torch.optim.adamw import AdamW, OptConfig

__all__ = ["AdamW", "OptConfig"]
