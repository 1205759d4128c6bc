from repro_torch.serving.service import (RenderResponse, RenderService,
                                         batched_frame_program)

__all__ = ["RenderService", "RenderResponse", "batched_frame_program"]
