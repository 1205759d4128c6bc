from repro_torch.serving.cache import BrickCache, CacheView
from repro_torch.serving.service import (RenderResponse, RenderService,
                                         batched_frame_program)

__all__ = ["BrickCache", "CacheView", "RenderService", "RenderResponse",
           "batched_frame_program"]
