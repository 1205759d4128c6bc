"""Architecture and shape configs.

One ``<arch>.py`` per assigned architecture, each exposing::

    CONFIG  - the exact published configuration (full scale)
    SMOKE   - a reduced configuration of the same family for CPU smoke tests

plus the paper's own DVNR configs in ``dvnr.py``.
"""
from repro_torch.configs.base import (
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ShapeConfig,
    SHAPES,
    ARCH_IDS,
    get_config,
    get_smoke_config,
    list_archs,
    cell_is_applicable,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCH_IDS",
    "get_config",
    "get_smoke_config",
    "list_archs",
    "cell_is_applicable",
]
