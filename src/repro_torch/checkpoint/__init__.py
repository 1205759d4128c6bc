"""Checkpoints: the atomic, asynchronous, reshardable manager and
error-bounded compressed trees (the port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.compressed import (compress_tree, compression_report,
                                               decompress_tree)
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager", "compress_tree", "decompress_tree",
           "compression_report"]
