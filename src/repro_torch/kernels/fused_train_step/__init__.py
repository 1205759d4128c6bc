"""The fused DVNR train step: [batch sampling,] hash encode and MLP
forward, the hand-derived backward and the gated AdamW update.

- ``ops.fused_train_step`` / ``ops.fused_train_step_sampling`` — the entry
  points on the stacked (P, ...) trainer state (host-sampled batch, or the
  counter-based draws and the trilinear gather inside the op);
- ``ref`` — the plain composition (autograd through the plain ops, then
  AdamW), and the plain versions of the two CUDA kernels;
- ``ops.train_step_cuda`` / ``ops.adamw_apply_cuda`` — the wrappers of
  ``csrc/train_step.cuh`` (f32 and bf16 instantiations) and
  ``csrc/adamw.cu`` (with or without the f32 master).
"""
from repro_torch.kernels.fused_train_step.ops import (fused_train_step,
                                                      fused_train_step_sampling)

__all__ = ["fused_train_step", "fused_train_step_sampling"]
