from repro_torch.kernels.fused_mlp.ops import (fused_mlp, fused_mlp_batched,
                                               fused_mlp_cuda)

__all__ = ["fused_mlp", "fused_mlp_batched", "fused_mlp_cuda"]
