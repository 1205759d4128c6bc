from repro_torch.kernels.inr_forward.ops import inr_forward_cuda, refusal

__all__ = ["inr_forward_cuda", "refusal"]
