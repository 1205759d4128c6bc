from repro_torch.kernels.composite.ops import composite, composite_cuda

__all__ = ["composite", "composite_cuda"]
