from repro_torch.models.api import Model, build_model

__all__ = ["Model", "build_model"]
