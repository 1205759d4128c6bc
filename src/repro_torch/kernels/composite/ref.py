"""Plain PyTorch front-to-back over-operator compositing of ray samples.

The port of ``repro.kernels.composite``: the sample loop of the JAX
reference's ``lax.scan``, with (color, transmittance) carried in float32
whatever the input dtype and the result cast to the input dtype at the end —
the arithmetic of the Pallas kernel (for float32 input, of the jnp
reference too)."""
from __future__ import annotations

import torch


def composite_ref(rgba: torch.Tensor) -> torch.Tensor:
    """rgba (..., S, 4) front-to-back samples -> (..., 4) (rgb, alpha)."""
    lead = rgba.shape[:-2]
    color = torch.zeros((*lead, 3), dtype=torch.float32, device=rgba.device)
    trans = torch.ones((*lead, 1), dtype=torch.float32, device=rgba.device)
    for s in range(rgba.shape[-2]):
        sample = rgba[..., s, :].float()
        a = sample[..., 3:4]
        color = color + trans * a * sample[..., :3]
        trans = trans * (1.0 - a)
    return torch.cat([color, 1.0 - trans], dim=-1).to(rgba.dtype)
