"""Backward pathline tracing over a DVNR temporal window (paper §V-E).

The port of ``repro.core.pathlines``. Upon trigger activation the sliding
window is reversed and velocities negated; seed points are integrated
backward in time with RK2 (midpoint), querying the per-partition velocity
INRs on demand (INR inference, the inference kernel on the ``cuda``
backend). Partition-aware: each query point is evaluated by the INR that
owns it (a mask-select over the small partition set).

``trace_ground_truth`` integrates the analytic field for the paper's
Fig. 13 comparison.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import backends
from repro_torch.configs.dvnr import DVNRConfig
from repro_torch.core.inr import _inr_apply
from repro_torch.data.volume import synthetic_field


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def _query_velocity(cfg: DVNRConfig, stacked_params, parts_meta, pts,
                    impl: backends.BackendLike = "ref"):
    """pts (N,3) global [0,1]^3 -> velocity (N,3), partition-aware
    de-normalized; on the params' device."""
    dev = pts.device
    P = len(parts_meta)
    out = torch.zeros((pts.shape[0], 3), dtype=torch.float32, device=dev)
    hit = torch.zeros((pts.shape[0],), dtype=torch.bool, device=dev)
    for p in range(P):
        m = parts_meta[p]
        lo = _f32(m["origin"], dev)
        ext = _f32(m["extent"], dev)
        local = (pts - lo) / ext
        inside = torch.all((local >= 0.0) & (local <= 1.0), dim=-1) & ~hit
        params_p = {"tables": stacked_params["tables"][p],
                    "mlp": [w[p] for w in stacked_params["mlp"]]}
        v01 = _inr_apply(cfg, params_p, torch.clamp(local, 0.0, 1.0),
                         impl).float()
        vmin = _f32(m["vmin"], dev)
        vmax = _f32(m["vmax"], dev)
        v = v01 * (vmax - vmin) + vmin
        out = torch.where(inside[:, None], v, out)
        hit = hit | inside
    return out


def trace_backward(cfg: DVNRConfig, window: Sequence, parts_meta, seeds,
                   dt: float, *, substeps: int = 4,
                   impl: backends.BackendLike = "ref"):
    """Backward pathlines over a temporal window of stacked velocity-INR params.

    ``window``: newest -> oldest list of stacked params (one entry per cached
    timestep); ``parts_meta``: per-partition origin/extent/vmin/vmax (vmin/vmax
    may be per-timestep: pass a list parallel to ``window``). ``seeds`` (N,3)
    move to the params' device. Returns the trajectory (T*substeps+1, N, 3).
    """
    dev = window[0]["tables"].device
    pts = torch.as_tensor(seeds, dtype=torch.float32).to(dev)
    traj = [pts]
    h = dt / substeps
    for t, stacked in enumerate(window):
        meta_t = parts_meta[t] if isinstance(parts_meta[0], (list, tuple)) else parts_meta
        for _ in range(substeps):
            # backward: negate velocity (paper: "reversed and negated the window")
            v1 = -_query_velocity(cfg, stacked, meta_t, pts, impl)
            mid = torch.clamp(pts + 0.5 * h * v1, 0.0, 1.0)
            v2 = -_query_velocity(cfg, stacked, meta_t, mid, impl)
            pts = torch.clamp(pts + h * v2, 0.0, 1.0)
            traj.append(pts)
    return torch.stack(traj)


def trace_ground_truth(kind: str, times: Sequence[float], seeds, dt: float,
                       *, substeps: int = 4):
    """RK2 backward integration of the analytic velocity field (post hoc),
    on the device of ``seeds`` (numpy seeds: the CPU)."""
    pts = torch.as_tensor(seeds, dtype=torch.float32)
    traj = [pts]
    h = dt / substeps

    def vel(p, t):
        return synthetic_field(kind, p, t)

    for t in times:
        for _ in range(substeps):
            v1 = -vel(pts, t)
            mid = torch.clamp(pts + 0.5 * h * v1, 0.0, 1.0)
            v2 = -vel(mid, t)
            pts = torch.clamp(pts + h * v2, 0.0, 1.0)
            traj.append(pts)
    return torch.stack(traj)


def pathline_deviation(traj_a, traj_b) -> dict:
    """Pointwise deviation stats between two (T,N,3) trajectories (arrays
    or tensors on any device)."""
    a = torch.as_tensor(traj_a, dtype=torch.float32)
    b = torch.as_tensor(traj_b, dtype=torch.float32).to(a.device)
    d = torch.linalg.vector_norm(a - b, dim=-1)
    return {"mean": float(d.mean()), "max": float(d.max()),
            "final_mean": float(d[-1].mean())}
