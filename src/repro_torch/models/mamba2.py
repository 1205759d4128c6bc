"""Mamba2 (SSD, state-space duality) block: the chunked scan for prefill
and loss, and the recurrent O(1)-state decode. [arXiv:2405.21060]

The same functions as ``repro.models.mamba2``, in PyTorch. Layout:
d_inner = expand * d_model, H = d_inner / head_dim heads, state size N, a
single B/C group, a causal depthwise conv of width W over [x, B, C].

Chunked SSD, chunk length Q:
  a_t   = exp(dt_t * A_h)                        per-head scalar decay
  intra = (C_q . B_k) * exp(la_q - la_k) * dt_k  for k <= q within a chunk
  inter = carry state H_c = (prod a) H_{c-1} + sum_k decay_k B_k (dt_k x_k)

The scan is plain PyTorch (the JAX package has no kernel for it): the
log-decays are summed in the compute dtype in the order XLA sums
``jnp.cumsum`` (:func:`cumsum_blocked`), the carry of chunk states in
float32, one Python step a chunk in the place of ``lax.scan``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, normal, rms_norm, silu, softplus


def dims(cfg):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    return di, nh, s.state_dim, s.head_dim, s.conv_width


def _a_log_init(nh: int, lead: tuple, device) -> torch.Tensor:
    """log(linspace(1, 16, nh)) in float32, tiled over ``lead``."""
    a = torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=device))
    return a.expand(*lead, nh).contiguous()


def init_ssm_params(gen: torch.Generator, cfg, dtype, lead: tuple = ()) -> dict:
    """One Mamba2 block's parameters, stacked on ``lead`` (``()``: one
    block; ``(L,)``: L stacked layers), under the JAX tree's keys."""
    di, nh, n, _, w = dims(cfg)
    d = cfg.d_model
    dev = gen.device
    return {
        "in_proj": dense_init(gen, (*lead, d, 2 * di + 2 * n + nh), d, dtype),
        "out_proj": dense_init(gen, (*lead, di, d), di, dtype),
        "conv_w": normal(gen, (*lead, w, di + 2 * n), 0.1, dtype),
        "A_log": _a_log_init(nh, lead, dev),
        "D": torch.ones((*lead, nh), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((*lead, nh), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((*lead, di), dtype=torch.float32, device=dev),
    }


def init_mamba2(gen: torch.Generator, cfg, dtype) -> dict:
    return init_ssm_params(gen, cfg, dtype)


def _split_proj(cfg, zxbcdt):
    di, nh, n, _, _ = dims(cfg)
    z, xc, b, c, dt = torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)
    return z, xc, b, c, dt


#: block length of :func:`cumsum_blocked` (XLA's reduce-window rewrite)
CUMSUM_BLOCK = 16


def _cumsum_seq(a, dim):
    parts = a.unbind(dim)
    acc, outs = parts[0], [parts[0]]
    for part in parts[1:]:
        acc = acc + part
        outs.append(acc)
    return torch.stack(outs, dim)


def cumsum_blocked(a, dim):
    """Cumulative sum along ``dim`` in ``a``'s dtype, each add rounded, in
    the order XLA computes ``jnp.cumsum`` (a reduce-window rewritten into
    blocks): the length is padded with zeros to blocks of ``CUMSUM_BLOCK``,
    each block summed left to right, then the blocks' running totals (the
    same way, recursively) added to every block after the first. The
    log-decays of a chunk reach |la| ~ 10^3, where float32's ulp is ~10^-4
    and ``exp(la_q - la_k)`` carries the summation order's rounding, so the
    order is JAX's, not ``torch.cumsum``'s (which sums in double on the
    CPU)."""
    n = a.shape[dim]
    if n <= CUMSUM_BLOCK:
        return _cumsum_seq(a, dim)
    nb = -(-n // CUMSUM_BLOCK)
    a2 = F.pad(a.movedim(dim, -1), (0, nb * CUMSUM_BLOCK - n))
    inner = _cumsum_seq(a2.reshape(*a2.shape[:-1], nb, CUMSUM_BLOCK), -1)
    before = cumsum_blocked(inner[..., -1], -1)[..., :-1, None]
    out = torch.cat([inner[..., :1, :], inner[..., 1:, :] + before], dim=-2)
    return out.reshape(*a2.shape[:-1], nb * CUMSUM_BLOCK)[..., :n].movedim(-1, dim)


def _causal_conv(xbc, conv_w):
    """xbc (B,S,Cd), conv_w (W,Cd): causal depthwise conv, a sum of W
    shifted products in JAX's order."""
    w = conv_w.shape[0]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * conv_w[i] for i in range(w))
    return silu(out)


def ssd_chunked(cfg, xh, dt, a_log, b, c):
    """Chunked SSD scan.

    xh (B,S,H,P) inputs, dt (B,S,H) discretization, a_log = dt*A (B,S,H) <= 0,
    b,c (B,S,N). Returns y (B,S,H,P), final state (B,H,P,N) float32. S must
    be a multiple of Q = min(chunk, S), as JAX asserts (no padding)."""
    B, S, H, Pd = xh.shape
    N = b.shape[-1]
    Q = min(cfg.ssm.chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of the chunk "
                         f"Q={Q} (JAX asserts S % Q == 0)")
    nc = S // Q
    r = lambda t: t.reshape(B, nc, Q, *t.shape[2:])
    xh, dt, a_log, b, c = r(xh), r(dt), r(a_log), r(b), r(c)

    la = cumsum_blocked(a_log, 2)                         # (B,nc,Q,H) in a_log's dtype
    # intra-chunk: y_q += sum_{k<=q} C_q.B_k * exp(la_q - la_k) * dt_k * x_k
    g = torch.einsum("bcqn,bckn->bcqk", c, b)             # (B,nc,Q,Q)
    dl = la[:, :, :, None, :] - la[:, :, None, :, :]      # (B,nc,Q,Q,H) la_q - la_k
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xh.device))[None, None, :, :, None]
    # clamp before exp so masked (k>q) entries don't overflow
    dl_safe = torch.where(mask, dl, 0.0)
    m = torch.where(mask, torch.exp(dl_safe), 0.0)
    m = m * g[..., None]                                  # (B,nc,Q,Q,H)
    xdt = xh * dt[..., None]                              # (B,nc,Q,H,P)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", m.to(xh.dtype), xdt)

    # chunk summaries: s_c = sum_k exp(la_end - la_k) B_k (dt_k x_k)
    decay_to_end = torch.exp(la[:, :, -1:, :] - la)       # (B,nc,Q,H)
    s = torch.einsum("bckn,bckh,bckhp->bchpn", b.float(), decay_to_end.float(),
                     xdt.float())
    chunk_decay = torch.exp(la[:, :, -1, :]).float()      # (B,nc,H)

    h = torch.zeros((B, H, Pd, N), dtype=torch.float32, device=xh.device)
    h_prev = []                                           # state entering each chunk
    for ci in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, ci, :, None, None] + s[:, ci]
    h_prev = torch.stack(h_prev, dim=1)                   # (B,nc,H,P,N)

    # inter-chunk: y_q += exp(la_q) * C_q . H_prev
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", c.float(), h_prev) \
        * torch.exp(la)[..., None].float()
    y = (y_intra.float() + y_inter).to(xh.dtype)
    return y.reshape(B, S, H, Pd), h


def mamba2_block_state(cfg, p, x, sharder=None):
    """Full Mamba2 block. x (B,S,D) -> (out (B,S,D), final ssm state, conv
    tail (B, W-1, Cd))."""
    di, nh, n, pd, w = dims(cfg)
    B, S, D = x.shape
    cdt = x.dtype
    zxbcdt = x @ p["in_proj"].to(cdt)
    z, xc, b, c, dt = _split_proj(cfg, zxbcdt)
    xbc_raw = torch.cat([xc, b, c], dim=-1)
    xbc = _causal_conv(xbc_raw, p["conv_w"].to(cdt))
    xc, b, c = torch.split(xbc, [di, n, n], dim=-1)
    dt = softplus(dt.float() + p["dt_bias"])                       # (B,S,H)
    a = -torch.exp(p["A_log"])                                      # (H,)
    a_log = dt * a                                                  # (B,S,H)
    xh = xc.reshape(B, S, nh, pd)
    y, h_final = ssd_chunked(cfg, xh, dt.to(cdt), a_log.to(cdt), b, c)
    y = y + p["D"].to(cdt)[:, None] * xh
    y = y.reshape(B, S, di)
    y = rms_norm(y * silu(z), p["norm_scale"])
    return y @ p["out_proj"].to(cdt), h_final, xbc_raw[:, -(w - 1):]


def mamba2_block(cfg, p, x, sharder=None):
    """Training/prefill path without state capture. x (B,S,D) -> (B,S,D)."""
    return mamba2_block_state(cfg, p, x, sharder)[0]


# --------------------------------------------------------------------------- #
# Recurrent decode
# --------------------------------------------------------------------------- #
def init_mamba_cache(cfg, batch: int, dtype, device=None, lead: tuple = ()):
    """``{"ssm": (*lead, B,H,P,N) f32, "conv": (*lead, B,W-1,Cd) dtype}``."""
    di, nh, n, pd, w = dims(cfg)
    return {
        "ssm": torch.zeros((*lead, batch, nh, pd, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((*lead, batch, w - 1, di + 2 * n), dtype=dtype,
                            device=device),
    }


def mamba2_decode_step(cfg, p, x, cache):
    """x (B,1,D); cache {"ssm": (B,H,P,N), "conv": (B,W-1,Cd)} -> (y, new
    cache); the cache's tensors are read, not written."""
    di, nh, n, pd, w = dims(cfg)
    B = x.shape[0]
    cdt = x.dtype
    zxbcdt = x[:, 0] @ p["in_proj"].to(cdt)                         # (B, ...)
    z, xc, b, c, dt = _split_proj(cfg, zxbcdt)
    xbc_new = torch.cat([xc, b, c], dim=-1)                         # (B,Cd)
    hist = torch.cat([cache["conv"].to(cdt), xbc_new[:, None]], dim=1)  # (B,W,Cd)
    conv_out = silu(torch.einsum("bwc,wc->bc", hist, p["conv_w"].to(cdt)))
    xc, b, c = torch.split(conv_out, [di, n, n], dim=-1)
    dt = softplus(dt.float() + p["dt_bias"])                        # (B,H)
    a = torch.exp(dt * -torch.exp(p["A_log"]))                      # (B,H)
    xh = xc.reshape(B, nh, pd).float()
    dbx = dt[:, :, None, None] * xh[..., None] * b[:, None, None, :].float()
    h = cache["ssm"] * a[:, :, None, None] + dbx                    # (B,H,P,N)
    y = torch.einsum("bhpn,bn->bhp", h, c.float())
    y = y + p["D"][:, None] * xh
    y = y.reshape(B, di).to(cdt)
    y = rms_norm(y * silu(z), p["norm_scale"])
    out = (y @ p["out_proj"].to(cdt))[:, None]
    return out, {"ssm": h, "conv": hist[:, 1:]}

