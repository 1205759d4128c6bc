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

On a mesh (a ``sharder`` with one) ``x`` is the rank's batch rows, whole
over ``"model"``, and ``p`` the rank's blocks as ``param_shardings`` holds
them, already gathered whole over ``"data"`` by the caller. JAX constrains
``xc`` (B, S, di) to ``("batch", None, "model")``; here the block runs
head-parallel over ``"model"`` wherever its width ``m`` divides the heads
(:func:`head_split`): each rank scans its ``nh / m`` heads.

``in_proj`` is held ``("fsdp", "model")`` over a concatenation of z, x, B,
C and dt (``2 di + 2 N + nh`` columns), and ``conv_w`` ``(None, "model")``
over ``di + 2 N`` (x, B, C), so a block of either's columns is not a
rank's heads. Two routes lead to z, x and dt of the rank's heads and B and
C whole (:func:`rank_view`, :func:`_proj`, :func:`_conv_split`):

- where a gradient is taken, both weights are gathered whole over
  ``"model"`` inside the layer (``collectives.gather_weight``) and the rank
  takes its columns. Each rank computes only its heads, so its gradient
  of each gathered weight is partial (its heads' columns, and its share of
  B's and C's): the gather's backward sums over ``"model"`` and keeps the
  rank's block (``summed=True``: a reduce-scatter); a leaf the guard left
  whole enters over ``"model"`` (its backward a psum). The input enters
  over ``"model"`` too (its cotangent from the rank's heads is partial);
- serving (no gradient) moves activations, not weights: each rank
  multiplies by its block of ``in_proj``'s columns and the products are
  all-gathered over ``"model"`` (B, S, 2 di + 2 N + nh); the rank then
  convolves its block of the conv's columns with its block of ``conv_w``
  and the outputs are all-gathered (B, S, di + 2 N). A decode step sends
  ``B (3 di + 4 N + nh)`` values a layer, where the two weights hold
  ``D (2 di + 2 N + nh) + W (di + 2 N)``.

The rest is head-aligned on either route:

- ``A_log``, ``D`` and ``dt_bias`` are held ``("model",)``: the rank's
  heads as they are.
- the gated RMSNorm normalises over the whole ``di``: the mean of squares
  is a psum over ``"model"`` of the rank's sums; ``norm_scale`` is held
  whole and entered over ``"model"`` before the rank takes its slice.
- ``out_proj`` (``("model", "fsdp")``) holds the rank's heads' rows: the
  product, then a psum over ``"model"`` (``collectives.reduce``).

The decode cache of a rank on such a mesh holds its batch rows, its heads'
``"ssm"`` states (B, nh / m, P, N) and the conv tail of the columns it
convolves (:func:`init_mamba_cache`): its block of the ``di + 2 N``
(B, W-1, (di + 2 N) / m) where ``conv_w`` is cut, else x of its heads,
then B and C (B, W-1, di / m + 2 N). Where ``m`` does not divide the
heads, every rank gathers the leaves ``"model"`` cuts
(``collectives.gather``, backward its block) and computes the whole block.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, normal, rms_norm, silu, softplus
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import mesh_sharder, model_split


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


def _split_proj(cfg, zxbcdt, heads=None):
    """z, x, B, C, dt of a projection (``heads`` of the ``nh`` heads: the
    rank's view)."""
    di, nh, n, pd, _ = dims(cfg)
    h = nh if heads is None else heads
    z, xc, b, c, dt = torch.split(zxbcdt, [h * pd, h * pd, n, n, h], dim=-1)
    return z, xc, b, c, dt


# --------------------------------------------------------------------------- #
# The rank's view on a mesh
# --------------------------------------------------------------------------- #
def head_split(cfg, sh) -> bool:
    """Whether the block runs head-parallel on ``sh``'s mesh: a model axis
    wider than 1 that divides the heads."""
    return sh is not None and model_split(sh, dims(cfg)[1])


def _cols(*ranges, device):
    return torch.cat([torch.arange(a, b, device=device) for a, b in ranges])


def _serving(heads) -> bool:
    """Whether the block takes the serving route (see the module
    docstring): a head split, and no gradient."""
    return heads is not None and not torch.is_grad_enabled()


def _conv_cols(cfg, sh, heads, device):
    """The conv's columns (of x, B, C) that the rank's heads read: x of its
    heads, then B and C."""
    di, _, n, pd, _ = dims(cfg)
    lo = sh.mesh.axis_index("model") * heads * pd
    return _cols((lo, lo + heads * pd), (di, di + 2 * n), device=device)


def rank_view(cfg, p, x, sh):
    """(x, p, heads): what this rank computes the block from. Without a
    head split (no mesh, or a model axis of 1), ``x`` and ``p`` as they
    are and every head (``heads`` None); with one (see the module
    docstring), ``heads`` its ``nh / m``, ``norm_scale`` its slice and
    ``out_proj``, ``A_log``, ``D``, ``dt_bias`` its blocks as held; where a
    gradient is taken, ``x`` entered over ``"model"`` and ``in_proj`` and
    ``conv_w`` the rank's columns of the gathered weights; serving, both
    as held (``conv_w``'s columns of the rank's heads where the guard left
    it whole). Where ``m > 1`` does not divide the heads, ``p`` with every
    leaf ``"model"`` cuts gathered whole."""
    di, nh, n, pd, _ = dims(cfg)
    if sh is None or sh.axis_size("model") == 1:
        return x, p, None
    mesh, M = sh.mesh, "model"
    widths = {"in_proj": 2 * di + 2 * n + nh, "conv_w": di + 2 * n, "A_log": nh,
              "D": nh, "dt_bias": nh}
    if not head_split(cfg, sh):
        q = dict(p)
        for k, w in widths.items():
            if model_split(sh, w):
                q[k] = col.gather(p[k], mesh, M, -1)
        if model_split(sh, di):
            q["out_proj"] = col.gather(p["out_proj"], mesh, M, 0)
        return x, q, None
    h = nh // sh.axis_size(M)
    lo, dl = mesh.axis_index(M) * h, h * pd
    dev = x.device
    q = dict(p)
    q["norm_scale"] = col.enter(p["norm_scale"], mesh, M).narrow(-1, lo * pd, dl)
    if _serving(h):
        if not model_split(sh, widths["conv_w"]):
            q["conv_w"] = p["conv_w"].index_select(-1, _conv_cols(cfg, sh, h, dev))
        return x, q, h

    def whole(k):                       # the leaf whole over "model", summed back
        if model_split(sh, widths[k]):
            return col.gather_weight(p[k], mesh, M, p[k].dim() - 1, True)
        return col.enter(p[k], mesh, M)

    q["in_proj"] = whole("in_proj").index_select(-1, _cols(
        (lo * pd, lo * pd + dl), (di + lo * pd, di + lo * pd + dl),
        (2 * di, 2 * di + 2 * n), (2 * di + 2 * n + lo, 2 * di + 2 * n + lo + h),
        device=dev))
    q["conv_w"] = whole("conv_w").index_select(-1, _conv_cols(cfg, sh, h, dev))
    return col.enter(x, mesh, M), q, h


def _proj(cfg, p, x, sh, heads):
    """(z, xbc, dt): ``x``'s projection, z and dt of the rank's heads (every
    head without a head split) and ``xbc`` the columns of the conv's input
    (x, B, C) that the rank convolves (:func:`init_mamba_cache`'s conv
    tail). Serving, from the ranks' products with their blocks of
    ``in_proj``, all-gathered over ``"model"``."""
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    if not _serving(heads):
        z, xc, b, c, dt = _split_proj(cfg, zxbcdt, heads)
        return z, torch.cat([xc, b, c], dim=-1), dt
    di, nh, n, pd, _ = dims(cfg)
    mesh = sh.mesh
    if model_split(sh, 2 * di + 2 * n + nh):
        zxbcdt = col.all_gather_dim(zxbcdt, mesh, "model", -1)
    z, xc, b, c, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([xc, b, c], dim=-1)
    if model_split(sh, di + 2 * n):     # the rank's block of the columns
        w = xbc.shape[-1] // sh.axis_size("model")
        xbc = xbc.narrow(-1, mesh.axis_index("model") * w, w)
    else:
        xbc = xbc.index_select(-1, _conv_cols(cfg, sh, heads, x.device))
    lo = mesh.axis_index("model") * heads
    return z.narrow(-1, lo * pd, heads * pd), xbc, dt.narrow(-1, lo, heads)


def _conv_split(cfg, out, sh, heads):
    """x of the rank's heads, B and C, from the conv's output over the
    columns the rank convolves (serving: all-gathered over ``"model"``
    where those are its block)."""
    di, nh, n, pd, _ = dims(cfg)
    if _serving(heads) and model_split(sh, di + 2 * n):
        xc, b, c = torch.split(col.all_gather_dim(out, sh.mesh, "model", -1),
                               [di, n, n], dim=-1)
        return xc.narrow(-1, sh.mesh.axis_index("model") * heads * pd, heads * pd), b, c
    h = nh if heads is None else heads
    return torch.split(out, [h * pd, n, n], dim=-1)


def _gated_norm(cfg, y, z, scale, sh, heads):
    """``rms_norm(y * silu(z), scale)`` over the whole ``di``: on the rank's
    heads, the mean of squares from a psum over ``"model"``."""
    var = None if heads is None else (lambda g: col.psum(
        torch.sum(torch.square(g), dim=-1, keepdim=True), sh.mesh, "model") / dims(cfg)[0])
    return rms_norm(y * silu(z), scale, var=var)


def _out_proj(y, p, sh, heads):
    out = y @ p["out_proj"].to(y.dtype)
    return out if heads is None else col.reduce(out, sh.mesh, "model")


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
    tail (B, W-1, Cd)); on a mesh the state and tail of the rank's heads
    (see the module docstring)."""
    di, nh, n, pd, w = dims(cfg)
    sh = mesh_sharder(sharder)
    x, p, heads = rank_view(cfg, p, x, sh)
    h = nh if heads is None else heads
    B, S, D = x.shape
    cdt = x.dtype
    z, xbc_raw, dt = _proj(cfg, p, x, sh, heads)
    xbc = _causal_conv(xbc_raw, p["conv_w"].to(cdt))
    xc, b, c = _conv_split(cfg, xbc, sh, heads)
    dt = softplus(dt.float() + p["dt_bias"])                       # (B,S,H)
    a = -torch.exp(p["A_log"])                                      # (H,)
    a_log = dt * a                                                  # (B,S,H)
    xh = xc.reshape(B, S, h, pd)
    y, h_final = ssd_chunked(cfg, xh, dt.to(cdt), a_log.to(cdt), b, c)
    y = y + p["D"].to(cdt)[:, None] * xh
    y = _gated_norm(cfg, y.reshape(B, S, h * pd), z, p["norm_scale"], sh, heads)
    return _out_proj(y, p, sh, heads), h_final, xbc_raw[:, -(w - 1):]


def mamba2_block(cfg, p, x, sharder=None):
    """Training/prefill path without state capture. x (B,S,D) -> (B,S,D)."""
    return mamba2_block_state(cfg, p, x, sharder)[0]


# --------------------------------------------------------------------------- #
# Recurrent decode
# --------------------------------------------------------------------------- #
def init_mamba_cache(cfg, batch: int, dtype, device=None, lead: tuple = (),
                     sharder=None):
    """``{"ssm": (*lead, B,H,P,N) f32, "conv": (*lead, B,W-1,Cd) dtype}``;
    on a mesh with a head split, the rank's heads and the conv columns it
    convolves serving (see the module docstring)."""
    di, nh, n, pd, w = dims(cfg)
    sh = mesh_sharder(sharder)
    h, cd = nh, di + 2 * n
    if head_split(cfg, sh):
        h = nh // sh.axis_size("model")
        cd = cd // sh.axis_size("model") if model_split(sh, cd) else h * pd + 2 * n
    return {
        "ssm": torch.zeros((*lead, batch, h, pd, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((*lead, batch, w - 1, cd), dtype=dtype, device=device),
    }


def mamba2_decode_step(cfg, p, x, cache, sharder=None):
    """x (B,1,D); cache {"ssm": (B,H,P,N), "conv": (B,W-1,Cd)} -> (y, new
    cache); the cache's tensors are read, not written. On a mesh, the
    rank's heads (:func:`init_mamba_cache`'s layout)."""
    di, nh, n, pd, w = dims(cfg)
    sh = mesh_sharder(sharder)
    x, p, heads = rank_view(cfg, p, x, sh)
    h = nh if heads is None else heads
    B = x.shape[0]
    cdt = x.dtype
    z, xbc_new, dt = _proj(cfg, p, x[:, 0], sh, heads)              # xbc_new (B,Cd)
    hist = torch.cat([cache["conv"].to(cdt), xbc_new[:, None]], dim=1)  # (B,W,Cd)
    conv_out = silu(torch.einsum("bwc,wc->bc", hist, p["conv_w"].to(cdt)))
    xc, b, c = _conv_split(cfg, conv_out, sh, heads)
    dt = softplus(dt.float() + p["dt_bias"])                        # (B,H)
    a = torch.exp(dt * -torch.exp(p["A_log"]))                      # (B,H)
    xh = xc.reshape(B, h, pd).float()
    dbx = dt[:, :, None, None] * xh[..., None] * b[:, None, None, :].float()
    hs = cache["ssm"] * a[:, :, None, None] + dbx                   # (B,H,P,N)
    y = torch.einsum("bhpn,bn->bhp", hs, c.float())
    y = y + p["D"][:, None] * xh
    y = _gated_norm(cfg, y.reshape(B, h * pd).to(cdt), z, p["norm_scale"], sh, heads)
    out = _out_proj(y, p, sh, heads)[:, None]
    return out, {"ssm": hs, "conv": hist[:, 1:]}
