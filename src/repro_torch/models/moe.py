"""Mixture-of-experts block: top-k routing and capacity dispatch.

The same functions as ``repro.models.moe``, in PyTorch. Routing is
Switch/Mixtral: a float32 softmax router, the top-k experts per token, the
weights renormalized over the chosen k, a capacity drop and the
load-balancing auxiliary loss.

Dispatch, as the JAX package names it:

- ``"scatter"`` / ``"scatter_gspmd"``: :func:`moe_block_scatter`, every
  batch row routes its own S tokens into a private (E, C_row, D) buffer;
- ``"scatter_global"``: :func:`moe_block_scatter_global`, one (E, C, D)
  buffer for all tokens (the JAX package's ablation baseline);
- ``"a2a"`` and the tensor-parallel dispatch need a mesh with a ``"model"``
  axis, which the port does not have: :func:`moe_block_a2a` and
  :func:`moe_block_tp` raise naming ROADMAP item 16, and so does any
  ``sharder``.

Dropped (token, slot) pairs still add ``x * 0`` into slot 0 of their
expert, as JAX's scatter does, so the buffer holds JAX's values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, silu
from repro_torch.parallel.sharding import require_no_sharder

#: dispatch names ``moe_block`` (and ``build_model``) take, as in JAX
DISPATCHES = ("scatter", "scatter_gspmd", "scatter_global", "a2a")


def _no_mesh(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs a mesh with a 'model' axis: tensor-parallel and "
        "expert-parallel execution is not ported yet (ROADMAP item 16)")


def init_moe(gen: torch.Generator, cfg, dtype) -> dict:
    assert cfg.moe is not None
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    p = {
        "router": dense_init(gen, (d, e), d, torch.float32),
        "wi": dense_init(gen, (e, d, f), d, dtype),
        "wo": dense_init(gen, (e, f, d), f, dtype),
    }
    if cfg.act == "swiglu":
        p["wg"] = dense_init(gen, (e, d, f), d, dtype)
    return p


def route(cfg, p, x_flat):
    """x_flat (T,D) -> (weights (T,k) f32, ids (T,k) int64, aux_loss scalar)."""
    moe = cfg.moe
    logits = (x_flat.float() @ p["router"].float()).float()         # (T,E)
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.topk(probs, moe.top_k, dim=-1)              # (T,k)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    # Switch aux loss: E * sum_e f_e * p_e
    e = moe.num_experts
    me = probs.mean(0)                                               # (E,)
    flat = ids.reshape(-1)
    ce = torch.zeros((e,), dtype=torch.float32, device=probs.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=probs.device))
    ce = ce / ids.numel()
    aux = e * torch.sum(me * ce) * moe.router_aux_weight
    return weights, ids, aux


def _capacity(cfg, tokens: int) -> int:
    moe = cfg.moe
    c = int(tokens * moe.top_k * moe.capacity_factor / moe.num_experts)
    return max(8, -(-c // 8) * 8)


def _positions_in_expert(flat_ids, num_experts):
    """Rank of each routed (token, slot) within its expert, computed via a
    stable sort: flat_ids (..., n) -> int32 (..., n). Leading dims are
    independent rows (JAX ``vmap``s the 1-d function over them)."""
    ids = flat_ids.long()
    n = ids.shape[-1]
    order = torch.argsort(ids, dim=-1, stable=True)
    sorted_ids = torch.gather(ids, -1, order)
    counts = torch.zeros((*ids.shape[:-1], num_experts), dtype=torch.int32,
                         device=ids.device)
    counts.scatter_add_(-1, ids, torch.ones(ids.shape, dtype=torch.int32,
                                            device=ids.device))
    starts = torch.cumsum(counts, dim=-1, dtype=torch.int32) - counts  # (..., E)
    pos_sorted = torch.arange(n, dtype=torch.int32, device=ids.device) \
        - torch.gather(starts, -1, sorted_ids)
    return torch.zeros(ids.shape, dtype=torch.int32,
                       device=ids.device).scatter_(-1, order, pos_sorted)


def _act(cfg, p, buf, h, eq):
    if cfg.act == "swiglu":
        return silu(torch.einsum(eq, buf, p["wg"].to(buf.dtype))) * h
    return F.gelu(h, approximate="tanh")      # jax.nn.gelu's default


def _expert_ffn(cfg, p, buf):
    """buf (E, C, D) -> (E, C, D) through per-expert FFN."""
    cdt = buf.dtype
    h = torch.einsum("ecd,edf->ecf", buf, p["wi"].to(cdt))
    h = _act(cfg, p, buf, h, "ecd,edf->ecf")
    return torch.einsum("ecf,efd->ecd", h, p["wo"].to(cdt))


def _expert_ffn_batched(cfg, p, buf):
    """buf (B, E, C, D) -> (B, E, C, D) through per-expert FFNs."""
    cdt = buf.dtype
    h = torch.einsum("becd,edf->becf", buf, p["wi"].to(cdt))
    h = _act(cfg, p, buf, h, "becd,edf->becf")
    return torch.einsum("becf,efd->becd", h, p["wo"].to(cdt))


def moe_block_scatter(cfg, p, x, sharder=None):
    """x (B,S,D) -> (out (B,S,D), aux_loss).

    Batch-row-grouped capacity dispatch: every batch row routes its own S
    tokens into a private (E, C_row, D) buffer (C_row = ``_capacity(cfg,
    S)``); the stacked (B, E, C_row, D) buffer goes through the experts
    and each (token, slot) gathers its row back, weighted."""
    require_no_sharder(sharder)
    moe = cfg.moe
    B, S, D = x.shape
    k = moe.top_k
    weights, ids, aux = route(cfg, p, x.reshape(B * S, D))           # (B*S, k)
    C = _capacity(cfg, S)                                            # per row
    ids_r = ids.reshape(B, S * k)
    pos = _positions_in_expert(ids_r, moe.num_experts)
    keep = pos < C                                                   # (B, S*k)
    pos_c = torch.where(keep, pos, 0).long()
    x_rep = torch.repeat_interleave(x, k, dim=1)                     # (B, S*k, D)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, S * k)
    buf = torch.zeros((B, moe.num_experts, C, D), dtype=x.dtype, device=x.device)
    buf = buf.index_put((rows, ids_r, pos_c), x_rep * keep[..., None].to(x.dtype),
                        accumulate=True)                             # (B,E,C,D)
    out_buf = _expert_ffn_batched(cfg, p, buf)
    gathered = out_buf[rows, ids_r, pos_c]                           # (B, S*k, D)
    wk = (weights.reshape(B, S * k) * keep).to(x.dtype)
    y = (gathered * wk[..., None]).reshape(B, S, k, D).sum(dim=2)
    return y, aux


def moe_block_scatter_global(cfg, p, x, sharder=None):
    """The pre-optimization dispatch (one global (E,C,D) buffer), the JAX
    package's baseline / ablation arm."""
    require_no_sharder(sharder)
    moe = cfg.moe
    B, S, D = x.shape
    T = B * S
    k = moe.top_k
    xf = x.reshape(T, D)
    weights, ids, aux = route(cfg, p, xf)
    C = _capacity(cfg, T)
    flat_ids = ids.reshape(-1)                                       # (T*k,)
    pos = _positions_in_expert(flat_ids, moe.num_experts)            # (T*k,)
    keep = pos < C
    pos_c = torch.where(keep, pos, 0).long()
    # dispatch: (E, C, D) -- token slot j of expert e
    x_rep = torch.repeat_interleave(xf, k, dim=0)                    # (T*k, D)
    buf = torch.zeros((moe.num_experts, C, D), dtype=x.dtype, device=x.device)
    buf = buf.index_put((flat_ids, pos_c), x_rep * keep[:, None].to(x.dtype),
                        accumulate=True)
    out_buf = _expert_ffn(cfg, p, buf)                               # (E, C, D)
    # combine
    gathered = out_buf[flat_ids, pos_c]                              # (T*k, D)
    wk = (weights.reshape(-1) * keep).to(x.dtype)
    y = (gathered * wk[:, None]).reshape(T, k, D).sum(dim=1)
    return y.reshape(B, S, D), aux


def moe_block_a2a(cfg, p, x, sharder=None):
    """Expert-parallel MoE with an all_to_all over the mesh's model axis:
    not ported (ROADMAP item 16)."""
    raise _no_mesh("moe_block_a2a (expert-parallel all_to_all dispatch)")


def moe_block_tp(cfg, p, x, sharder=None):
    """TP-inside-expert MoE with a deferred combine over the model axis: not
    ported (ROADMAP item 16)."""
    raise _no_mesh("moe_block_tp (tensor-parallel experts)")


def moe_block(cfg, p, x, sharder=None, dispatch: str = "scatter"):
    """Dispatch selection. Without a mesh ``"scatter"`` and
    ``"scatter_gspmd"`` are :func:`moe_block_scatter` and
    ``"scatter_global"`` is :func:`moe_block_scatter_global`, as in JAX;
    ``"a2a"`` and any ``sharder`` raise (ROADMAP item 16)."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}; one of {DISPATCHES}")
    if dispatch == "a2a":
        return moe_block_a2a(cfg, p, x, sharder)
    require_no_sharder(sharder)
    if dispatch == "scatter_global":
        return moe_block_scatter_global(cfg, p, x)
    return moe_block_scatter(cfg, p, x)
