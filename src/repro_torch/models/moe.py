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
- ``"a2a"``: :func:`moe_block_a2a`, expert parallelism with an
  all_to_all over ``"model"`` (a mesh is needed; without one ``moe_block``
  routes ``"a2a"`` to the scatter, as JAX's does);
- :func:`moe_block_tp`: tensor parallelism inside each expert with the
  deferred combine (one psum of the token stream).

On a mesh ``moe_block`` routes exactly as JAX's (``moe.py``): expert-
parallel experts to ``a2a`` when the experts and the sequence divide the
model axis, tensor-parallel ones to ``moe_block_tp``, ``"scatter_gspmd"``
and ``"scatter_global"`` to the scatters as XLA partitions them. The
shard_map bodies are JAX's, with its boundaries made explicit: an input
that the in_specs do not cut over ``"model"`` enters through
``collectives.enter`` (its gradient summed over the ranks), an output that
the out_specs do not cut leaves through ``collectives.leave``, and the
token blocks move by ``block`` / ``gather``. So the auxiliary loss of an
``a2a`` layer is each rank's own (JAX returns the first device's, and its
gradient is the mean over the devices'), and ``moe_block_tp``'s is the
pmean over the batch axes. The parameters arrive whole over ``"data"``:
the caller gathers the rank's blocks of a layer before the block
(``transformer.gather_fsdp``: the experts' ``("expert", "fsdp", None)``
under ``ep``, ``(None, "fsdp", "model")`` under ``tp``), and the gathers'
reduce-scatters and ``transformer.enter_batch`` sum their gradients over
the batch axes.

Dropped (token, slot) pairs still add ``x * 0`` into slot 0 of their
expert, as JAX's scatter does, so the buffer holds JAX's values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, silu
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import mesh_sharder, model_split

#: dispatch names ``moe_block`` (and ``build_model``) take, as in JAX
DISPATCHES = ("scatter", "scatter_gspmd", "scatter_global", "a2a")


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


def route(cfg, p, x_flat, mean=None):
    """x_flat (T,D) -> (weights (T,k) f32, ids (T,k) int64, aux_loss scalar).
    ``mean``: where the tokens are a block of the batch, the function that
    averages a per-block statistic over the blocks (the aux loss's expert
    fractions are the global batch's)."""
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
    if mean is not None:
        me, ce = mean(me), mean(ce)
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


def _experts_on_mesh(cfg, p, buf, sh, ffn, e_dim: int):
    """``ffn(p, buf)`` with ``buf`` whole over ``"model"`` and the experts
    held as the rules cut them: expert-parallel ones, the rank's experts on
    its block of ``buf`` (axis ``e_dim``) and the blocks gathered; tensor-
    parallel ones, the rank's slice of every expert and a psum."""
    mesh = sh.mesh
    if cfg.moe.expert_sharding == "ep" and model_split(sh, cfg.moe.num_experts):
        return col.gather(ffn(p, col.block(buf, mesh, "model", e_dim)),
                          mesh, "model", e_dim)
    if cfg.moe.expert_sharding != "ep" and model_split(sh, cfg.d_ff):
        return col.reduce(ffn(p, col.enter(buf, mesh, "model")), mesh, "model")
    return ffn(p, buf)


def _batch_mean(sh):
    """The mean over the sharder's batch axes of a per-block statistic
    (None without a mesh)."""
    if sh is None:
        return None
    axes = sh.axes("batch")
    return lambda t: col.leave(col.pmean(t, sh.mesh, axes), sh.mesh, axes)


def moe_block_scatter(cfg, p, x, sharder=None):
    """x (B,S,D) -> (out (B,S,D), aux_loss).

    Batch-row-grouped capacity dispatch: every batch row routes its own S
    tokens into a private (E, C_row, D) buffer (C_row = ``_capacity(cfg,
    S)``); the stacked (B, E, C_row, D) buffer goes through the experts
    and each (token, slot) gathers its row back, weighted. On a mesh (XLA's
    partitioning of JAX's block): the rows are the rank's batch block, the
    experts run as the rules hold them, the aux loss's fractions are the
    global batch's."""
    sh = mesh_sharder(sharder)
    moe = cfg.moe
    B, S, D = x.shape
    k = moe.top_k
    weights, ids, aux = route(cfg, p, x.reshape(B * S, D), _batch_mean(sh))
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
    out_buf = (_expert_ffn_batched(cfg, p, buf) if sh is None else
               _experts_on_mesh(cfg, p, buf, sh,
                                lambda pp, b: _expert_ffn_batched(cfg, pp, b), 1))
    gathered = out_buf[rows, ids_r, pos_c]                           # (B, S*k, D)
    wk = (weights.reshape(B, S * k) * keep).to(x.dtype)
    y = (gathered * wk[..., None]).reshape(B, S, k, D).sum(dim=2)
    return y, aux


def moe_block_scatter_global(cfg, p, x, sharder=None):
    """The pre-optimization dispatch (one global (E,C,D) buffer), the JAX
    package's baseline / ablation arm. On a mesh its token axis does not
    shard (JAX's note): every rank gathers the global batch, computes the
    whole buffer and keeps its batch block of the output."""
    sh = mesh_sharder(sharder)
    if sh is not None and sh.mesh.axis_size(sh.axes("batch")) > 1:
        mesh, axes = sh.mesh, sh.axes("batch")
        y, aux = moe_block_scatter_global(
            cfg, p, col.all_gather_dim(x, mesh, axes, 0), _no_batch(sh))
        return _own_block(y, mesh, axes), col.leave(aux, mesh, axes)
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
    out_buf = (_expert_ffn(cfg, p, buf) if sh is None else
               _experts_on_mesh(cfg, p, buf, sh,
                                lambda pp, b: _expert_ffn(cfg, pp, b), 0))
    # combine
    gathered = out_buf[flat_ids, pos_c]                              # (T*k, D)
    wk = (weights.reshape(-1) * keep).to(x.dtype)
    y = (gathered * wk[:, None]).reshape(T, k, D).sum(dim=1)
    return y.reshape(B, S, D), aux


def _no_batch(sh):
    """``sh`` for work on the whole global batch (no batch axes)."""
    from repro_torch.parallel.sharding import Sharder
    out = Sharder(sh.mesh)
    out.axis_map = dict(sh.axis_map, batch=())
    return out


def _own_block(y, mesh, axes):
    """This rank's batch block of ``y``, computed whole from the gathered
    batch: a plain slice (its gradient the block's; the gather before it
    sums the ranks' parts)."""
    n, k = mesh.axis_size(axes), mesh.axis_index(axes)
    b = y.shape[0] // n
    return y[k * b:(k + 1) * b]


def _a2a_dispatch(cfg, xl, router, m: int):
    """The routing and capacity buffer of JAX's ``moe_block_a2a`` body on
    this rank's tokens ``xl`` (Bl, Sl, D): (weights, ids, aux, keep, pos_c,
    flat_ids, buf (E, C, D))."""
    moe = cfg.moe
    Bl, Sl, D = xl.shape
    Tl = Bl * Sl
    xf = xl.reshape(Tl, D)
    weights, ids, aux = route(cfg, {"router": router}, xf)
    C = _capacity(cfg, Tl)
    C = max(8, -(-C // m) * m)  # divisible by model size for all_to_all
    flat_ids = ids.reshape(-1)
    pos = _positions_in_expert(flat_ids, moe.num_experts)
    keep = pos < C
    pos_c = torch.where(keep, pos, 0).long()
    x_rep = torch.repeat_interleave(xf, moe.top_k, dim=0)
    buf = torch.zeros((moe.num_experts, C, D), dtype=xl.dtype, device=xl.device)
    buf = buf.index_put((flat_ids, pos_c), x_rep * keep[:, None].to(xl.dtype),
                        accumulate=True)
    return weights, ids, aux, keep, pos_c, flat_ids, buf


def moe_block_a2a(cfg, p, x, sharder=None):
    """Expert-parallel MoE with explicit all_to_all over the model axis
    (JAX's ``moe_block_a2a``): needs a mesh with a ``"model"`` axis that
    divides the experts and the sequence. Each model rank takes its block
    of the sequence (the batch is whole over ``"model"`` outside), routes
    it into a capacity buffer of ``max(8, ceil(C/m)*m)`` slots per expert
    (``C`` for its own tokens), sends each expert's slots to the rank that
    holds it, runs its experts, sends the results back and combines; the
    ranks gather the token blocks. ``p``: the router whole, the experts this
    rank's block."""
    sh = mesh_sharder(sharder)
    if sh is None or "model" not in sh.mesh.shape:
        raise ValueError("moe_block_a2a needs a sharder with a mesh that has "
                         "a 'model' axis")
    mesh = sh.mesh
    m = mesh.shape["model"]
    moe = cfg.moe
    if moe.num_experts % m:
        raise ValueError("a2a dispatch needs E % model == 0")
    D = x.shape[2]
    xl = col.block(x, mesh, "model", 1)
    router = col.enter(p["router"], mesh, "model")
    weights, ids, aux, keep, pos_c, flat_ids, buf = _a2a_dispatch(cfg, xl, router, m)
    # every shard sends its tokens for experts e to the shard owning e and
    # receives C tokens per peer -> (E/m, m*C, D)
    buf = col.all_to_all(buf, mesh, "model", 0, 1)
    out = _expert_ffn(cfg, p, buf)
    out = col.all_to_all(out, mesh, "model", 1, 0)
    gathered = out[flat_ids, pos_c]
    Bl, Sl = xl.shape[:2]
    wk = (weights.reshape(-1) * keep).to(xl.dtype)
    y = (gathered * wk[:, None]).reshape(Bl * Sl, moe.top_k, D).sum(dim=1)
    y = col.gather(y.reshape(Bl, Sl, D), mesh, "model", 1)
    return y, col.leave(aux, mesh, mesh.axis_names)


def moe_block_tp(cfg, p, x, sharder=None):
    """TP-inside-expert MoE (few huge experts, e.g. grok-1) with the
    deferred combine (JAX's ``moe_block_tp``): every model rank runs the
    whole dispatch of its batch block on its slice of each expert's
    ``d_ff``, combines its partial token outputs, and one psum over
    ``"model"`` of the (B, S, D) token stream sums them; the aux loss is
    the pmean over the batch axes. ``p``: the router whole, the experts'
    ``wi`` / ``wg`` columns and ``wo`` rows this rank's."""
    sh = mesh_sharder(sharder)
    if sh is None:
        raise ValueError("moe_block_tp needs a sharder with a mesh")
    mesh = sh.mesh
    moe = cfg.moe
    B, S, D = x.shape
    k = moe.top_k
    xl = col.enter(x, mesh, "model")
    router = col.enter(p["router"], mesh, "model")
    weights, ids, aux = route(cfg, {"router": router}, xl.reshape(B * S, D))
    C = _capacity(cfg, S)
    ids_r = ids.reshape(B, S * k)
    pos = _positions_in_expert(ids_r, moe.num_experts)
    keep = pos < C
    pos_c = torch.where(keep, pos, 0).long()
    x_rep = torch.repeat_interleave(xl, k, dim=1)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, S * k)
    buf = torch.zeros((B, moe.num_experts, C, D), dtype=x.dtype, device=x.device)
    buf = buf.index_put((rows, ids_r, pos_c), x_rep * keep[..., None].to(x.dtype),
                        accumulate=True)                             # (Bl,E,C,D)
    out = _expert_ffn_batched(cfg, p, buf)                           # partial/model
    gathered = out[rows, ids_r, pos_c]
    wk = (weights.reshape(B, S * k) * keep).to(x.dtype)
    y = (gathered * wk[..., None]).reshape(B, S, k, D).sum(dim=2)
    y = col.leave(col.psum(y, mesh, "model"), mesh, "model")         # combine-then-AR
    aux = col.pmean(aux, mesh, sh.axes("batch"))
    return y, col.leave(aux, mesh, mesh.axis_names)


def moe_block(cfg, p, x, sharder=None, dispatch: str = "scatter"):
    """Dispatch selection, as JAX's. Without a mesh ``"scatter"``,
    ``"scatter_gspmd"`` and ``"a2a"`` are :func:`moe_block_scatter` and
    ``"scatter_global"`` is :func:`moe_block_scatter_global`. On a mesh,
    ``"scatter"`` and ``"a2a"`` route expert-parallel experts that divide
    the model axis (with a sequence that divides it) to
    :func:`moe_block_a2a`, and tensor-parallel experts to
    :func:`moe_block_tp`; ``"scatter_gspmd"`` forces the grouped scatter
    and ``"scatter_global"`` the global one."""
    if dispatch not in DISPATCHES:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}; one of {DISPATCHES}")
    sh = mesh_sharder(sharder)
    moe_cfg = cfg.moe
    has_model_axis = sh is not None and "model" in sh.mesh.shape
    ep_divisible = has_model_axis and moe_cfg.expert_sharding == "ep" \
        and moe_cfg.num_experts % sh.mesh.shape["model"] == 0 \
        and x.shape[1] % sh.mesh.shape["model"] == 0  # a2a slices tokens
    if dispatch == "scatter_global":
        return moe_block_scatter_global(cfg, p, x, sh)
    if dispatch == "scatter_gspmd":
        return moe_block_scatter(cfg, p, x, sh)
    if dispatch in ("a2a", "scatter") and ep_divisible:
        return moe_block_a2a(cfg, p, x, sh)
    if has_model_axis and moe_cfg.expert_sharding == "tp":
        return moe_block_tp(cfg, p, x, sh)
    return moe_block_scatter(cfg, p, x, sh)
