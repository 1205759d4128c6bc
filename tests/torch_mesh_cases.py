"""The LM-on-a-mesh cases of the port's CPU parity tests
(``test_torch_mesh_{collectives,models,training,families}.py``): their inputs, the
JAX package's results on 4 host devices, and the port's side on 4 ``gloo``
ranks. It holds no test of its own.

The JAX side runs in a subprocess (``python tests/torch_mesh_cases.py
<group> <out.pkl> [<inputs.pkl>]`` with ``XLA_FLAGS=--xla_force_host_
platform_device_count=4``), one per test module; the port's side runs in
the ranks ``test_torch_dist_workers.launch`` spawns, one launch per test
module. JAX is imported only inside the subprocess's functions, so the
ranks stay light. Inputs are made from a seed with numpy.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
JAX_TIMEOUT_S = 600

#: the LM cases: (arch, mesh shape (data, model), batch, sequence, config
#: changes, MoE dispatch); every config in float32 compute
LM_CASES = {
    "llama_2x2": ("llama3_8b", (2, 2), 4, 16, {}, "scatter"),
    "llama_1x4": ("llama3_8b", (1, 4), 4, 16, {}, "scatter"),
    # 6 q heads do not divide the 4-wide model axis: sequence mode
    "qwen_seq_1x4": ("qwen2_0_5b", (1, 4), 4, 16,
                     {"n_heads": 6, "n_kv_heads": 3, "head_dim": 16}, "scatter"),
    "grok_2x2": ("grok_1_314b", (2, 2), 4, 16, {}, "scatter"),          # tp
    "arctic_2x2": ("arctic_480b", (2, 2), 4, 16, {}, "scatter"),        # a2a
    "arctic_gspmd_2x2": ("arctic_480b", (2, 2), 4, 16, {}, "scatter_gspmd"),
    "grok_global_2x2": ("grok_1_314b", (2, 2), 4, 16, {}, "scatter_global"),
    # 3 rows do not split over "data": no batch axes, every data rank takes
    # the whole batch and the weight gather's backward keeps its block
    "llama_b3_2x2": ("llama3_8b", (2, 2), 3, 16, {}, "scatter"),
}
#: prefill + decode: (arch, mesh, batch, prompt, decode steps, changes)
DECODE_CASES = {
    "llama_decode_1x4": ("llama3_8b", (1, 4), 2, 16, 4, {}),
    "qwen_decode_1x4": ("qwen2_0_5b", (1, 4), 2, 16, 4,
                        {"n_heads": 6, "n_kv_heads": 3, "head_dim": 16}),
    # the prefill's a2a, then the decode steps' scatter (one token a step);
    # at a capacity that binds nowhere, so that the reference's prefills of
    # 17-19 tokens (the scatter: 4 does not divide them) drop what the
    # prefill of 16 (a2a) and the decode steps drop: nothing
    "arctic_decode_1x4": ("arctic_480b", (1, 4), 2, 16, 4, {"capacity_factor": 8.0}),
    # the weights cut over "data" too, each layer's gathered at its use
    "llama_decode_2x2": ("llama3_8b", (2, 2), 2, 16, 4, {}),
}
#: decode cases held to another case's JAX logits (the same model, inputs
#: and prompt: the teacher-forced logits do not depend on the mesh)
DECODE_SAME = {"llama_decode_2x2": "llama_decode_1x4"}


def config(arch, changes, jax_side=False):
    """The SMOKE config in float32 compute with ``changes`` (a
    ``capacity_factor`` entry goes to the MoE config, an ``ssm_head_dim``
    one to the SSM config)."""
    if jax_side:
        from repro.configs import get_smoke_config
    else:
        from repro_torch.configs import get_smoke_config
    changes = dict(changes)
    cap = changes.pop("capacity_factor", None)
    head_dim = changes.pop("ssm_head_dim", None)
    cfg = get_smoke_config(arch).replace(compute_dtype="float32", **changes)
    if cap is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=cap))
    if head_dim is not None:
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, head_dim=head_dim))
    return cfg


def moe_config(arch, capacity=None, jax_side=False):
    cfg = config(arch, {}, jax_side)
    if capacity is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=capacity))


def lm_batch(vocab, B, S, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# --------------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------------- #
def model_inputs() -> dict:
    """The LM cases' params (JAX's init, numpy) and batches."""
    import jax
    from repro.models import build_model
    out = {}
    for name, (arch, shape, B, S, ch, *_) in {**LM_CASES, **{
            k: (a, sh, B, S + n, ch) for k, (a, sh, B, S, n, ch) in DECODE_CASES.items()
            if k not in DECODE_SAME}
    }.items():
        cfg = config(arch, ch, True)
        params = jax.tree.map(np.asarray, build_model(cfg).init(jax.random.PRNGKey(0)))
        out[name] = {"params": params, "batch": lm_batch(cfg.vocab, B, S, seed=1)}
    for name, same in DECODE_SAME.items():
        out[name] = out[same]
    return out


# --------------------------------------------------------------------------- #
# the JAX side
# --------------------------------------------------------------------------- #
def _jmesh(shape):
    import jax
    from repro.launch.mesh import build_mesh
    return build_mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))


def jax_models(inp: dict) -> dict:
    """JAX's loss and gradients of every LM case, jitted with
    ``Sharder(mesh, B)`` and ``param_shardings``; JAX's teacher-forced
    prefill logits of every decode case on its mesh."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model
    from repro.parallel.sharding import Sharder, param_shardings
    out = {}
    for name, (arch, shape, B, S, ch, dispatch) in LM_CASES.items():
        cfg = config(arch, ch, True)
        model = build_model(cfg, moe_dispatch=dispatch)
        mesh = _jmesh(shape)
        sharder = Sharder(mesh, B)
        params = jax.tree.map(jnp.asarray, inp[name]["params"])
        batch = jax.tree.map(jnp.asarray, inp[name]["batch"])
        ps = param_shardings(jax.eval_shape(lambda: params), cfg, sharder)
        f = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b, sharder)[0]),
                    in_shardings=(ps, None))
        with mesh:
            loss, grads = f(params, batch)
        out[name] = {"loss": float(loss),
                     "grads": jax.tree.map(np.asarray, grads)}
    for name, (arch, shape, B, S, n, ch) in DECODE_CASES.items():
        if name in DECODE_SAME:
            continue
        cfg = config(arch, ch, True)
        model = build_model(cfg)
        mesh = _jmesh(shape)
        sharder = Sharder(mesh, B)
        params = jax.tree.map(jnp.asarray, inp[name]["params"])
        toks = inp[name]["batch"]["tokens"]
        logits = []
        for i in range(n + 1):
            f = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}, S + i, sharder)[0])
            with mesh:
                logits.append(np.asarray(f(params, jnp.asarray(toks[:, :S + i]))))
        out[name] = {"logits": logits}
    return out


# --------------------------------------------------------------------------- #
# collectives, MoE blocks, sequence-parallel attention, the int8 all-reduce
# --------------------------------------------------------------------------- #
#: the collectives' cases on the (2, 2) mesh, axis "model": x (4, 8) and its
#: in / out specs over ("data", "model") ("m": mapped over "model", "r":
#: whole over it); all_gather's backward is the psum_scatter
PRIMITIVES = {
    "psum": ("m", "r"), "pmean": ("m", "r"), "all_gather": ("m", "m"),
    "all_to_all": ("m", "m"), "enter": ("r", "m"),
    "leave": ("m", "r"), "block": ("m", "m"),
    # the GSPMD pair: JAX's psum / all_gather into an unmapped output
    "reduce": ("m", "r"), "gather": ("m", "r"),
}
MOE_CASES = {   # name: (arch, capacity factor or None: the config's, seed, S)
    "tp_cap8": ("grok_1_314b", 8.0, 0, 16),
    "a2a_cap16": ("arctic_480b", 16.0, 2, 16),
    # the config's capacity (1.25), bound: the tokens share a direction, so
    # the router sends many to the same experts
    "a2a_config": ("arctic_480b", None, 2, 16),
}
#: qwen2's attention block with 3 q / 3 K/V heads of 16 on the 2-wide model
#: axis (sequence mode): arch, config changes, batch, sequence
ATTN_CASE = ("qwen2_0_5b", {"n_heads": 3, "n_kv_heads": 3, "head_dim": 16}, 2, 32)


def collective_inputs() -> dict:
    import jax
    import jax.numpy as jnp
    from repro.models.attention import init_attention
    from repro.models.moe import init_moe
    rng = np.random.default_rng(7)
    out = {"x": rng.standard_normal((4, 8)).astype(np.float32),
           "w": {k: rng.standard_normal((8, 16)).astype(np.float32) for k in PRIMITIVES}}
    for name, (arch, cap, seed, S) in MOE_CASES.items():
        cfg = moe_config(arch, cap, True)
        p = jax.tree.map(np.asarray, init_moe(jax.random.PRNGKey(seed), cfg, jnp.float32))
        x = rng.standard_normal((4, S, cfg.d_model))
        if cap is None:
            x = x + 2.0 * rng.standard_normal(cfg.d_model)
        out[name] = {"params": p, "x": x.astype(np.float32)}
    arch, changes, B, S = ATTN_CASE
    cfg = config(arch, changes, True)
    p = jax.tree.map(np.asarray, init_attention(jax.random.PRNGKey(3), cfg, jnp.float32))
    p = {k: (v + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
         if k.startswith("b") else v for k, v in p.items()}       # biases not zero
    out["attn"] = {"params": p,
                   "x": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                   "positions": np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()}
    out["ef"] = {"g": rng.standard_normal((4, 8)).astype(np.float32),
                 "r": 0.01 * rng.standard_normal((4, 8)).astype(np.float32)}
    return out


def primitive_local(name, xl, axis_index, lax, axis="model"):
    """The body of each collective's case (JAX's ``lax`` or the port's
    stand-in), on this device's block ``xl`` (2, 4) or rows (2, 8)."""
    if name in ("psum", "reduce"):
        return lax.psum(xl, axis)
    if name == "pmean":
        return lax.pmean(xl, axis)
    if name == "all_gather":
        return lax.all_gather(xl, axis, axis=1, tiled=True) * (1.0 + axis_index)
    if name == "gather":
        return lax.all_gather(xl, axis, axis=1, tiled=True)
    if name == "all_to_all":
        return lax.all_to_all(xl, axis, 1, 0, tiled=True) * (1.0 + axis_index)
    if name in ("enter", "block"):
        return xl * (1.0 + axis_index)
    return xl * 2.0                                          # leave


def jax_collectives(inp: dict) -> dict:
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.models.attention import attention_block
    from repro.models.moe import (_capacity, _positions_in_expert, moe_block_a2a,
                                  moe_block_tp, route)
    from repro.optim.compressed import ef_compress_decompress, quantize_int8
    from repro.parallel.sharding import Sharder
    mesh = _jmesh((2, 2))
    spec = {"m": P("data", "model"), "r": P("data", None)}
    out = {"prims": {}}
    x = jnp.asarray(inp["x"])
    for name, (i, o) in PRIMITIVES.items():
        def f(xx, name=name, o=o):
            y = shard_map(lambda xl: primitive_local(
                name, xl, jax.lax.axis_index("model"), jax.lax),
                mesh=mesh, in_specs=spec[i], out_specs=spec[o], check_rep=False)(xx)
            w = jnp.asarray(inp["w"][name])[:y.shape[0], :y.shape[1]]
            return jnp.sum(w * y), y
        (_, y), g = jax.value_and_grad(f, has_aux=True)(x)
        out["prims"][name] = {"y": np.asarray(y), "grad": np.asarray(g)}
    sharder = Sharder(mesh, 4)
    for name, (arch, cap, _, S) in MOE_CASES.items():
        cfg = moe_config(arch, cap, True)
        fn = moe_block_tp if name.startswith("tp") else moe_block_a2a
        p = jax.tree.map(jnp.asarray, inp[name]["params"])
        xx = jnp.asarray(inp[name]["x"])

        def loss(pp, xv, fn=fn, cfg=cfg):
            with mesh:
                return fn(cfg, pp, xv, sharder)[0].sum()
        with mesh:
            y, aux = jax.jit(lambda pp, xv, fn=fn, cfg=cfg: fn(cfg, pp, xv, sharder))(p, xx)
        gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, xx)
        res = {"y": np.asarray(y), "aux": float(aux), "grads": jax.tree.map(np.asarray, gp),
               "gx": np.asarray(gx)}
        if fn is moe_block_a2a:     # each device's drop set: its tokens' keep mask
            keeps = {}
            for d in range(2):
                for r in range(2):
                    h = S // 2
                    xl = xx[2 * d:2 * d + 2, h * r:h * r + h].reshape(-1, cfg.d_model)
                    _, ids, _ = route(cfg, p, xl)
                    C = _capacity(cfg, xl.shape[0])
                    C = max(8, -(-C // 2) * 2)
                    keeps[(d, r)] = np.asarray(
                        _positions_in_expert(ids.reshape(-1), cfg.moe.num_experts) < C)
            res["keep"] = keeps
        out[name] = res
    cfg = config(*ATTN_CASE[:2], True)
    p = jax.tree.map(jnp.asarray, inp["attn"]["params"])
    xa, pos = jnp.asarray(inp["attn"]["x"]), jnp.asarray(inp["attn"]["positions"])
    sh2 = Sharder(mesh, ATTN_CASE[2])

    def attn(pp, xx):
        with mesh:
            return attention_block(cfg, pp, xx, pos, sharder=sh2)
    o = jax.jit(attn)(p, xa)
    gp, gx = jax.jit(jax.grad(lambda pp, xx: jnp.sum(attn(pp, xx) * jnp.cos(attn(pp, xx))),
                              argnums=(0, 1)))(p, xa)
    out["attn"] = {"o": np.asarray(o), "ref": np.asarray(attention_block(cfg, p, xa, pos)),
                   "grads": jax.tree.map(np.asarray, gp), "gx": np.asarray(gx)}
    g, r = jnp.asarray(inp["ef"]["g"]), jnp.asarray(inp["ef"]["r"])
    ng, nr = shard_map(lambda a, b: ef_compress_decompress(a, b, axis="model"),
                       mesh=mesh, in_specs=(P("data", "model"),) * 2,
                       out_specs=(P("data", "model"),) * 2, check_rep=False)(g, r)
    codes = shard_map(lambda a, b: quantize_int8(a + b)[0], mesh=mesh,
                      in_specs=(P("data", "model"),) * 2,
                      out_specs=P("data", "model"), check_rep=False)(g, r)
    out["ef"] = {"g": np.asarray(ng), "r": np.asarray(nr), "q": np.asarray(codes)}
    return out


# --------------------------------------------------------------------------- #
# the SSM, hybrid, encoder-decoder and VLM families
# --------------------------------------------------------------------------- #
#: loss cases: (arch, mesh, batch, sequence, config changes)
FAMILY_CASES = {
    # in_proj's 296 columns in blocks of 148 / 74: not the ranks' heads
    "mamba_2x2": ("mamba2_780m", (2, 2), 4, 64, {}),
    "mamba_1x4": ("mamba2_780m", (1, 4), 4, 64, {}),
    # 2 groups of 2 and 1 tail layer: the shared block applied twice
    "zamba_2x2": ("zamba2_1_2b", (2, 2), 4, 32, {}),
    "seamless_2x2": ("seamless_m4t_large_v2", (2, 2), 4, 16, {}),
    "qwen_vl_2x2": ("qwen2_vl_7b", (2, 2), 4, 16, {}),
    # 3 rows do not split over "data": no batch axes
    "mamba_b3_2x2": ("mamba2_780m", (2, 2), 3, 64, {}),
    # 2 heads of 64 do not divide the 4-wide model axis: every rank the
    # whole block, the leaves "model" cuts (conv_w, out_proj) gathered
    "mamba_whole_1x4": ("mamba2_780m", (1, 4), 4, 32, {"ssm_head_dim": 64}),
}
#: prefill + decode on (1, 4): (arch, batch, prompt, decode steps); the
#: prompt and its steps within one SSD chunk (JAX asserts whole chunks)
FAMILY_DECODE = {
    "mamba_decode_1x4": ("mamba2_780m", 2, 16, 4),
    "zamba_decode_1x4": ("zamba2_1_2b", 2, 8, 4),
    "seamless_decode_1x4": ("seamless_m4t_large_v2", 2, 16, 4),
    "qwen_vl_decode_1x4": ("qwen2_vl_7b", 2, 16, 4),
}
#: the encoder-decoder's decode cache slots (>= its steps + 1; divides 4)
ENCDEC_SLOTS = 8


def family_batch(cfg, B, S, seed=1) -> dict:
    """A train batch of the family's inputs: tokens, or the encoder's
    embeddings and target tokens, or the VLM's embeddings and M-RoPE
    positions (drawn at random, not from ``arange``: a wrong batch cut
    of the (3, B, S) positions shows)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    emb = lambda: (0.5 * rng.standard_normal((B, S, cfg.d_model))).astype(np.float32)
    if cfg.family == "encdec":
        return {"src_embeds": emb(), "tgt_tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        return {"embeds": emb(), "labels": toks[:, 1:],
                "positions": rng.integers(0, S, (3, B, S)).astype(np.int32)}
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def family_inputs() -> dict:
    """The family cases' params (JAX's init, numpy) and batches; a decode
    case's batch holds the prompt and the tokens its steps feed."""
    import jax
    from repro.models import build_model
    inits: dict = {}

    def params(arch, ch):             # one init a config, shared by its cases
        key = (arch, tuple(sorted(ch.items())))
        if key not in inits:
            inits[key] = jax.tree.map(np.asarray, jax.jit(build_model(
                config(arch, ch, True)).init)(jax.random.PRNGKey(0)))
        return inits[key]

    out = {}
    for name, (arch, shape, B, S, ch) in FAMILY_CASES.items():
        out[name] = {"params": params(arch, ch),
                     "batch": family_batch(config(arch, ch, True), B, S)}
    for name, (arch, B, S, n) in FAMILY_DECODE.items():
        cfg = config(arch, {}, True)
        batch = family_batch(cfg, B, S, seed=2)
        batch["steps"] = np.random.default_rng(3).integers(
            0, cfg.vocab, (B, n)).astype(np.int32)
        out[name] = {"params": params(arch, {}), "batch": batch}
    return out


def teacher_forced(cfg, params, batch, sharder):
    """JAX's logits at every position of the prompt followed by the decode
    steps' tokens (for the encoder-decoder: of the target tokens, BOS and
    the steps' tokens, against the encoded source): (B, S + n, Vp)."""
    import jax.numpy as jnp
    from repro.models import encdec, hybrid, ssm_lm, transformer
    cdt = jnp.float32
    steps = batch["steps"]
    if cfg.family == "encdec":
        enc = encdec.encode(cfg, params, batch["src_embeds"].astype(cdt), sharder)
        tgt = jnp.concatenate([batch["tgt_tokens"][:, :1], steps], axis=1)
        return transformer.logits_fn(cfg, params, encdec.decode_train(
            cfg, params, tgt, enc, sharder))
    emb = params["embed"]["tok"].astype(cdt)
    if cfg.family == "vlm":
        B, S, _ = batch["embeds"].shape
        x = jnp.concatenate([batch["embeds"], emb[steps]], axis=1)
        later = jnp.broadcast_to(S + jnp.arange(steps.shape[1], dtype=jnp.int32),
                                 (3, B, steps.shape[1]))
        pos = jnp.concatenate([batch["positions"], later], axis=2)
        h, _ = transformer.forward_hidden(cfg, params, x, pos, sharder)
        return transformer.logits_fn(cfg, params, h)
    toks = jnp.concatenate([batch["tokens"], steps], axis=1)
    x = emb[toks]
    if cfg.family == "ssm":
        h = ssm_lm.forward_hidden(cfg, params, x, sharder)
    else:
        B, S = toks.shape
        h = hybrid.forward_hidden(cfg, params, x, transformer.make_positions(cfg, B, S),
                                  sharder)
    return transformer.logits_fn(cfg, params, h)


def jax_families(inp: dict) -> dict:
    """JAX's loss and gradients of every family case, jitted with
    ``Sharder(mesh, B)`` and ``param_shardings``; every decode case's
    teacher-forced logits on (1, 4)."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model
    from repro.parallel.sharding import Sharder, param_shardings
    out = {}
    for name, (arch, shape, B, S, ch) in FAMILY_CASES.items():
        cfg = config(arch, ch, True)
        model = build_model(cfg)
        mesh = _jmesh(shape)
        sharder = Sharder(mesh, B)
        params = jax.tree.map(jnp.asarray, inp[name]["params"])
        batch = jax.tree.map(jnp.asarray, inp[name]["batch"])
        ps = param_shardings(jax.eval_shape(lambda: params), cfg, sharder)
        f = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b, sharder)[0]),
                    in_shardings=(ps, None))
        with mesh:
            loss, grads = f(params, batch)
        out[name] = {"loss": float(loss), "grads": jax.tree.map(np.asarray, grads)}
    mesh = _jmesh((1, 4))
    for name, (arch, B, S, n) in FAMILY_DECODE.items():
        cfg = config(arch, {}, True)
        sharder = Sharder(mesh, B)
        params = jax.tree.map(jnp.asarray, inp[name]["params"])
        batch = jax.tree.map(jnp.asarray, inp[name]["batch"])
        with mesh:
            logits = jax.jit(lambda p, b: teacher_forced(cfg, p, b, sharder))(params, batch)
        out[name] = {"logits": np.asarray(logits)}
    return out


GROUPS = {"models": (model_inputs, jax_models),
          "collectives": (collective_inputs, jax_collectives),
          "families": (family_inputs, jax_families)}


def _jax_env() -> dict:
    return dict(os.environ, JAX_PLATFORMS="cpu",
                XLA_FLAGS="--xla_force_host_platform_device_count=4",
                PYTHONPATH=str(ROOT / "src") + os.pathsep + str(ROOT / "tests"))


def run_jax(group: str, workdir: Path) -> tuple:
    """(inputs, JAX's results) of a group of cases, the JAX side in a
    subprocess on 4 host devices."""
    workdir.mkdir(parents=True, exist_ok=True)
    res = workdir / f"jax_{group}.pkl"
    subprocess.run([sys.executable, str(Path(__file__)), group, str(res)],
                   env=_jax_env(), check=True, timeout=JAX_TIMEOUT_S)
    with open(res, "rb") as f:
        inp, out = pickle.load(f)
    return inp, out


class JaxJob:
    """A group's JAX side started in a subprocess, so that the port's side
    runs meanwhile: :meth:`inputs` waits for the group's inputs (written
    first, to ``<workdir>/inputs_<group>.pkl``, whose path it returns with
    them), :meth:`results` for JAX's results."""

    def __init__(self, group: str, workdir: Path):
        workdir.mkdir(parents=True, exist_ok=True)
        self.res = workdir / f"jax_{group}.pkl"
        self.inp = workdir / f"inputs_{group}.pkl"
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen([sys.executable, str(Path(__file__)), group,
                                      str(self.res), str(self.inp)], env=_jax_env())

    def _wait_for(self, path: Path) -> None:
        while not path.exists():
            if self.proc.poll() is not None and not path.exists():
                raise RuntimeError(f"the JAX side exited {self.proc.returncode}")
            if time.monotonic() - self.t0 > JAX_TIMEOUT_S:
                self.proc.kill()
                raise TimeoutError(f"the JAX side took over {JAX_TIMEOUT_S} s")
            time.sleep(0.2)

    def inputs(self) -> tuple:
        self._wait_for(self.inp)
        with open(self.inp, "rb") as f:
            return pickle.load(f), self.inp

    def results(self) -> dict:
        try:
            self.proc.wait(timeout=max(1.0, JAX_TIMEOUT_S - (time.monotonic() - self.t0)))
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
        if self.proc.returncode:
            raise RuntimeError(f"the JAX side exited {self.proc.returncode}")
        with open(self.res, "rb") as f:
            return pickle.load(f)[1]


if __name__ == "__main__":
    make, run = GROUPS[sys.argv[1]]
    inputs = make()
    if len(sys.argv) > 3:            # the inputs first, for a port side meanwhile
        tmp = sys.argv[3] + ".tmp"
        with open(tmp, "wb") as fh:
            pickle.dump(inputs, fh)
        os.replace(tmp, sys.argv[3])
    with open(sys.argv[2], "wb") as fh:
        pickle.dump((inputs, run(inputs)), fh)
