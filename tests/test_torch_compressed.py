"""repro_torch's int8 error-feedback compression (``optim.compressed``)
against the JAX package's, bit for bit on the same numpy inputs:
``quantize_int8``, ``dequantize_int8``, ``ef_compress_decompress`` over a
tree (f32 and bf16 grads, residual threaded over steps) and the grad
transform. ``axis=`` (the mesh's int8 all-reduce) raises without a mesh
and is JAX's inside ``shard_map`` on a one-rank mesh (4 ranks against 4
host devices: ``test_torch_mesh_collectives.py``).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import compressed as jc
from repro_torch import interop
from repro_torch.optim import compressed as tc


def _bits(a):
    a = np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def _np(t):
    return interop.lm_params_to_numpy({"x": t})["x"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["normal", "halves", "zeros", "tiny"])
def test_quantize_dequantize_bit_for_bit(case, dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((37, 19)).astype(np.float32)
    if case == "halves":
        # values at exact .5 quanta: round half to even in both
        x = (rng.integers(-254, 255, (37, 19)) / 2.0).astype(np.float32)
        x[0, 0] = 127.0
    elif case == "zeros":
        x = np.zeros((5, 3), np.float32)
    elif case == "tiny":
        x = x * 1e-13
    x = x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x
    jq, js = jc.quantize_int8(jnp.asarray(x))
    tq, ts = tc.quantize_int8(interop.lm_params_from_numpy({"x": x}, "cpu")["x"])
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(np.asarray(js)))
    for out in ("float32", "bfloat16"):
        jd = jc.dequantize_int8(jq, js, jnp.dtype(out))
        td = tc.dequantize_int8(tq, ts, getattr(torch, out))
        np.testing.assert_array_equal(_bits(_np(td)), _bits(jd))


def test_ef_compress_decompress_threads_the_residual_bit_for_bit():
    rng = np.random.default_rng(4)
    tree = {"w": rng.standard_normal((64, 33)).astype(np.float32),
            "b": {"c": rng.standard_normal(17).astype(np.float32) * 1e-3,
                  "h": rng.standard_normal((8, 8)).astype(ml_dtypes.bfloat16)}}
    jr = jc.init_error_feedback(jax.tree.map(jnp.asarray, tree))
    tr = tc.init_error_feedback(interop.lm_params_from_numpy(tree, "cpu"))
    for step in range(4):
        g = jax.tree.map(lambda a: (a * (1 + step)).astype(a.dtype), tree)
        jg, jr = jc.ef_compress_decompress(jax.tree.map(jnp.asarray, g), jr)
        tg, tr = tc.ef_compress_decompress(interop.lm_params_from_numpy(g, "cpu"), tr)
        for got, want in ((tg, jg), (tr, jr)):
            got = interop.lm_params_to_numpy(got)
            want = jax.tree.map(np.asarray, want)
            for (n1, a), (n2, b) in zip(sorted(_flat(got)), sorted(_flat(want))):
                assert n1 == n2 and a.dtype == b.dtype, (n1, a.dtype, b.dtype)
                np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f"{step} {n1}")
    assert float(np.abs(interop.lm_params_to_numpy(tr)["w"]).max()) > 0


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_grad_transform_and_axis():
    rng = np.random.default_rng(5)
    g = {"w": rng.standard_normal((16, 4)).astype(np.float32)}
    jref = {"value": jc.init_error_feedback(jax.tree.map(jnp.asarray, g))}
    tref = {"value": tc.init_error_feedback(interop.lm_params_from_numpy(g, "cpu"))}
    jt, tt = jc.make_ef_int8_transform(jref), tc.make_ef_int8_transform(tref)
    for _ in range(2):
        jout = jt(jax.tree.map(jnp.asarray, g))
        tout = tt(interop.lm_params_from_numpy(g, "cpu"))
        np.testing.assert_array_equal(tout["w"].numpy(), np.asarray(jout["w"]))
        np.testing.assert_array_equal(tref["value"]["w"].numpy(),
                                      np.asarray(jref["value"]["w"]))
    # ``axis=`` sums the codes over a mesh axis: it needs the mesh; on a
    # one-rank mesh it is JAX's inside shard_map on one device (4 ranks
    # against 4 devices: test_torch_mesh_collectives.py)
    with pytest.raises(ValueError, match="needs the mesh"):
        tc.ef_compress_decompress(tref["value"], tref["value"], axis="pod")
    with pytest.raises(ValueError, match="needs the mesh"):
        tc.make_ef_int8_transform(tref, axis="pod")
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.launch.mesh import build_mesh
    from repro_torch.launch.mesh import Mesh
    jmesh = build_mesh(np.array(jax.devices()[:1]), ("pod",))
    mesh = Mesh({"pod": 1}, ("pod",), {"pod": 0}, 0, torch.device("cpu"))
    r = {"w": (0.01 * rng.standard_normal((16, 4))).astype(np.float32)}
    jg, jr = shard_map(lambda a, b: jc.ef_compress_decompress(a, b, axis="pod"),
                       mesh=jmesh, in_specs=(P("pod"), P("pod")),
                       out_specs=(P("pod"), P("pod")), check_rep=False)(
        jax.tree.map(jnp.asarray, g), jax.tree.map(jnp.asarray, r))
    tg, tr = tc.ef_compress_decompress(interop.lm_params_from_numpy(g, "cpu"),
                                       interop.lm_params_from_numpy(r, "cpu"),
                                       axis="pod", mesh=mesh)
    np.testing.assert_array_equal(tg["w"].numpy(), np.asarray(jg["w"]))
    np.testing.assert_array_equal(tr["w"].numpy(), np.asarray(jr["w"]))
    tt = tc.make_ef_int8_transform({"value": interop.lm_params_from_numpy(r, "cpu")},
                                   axis="pod", mesh=mesh)
    np.testing.assert_array_equal(tt(interop.lm_params_from_numpy(g, "cpu"))["w"].numpy(),
                                  np.asarray(jg["w"]))
