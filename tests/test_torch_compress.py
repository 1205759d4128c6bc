"""repro_torch.compress against repro.compress: every codec's blob byte for
byte (zstd and zlib coders), decoding in both directions, K-means, model
compression through the facade, and SSIM (SMOKE, the CPU)."""
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.compress import codec_util as jcu
from repro.compress import kmeans as jkm
from repro.compress import registry as jreg
from repro.compress.model_compress import compress_model as jax_compress_model
from repro.compress.model_compress import decompress_model as jax_decompress_model
from repro.configs import dvnr as jdvnr
from repro.core import metrics as jmetrics
from repro_torch import api, interop
from repro_torch.compress import codec_util as tcu
from repro_torch.compress import kmeans as tkm
from repro_torch.compress import registry as treg
from repro_torch.compress.model_compress import compress_model, decompress_model
from repro_torch.configs import dvnr
from repro_torch.core import metrics

METAS = tuple({"origin": (0.5 * p, 0.0, 0.0), "extent": (0.5, 1.0, 1.0),
               "vmin": -0.5 * p, "vmax": 1.0 + p} for p in range(2))


@pytest.fixture(params=["zstd", "zlib"])
def coder(request, monkeypatch):
    """Run a test under each entropy coder: zstandard where it is installed
    (skipped where it is not), and the zlib path of boxes without it."""
    if request.param == "zstd":
        if not (jcu.HAVE_ZSTD and tcu.HAVE_ZSTD):
            pytest.skip("zstandard is not installed here")
    else:
        monkeypatch.setattr(jcu, "HAVE_ZSTD", False)
        monkeypatch.setattr(tcu, "HAVE_ZSTD", False)
    return request.param


def _arrays():
    rng = np.random.default_rng(3)
    smooth = np.cumsum(np.cumsum(rng.standard_normal((9, 12, 7)), 0), 1)
    return {"grid3": smooth.astype(np.float32),
            "grid4": rng.standard_normal((5, 5, 5, 2)).astype(np.float32),
            "vec": rng.standard_normal(301).astype(np.float32),
            "ragged": (rng.standard_normal(64 * 3 + 5) * 1e-3).astype(np.float32)}


CASES = [("interp", "grid3", 1e-2, {}), ("interp", "grid4", 5e-3, {"spatial": 3}),
         ("interp", "vec", 1e-3, {}), ("blockt", "vec", 1e-2, {}),
         ("blockt", "ragged", 1e-5, {}), ("quantizer", "grid3", 0.05, {}),
         ("quant", "ragged", 1e-4, {}), ("zstd", "grid4", None, {}),
         ("zstd", "vec", None, {})]


@pytest.mark.parametrize("name,arr,tol,kw", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_codec_blobs_byte_for_byte_both_ways(coder, name, arr, tol, kw):
    x = _arrays()[arr]
    jc, tc = jreg.get_codec(name), treg.get_codec(name)
    assert tc.name == jc.name and tc.lossy == jc.lossy
    want, got = jc.encode(x, tol, **kw), tc.encode(x, tol, **kw)
    assert got == want
    tag = b"Z" if coder == "zstd" else b"L"
    if name != "zstd":
        assert got[5:6] == tag                  # CRC frame, then the coder tag
    dec = tc.decode(want)
    assert dec.dtype == np.asarray(jc.decode(want)).dtype
    assert (dec == np.asarray(jc.decode(got))).all()
    if tol is not None:
        assert np.abs(dec - x).max() <= tol
    else:
        assert (dec == x).all()


def test_registry_and_framing_match_jax():
    assert treg.available_codecs() == jreg.available_codecs()
    with pytest.raises(ValueError, match="lossy"):
        treg.get_codec("interp").encode(np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="unknown codec"):
        treg.get_codec("nope")
    data = b"some payload bytes" * 7
    assert tcu.crc_frame(data) == jcu.crc_frame(data)
    assert tcu.compress_bytes(data) == jcu.compress_bytes(data)
    framed = tcu.compress_bytes(data)
    bad = framed[:6] + bytes([framed[6] ^ 0x10]) + framed[7:]
    with pytest.raises(tcu.BlobIntegrityError):
        tcu.decompress_bytes(bad)
    assert treg.BlobIntegrityError is tcu.BlobIntegrityError
    # legacy blobs: no frame, no tag
    assert tcu.decompress_bytes(zlib.compress(data)) == data
    assert tcu.dtype_token(np.float32) == jcu.dtype_token(np.float32) == "<f4"
    assert tcu.dtype_token(ml_dtypes.bfloat16) == "bfloat16"
    for q in (np.array([3, -100]), np.array([300]), np.array([1 << 40]),
              np.zeros(0, np.int64)):
        assert tcu.pack_codes(q) == jcu.pack_codes(q)


def test_zstd_blob_without_zstandard_raises_actionable_error(monkeypatch):
    body = b"Z" + b"\x28\xb5\x2f\xfd"
    blob = b"C" + (zlib.crc32(body) & 0xFFFFFFFF).to_bytes(4, "big") + body
    monkeypatch.setattr(tcu, "HAVE_ZSTD", False)
    with pytest.raises(RuntimeError, match="pip install zstandard"):
        tcu.decompress_bytes(blob)
    with pytest.raises(RuntimeError, match="pip install zstandard"):
        tcu.decompress_bytes(b"\x28\xb5\x2f\xfd" + b"\x00" * 8)


def _f16_ulp(c):
    c = np.asarray(c, np.float16)
    return np.abs(np.nextafter(c, np.float16(np.inf)) - c).astype(np.float32)


def test_kmeans_decode_both_ways_and_encode_within_ties(coder):
    rng = np.random.default_rng(5)
    arrays = {"w0": rng.standard_normal((20, 16)).astype(np.float32),
              "w1": rng.uniform(-1, 1, 700).astype(np.float32)}
    jblob, tblob = jkm.kmeans_encode(arrays, bits=4), tkm.kmeans_encode(arrays, bits=4)
    # decoding is byte for byte in both directions
    for blob in (jblob, tblob):
        a, b = jkm.kmeans_decode(blob), tkm.kmeans_decode(blob)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].tobytes() == b[k].tobytes() and a[k].shape == b[k].shape
    # encoding: labels equal except at ties, f16 centers within one ulp
    for name, x in arrays.items():
        jl, jc, _ = jkm.kmeans_quantize_array(x, 4)
        tl, tc, rec = tkm.kmeans_quantize_array(x, 4)
        assert tc.dtype == np.float32 and rec.shape == (x.size,)
        assert np.all(np.abs(tc.astype(np.float16).astype(np.float32)
                             - jc.astype(np.float16).astype(np.float32))
                      <= _f16_ulp(jc))
        np.testing.assert_allclose(tc, jc, rtol=1e-6, atol=1e-7)
        diff = tl != jl
        if diff.any():      # a point equidistant from its two nearest centers
            flat = x.ravel()[diff]
            d = np.abs(flat[:, None] - jc[None, :])
            two = np.sort(d, 1)[:, :2]
            assert np.all(two[:, 1] - two[:, 0] <= 4 * np.finfo(np.float32).eps
                          * np.abs(flat).max())
    with pytest.raises(ValueError, match="not a kmeans blob"):
        tkm.kmeans_decode(treg.get_codec("quant").encode(np.zeros(3), 0.1))


def _jax_model(P=2, amp=0.1):
    jm = japi.DVNRModel.init(jdvnr.SMOKE, jax.random.PRNGKey(4), n_partitions=P,
                             parts_meta=METAS[:P])
    npp = jax.tree.map(np.asarray, jm.params)
    npp["tables"] = np.random.default_rng(4).uniform(
        -amp, amp, npp["tables"].shape).astype(np.float32)
    jm = japi.DVNRModel(jdvnr.SMOKE, jax.tree.map(jnp.asarray, npp), METAS[:P])
    return jm, api.DVNRModel(dvnr.SMOKE, interop.params_from_numpy(npp, "cpu"),
                             METAS[:P])


@pytest.mark.parametrize("codecs", [{}, {"dense_codec": "blockt",
                                         "hash_codec": "quant",
                                         "mlp_codec": "interp"}])
def test_compress_model_byte_for_byte_both_ways(coder, codecs):
    jm, tm = _jax_model()
    jblobs, jinfo = japi.compress(jm, **codecs)
    tblobs, tinfo = api.compress(tm, **codecs)
    assert tblobs == jblobs and tinfo == jinfo
    assert tm.compress(**codecs) == jblobs
    # the port decodes JAX's blobs to JAX's params, and the other way round
    back = api.decompress(dvnr.SMOKE, jblobs, parts_meta=METAS, device="cpu")
    jback = japi.decompress(jdvnr.SMOKE, tblobs, parts_meta=METAS)
    assert back.parts_meta == tm.parts_meta and back.grange == jback.grange
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jback.params)),
                    jax.tree.leaves(interop.params_to_numpy(back.params))):
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    # one partition, one blob; bf16 params compress as their f32 values
    one = api.DVNRModel.from_compressed(dvnr.SMOKE, jblobs[1], device="cpu")
    assert not one.stacked and torch.equal(one.params["tables"],
                                           back.params["tables"][1])
    p1 = jax.tree.map(lambda t: t[1], jm.params)
    blob, info = compress_model(dvnr.SMOKE, tm.partition(1).params, 1e-3, 1e-4)
    assert (blob, info) == jax_compress_model(jdvnr.SMOKE, p1, 1e-3, 1e-4)
    bf = {"tables": tm.params["tables"][0].to(torch.bfloat16),
          "mlp": [w[0].to(torch.bfloat16) for w in tm.params["mlp"]]}
    jbf = jax.tree.map(lambda t: t[0].astype(jnp.bfloat16), jm.params)
    assert compress_model(dvnr.SMOKE, bf)[0] == jax_compress_model(jdvnr.SMOKE, jbf)[0]
    dec = decompress_model(dvnr.SMOKE, blob, device="cpu")
    jdec = jax_decompress_model(jdvnr.SMOKE, blob)
    assert np.asarray(jdec["tables"]).tobytes() == dec["tables"].numpy().tobytes()
    # the hashed levels (every row coded) are within r_enc of the weights
    res = dvnr.SMOKE.level_resolutions()
    hashed = [l for l, r in enumerate(res) if (r + 1) ** 3 > dvnr.SMOKE.table_size]
    err = (dec["tables"][hashed] - tm.params["tables"][1][hashed]).abs().max()
    assert hashed and float(err) <= 1e-3 * (1 + 1e-6)
    with pytest.raises(ValueError, match="not a compressed DVNR model"):
        decompress_model(dvnr.SMOKE, treg.get_codec("quant").encode(
            np.zeros(3), 0.1), device="cpu")


def test_ssim_and_dssim_match_jax():
    rng = np.random.default_rng(6)
    a = rng.uniform(0, 1, (13, 11, 9)).astype(np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for fn in ("ssim3d", "dssim"):
        want = float(getattr(jmetrics, fn)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(metrics, fn)(ta, tb)
        assert got.dtype == torch.float32 and abs(float(got) - want) <= 1e-6
    assert float(metrics.ssim3d(ta, ta)) == pytest.approx(1.0, abs=1e-6)
    img_a = rng.uniform(0, 1, (20, 17, 4)).astype(np.float32)
    img_b = np.clip(img_a + 0.1 * rng.standard_normal(img_a.shape), 0, 1) \
        .astype(np.float32)
    for sl in (np.s_[...], np.s_[..., 2]):
        want = float(jmetrics.ssim2d(jnp.asarray(img_a[sl]), jnp.asarray(img_b[sl])))
        got = float(metrics.ssim2d(torch.from_numpy(np.ascontiguousarray(img_a[sl])),
                                   torch.from_numpy(np.ascontiguousarray(img_b[sl]))))
        assert abs(got - want) <= 1e-6
