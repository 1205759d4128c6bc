#!/usr/bin/env python3
"""On-card check of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit; imports nothing of JAX or of the JAX package. Phases:

1. build   compile ``src/repro_torch/csrc/*.cu`` with nvcc into ``build/``;
2. kernels each kernel against its plain PyTorch version on the card, at
           PRODUCTION256 shapes (L=5, F=4, T=2^13, res 4..64: dense and
           hashed levels), tables U(-1,1), coordinates inside and outside
           [0,1], H=1/2/3 MLPs, out_dim 1 and 3, ragged N/R/S, f32 and bf16;
3. decode  ``DVNRModel.decode_grid`` of one 256^3 partition through the
           kernels, against the plain path on the card;
4. serve   a ``RenderService`` over 8 PRODUCTION256 partitions (the 2x2x2
           split of a 512^3 volume): 4 ticks of 2 orbiting clients at
           256x256, 64 samples, every frame finite, one tick against the
           plain path; the launch counters are zeroed just before the ticks
           and each kernel must have launched during them;
5. report  per-tick and per-kernel times (CUDA events) with each kernel's
           bound, its plain version's time and a PyTorch yardstick, tagged
           with the card's name and power limit.

Exits non-zero on any failure. The last line is
``{"ok": true, "device": {...}}``; the line before it is the per-kernel JSON.
Float32 products of the plain versions run in full float32
(``allow_tf32`` off for matmul and cuDNN).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks: HBM bytes/s, and float32 FLOP/s outside the
# tensor cores (the timed kernels run float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
REPLACES = {
    "hash_encode": "src/repro/kernels/hash_encoding/kernel.py:62",
    "fused_mlp_fwd": "src/repro/kernels/fused_mlp/kernel.py:66",
    "composite": "src/repro/kernels/composite/kernel.py:51",
}
# sizes of the run (the rehearsal on a CPU shrinks them)
DECODE_EDGE = 256          # phase 3: one 256^3 partition
LOCAL_EDGE = 256           # phase 4: 2x2x2 partitions of 256^3 each
IMAGE, SAMPLES, CLIENTS, TICKS = 256, 64, 2, 4
CHECK_N = (100_003, 4_099)   # phase 2 coordinate rows (ragged)
DECODE_CHUNK = 1 << 22
DEVICE = "cuda"

SOURCES = {
    "hash_encode": "src/repro_torch/csrc/hash_encode.cu",
    "fused_mlp_fwd": "src/repro_torch/csrc/fused_mlp.cu",
    "composite": "src/repro_torch/csrc/composite.cu",
}


class SmokeFailure(Exception):
    pass


def card_tag() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0].strip()


def check(name, got, want, *, atol, rtol=0.0):
    """Elementwise |got - want| <= atol + rtol * |want|, compared in f32."""
    import torch
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise SmokeFailure(f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise SmokeFailure(f"{name}: non-finite output")
    err = (g - w).abs()
    allowed = atol + rtol * w.abs()
    worst = float((err - allowed).max())
    max_err = float(err.max())
    print(f"  {name:<44s} max_abs_err={max_err:.3e}  tol: atol={atol:.1e} "
          f"rtol={rtol:.1e}  {'ok' if worst <= 0 else 'FAIL'}")
    if worst > 0:
        raise SmokeFailure(f"{name}: max abs err {max_err:.3e} over tolerance")
    return max_err


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def profile_tick(tick):
    """Run ``tick()`` under torch.profiler: (device busy ms, [(kernel name,
    (ms, count))] by time, host wall ms); busy is None when the profiler saw
    no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.self_device_time_total > 0:
            kernels[e.key] = (e.self_device_time_total / 1e3, e.count)
    busy = sum(ms for ms, _ in kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return (busy or None), ranked, wall


def bound_ms(nbytes: float, flops: float):
    """The least time the card could take: each input read once, each output
    written once at the HBM rate, or the operations at the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this check "
                           "needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch
    except ImportError as e:
        raise SmokeFailure(f"cannot import repro_torch from {ROOT / 'src'}: "
                           f"run chip_smoke.py from a checkout ({e})")
    if Path(repro_torch.__file__).resolve().parents[1] != ROOT / "src":
        raise SmokeFailure(f"repro_torch was imported from "
                           f"{repro_torch.__file__}, not from this checkout")
    import numpy as np

    from repro_torch import api
    from repro_torch.configs.dvnr import PRODUCTION256
    from repro_torch.core import render as R
    from repro_torch.data.volume import make_partition
    from repro_torch.kernels import build
    from repro_torch.kernels.composite.ops import composite_cuda
    from repro_torch.kernels.composite.ref import composite_ref
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_cuda
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_batched_ref
    from repro_torch.kernels.hash_encoding.ops import hash_encode_cuda
    from repro_torch.kernels.hash_encoding.ref import hash_encode_batched_ref
    from repro_torch.serving import RenderService

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    tag = card_tag()
    print(f"card: {tag}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    wrappers = {"hash_encode": hash_encode_cuda, "fused_mlp_fwd": fused_mlp_cuda,
                "composite": composite_cuda}
    cfg = PRODUCTION256
    res = cfg.level_resolutions()
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    # ---------------------------------------------------------------- 1
    print("== phase 1: build")
    t0 = time.perf_counter()
    build.library()
    print(f"  built {sorted(p.name for p in build.CSRC.glob('*.cu'))} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds:.1f} s)")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("   ", line.strip())

    # ---------------------------------------------------------------- 2
    print("== phase 2: kernels against their plain versions "
          f"(PRODUCTION256: L={L} F={F} T={T} res={res})")
    P, B = 8, 16
    part = [int(p) for p in rng.integers(0, P, B)]
    part_d = torch.tensor(part, device=dev)
    tables32 = t(rng.uniform(-1, 1, (P, L, T, F)))
    for N, lo, hi, label in ((CHECK_N[0], 0.0, 1.0, "in [0,1]"),
                             (CHECK_N[1], -0.25, 1.25, "in [-0.25,1.25]")):
        coords = t(rng.uniform(lo, hi, (B, N, 3)))
        for dt in (torch.float32, torch.bfloat16):
            tab = tables32.to(dt)
            want = hash_encode_batched_ref(coords, tab, res, part_d)
            got = hash_encode_cuda(coords, tab, res, part)
            scale = max(1.0, float(want.float().abs().max()))
            if dt == torch.float32:   # FMA vs mul+add over 8 corners
                check(f"hash_encode f32 N={N} coords {label}", got, want,
                      atol=2e-6 * scale)
            else:   # same f32 sums; the final bf16 rounding may flip 1 ulp
                check(f"hash_encode bf16 N={N} coords {label}", got, want,
                      atol=1e-6 * scale, rtol=2.0 ** -7)
    D_in = L * F
    W = cfg.n_neurons
    for H, D_out, N in ((cfg.n_hidden_layers, cfg.out_dim, CHECK_N[0]),
                        (1, 1, 1_000), (3, 3, CHECK_N[1])):
        dims = [D_in] + [W] * H + [D_out]
        ws = [t(rng.uniform(-1, 1, (P, a, b)) * np.sqrt(6.0 / a))
              for a, b in zip(dims[:-1], dims[1:])]
        x = t(rng.uniform(-1, 1, (B, N, D_in)))
        for dt in (torch.float32, torch.bfloat16):
            xs, wss = x.to(dt), [w.to(dt) for w in ws]
            want = fused_mlp_batched_ref(xs, wss, part_d)
            got = fused_mlp_cuda(xs, wss, part)
            scale = max(1.0, float(want.float().abs().max()))
            if dt == torch.float32:   # summation order of W<=20-term sums
                check(f"fused_mlp f32 H={H} D_out={D_out} N={N}", got, want,
                      atol=2e-6 * scale)
            else:   # an ulp tie in a hidden layer can move the output 2 ulp
                check(f"fused_mlp bf16 H={H} D_out={D_out} N={N}", got, want,
                      atol=2.0 ** -7 * scale, rtol=2.0 ** -7)
    for Rn, S in ((CHECK_N[0], 67), (1_000, 5)):
        rgba = rng.uniform(0, 1, (Rn, S, 4))
        rgba[..., 3] *= 0.1
        rgba = t(rgba)
        for dt in (torch.float32, torch.bfloat16):
            r = rgba.to(dt)
            want = composite_ref(r)
            got = composite_cuda(r)
            if dt == torch.float32:   # FMA vs mul+add over S steps
                check(f"composite f32 R={Rn} S={S}", got, want, atol=2e-6)
            else:   # f32 carries differ by FMA; the bf16 rounding may flip 1 ulp
                check(f"composite bf16 R={Rn} S={S}", got, want, atol=1e-6,
                      rtol=2.0 ** -7)
    torch.cuda.synchronize()

    # ---------------------------------------------------------------- 3
    print(f"== phase 3: decode_grid of one {DECODE_EDGE}^3 partition")
    model1 = api.DVNRModel.init(cfg, 1, device=dev)
    model1.params["tables"] = t(rng.uniform(-1, 1, (L, T, F)))
    shape = (DECODE_EDGE,) * 3
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grid_k = model1.decode_grid(shape, backend="cuda", chunk=DECODE_CHUNK)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    decode_launches = {n: w.launches for n, w in wrappers.items()}
    t0 = time.perf_counter()
    grid_p = model1.decode_grid(shape, backend="ref", chunk=DECODE_CHUNK)
    torch.cuda.synchronize()
    decode_plain_ms = (time.perf_counter() - t0) * 1e3
    scale = max(1.0, float(grid_p.abs().max()))
    check(f"decode_grid {DECODE_EDGE}^3 cuda vs ref", grid_k, grid_p,
          atol=2e-6 * scale)
    print(f"  decode {DECODE_EDGE}^3: {decode_ms:.2f} ms through the kernels, "
          f"{decode_plain_ms:.2f} ms plain (first call, host clock) "
          f"launches {decode_launches} [{tag}]")
    for n in ("hash_encode", "fused_mlp_fwd"):
        if decode_launches[n] <= 0:
            raise SmokeFailure(f"decode_grid launched no {n} kernel")
    del grid_k, grid_p

    # ---------------------------------------------------------------- 4
    print("== phase 4: RenderService over 8 PRODUCTION256 partitions "
          "(2x2x2 split of 512^3)")
    P = 8
    parts = [make_partition("cloverleaf", p, (2, 2, 2), (LOCAL_EDGE,) * 3,
                            t=0.3, device=dev) for p in range(P)]
    metas = [api.PartitionMeta.of(p) for p in parts]
    del parts
    model = api.DVNRModel.init(cfg, 2, n_partitions=P, parts_meta=metas,
                               device=dev)
    model.params["tables"] = t(rng.uniform(-1, 1, (P, L, T, F)))
    C, Wd, Hd, S = CLIENTS, IMAGE, IMAGE, SAMPLES
    cam = api.Camera()

    def requests(tick):
        return [api.RenderRequest(camera=cam.orbit(2 * np.pi * (tick + c / C) / 8),
                                  width=Wd, height=Hd, n_samples=S)
                for c in range(C)]

    svc = RenderService(model, backend="cuda")
    for w in wrappers.values():
        w.launches = 0
    tick_ms, first_frames = [], None
    for tick in range(TICKS):
        for req in requests(tick):
            svc.submit(req)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resp = svc.tick()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        if len(resp) != C:
            raise SmokeFailure(f"tick {tick}: {len(resp)} responses for {C}")
        for r in resp:
            if r.frame.shape != (Hd, Wd, 4) or not np.isfinite(r.frame).all():
                raise SmokeFailure(f"tick {tick}: bad frame {r.frame.shape}")
        if first_frames is None:
            first_frames = np.stack([r.frame for r in resp])
    launches = {n: w.launches for n, w in wrappers.items()}
    print(f"  launches during the {TICKS} ticks: {launches}")
    for n, k in launches.items():
        if k <= 0:
            raise SmokeFailure(f"the serving path launched no {n} kernel")
    for i, ms in enumerate(tick_ms):
        print(f"  tick {i}: {ms:.2f} ms ({C} clients {Wd}x{Hd}x{S}, host clock "
              f"incl. frame copy) [{tag}]")
    plain = RenderService(model, backend="ref")
    for req in requests(0):
        plain.submit(req)
    plain_frames = np.stack([r.frame for r in plain.tick()])
    frame_err = check("tick 0 frames: cuda vs ref", torch.from_numpy(first_frames),
                      torch.from_numpy(plain_frames), atol=1e-5)
    print(f"  frame alpha mean {float(first_frames[..., 3].mean()):.4f}, "
          f"rgb mean {float(first_frames[..., :3].mean()):.4f}")

    # ---------------------------------------------------------------- 5
    print(f"== phase 5: per-kernel times at the tick's shapes [{tag}]")
    reqs = requests(0)
    eyes = torch.tensor([r.camera.eye for r in reqs], device=dev)
    ctrs = torch.tensor([r.camera.center for r in reqs], device=dev)
    ups = torch.tensor([r.camera.up for r in reqs], device=dev)
    origins, dirs = R.rays_from_arrays(eyes, ctrs, ups, cam.fov_deg, Wd, Hd)
    los, exts, vrs = model.meta_arrays()
    hit, dtt, local, t0r = R._march_setup(los, exts, origins[:, None],
                                          dirs[:, None], S)
    Rr = Wd * Hd
    coords = local.reshape(C * P, Rr * S, 3)
    rows = list(range(P)) * C
    rows_d = torch.tensor(rows, device=dev)
    sp = model.stacked_params()
    feats = hash_encode_cuda(coords, sp["tables"], res, rows)
    v = fused_mlp_cuda(feats, sp["mlp"], rows)
    grange = torch.tensor(model.grange, dtype=torch.float32, device=dev)
    tfs = torch.stack([R.default_tf(device=dev)] * C)
    rgba = R._shade_samples(v.reshape(C, P, Rr, S), hit, dtt,
                            (vrs[:, 0, None, None], vrs[:, 1, None, None]),
                            grange, tfs, 50.0)
    Bn, Nn = C * P, Rr * S
    nH = cfg.n_hidden_layers

    def mlp_chain():   # yardstick: one bmm + relu per layer
        h = feats
        for w in sp["mlp"][:-1]:
            h = torch.relu(torch.bmm(h, w[rows_d]))
        return torch.bmm(h, sp["mlp"][-1][rows_d])

    # rays that miss a partition's box carry coordinates far outside [0,1]
    # (their samples are masked to transparent before compositing), so the
    # INR stages are compared on the rays that hit the box
    hitm = hit.reshape(C * P, Rr, 1).expand(C * P, Rr, S).reshape(C * P, Rr * S)
    kernels = []
    specs = [
        ("hash_encode", lambda: hash_encode_cuda(coords, sp["tables"], res, rows),
         lambda: hash_encode_batched_ref(coords, sp["tables"], res, rows_d), None,
         Bn * Nn * 12 + Bn * Nn * L * F * 4 + P * L * T * F * 4,
         Bn * Nn * L * (25 + 16 * F)),
        ("fused_mlp_fwd", lambda: fused_mlp_cuda(feats, sp["mlp"], rows),
         lambda: fused_mlp_batched_ref(feats, sp["mlp"], rows_d), mlp_chain,
         Bn * Nn * (D_in + cfg.out_dim) * 4
         + P * 4 * sum(w.shape[1] * w.shape[2] for w in sp["mlp"]),
         2 * Bn * Nn * (D_in * W + (nH - 1) * W * W + W * cfg.out_dim)),
        ("composite", lambda: composite_cuda(rgba), lambda: composite_ref(rgba),
         None, rgba.numel() * 4 + C * P * Rr * 4 * 4, C * P * Rr * S * 9),
    ]
    for name, kern, plain_fn, lib_fn, nbytes, flops in specs:
        got, want = kern(), plain_fn()
        if name != "composite":
            got, want = got[hitm], want[hitm]
        err = check(f"{name} at tick shapes (hit rays)", got, want,
                    atol=2e-6 * max(1.0, float(want.abs().max())))
        del got, want
        ms = cuda_ms(kern, reps=10)
        pms = cuda_ms(plain_fn, reps=3)
        lms = cuda_ms(lib_fn, reps=5) if lib_fn is not None else None
        bms, by = bound_ms(nbytes, flops)
        print(f"  {name:<14s} {ms:9.3f} ms  bound {bms:8.3f} ms ({by})  "
              f"plain {pms:9.3f} ms  library "
              f"{'-' if lms is None else f'{lms:.3f} ms'}  "
              f"launches/tick {launches[name] / TICKS:.0f} [{tag}]")
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms,
                        "bound_ms": bms, "bound_by": by, "library_ms": lms})
    del feats, v, rgba, coords, local

    # phase-3 shapes: one decode chunk of 2^22 points, one partition
    Nd = DECODE_CHUNK
    cd = torch.rand((1, Nd, 3), device=dev)
    sp1 = {"tables": model1.params["tables"][None],
           "mlp": [w[None] for w in model1.params["mlp"]]}
    fd = hash_encode_cuda(cd, sp1["tables"], res, [0])
    for name, kern, nbytes, flops in (
            ("hash_encode", lambda: hash_encode_cuda(cd, sp1["tables"], res, [0]),
             Nd * (12 + L * F * 4) + L * T * F * 4, Nd * L * (25 + 16 * F)),
            ("fused_mlp_fwd", lambda: fused_mlp_cuda(fd, sp1["mlp"], [0]),
             Nd * (D_in + 1) * 4, 2 * Nd * (D_in * W + (nH - 1) * W * W + W))):
        ms = cuda_ms(kern, reps=10)
        bms, by = bound_ms(nbytes, flops)
        print(f"  decode chunk {name:<14s} N=2^22: {ms:.3f} ms  bound "
              f"{bms:.3f} ms ({by}); {decode_launches[name]} launches per "
              f"{DECODE_EDGE}^3 decode [{tag}]")
    print(f"  frame max err vs plain {frame_err:.3e}; ticks "
          f"{[round(x, 3) for x in tick_ms]} ms")

    # where a tick's time goes: one more tick under torch.profiler
    for req in requests(TICKS):
        svc.submit(req)
    torch.cuda.synchronize()
    busy, by_kernel, wall = profile_tick(svc.tick)
    if busy is None:
        print(f"  profiled tick: no device time recorded (not measured) [{tag}]")
    else:
        print(f"  profiled tick: {wall:.2f} ms host clock, device busy "
              f"{busy:.2f} ms, idle share {1 - busy / wall:.3f} [{tag}]")
        for name, (ms, n) in by_kernel[:12]:
            print(f"    {ms:9.3f} ms  x{n:<4d} {name[:90]}")

    print(tag)                        # name, power limit as nvidia-smi says
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
