"""Direct volume rendering from DVNR models (paper §IV-C).

The port of ``repro.core.render``: ray generation, the sample-streaming ray
marcher (coordinates, INR inference or brick-pool sampling, transfer
function, front-to-back compositing), exact sort-last depth compositing of
the per-partition images, and the multi-rank binary swap
(:func:`binary_swap`, :func:`make_distributed_render_step`: each rank
renders its partition on its own device and the ranks composite by
exchanging halves, :mod:`repro_torch.parallel.collectives`).

Where JAX ``vmap``s one partition's render over partitions (and the render
service ``vmap``s the frame over clients), the port writes the batch out:
every function here broadcasts over leading axes, and
:func:`_render_batch` renders C cameras x P partitions with one hash-encode,
one MLP and one compositing launch. The brick-cache twins
(``*_sampled``) take their value samples from a decoded brick pool instead
of the INR (:func:`sample_bricks`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import backends
from repro_torch.configs.dvnr import DVNRConfig
from repro_torch.core.inr import _inr_apply, _inr_apply_batched
from repro_torch.data.volume import _CORNERS
from repro_torch.kernels.composite.ops import composite
from repro_torch.precision import torch_dtype


# --------------------------------------------------------------------------- #
# Camera / rays
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class Camera:
    """An immutable pinhole camera (hashable: it rides inside requests)."""

    eye: Tuple[float, float, float] = (1.8, 1.4, 1.6)
    center: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    up: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    fov_deg: float = 45.0

    def orbit(self, angle: float, *, radius: Optional[float] = None,
              height: Optional[float] = None) -> "Camera":
        """The camera rotated to ``angle`` (radians) on a horizontal orbit
        around ``center``."""
        cx, cy, cz = self.center
        dx, dy, dz = (self.eye[0] - cx, self.eye[1] - cy, self.eye[2] - cz)
        r = float(np.hypot(dx, dy)) if radius is None else radius
        h = dz if height is None else height
        return Camera(eye=(cx + r * float(np.cos(angle)),
                           cy + r * float(np.sin(angle)), cz + h),
                      center=self.center, up=self.up, fov_deg=self.fov_deg)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def rays_from_arrays(eye, center, up, fov_deg: float, width: int, height: int,
                     device=None):
    """Rays of pinhole cameras: eye/center/up (..., 3) each (tuples or
    tensors; a leading axis batches cameras) -> (origins, dirs), each
    (..., width*height, 3) f32."""
    if device is None:
        device = eye.device if torch.is_tensor(eye) else "cpu"
    eye = _f32(eye, device)
    fwd = _normalize(_f32(center, device) - eye)
    right = _normalize(torch.linalg.cross(fwd, _f32(up, device).expand_as(fwd),
                                          dim=-1))
    upv = torch.linalg.cross(right, fwd, dim=-1)
    tan = float(np.tan(np.radians(fov_deg) / 2))
    xs = (torch.arange(width, dtype=torch.float32, device=device) + 0.5) \
        / width * 2 - 1
    ys = (torch.arange(height, dtype=torch.float32, device=device) + 0.5) \
        / height * 2 - 1
    X, Y = torch.meshgrid(xs * tan, ys * tan * (height / width), indexing="xy")
    e = (..., None, None, slice(None))
    dirs = fwd[e] + X[..., None] * right[e] + Y[..., None] * upv[e]
    dirs = _normalize(dirs)
    origins = eye[e].expand(dirs.shape)
    lead = dirs.shape[:-3]
    return origins.reshape(*lead, -1, 3), dirs.reshape(*lead, -1, 3)


def make_rays(cam: Camera, width: int, height: int, device="cpu"):
    return rays_from_arrays(cam.eye, cam.center, cam.up, cam.fov_deg,
                            width, height, device=device)


def ray_aabb(origins, dirs, box_lo, box_hi):
    """Slab test -> (t0, t1) per ray; t1 <= t0 means miss."""
    inv = 1.0 / torch.where(dirs.abs() < 1e-9, 1e-9, dirs)
    t_lo = (box_lo - origins) * inv
    t_hi = (box_hi - origins) * inv
    t0 = torch.minimum(t_lo, t_hi).amax(dim=-1)
    t1 = torch.maximum(t_lo, t_hi).amin(dim=-1)
    return torch.clamp(t0, min=0.0), t1


# --------------------------------------------------------------------------- #
# Transfer function
# --------------------------------------------------------------------------- #
def default_tf(n: int = 64, device="cpu") -> torch.Tensor:
    """A cool-to-warm piecewise-linear RGBA table over normalized value [0,1]."""
    t = np.linspace(0, 1, n)
    r = np.clip(1.5 * t, 0, 1)
    g = np.clip(1.0 - np.abs(2 * t - 1), 0, 1) * 0.8
    b = np.clip(1.5 * (1 - t), 0, 1)
    a = np.clip(t**2 * 0.8 + 0.02, 0, 1)
    return _f32(np.stack([r, g, b, a], -1), device)


def apply_tf(values: torch.Tensor, tf_table: torch.Tensor) -> torch.Tensor:
    """values (...) -> rgba (..., 4). ``tf_table`` is (K, 4), or (C, K, 4)
    with one table per leading index of ``values`` (one per client)."""
    K = tf_table.shape[-2]
    v = torch.clamp(values, 0.0, 1.0) * (K - 1)
    lo = torch.clamp(torch.floor(v).to(torch.int64), 0, K - 2)
    w = (v - lo.to(v.dtype))[..., None]
    if tf_table.ndim == 2:
        flat = tf_table
    else:
        C = tf_table.shape[0]
        flat = tf_table.reshape(C * K, 4)
        lo = lo + (torch.arange(C, device=lo.device) * K) \
            .reshape(C, *([1] * (values.ndim - 1)))
    return flat[lo] * (1 - w) + flat[lo + 1] * w


# --------------------------------------------------------------------------- #
# Brick-cache sampling (repro_torch.serving)
# --------------------------------------------------------------------------- #
#: points sampled at a time: bounds the (N, 8) index and weight tensors
SAMPLE_CHUNK = 1 << 22


def _sample_bricks(pool, slots, coords01, grid_shape, brick_edge: int):
    dev = coords01.device
    dims = torch.tensor(grid_shape, dtype=torch.float32, device=dev)
    pos = coords01 * dims - 0.5
    lo = torch.minimum(torch.clamp(torch.floor(pos), min=0), dims - 2)
    w = torch.clamp(pos - lo, 0.0, 1.0)
    lo = lo.to(torch.int64)
    brick = torch.div(lo, brick_edge, rounding_mode="floor")            # (N,3)
    nbx, nby, nbz = slots.shape
    slot = slots.reshape(-1)[(brick[:, 0] * nby + brick[:, 1]) * nbz
                             + brick[:, 2]].to(torch.int64)             # (N,)
    local = lo - brick * brick_edge                                     # (N,3)
    off = torch.as_tensor(_CORNERS, dtype=torch.int64, device=dev)      # (8,3)
    E = brick_edge + 1
    # the linear index of each corner, built axis by axis: integer math, so
    # the same index as JAX's (N,8,3) corner array without materialising it
    lin = slot[:, None] * E + (local[:, 0, None] + off[:, 0])
    lin = lin * E + (local[:, 1, None] + off[:, 1])
    lin = lin * E + (local[:, 2, None] + off[:, 2])                     # (N,8)
    vals = pool.reshape(-1)[lin.reshape(-1)].reshape(lin.shape)
    one = off == 1
    ww = torch.where(one[:, 0], w[:, 0, None], 1.0 - w[:, 0, None])
    ww = ww * torch.where(one[:, 1], w[:, 1, None], 1.0 - w[:, 1, None])
    ww = ww * torch.where(one[:, 2], w[:, 2, None], 1.0 - w[:, 2, None])
    return torch.einsum("nc,nc->n", ww, vals.to(ww.dtype))


def sample_bricks(pool, slots, coords01, grid_shape, brick_edge: int):
    """Trilinear sampling of a brick-tiled cell-centered grid.

    ``pool`` (n_slots, E, E, E) with ``E = brick_edge + 1`` holds decoded
    bricks with a one-voxel overlap row (each brick is self-contained for
    trilinear interpolation over the cells it owns), ``slots`` (nbx, nby,
    nbz) maps brick index -> pool slot, and ``coords01`` (N, 3) are
    normalized coords over the grid. The arithmetic of JAX's
    ``sample_bricks`` and of :func:`repro_torch.data.volume.sample_trilinear`
    (ghost=0): the same cell-centered mapping, clamps, corner order and
    8-corner sum, so it matches either bit for bit when the pool holds the
    decoded grid values. Points go :data:`SAMPLE_CHUNK` at a time (each is
    independent), which bounds the (N, 8) intermediates."""
    N, chunk = coords01.shape[0], SAMPLE_CHUNK
    if N <= chunk:
        return _sample_bricks(pool, slots, coords01, grid_shape, brick_edge)
    out = torch.empty(N, dtype=torch.float32, device=coords01.device)
    for i in range(0, N, chunk):
        out[i:i + chunk] = _sample_bricks(pool, slots, coords01[i:i + chunk],
                                          grid_shape, brick_edge)
    return out


def sample_bricks_batched(pool, slots, coords01, grid_shape, brick_edge: int,
                          part):
    """:func:`sample_bricks` of B rows: ``coords01`` (B, N, 3), row ``b``
    through partition ``part[b]``'s slot map ``slots[part[b]]`` ((P, nbx,
    nby, nbz)) -> (B, N) f32."""
    B, N = coords01.shape[:2]
    out = torch.empty((B, N), dtype=torch.float32, device=coords01.device)
    for b, p in enumerate(part):
        out[b] = sample_bricks(pool, slots[p], coords01[b], grid_shape,
                               brick_edge)
    return out


# --------------------------------------------------------------------------- #
# Ray marching
# --------------------------------------------------------------------------- #
def _march_setup(origin, extent, origins, dirs, n_samples: int):
    """Shared ray-march scaffolding: (hit, dt, local coords (..., R, S, 3),
    t0). ``origin``/``extent`` (..., 3) are boxes, ``origins``/``dirs``
    (..., R, 3) rays; leading axes broadcast (boxes (P,3) against rays
    (C,1,R,3) march every partition for every client)."""
    lo = _f32(origin, origins.device)[..., None, :]
    hi = lo + _f32(extent, origins.device)[..., None, :]
    t0, t1 = ray_aabb(origins, dirs, lo, hi)
    hit = t1 > t0
    dt = (t1 - t0) / n_samples
    steps = torch.arange(n_samples, dtype=torch.float32, device=origins.device)
    ts = t0[..., None] + (steps + 0.5) * dt[..., None]                 # (.., R, S)
    pos = origins[..., None, :] + ts[..., None] * dirs[..., None, :]   # (.., R, S, 3)
    local = (pos - lo[..., None, :]) / (hi - lo)[..., None, :]
    return hit, dt, local, t0


def _range_scale(lo, hi):
    d = hi - lo
    return torch.clamp(d, min=1e-12) if torch.is_tensor(d) else max(d, 1e-12)


def _shade_samples(v, hit, dt, vrange, grange, tf_table, density: float):
    """Value samples (..., R, S) -> rgba samples (..., R, S, 4) in f32:
    de-normalize to the GLOBAL range, transfer function, opacity
    integration; missed rays are transparent."""
    vmin, vmax = vrange
    gmin, gmax = grange
    raw = v.to(torch.float32) * (vmax - vmin) + vmin
    vg = (raw - gmin) / _range_scale(gmin, gmax)
    rgba = apply_tf(vg, tf_table)
    alpha = 1.0 - torch.exp(-rgba[..., 3] * density * dt[..., None])
    rgba = torch.cat([rgba[..., :3], alpha[..., None]], -1)
    return torch.where(hit[..., None, None], rgba, 0.0)


def _shade_composite(v, hit, dt, t0, vrange, grange, tf_table, density,
                     backend, compute_dtype):
    """Value samples (..., R, S) -> (rgba (..., R, 4), depth (..., R))."""
    rgba = _shade_samples(v, hit, dt, vrange, grange, tf_table, density)
    out = composite(rgba, backend, compute_dtype=compute_dtype)
    depth = torch.where(hit, t0, torch.inf)
    return out, depth


def _render_partition(cfg: DVNRConfig, params, origin, extent, vrange, grange,
                      origins, dirs, tf_table, *, n_samples: int = 64,
                      density: float = 50.0,
                      impl: backends.BackendLike = "ref", compute_dtype=None):
    """Ray-march one partition's INR. Returns (rgba (R,4), depth (R,))."""
    backend = backends.resolve(impl)
    hit, dt, local, t0 = _march_setup(origin, extent, origins, dirs, n_samples)
    R, S = local.shape[:2]
    v = _inr_apply(cfg, params, local.reshape(-1, 3), backend,
                   compute_dtype=compute_dtype).reshape(R, S)
    return _shade_composite(v, hit, dt, t0, vrange, grange, tf_table,
                            density, backend, compute_dtype)


def _render_rows(values, metas, origins, dirs, tf_tables, grange, *,
                 n_samples: int, density: float, backend, compute_dtype):
    """Render C cameras x P partitions at once: ``origins``/``dirs``
    (C, R, 3), ``tf_tables`` (C, K, 4), ``metas = (los, exts, vrs)`` of
    the P partitions; ``values(coords (C*P, R*S, 3), part)`` gives the
    value samples of row ``c * P + p`` (client c's rays through partition
    ``part[c * P + p] = p``). Returns (images (C,P,R,4), depths (C,P,R)).
    One call of ``values`` and one compositing launch cover the whole batch
    (the port of the ``jax.vmap`` over partitions and clients)."""
    los, exts, vrs = metas
    C, R = origins.shape[:2]
    P = los.shape[0]
    hit, dt, local, t0 = _march_setup(los, exts, origins[:, None],
                                      dirs[:, None], n_samples)
    S = local.shape[-2]
    v = values(local.reshape(C * P, R * S, 3), list(range(P)) * C) \
        .reshape(C, P, R, S)
    vrange = (vrs[:, 0, None, None], vrs[:, 1, None, None])
    return _shade_composite(v, hit, dt, t0, vrange, grange, tf_tables,
                            density, backend, compute_dtype)


def _render_batch(cfg: DVNRConfig, stacked_params, metas, origins, dirs,
                  tf_tables, grange, *, n_samples: int = 64,
                  density: float = 50.0, impl: backends.BackendLike = "ref",
                  compute_dtype=None):
    """:func:`_render_rows` through INR inference: one batched INR call
    (one inference launch on the ``cuda`` backend) for every row."""
    backend = backends.resolve(impl)

    def values(coords, part):
        return _inr_apply_batched(cfg, stacked_params, coords, part, backend,
                                  compute_dtype=compute_dtype)

    return _render_rows(values, metas, origins, dirs, tf_tables, grange,
                        n_samples=n_samples, density=density, backend=backend,
                        compute_dtype=compute_dtype)


def _render_partition_sampled(pool, slots, grid_shape, brick_edge: int,
                              origin, extent, vrange, grange, origins, dirs,
                              tf_table, *, n_samples: int = 64,
                              density: float = 50.0,
                              impl: backends.BackendLike = "ref",
                              compute_dtype=None):
    """The cache-aware twin of :func:`_render_partition`: value samples come
    from a decoded brick pool (:class:`repro_torch.serving.BrickCache`,
    ``slots`` (nbx, nby, nbz)) instead of INR inference."""
    backend = backends.resolve(impl)
    hit, dt, local, t0 = _march_setup(origin, extent, origins, dirs, n_samples)
    R, S = local.shape[:2]
    v = sample_bricks(pool, slots, local.reshape(-1, 3), grid_shape,
                      brick_edge).reshape(R, S)
    return _shade_composite(v, hit, dt, t0, vrange, grange, tf_table,
                            density, backend, compute_dtype)


def _render_batch_sampled(pool, slots, grid_shape, brick_edge: int, metas,
                          origins, dirs, tf_tables, grange, *,
                          n_samples: int = 64, density: float = 50.0,
                          impl: backends.BackendLike = "ref",
                          compute_dtype=None):
    """:func:`_render_rows` from the brick pool: row ``c * P + p`` samples
    partition p's slot map ``slots[p]`` ((P, nbx, nby, nbz)); no INR
    inference."""
    backend = backends.resolve(impl)

    def values(coords, part):
        return sample_bricks_batched(pool, slots, coords, grid_shape,
                                     brick_edge, part)

    return _render_rows(values, metas, origins, dirs, tf_tables, grange,
                        n_samples=n_samples, density=density, backend=backend,
                        compute_dtype=compute_dtype)


# --------------------------------------------------------------------------- #
# Sort-last compositing
# --------------------------------------------------------------------------- #
def over(front, back):
    """Over-operator on (..., 4) rgba with premultiplied-style alpha."""
    a_f = front[..., 3:4]
    rgb = front[..., :3] + (1 - a_f) * back[..., :3]
    a = a_f + (1 - a_f) * back[..., 3:4]
    return torch.cat([rgb, a], dim=-1)


def composite_depth_sort(images, depths):
    """images (..., P, R, 4), depths (..., P, R) -> (..., R, 4): exact
    per-ray depth ordering (a stable sort, as ``jnp.argsort``), then the
    over-operator front to back. The loop is the ``lax.scan`` over the
    sorted partitions; each step blends every client's every ray."""
    order = torch.argsort(depths, dim=-2, stable=True)
    sorted_imgs = torch.take_along_dim(images, order[..., None], dim=-3)
    out = torch.zeros_like(sorted_imgs[..., 0, :, :])
    for p in range(sorted_imgs.shape[-3]):
        out = over(out, sorted_imgs[..., p, :, :])
    return out


def _swap_rounds(img, dep, mesh, n: int):
    """The binary-swap loop of one rank of ``mesh`` (``n`` ranks, a power
    of two): ``img`` (R,4) / ``dep`` (R,) are this rank's full-frame
    partial; returns the fully composited frame (R,4) (identical on every
    rank after the final all-gather of owned strips) and the depth buffer.
    Round r pairs rank i with ``i ^ (1 << (rounds-1-r))``: the rank whose
    bit is 0 keeps the front half of the live region, its partner the back
    half; each sends the half it gives up and composites the half it keeps,
    the nearer of the two (per-ray depth) over the other."""
    from repro_torch.parallel.collectives import all_gather, ppermute

    rounds = int(np.log2(n))
    R = img.shape[0]
    me = mesh.index
    lo, size = 0, R
    for r in range(rounds):
        half = size // 2
        bit = (me >> (rounds - 1 - r)) & 1
        keep_lo = lo + (0 if bit == 0 else half)
        send_lo = lo + (half if bit == 0 else 0)
        mine_keep = img[keep_lo:keep_lo + half]
        d_keep = dep[keep_lo:keep_lo + half]
        pairs = [(i, i ^ (1 << (rounds - 1 - r))) for i in range(n)]
        # one message of the half's rgba and depth together
        send = torch.cat([img[send_lo:send_lo + half],
                          dep[send_lo:send_lo + half, None]], dim=1)
        got = ppermute(send, pairs, group=mesh.group)
        got_img, got_d = got[:, :4], got[:, 4]
        front_first = d_keep <= got_d
        merged = torch.where(front_first[:, None], over(mine_keep, got_img),
                             over(got_img, mine_keep))
        img = img.clone()
        dep = dep.clone()
        img[keep_lo:keep_lo + half] = merged
        dep[keep_lo:keep_lo + half] = torch.minimum(d_keep, got_d)
        lo, size = keep_lo, half
    # final gather of owned strips (one all-gather of R/n rows each)
    full = all_gather(img[lo:lo + R // n], group=mesh.group, tiled=True)
    return full, dep


def binary_swap(mesh, images, depths):
    """Binary-swap sort-last compositing across the ranks of ``mesh``.

    images: this rank's (1, R, 4) partial frame, depths its (1, R) per-ray
    depths. Each of the log2 P rounds splits the live image region in half;
    peers exchange the half they will NOT own and composite the half they
    keep (depth-ordered by partner rank). Returns the (1, R, 4) frame, the
    same on every rank. Total wire bytes per rank: R*(1 - 1/P)*20 (rgba and
    depth) — vs (P-1)*R*16 for gather-to-root.

    PRECONDITION (classic sort-last binary swap): partition p's box position
    must follow p's bit pattern on a power-of-two grid (what partition_grid /
    make_partition produce), so every swap-partner pair is separated by an
    axis-aligned plane and the per-ray pairwise depth comparison yields the
    global front-to-back order. For arbitrary (non-plane-separated) depth
    fields use ``composite_depth_sort``.
    """
    n = mesh.size
    if n & (n - 1):
        raise ValueError("binary swap needs a power-of-two rank count")
    full, _ = _swap_rounds(images[0], depths[0], mesh, n)
    return full[None]


def make_distributed_render_step(cfg: DVNRConfig, mesh, *, n_samples: int = 64,
                                 density: float = 50.0,
                                 impl: backends.BackendLike = "ref"):
    """The production render step: every rank renders its own partition's
    INR on its own device (the INR inference and compositing kernels on the
    ``cuda`` backend) and the ranks binary-swap composite in place.

    Returned fn, called by every rank of ``mesh`` with its own partition:
        step(params, part_lo, part_ext, vrange, origins, dirs, tf_table,
             grange) -> (1, R, 4) frame (the same on every rank)
    params: this rank's stacked (1, ...) INR params; part_lo / part_ext
    its partition's origin and extent in world space (3 numbers each);
    vrange its (vmin, vmax); grange the global (min, max); origins / dirs
    (R, 3) and tf_table (K, 4) the same on every rank.
    """
    n = mesh.size
    if n & (n - 1):
        raise ValueError("binary swap needs a power-of-two rank count")
    backend = backends.resolve(impl)

    def step(params, part_lo, part_ext, vrange, origins, dirs, tf_table, grange):
        dev = params["tables"].device
        metas = tuple(_f32(x, dev).reshape(1, -1)
                      for x in (part_lo, part_ext, vrange))
        # the single-process batch of one partition: the same per-partition
        # image as api.render's (one inference and one compositing launch)
        img, dep = _render_batch(
            cfg, params, metas, origins[None], dirs[None], tf_table[None],
            tuple(float(g) for g in grange), n_samples=n_samples,
            density=density, impl=backend)
        full, _ = _swap_rounds(img[0, 0], dep[0, 0], mesh, n)
        return full[None]

    return step


def meta_arrays(parts_meta, device="cpu"):
    """Partition metadata -> ``(los, exts, vrs)`` f32 tensors, each (P,·)."""
    los = _f32([tuple(m["origin"]) for m in parts_meta], device)
    exts = _f32([tuple(m["extent"]) for m in parts_meta], device)
    vrs = _f32([(m["vmin"], m["vmax"]) for m in parts_meta], device)
    return los, exts, vrs


def _frame_from_rays(images, depths, width, height, out_dtype):
    out = composite_depth_sort(images, depths)
    # the image is f32 unless the caller asks otherwise: a reduced
    # compute_dtype does not leak into the returned frame
    out = out.to(torch.float32 if out_dtype is None else torch_dtype(out_dtype))
    return out.reshape(*out.shape[:-2], height, width, 4)


def _render_distributed(cfg, stacked_params, parts_meta, cam: Optional[Camera],
                        width: int, height: int, grange, *,
                        n_samples: int = 64,
                        impl: backends.BackendLike = "ref",
                        tf_table: Optional[torch.Tensor] = None,
                        density: float = 50.0,
                        compute_dtype=None, out_dtype=None, metas=None,
                        rays=None):
    """Render P partitions in one batched pass and depth-composite them.

    ``rays=(origins, dirs)`` overrides the camera: (R,3) each for one frame
    -> (H,W,4), or (C,R,3) with ``tf_table`` (C,K,4) for C clients at once
    -> (C,H,W,4) (the render service's batched tick)."""
    device = stacked_params["tables"].device
    tf_table = default_tf(device=device) if tf_table is None else tf_table
    origins, dirs = make_rays(cam, width, height, device) if rays is None \
        else rays
    metas = meta_arrays(parts_meta, device) if metas is None else metas
    single = origins.ndim == 2
    if single:
        origins, dirs, tf_table = origins[None], dirs[None], tf_table[None]
    images, depths = _render_batch(
        cfg, stacked_params, metas, origins, dirs, tf_table, grange,
        n_samples=n_samples, density=density, impl=impl,
        compute_dtype=compute_dtype)
    frames = _frame_from_rays(images, depths, width, height, out_dtype)
    return frames[0] if single else frames


def _render_distributed_sampled(pool, slots, grid_shape, brick_edge: int,
                                metas, cam: Optional[Camera], width: int,
                                height: int, grange, *, n_samples: int = 64,
                                impl: backends.BackendLike = "ref",
                                tf_table: Optional[torch.Tensor] = None,
                                density: float = 50.0,
                                compute_dtype=None, out_dtype=None,
                                rays=None):
    """Cache-aware twin of :func:`_render_distributed`: every partition's
    value samples come from the decoded brick ``pool`` (``slots`` is the
    (P, nbx, nby, nbz) brick->slot map of a
    :class:`repro_torch.serving.BrickCache` view); the frame runs no INR
    inference. ``rays`` as in :func:`_render_distributed`."""
    device = pool.device
    tf_table = default_tf(device=device) if tf_table is None else tf_table
    origins, dirs = make_rays(cam, width, height, device) if rays is None \
        else rays
    single = origins.ndim == 2
    if single:
        origins, dirs, tf_table = origins[None], dirs[None], tf_table[None]
    images, depths = _render_batch_sampled(
        pool, slots, grid_shape, brick_edge, metas, origins, dirs, tf_table,
        grange, n_samples=n_samples, density=density, impl=impl,
        compute_dtype=compute_dtype)
    frames = _frame_from_rays(images, depths, width, height, out_dtype)
    return frames[0] if single else frames


# --------------------------------------------------------------------------- #
# Deprecated free-function render surface (pre-RenderRequest)
# --------------------------------------------------------------------------- #
def render_partition(cfg, params, origin, extent, vrange, grange, origins,
                     dirs, tf_table, **kw):
    """Deprecated: internal — use ``repro_torch.api.render(model,
    RenderRequest())``."""
    import warnings
    warnings.warn("repro_torch.core.render.render_partition is internal; use "
                  "repro_torch.api.render(model, RenderRequest(...))",
                  DeprecationWarning, stacklevel=2)
    return _render_partition(cfg, params, origin, extent, vrange, grange,
                             origins, dirs, tf_table, **kw)


def render_distributed(cfg, stacked_params, parts_meta, cam, width, height,
                       grange, **kw):
    """Deprecated: internal — use ``repro_torch.api.render(model,
    RenderRequest())``."""
    import warnings
    warnings.warn("repro_torch.core.render.render_distributed is internal; use "
                  "repro_torch.api.render(model, RenderRequest(...))",
                  DeprecationWarning, stacklevel=2)
    return _render_distributed(cfg, stacked_params, parts_meta, cam, width,
                               height, grange, **kw)
