"""DVNR (the paper's own technique) configurations — the port's own copy.

Field for field and preset for preset the same as ``repro.configs.dvnr`` (the
port imports nothing of the JAX package; ``tests/test_torch_config.py`` holds
the two equal). Mirrors the paper appendix "Network Configurations": INR = multi-resolution hash
encoding + small ReLU MLP; per-partition adaptive hash table size / resolutions;
boundary loss (lambda, sigma); model compression targets (zfp_enc / zfp_mlp).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class DVNRConfig:
    """One DVNR model (per partition)."""

    # ----- INR architecture (paper appendix naming) -----
    n_levels: int = 4
    n_features_per_level: int = 4
    log2_hashmap_size: int = 11
    base_resolution: int = 0            # 0 -> (int)cbrt(1 << log2_hashmap_size)
    per_level_scale: float = 2.0
    n_neurons: int = 16
    n_hidden_layers: int = 2
    out_dim: int = 1                    # scalar field (3 for velocity fields)

    # ----- training (III-B adaptive parameters) -----
    lrate: float = 5e-3
    lrate_decay: int = -1               # exp decay interval in steps; -1 = none
    epochs: int = 16                    # N_epoch
    batch_size: int = 16_384            # N_batch
    n_train_min: int = 64               # N_train^min
    target_loss: float = 0.0            # moving-average early-stop threshold (0 = off)
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 1e-9

    # ----- III-B adaptive hash table scaling -----
    t_min_log2: int = 6                 # T_min
    # T = max(T_min, T_ref * ceil(Nvox / Nvox_global)); R0 = floor(R_ref * cbrt(T/T_ref))

    # ----- III-C boundary loss -----
    boundary_lambda: float = 0.15
    boundary_sigma: float = 0.005

    # ----- III-D model compression targets -----
    zfp_enc: float = 0.02               # r1 = r2 (encoder accuracy target)
    zfp_mlp: float = 0.01               # r3 (MLP accuracy target)

    # ----- III-E weight caching -----
    weight_caching: bool = True

    # ----- mixed precision (precision policy name) -----
    # "f32" (full precision, default), "bf16" (bf16 params/compute, f32
    # master + loss), "bf16_out", or an explicit "param/compute/output"
    # triple. Kept as a string so configs serialize (msgpack) and hash as
    # jit-static data; resolve with repro_torch.precision.resolve_precision.
    precision: str = "f32"

    # ----- fused train step (repro.kernels.fused_train_step) -----
    # "auto" (fuse when the backend advertises the fused_train_step
    # capability — all built-in backends do), "on" (require it; error if the
    # backend can't), "off" (always the unfused step — the parity baseline).
    fuse_train_step: str = "auto"

    # ----- in-op batch sampling (repro.kernels.fused_train_step sampling
    # stage) -----
    # "auto" (move the counter-based coordinate draws + trilinear target
    # gather inside the fused train step whenever it is enabled and the
    # backend advertises fused_sampling — all built-ins do), "on" (require
    # it; error if fuse_train_step resolves off or the backend can't),
    # "off" (sample on the host — the sampling parity baseline). All modes
    # draw bit-identical batches for the same (key, step, partition): the
    # sampler is counter-based (repro.core.sampling).
    fuse_sampling: str = "auto"

    # ----- in-op sampling volume layout (sampling_brick) -----
    # Only meaningful when fuse_sampling resolves on and the backend is
    # pallas. "auto" (default) keeps the whole ghost-padded partition pinned
    # in VMEM when it fits the backend's vmem_limit_bytes (the original layout,
    # bit-for-bit) and otherwise streams the HBM-resident volume through
    # VMEM one brick at a time (largest cube brick that fits the budget —
    # what production 256^3 partitions use). An int > 0 forces the tiled
    # kernel with that cube edge; 0 / "pinned" forces the pinned kernel
    # (the negative control: over-budget volumes are rejected at build
    # time). All layouts produce bit-identical training trajectories.
    # Kept as str-or-int for msgpack/jit-static hashing, like the knobs
    # above.
    sampling_brick: object = "auto"

    # ----- non-finite training guard (repro.resilience) -----
    # True folds a cheap per-partition isfinite reduction into the scan-fused
    # train chunk (per-step loss check in the scan carry + a per-leaf params
    # check at the chunk boundary — no collectives, no extra host syncs) and
    # reports it as DVNRState.finite. RecoveryPolicy consumes it; with the
    # guard off the detector is skipped entirely and the traced program is
    # unchanged from the pre-resilience stack.
    guard_nonfinite: bool = True

    # ----- static analysis at trainer build time (repro.analysis) -----
    # "off" (default; the cheap fused-sampling VMEM guard still runs),
    # "warn" (trace the chunk program at build time and run the jaxpr-level
    # checks — VMEM budget, precision flow, RNG/gather placement — warning on
    # violations), "error" (refuse to build a violating trainer:
    # repro.analysis.StaticCheckError).
    static_checks: str = "off"

    @property
    def resolved_base_resolution(self) -> int:
        if self.base_resolution > 0:
            return self.base_resolution
        return int(round((1 << self.log2_hashmap_size) ** (1.0 / 3.0)))

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    def level_resolutions(self) -> Tuple[int, ...]:
        r0 = self.resolved_base_resolution
        return tuple(
            max(2, int(r0 * self.per_level_scale**lvl)) for lvl in range(self.n_levels)
        )

    def replace(self, **kw) -> "DVNRConfig":
        import dataclasses

        return dataclasses.replace(self, **kw)


# Paper appendix presets ------------------------------------------------------
# Scaling experiments (Fig. 6)
CLOVERLEAF_SCALING = DVNRConfig(
    lrate=0.005, lrate_decay=-1, epochs=14, n_neurons=16, n_hidden_layers=2,
    n_levels=5, n_features_per_level=4, per_level_scale=2.0,
    base_resolution=8, log2_hashmap_size=16,
)
NEKRS_SCALING = DVNRConfig(
    lrate=0.005, lrate_decay=-1, epochs=8, n_neurons=16, n_hidden_layers=3,
    n_levels=5, n_features_per_level=4, per_level_scale=2.0,
    log2_hashmap_size=16,
)
S3D_SCALING = DVNRConfig(
    lrate=0.005, lrate_decay=-1, epochs=16, n_neurons=16, n_hidden_layers=2,
    n_levels=4, n_features_per_level=4, per_level_scale=2.0,
    log2_hashmap_size=13,
)

# In situ compression experiments (Fig. 7)
NEKRS_INSITU = DVNRConfig(
    lrate=0.001, lrate_decay=-1, epochs=4, n_neurons=16, n_hidden_layers=3,
    n_levels=5, n_features_per_level=4, per_level_scale=2.0,
    log2_hashmap_size=12, target_loss=0.0105, zfp_mlp=0.005, zfp_enc=0.010,
)
S3D_INSITU = DVNRConfig(
    lrate=0.005, lrate_decay=-1, epochs=16, n_neurons=16, n_hidden_layers=2,
    n_levels=4, n_features_per_level=4, per_level_scale=2.0,
    log2_hashmap_size=11, target_loss=0.005, zfp_mlp=0.01, zfp_enc=0.02,
)

# Temporal caching (Fig. 12)
CLOVERLEAF_CACHE = DVNRConfig(
    epochs=14, lrate=0.01, lrate_decay=6, n_neurons=16, n_hidden_layers=1,
    n_levels=4, n_features_per_level=4, per_level_scale=2.0,
    log2_hashmap_size=16, zfp_mlp=0.01, zfp_enc=0.02,
)
NEKRS_CACHE = DVNRConfig(
    lrate=0.01, lrate_decay=20, epochs=4, n_neurons=16, n_hidden_layers=1,
    n_levels=4, n_features_per_level=4, per_level_scale=2.0,
    log2_hashmap_size=12, zfp_mlp=0.005, zfp_enc=0.010,
)

# Ablation study (Fig. 14)
ABLATION = DVNRConfig(
    n_neurons=64, n_hidden_layers=3, n_levels=10, n_features_per_level=8,
    log2_hashmap_size=19, base_resolution=4, per_level_scale=2.0,
)

# Production dry-run config: one INR per device, 256^3 local partition.
PRODUCTION = DVNRConfig(
    n_levels=5, n_features_per_level=4, log2_hashmap_size=16, base_resolution=8,
    per_level_scale=2.0, n_neurons=16, n_hidden_layers=2, epochs=14,
    batch_size=65_536,
)

# The strong-scaled production rank: one 256^3 local partition of a 512^3
# global volume under the III-B adaptive rule
# (T = max(T_min, T_ref * Nvox/Nvox_global), R0 = floor(R_ref * cbrt(T/T_ref)))
# applied to PRODUCTION's T_ref = 2^16, R_ref = 8 at an 8-rank split:
# T = 2^13, R0 = 4. This is the per-partition table the fused-train-step
# kernel budgets VMEM against (its state groups stay ~4 MiB, leaving room
# for the brick-tiled sampling stage at 256^3); giant-T offline tables need
# the still-open table-sharded grid axis instead.
PRODUCTION256 = PRODUCTION.replace(log2_hashmap_size=13, base_resolution=4)

# Reduced config for CPU smoke tests.
SMOKE = DVNRConfig(
    n_levels=2, n_features_per_level=2, log2_hashmap_size=7, base_resolution=4,
    per_level_scale=2.0, n_neurons=16, n_hidden_layers=1, epochs=2,
    batch_size=512, n_train_min=8,
)

CONFIG = PRODUCTION
