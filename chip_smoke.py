#!/usr/bin/env python3
"""On-card check of the PyTorch / CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the CUDA
toolkit; imports nothing of JAX or of the JAX package. Phases:

1. build   compile ``src/repro_torch/csrc/*.cu`` with nvcc into ``build/``,
           print every kernel's registers and spills (a spill in the MLP
           forward or backward or the INR inference kernel fails), and count
           the tensor-core (HGMMA) and TMA (UTMALDG) instructions of the
           bf16 flash kernels and the mma.sync (HMMA) instructions of the
           MLP forward and backward and INR inference kernels in
           ``cuobjdump -sass`` (a bf16 forward or inference instantiation
           without them fails, and any backward one without them or without
           cp.async; the listing is made in the background and these
           counts are held once phase 5 is done);
2. kernels each kernel against its plain PyTorch version on the card, at
           PRODUCTION256 shapes (L=5, F=4, T=2^13, res 4..64: dense and
           hashed levels): the serving kernels with tables U(-1,1),
           coordinates inside and outside [0,1], H=1/2/3 MLPs, out_dim 1 and
           3, ragged N/R/S, f32 and bf16; the training kernels (hash-encode
           backward, MLP backward, both variants of the train step, AdamW)
           at the training shapes (8 partitions x a batch of 65,536, f32),
           each from cloned state; the hash-encode backward also with every
           point in one coarse cell, at PRODUCTION's T=2^16 (direct levels)
           and at F = 1, 2 and 8 (ABLATION); the MLP backward, f32 and bf16,
           also at MLP_BWD_CASES' shapes; the MLP backward's and the f32
           train step's checks add the allowance of the operands' ties
           (``mlp_ties``, ``step_ties``: decisions within rounding of their
           boundary taken the other way) and hold the tie counts, and
           controls with a planted fault must fail; the host-sampled train
           step also on the table draw that failed before that rule and on
           TIE_DRAW_SEEDS' draws; both variants of the train step at the
           velocity models' D_out = 3 (8 x 65,536 samples of 3-component
           volumes, the same tie-aware yardstick); the INR inference kernel
           (encode and MLP in one launch) at the MLP cases' shapes, f32,
           bf16 and "f32/bf16/f32", coordinates inside and outside [0,1];
           each bf16 flash case against
           the plain version (3e-2), the kernel's tile schedule in f32 with
           p rounded to bf16 (``attention_tiled_ref``, 1e-5 + 8e-3 |out|
           plus the p-rounding slack, whose 2^-16 width is first held
           against the kernel's own f32 p, dumped by its check
           instantiation) and the f32 plain version (per-row relative L2
           1e-2);
3. decode  ``DVNRModel.decode_grid`` of one 256^3 partition through the
           kernels, against the plain path on the card: the inference route
           (one INR inference launch per chunk, no encode or MLP launch);
4. serve   a ``RenderService`` over 8 PRODUCTION256 partitions (the 2x2x2
           split of a 512^3 volume): 4 ticks of 2 orbiting clients at
           256x256, 64 samples, every frame finite, one tick against the
           plain path; the launch counters are zeroed just before the ticks:
           the INR inference kernel must launch in every tick, compositing
           during them, the encode and MLP forward kernels never
           (``use_cache=False``: INR inference per sample);
4b. cache  the same model through a ``BrickCache`` (256^3 a partition in
           bricks of 16, a 1 GiB pool: 32,768 bricks, 54,637 slots): the
           cold fill (host clock and device time; one INR inference launch
           per chunk) and warm ``ensure``, the pool against the plain fill;
           a cold and 3 warm cached ticks (counters zeroed just before: the
           inference kernel in the fills only, compositing in every tick,
           the encode and MLP forward kernels never), cold-cache frames
           equal to warm ones bit for bit and within 1e-5 of the plain
           path's cached frames, cached and uncached ticks in turns (host
           clock, peak memory: the cached at most the uncached + 2 GiB),
           one profiled cached tick; a bf16 pool within 0.05 of the f32
           pool's frames; a ``TemporalModelCache(window=2)`` of the model
           and a perturbed copy, raw and compressed, served at timesteps
           0, 1, 0, 1, 1 through a fresh cache: 10,899 evictions at each
           switch, every one of the stale timestep, the last ``ensure``
           all hits;
5. train   ``api.train(backend="cuda")`` of the 8 PRODUCTION256 partitions
           of a 512^3 CloverLeaf for 512 steps at the full batch, counters
           zeroed just before: the train-step and AdamW kernels must have
           launched, the loss must fall, and the first 16 losses must agree
           with the plain path (``backend="ref"``) and with the unfused
           kernel path (hash-encode forward and backward, MLP forward and
           backward kernels, whose counters must move too); ms per step,
           samples per second and the final PSNR through ``evaluate`` (the
           inference route; under bf16 its bf16 instantiation);
6. report  per-tick and per-kernel times (CUDA events) with each kernel's
           bound, its plain version's time and a PyTorch yardstick (for the
           INR inference kernel the encode + MLP pair back to back, at the
           tick's shapes and on a 2^22 decode chunk, and the grid-stride
           design before it there and at PRODUCTION's and ABLATION's
           widths, with the stage clock of both; the MLP forward also
           under bf16 against the bf16 bmm + relu chain), a tick's peak memory
           and host time with and without the inference route, and the
           device's idle share over one profiled serving tick, one
           profiled training chunk and one unfused chunk per policy (the
           top device kernels and host operations), and the MLP backward's
           time by stage (a clock on each warp of its W = 16
           instantiation), tagged with the card's name and power limit;
7. LM      serving with the dense transformer at ``llama3_8b``'s published
           width and depth (32 layers, d=4,096, 32/8 heads, d_ff=14,336,
           vocab 128,256; f32 params from a seed, bf16 compute): prefill of
           2 x 4,096 prompt tokens (cut from ``prefill_32k``'s 32 x 32,768 to
           stay inside the time limit) and 32 greedy decode steps through
           ``build_model(cfg).prefill / decode_step``, counters zeroed just
           before: the flash-attention kernel must launch once per layer in
           the prefill and never in a decode step. Checks: the same width at
           depth 2 in f32, kernel path against the plain path and prefill(S)
           + decode(1) against prefill(S+1) (1e-4 of the largest logit);
           at full depth in bf16, kernel path against the plain path (cosine
           >= 0.999, every logit finite). Prefill ms, prompt tokens/s,
           decode ms per step and peak memory, then the flash kernel's row
           timed as phase 6 times the others (SDPA as its yardstick).
           Phase 2 holds the flash kernel against its plain version at the
           llama, danube (dh=80, window) and qwen2 (14/2 heads) shapes and
           at dh 16 and 32. bf16 runs the tensor-core kernel, f32 the
           CUDA-core one.
8. in situ the reactive in situ loop through ``InSituSession(...).run`` on
           PRODUCTION256: a CloverLeaf simulation of 8 ranks x 256^3 (ghost
           1, dt 0.03), 3,584 steps a trained tick, a window of 4 compressed
           models, ``RecoveryPolicy(max_retries=1)``, a 1 s deadline on the
           injected clock and JAX's seed-11 acceptance plan on 8 cycles;
           ``health()`` must be the dict its rules give, on a run a cycle at
           a time (each tick's host clock split into publish, train, retry,
           compress and actions, and its launch counters: the train step and
           AdamW on every trained tick and on the retry, the inference kernel
           on the trigger's tick only, compositing once a frame, the encode,
           MLP and backward kernels never) and again on one ``run(8)``; a
           shock trigger (the share of voxels above SHOCK_LEVEL, a device
           reduction) fires once and renders 256^2 x 64, extracts a 128^3
           isosurface a partition and renders every model in the window:
           frames within 1e-5 of the plain path on the card, the isosurface
           held by the tie rule (``check_isosurface``); the window's bytes
           against the raw steps' and against ``cache_mode="raw"``, the
           session's peak memory; ``api.train(recovery=RecoveryPolicy())``
           with one NaN partition (frozen at its init after the ladder, the
           healthy partitions against a clean run); two velocity models and
           4,096 backward pathlines against the plain path within a per-seed
           bound (``pathline_bound``) and against the analytic field; the
           train step at D_out = 3 timed at the pathline path's shapes. The
           recovery run and its clean runs take the train step's
           deterministic route: the healthy partitions and two clean runs
           bit for bit; the first 16 steps on the default route at 1e-4;
9. ranks   DVNR across ranks (``distributed_phase``): 8 ``gloo`` ranks
           spawned into one process group share the card (NCCL refuses two
           ranks on one device; the halo's and the swap's wire is staged
           through host copies, compute stays on the card), a 2x2x2 mesh,
           one PRODUCTION256 partition of the 512^3 CloverLeaf a rank, the
           kernels built by this process before any rank starts: (a)
           partitions with their ghosts zeroed, filled by ``halo_exchange``,
           bit for bit against ``halo_exchange_ref`` and equal to
           make_partition's ghost cells on interior faces; (b) 512 steps
           of ``api.train(mesh=)`` a rank on the deterministic route, a
           checkpoint at step 256 in between: ``count_collectives`` reads 0
           over every chunk and over a chunk with rank 1's partition masked
           out, >= 1 over a control ring shift; every rank's train-step and
           AdamW counters move; each rank's state bit for bit its
           partition's in the single-process stacked run; (c)
           ``make_distributed_render_step`` at 256^2 x 64: the same frame on
           every rank, within 1e-5 of ``api.render``; (d) ``plan_restart(5)``
           gives 4 ranks, ``elastic_restore`` onto them (2 partitions each),
           512 steps reached: bit for bit (b)'s states; the static check
           ``zero_collectives`` passes over each rank's chunk and fails over
           its control shift.
10. checks ``python -m repro_torch.analysis --config production256
           --backend cuda`` exits 0; ``kernel_budget`` reads each launched
           kernel's ``cudaFuncGetAttributes``, which must agree with phase 1's
           ``ptxas`` numbers; ``python -m repro_torch.analysis lock verify
           --device cuda --config quickstart,smoke`` exits 0 against the
           committed lock (written on the CPU), and the production256
           reports of this process match its production256 entries;
           ``static_checks="error"`` builds on the clean config and raises
           on each control (``analysis_phase``);
11. examples ``examples/quickstart_torch.py`` and
           ``examples/insitu_reactive_torch.py`` at a cut depth
           (``examples_phase``).
12. families the MoE, SSM, hybrid and encoder-decoder models at published
           width (``families_phase``): grok-1 (4 of 64 layers, bf16
           params), arctic (2 of 35, bf16), mamba2 (48 layers), zamba2 (38)
           and seamless (24 + 24), params from a seed on the card, each
           serving 2 x 4,096 uniform prompt tokens (seamless: N(0,1) source
           frames and a first target token) and 32 greedy decode steps
           through ``build_model(cfg).prefill / decode_step`` (``impl`` and
           ``device`` at ``"auto"``), the flash counter zeroed just before
           each: 4, 2, 0, 6 and 24 launches in the prefill, none in a decode
           step. Checks: the kernel path against the plain path at the
           model's dtypes on the real vocabulary (cosine >= 0.999, every
           logit finite; MoE: the routed experts layer by layer, a flip
           only within twice the router probabilities' departure of a tie;
           where the SSD scan runs in bf16, ROADMAP §C8, the kernel path
           no further from the f32 computation of the same params than
           1.5x the plain path, and the two f32 paths within 1e-4 of the
           largest logit at full depth), and at a cut depth in
           float32 (grok 1, mamba2 2, zamba2 7, seamless 2 + 2; arctic's
           float32 layer does not fit) the kernel path against the plain
           path and prefill then decode against a teacher-forced pass, both
           at 1e-4 of the largest logit. Prefill ms, prompt tokens/s,
           decode ms per step, peak memory and the idle share of one
           profiled prefill; then row 8-nc, the flash kernel at the
           encoder's shape (non-causal, 2 x 4,096 x 16 heads of 64) timed
           against its bound, its plain version and SDPA. Phase 2 holds the
           kernel at these shapes first (the encoder's, its cross-attention
           with Sq = 512 < Sk = 4,096, grok's 48/8 and arctic's 56/8 heads
           of 128, zamba2's 32/32 of 64), and at phase 13's training
           shapes (qwen2 8 x 1,024; olmo, llama3, zamba2, the seamless
           decoder, its encoder and cross-attention, grok and arctic at
           4 x 1,024).
13. train  LM training (``lm_training_phase``): ``python -m
           repro_torch.launch.train --arch qwen2_0_5b --steps 8 --batch 8
           --seq 1024 --ckpt-every 7`` through ``launch.train.main`` (the
           published CONFIG, 24 layers, f32 params, bf16 compute, remat
           "dots"), then ``--resume`` to step 12, which must continue at
           step 9; every step's loss finite; the flash kernel launched 48
           times a step (24 attention layers, twice under remat: the
           recompute runs the forward again); step ms (median after the
           first), tokens/s, peak memory and a profiled step's idle share.
           Then 5 steps under remat "none" at the same batch (step ms
           against "dots", peak memory, 24 flash launches a step, a
           profiled step's idle share and host ops). Then the kernel path against the plain path at the driver's
           params and first batch: one loss and gradient under
           ``impl="cuda"`` and one under ``impl="ref"`` (bf16 compute: loss
           within 2e-2 relative, gradient cosine >= 0.999; f32 compute:
           loss and gradient relative L2 within 1e-4), each with a control
           (the kernel path's gradient plus noise) that must fail. Then
           olmo_1b (16 layers), llama3_8b (2 of 32), mamba2 (48), zamba2
           (38), seamless (24 + 24), grok-1 (1 layer, 4 of 8 experts) and
           arctic (1 layer, 16 of 128 experts) at published width, 3 steps
           of 4 x 1,024 tokens each through ``make_train_step``, their flash
           launches a step, peak memory and the same kernel-vs-plain checks
           (MoE: routing flips only near ties; where the SSD scan runs in
           bf16, ROADMAP §C8, the kernel path's gradient no further from
           the f32 computation's than 1.5x the plain path's, and the f32
           computation's own kernel path within 1e-4 of its plain path).
14. mesh   the LMs on a mesh of gloo ranks sharing the card
           (``mesh_phase``).
15. dryrun the dry-run against the card (``dryrun_phase``): in a
           subprocess (its fake tensors never meet this process's), the
           one-card dry-run cells of phase 5's fused f32 DVNR
           step (8 PRODUCTION256 partitions x 65,536), phase 7's llama3_8b
           bf16 prefill (2 x 4,096) and phase 13's qwen2_0_5b driver step
           (8 x 1,024): model FLOPs, counted FLOPs and bytes, predicted
           peak bytes and the roofline step time on the H100's constants,
           beside each phase's measured time (the kernel route); then the
           predicted peak against the measured peak of the same plain
           route on the card (phase 7's plain prefill; the DVNR and qwen2
           steps run once here on ``impl="ref"``).

The unfused path's deterministic routes (the hash backward's int64
fixed-point scatter, the MLP backward's per-block dW rows summed in order)
are held in phase 2 (``unfused_det_checks``: the default route's
yardsticks, controls, two launches bit for bit, one partition alone equal
to its row), run two clean 128-step unfused runs bit for bit in phase 5
(``unfused_det_training``, f32 and bf16) and are timed in phase 6 beside
the default route.

Both deterministic routes sum the table gradient through one fixed-point
scatter (``csrc/hash_encode.cu``, each level's int64 slab in one block, a
cluster's, or direct, by a host plan): phase 1 holds the plan's Python
mirror against the C plan (``fx_plan_checks``) and its native shared adds
in the SASS (``fx_sass_checks``), phase 2 its sums bit for bit against the
design before it, the yardstick (``fx_yardstick_checks``,
``det_yardstick_equal``: every plan letter, f32 and bf16, one coarse cell,
ragged rows, PRODUCTION and ABLATION's levels, the train step's split
against its fused design), and phase 6 times each row beside the
yardstick in turns, the fused yardstick's stage clock and the hash
backward's levels one by one (``det_design_turns``, ``det_step_clock``,
``fx_level_times``). ``det_probe()`` runs those parts alone.

The deterministic route of the train step (``torch.use_deterministic_
algorithms(True)``; int64 fixed-point table gradient, per-group dW and loss
rows summed by AdamW in group order) is held wherever the default route is
in phase 2 (``check_step`` / ``check_step_bf16``: the same yardsticks, two
launches bit for bit, one partition alone bit for bit with its row of the
stacked launch), its AdamW bit for bit against the plain AdamW on the same
reduction, two clean 512-step runs bit for bit in phase 5 (f32 and bf16),
and timed beside the default route in phase 6.

Exits non-zero on any failure. The last line is
``{"ok": true, "device": {...}}``; the line before it is the per-kernel JSON.
Float32 products of the plain versions run in full float32
(``allow_tf32`` off for matmul and cuDNN).
"""
from __future__ import annotations

import atexit
import contextlib
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCRIPT_T0 = time.perf_counter()

# H100 SXM published peaks: HBM bytes/s, float32 FLOP/s outside the tensor
# cores (the DVNR kernels run float32 on the CUDA cores), and dense bf16
# tensor-core FLOP/s (the bound of bf16 attention)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
REPLACES = {
    "hash_encode": "src/repro/kernels/hash_encoding/kernel.py:62",
    "fused_mlp_fwd": "src/repro/kernels/fused_mlp/kernel.py:66",
    "composite": "src/repro/kernels/composite/kernel.py:51",
    "hash_encode_bwd": "src/repro/kernels/hash_encoding/ops.py:85",
    "fused_mlp_bwd": "src/repro/kernels/fused_mlp/kernel.py:88",
    "train_step": "src/repro/kernels/fused_train_step/kernel.py:364",
    "adamw_apply": "src/repro/kernels/fused_train_step/kernel.py:218",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:94",
    "inr_forward": "src/repro/kernels/hash_encoding/kernel.py:62 and "
                   "src/repro/kernels/fused_mlp/kernel.py:66",
}
# the bf16 policy's instantiations replace the same TPU kernels (which take
# the compute dtype and a master copy as options)
REPLACES.update({"fused_mlp_fwd_bf16": REPLACES["fused_mlp_fwd"],
                 "hash_encode_bwd_bf16": REPLACES["hash_encode_bwd"],
                 "fused_mlp_bwd_bf16": REPLACES["fused_mlp_bwd"],
                 "train_step_bf16": REPLACES["train_step"],
                 "adamw_apply_master": REPLACES["adamw_apply"],
                 "inr_forward_bf16": REPLACES["inr_forward"],
                 "train_step_v3": REPLACES["train_step"],
                 # the deterministic route (torch.use_deterministic_algorithms)
                 "train_step_det": REPLACES["train_step"],
                 "train_step_det_bf16": REPLACES["train_step"],
                 "adamw_det": REPLACES["adamw_apply"],
                 "adamw_det_master": REPLACES["adamw_apply"],
                 # the unfused backwards' deterministic routes
                 "hash_encode_bwd_det": REPLACES["hash_encode_bwd"],
                 "hash_encode_bwd_det_bf16": REPLACES["hash_encode_bwd"],
                 "fused_mlp_bwd_det": REPLACES["fused_mlp_bwd"],
                 "fused_mlp_bwd_det_bf16": REPLACES["fused_mlp_bwd"]})
# sizes of the run (the rehearsal on a CPU shrinks them)
DECODE_EDGE = 256          # phase 3: one 256^3 partition
LOCAL_EDGE = 256           # phase 4: 2x2x2 partitions of 256^3 each
IMAGE, SAMPLES, CLIENTS, TICKS = 256, 64, 2, 4
# phase 4b: the brick cache's decode grid a partition, brick edge, pool
# budget; warm cached ticks after the cold one
CACHE_EDGE, BRICK_EDGE, CACHE_BUDGET, CACHED_WARM_TICKS = 256, 16, 1 << 30, 3
CHECK_N = (100_003, 4_099)   # phase 2 coordinate rows (ragged)
DECODE_CHUNK = 1 << 22
TRAIN_EDGE = 256             # phases 2 and 5: 2x2x2 partitions of 256^3 each
TRAIN_STEPS, COMPARE_STEPS, PROFILE_STEPS = 512, 16, 16
#: phase 5's two clean runs of the unfused path's deterministic routes,
#: f32 and bf16: fewer steps than TRAIN_STEPS (17.8 ms a step: four runs of
#: 512 steps took 36 s of the script's time limit; 128 since the script
#: passed 850 s on a card whose host ran the unfused path at 12.9 ms a step)
DET_UNFUSED_STEPS = 128
DEVICE = "cuda"
# phase 2: flash attention against its plain version, (B, Sq, Sk, Hq, Hkv,
# dh, causal, window, dtype)
FLASH_CASES = (
    (2, 4096, 4096, 32, 8, 128, True, None, "bfloat16"),    # llama
    (2, 4096, 4096, 32, 8, 128, True, None, "float32"),
    (1, 4099, 4099, 32, 8, 128, True, None, "float32"),     # ragged S
    (1, 1000, 4099, 32, 8, 128, True, None, "bfloat16"),    # Sk > Sq, right-aligned
    (1, 1000, 4099, 32, 8, 128, True, None, "float32"),
    (1, 8192, 8192, 32, 8, 80, True, 4096, "bfloat16"),     # danube: dh=80, window
    (1, 8192, 8192, 32, 8, 80, True, 4096, "float32"),
    (2, 4096, 4096, 14, 2, 64, True, None, "bfloat16"),     # qwen2: g=7
    (2, 4096, 4096, 14, 2, 64, True, None, "float32"),
    (2, 2048, 2048, 16, 16, 128, False, None, "float32"),   # non-causal
    (2, 2048, 2048, 16, 16, 128, False, None, "bfloat16"),
    (2, 2048, 2048, 16, 4, 16, True, None, "bfloat16"),      # dh=16 (SMOKE)
    (1, 1500, 3001, 8, 8, 32, True, 512, "bfloat16"),        # dh=32, Sk > Sq, window
    # phase 12's shapes: the seamless encoder (non-causal, dh=64), its
    # decoder's cross-attention (Sq != Sk), grok (g=6), arctic (g=7) and
    # zamba2's shared block (32/32 heads of 64)
    (2, 4096, 4096, 16, 16, 64, False, None, "bfloat16"),
    (2, 4096, 4096, 16, 16, 64, False, None, "float32"),
    (2, 512, 4096, 16, 16, 64, False, None, "bfloat16"),
    (2, 512, 4096, 16, 16, 64, False, None, "float32"),
    (2, 4096, 4096, 48, 8, 128, True, None, "bfloat16"),
    (2, 4096, 4096, 56, 8, 128, True, None, "bfloat16"),
    (2, 4096, 4096, 32, 32, 64, True, None, "bfloat16"),
    # phase 13's training shapes: qwen2 (8 x 1,024), then 4 x 1,024 for
    # olmo, llama3, zamba2's shared block, the seamless decoder (causal) and
    # its encoder and cross-attention (non-causal, Sq = Sk), grok and arctic
    (8, 1024, 1024, 14, 2, 64, True, None, "bfloat16"),
    (4, 1024, 1024, 16, 16, 128, True, None, "bfloat16"),
    (4, 1024, 1024, 32, 8, 128, True, None, "bfloat16"),
    (4, 1024, 1024, 32, 32, 64, True, None, "bfloat16"),
    (4, 1024, 1024, 16, 16, 64, True, None, "bfloat16"),
    (4, 1024, 1024, 16, 16, 64, False, None, "bfloat16"),
    (4, 1024, 1024, 48, 8, 128, True, None, "bfloat16"),
    (4, 1024, 1024, 56, 8, 128, True, None, "bfloat16"),
)
#: the seamless encoder's case (row 8-nc of the kernels line)
ENCODER_CASE = (2, 4096, 4096, 16, 16, 64, False, None, "bfloat16")
#: each FLASH_CASES case's max abs error against the plain version (phase 2)
FLASH_CASE_ERRS: dict = {}
# phase 7: the LM. LM_CONFIG None means llama3_8b's published CONFIG (the
# rehearsal on a CPU hands in a SMOKE config)
LM_ARCH, LM_CONFIG = "llama3_8b", None
LM_BATCH, LM_PROMPT, LM_DECODE, LM_CHECK_LAYERS = 2, 4096, 32, 2
# phase 12: the MoE, SSM, hybrid, encoder-decoder and VLM families at
# published width: (arch, layers served (None: the published depth), layers of the
# float32 checks (None: checked in bf16 only)); FAMILY_CONFIGS maps an arch
# to the config to serve in the place of its published CONFIG (the
# rehearsal on a CPU hands in SMOKE configs); the MoE prefill-then-decode
# check's prompt (its capacity raised so that it does not bind: C >= S k)
FAMILY_MODELS = (("grok_1_314b", 4, 1), ("arctic_480b", 2, None),
                 ("mamba2_780m", None, 2), ("zamba2_1_2b", None, 7),
                 ("seamless_m4t_large_v2", None, 2), ("qwen2_vl_7b", 1, 1))
FAMILY_CONFIGS: dict = {}
FAMILY_FLASH = {"grok_1_314b": 4, "arctic_480b": 2, "zamba2_1_2b": 6,
                "seamless_m4t_large_v2": 24, "mamba2_780m": 0, "qwen2_vl_7b": 1}
FAMILY_MOE_CHECK_PROMPT = 1024
FAMILY_SEQ_STEPS = 4          # the encoder-decoder's teacher-forced steps
FAMILY_IMPL = "auto"          # the served path's backend ("auto": the card's)
# phase 13: LM training. The driver's run (``launch.train.main``) of
# TRAIN_LM_ARCH at its published CONFIG with TRAIN_LM_ARGS, then resumed
# to TRAIN_LM_RESUME; TRAIN_LM_EXTRA holds further driver flags (the
# rehearsal on a CPU: ``--smoke --device cpu --impl cuda``). Then each of
# TRAIN_FAMILIES, (arch, layers (None: the published depth), experts
# (None: the published count)), trains TRAIN_FAMILY_STEPS steps of
# TRAIN_FAMILY_BATCH x TRAIN_FAMILY_SEQ tokens through make_train_step;
# TRAIN_CONFIGS maps an arch to the config to train in the place of its
# published CONFIG (the rehearsal hands in SMOKE configs)
TRAIN_LM_ARCH = "qwen2_0_5b"
# (--ckpt-every divides neither --steps nor TRAIN_LM_RESUME, where the
# driver's final save would write that step a second time: steps 7, 8 and
# 12 are written, 7 asynchronously)
TRAIN_LM_ARGS = ("--steps", "8", "--batch", "8", "--seq", "1024", "--ckpt-every", "7")
TRAIN_LM_RESUME = 12
TRAIN_REMAT_NONE_STEPS = 4    # TRAIN_LM_ARCH's steps under remat "none"
TRAIN_LM_EXTRA: tuple = ()
TRAIN_FAMILIES = (("olmo_1b", None, None), ("llama3_8b", 2, None),
                  ("mamba2_780m", None, None), ("zamba2_1_2b", None, None),
                  ("seamless_m4t_large_v2", None, None), ("grok_1_314b", 1, 4),
                  ("arctic_480b", 1, 16), ("qwen2_vl_7b", 1, None))
TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ, TRAIN_FAMILY_STEPS = 4, 1024, 3
TRAIN_CONFIGS: dict = {}
TRAIN_IMPL = "auto"           # the trained path's backend ("auto": the card's)
# phase 14: the LMs on a mesh of MESH_WORLD gloo ranks sharing the card.
# (a) TRAIN_LM_ARCH through the driver, MESH_DRIVER_STEPS steps at
# TRAIN_LM_ARGS' batch and sequence, on make_mesh_for's (1, 4); (b)
# MESH_DENSE (arch, layers): on (1, 4) a MESH_SERVE (B, S, decode steps)
# prefill and decode, then on (2, 2) one train step of MESH_TRAIN's (B, S,
# steps) B x S; (c) each of MESH_MOE (arch, layers, experts): on (2, 2) a
# MESH_MOE_PROMPT (B, S) prefill at the config's capacity and, for
# expert-parallel experts, at one that does not bind, then one train step
# (expert-parallel experts at the capacity that does not bind, where a2a
# drops what the scatter drops: nothing). Each train run's first step
# holds its gradient against the one-rank run's. On (2, 2) the weights and
# AdamW state are cut over "data" too (the fsdp split), each layer's
# gathered over "data" at its use: the gloo wire carries 5-7 GB a rank a
# step (30-60 s), hence so few.
# (d) each of MESH_FAMILIES (arch, config changes: the depth cut), the SSM,
# hybrid, encoder-decoder and VLM families at published width: on (1, 4) a
# MESH_FAMILY_SERVE (B, S, decode steps) prefill and decode against the
# one-rank path's logits, then on (2, 2) one train step of MESH_TRAIN's
# B x S, its gradient and loss held against the one-rank run's; MESH_UPDATE
# takes MESH_TRAIN's steps instead, held to phase 13's losses: the second
# checks an AdamW update of the fsdp blocks (on the cheapest step of those
# phase 13 trained at the same config).
# MESH_CONFIGS maps an arch to the config in the place of its published
# CONFIG (the rehearsal on a CPU hands in SMOKE configs).
MESH_WORLD = 4
MESH_DRIVER_STEPS = 2
MESH_DENSE = ("llama3_8b", 2)
MESH_SERVE = (2, 4096, 8)
MESH_TRAIN = (4, 1024, 2)
MESH_MOE = (("grok_1_314b", 1, 4), ("arctic_480b", 1, 16))
MESH_MOE_PROMPT = (4, 1024)
MESH_FAMILIES = (("mamba2_780m", {"n_layers": 2}), ("zamba2_1_2b", {"n_layers": 7}),
                 ("seamless_m4t_large_v2", {"n_layers": 1, "encoder_layers": 1}),
                 ("qwen2_vl_7b", {"n_layers": 1}))
MESH_UPDATE = "qwen2_vl_7b"
MESH_FAMILY_SERVE = (2, 1024, 2)
MESH_CONFIGS: dict = {}
#: phase 14's yardsticks: bf16 losses against the one-rank run's (relative),
#: and the cosine of gradients and logits against the one-rank path's
MESH_LOSS_RTOL, MESH_COS = 2e-2, 0.999
#: the one-rank runs phase 13 leaves for phase 14: each path's losses
PHASE13: dict = {}
#: what phases 5, 7 and 13 measured for phase 15's dry-run cells: each
#: cell's time (ms) and where the script ran its plain route, that route's
#: peak memory (bytes: its inputs and what it allocated)
DRYRUN_MEASURED: dict = {}
# phase 8: the in situ session's rank edge (8 ranks: the 2x2x2 split of a
# 512^3 volume), cycles and window; the shock trigger (the share of voxels
# above SHOCK_LEVEL: ~0.024 at cycle 4 and ~0.028 at cycle 5 of a 512^3
# CloverLeaf at dt 0.03); the isosurface's vertex grid a partition; the
# pathline study's ranks, seeds and steps a model; the backend ("auto":
# the card's kernels)
INSITU_EDGE, INSITU_CYCLES, INSITU_WINDOW = 256, 8, 4
SHOCK_LEVEL, SHOCK_FRAC = 3.0, 0.026
ISO_RES = 128
PATH_RANKS, PATH_SEEDS, PATH_STEPS = 4, 4096, 512
INSITU_IMPL = "auto"
# phase 9: DVNR across ranks: the ranks (one partition each of the 2x2x2
# split), the steps and the step of the checkpoint, the survivors of the
# elastic restart, and a limit on each group of ranks (init and join)
DIST_RANKS, DIST_STEPS, DIST_SAVE_AT, DIST_SURVIVORS = 8, 512, 256, 5
DIST_TIMEOUT_S = 600
# phase 2: the MLP backward's further cases, (label, P, part, N, D_in, W,
# H, D_out)
MLP_BWD_CASES = (
    ("N=30,011", 4, [0, 1, 2, 3, 0, 1], 30_011, 20, 16, 2, 1),
    ("H=1 (CLOVERLEAF_CACHE)", 4, [0, 1, 2, 3], 65_536, 16, 16, 1, 1),
    ("H=3 (NEKRS)", 4, [0, 1, 2, 3], 65_536, 20, 16, 3, 1),
    ("W=32", 4, [0, 1, 2, 3], 65_536, 20, 32, 2, 1),
    ("W=64 D_in=80 H=3 (ABLATION)", 2, [0, 1], 65_536, 80, 64, 3, 1),
    ("D_out=3", 4, [0, 1, 2, 3], 40_009, 20, 16, 2, 3),
    ("permuted part, P=5", 5, [4, 0, 3, 3, 1, 2], 20_011, 20, 16, 2, 1),
    ("D_in=5 (odd: 4- and 2-byte copies)", 4, [0, 1, 2, 3], 30_011, 5, 16, 2, 1),
)

SOURCES = {
    "hash_encode": "src/repro_torch/csrc/hash_encode.cu",
    "fused_mlp_fwd": "src/repro_torch/csrc/fused_mlp.cu",
    "composite": "src/repro_torch/csrc/composite.cu",
    "hash_encode_bwd": "src/repro_torch/csrc/hash_encode.cu",
    "fused_mlp_bwd": "src/repro_torch/csrc/fused_mlp.cu",
    "train_step": "src/repro_torch/csrc/train_step.cuh",
    "adamw_apply": "src/repro_torch/csrc/adamw.cu",
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "fused_mlp_fwd_bf16": "src/repro_torch/csrc/fused_mlp.cu",
    "hash_encode_bwd_bf16": "src/repro_torch/csrc/hash_encode.cu",
    "fused_mlp_bwd_bf16": "src/repro_torch/csrc/fused_mlp.cu",
    "train_step_bf16": "src/repro_torch/csrc/train_step_bf16_sampling.cu",
    "adamw_apply_master": "src/repro_torch/csrc/adamw.cu",
    "inr_forward": "src/repro_torch/csrc/inr_forward.cuh",
    "inr_forward_bf16": "src/repro_torch/csrc/inr_forward_bf16.cu",
    "train_step_v3": "src/repro_torch/csrc/train_step.cuh",
    "train_step_det": "src/repro_torch/csrc/train_step_det_sampling.cu",
    "train_step_det_bf16": "src/repro_torch/csrc/train_step_det_bf16_sampling.cu",
    "adamw_det": "src/repro_torch/csrc/adamw.cu",
    "adamw_det_master": "src/repro_torch/csrc/adamw.cu",
    "hash_encode_bwd_det": "src/repro_torch/csrc/hash_encode.cu",
    "hash_encode_bwd_det_bf16": "src/repro_torch/csrc/hash_encode.cu",
    "fused_mlp_bwd_det": "src/repro_torch/csrc/fused_mlp.cu",
    "fused_mlp_bwd_det_bf16": "src/repro_torch/csrc/fused_mlp.cu",
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


#: the kernels whose SASS phase 1 counts (a substring of the mangled name)
#: and the instructions counted in each
SASS_COUNTS = {"flash_attention_kernel_bf16": ("HGMMA", "UTMALDG", "LDGSTS"),
               "fused_mlp_fwd_kernel": ("HMMA",),
               "fused_mlp_bwd_kernel": ("HMMA", "LDGSTS"),
               "inr_forward_kernel": ("HMMA", "UBLKCP"),
               "inr_forward_grid_kernel": ("HMMA",)}


def sass_counts(lib_path):
    """Start ``cuobjdump -sass`` of the built library in the background (its
    listing into ``build/``; it takes most of a minute, which the phases
    after the build overlap) and return a function that waits for it and
    gives, per instantiation of the kernels of ``SASS_COUNTS``, the count
    of its instructions in its SASS: HGMMA (wgmma), HMMA (mma.sync),
    UTMALDG (TMA), LDGSTS (cp.async), UBLKCP (bulk copies)."""
    import re
    from repro_torch.kernels import build
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    listing = Path(lib_path).with_suffix(".sass")
    t0 = time.perf_counter()
    with open(listing, "w") as f:
        proc = subprocess.Popen([str(cuobjdump), "-sass", str(lib_path)], stdout=f,
                                stderr=subprocess.PIPE, text=True)
    atexit.register(proc.kill)        # a phase that fails first leaves none behind

    def counts() -> dict:
        try:
            _, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise SmokeFailure("cuobjdump -sass ran past 300 s")
        if proc.returncode:
            raise SmokeFailure(f"cuobjdump failed: {err.strip()[:500]}")
        waited = time.perf_counter() - t0
        out, cur, atoms = {}, None, None
        with open(listing) as f:
            for line in f:
                if "Function : " in line:
                    name = re.search(r"Function : (\S+)", line).group(1)
                    ops = [o for k, o in SASS_COUNTS.items() if k in name]
                    cur = None
                    if ops:
                        cur = out[name] = dict.fromkeys(ops[0], 0)
                    atoms = None
                    if any(k in name for k in FX_SASS_KERNELS):
                        atoms = SASS_ATOMICS[name] = {}
                elif cur is not None or atoms is not None:
                    for op in cur or ():
                        if op in line and re.search(rf"\b{op}\b", line):
                            cur[op] += 1
                    if atoms is not None:
                        for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|REDS|RED)"
                                             r"\.[A-Z0-9_.]+)", line):
                            atoms[op] = atoms.get(op, 0) + 1
        listing.unlink()
        print(f"  cuobjdump -sass of the library: {waited:.1f} s after its start, "
              f"parsed in {time.perf_counter() - t0 - waited:.1f} s")
        return out

    return counts


def sass_checks(sass) -> None:
    """Phase 1's checks of the library's SASS (``sass_counts``' function,
    called once phase 5 is done): every bf16 flash kernel on HGMMA, every
    bf16 MLP forward and INR inference instantiation on HMMA, every INR
    inference instantiation with bulk copies (UBLKCP: it can stage levels),
    every MLP backward one on HMMA and LDGSTS (its rows staged with
    cp.async)."""
    sass = sass()
    for fn, c in sorted(sass.items()):
        print(f"  SASS {fn}: {c}")
    flash = [c for fn, c in sass.items() if "flash_attention_kernel_bf16" in fn]
    if not flash or any(c["HGMMA"] == 0 for c in flash):
        raise SmokeFailure(f"bf16 flash kernels without HGMMA: {sass}")
    for kernel in ("fused_mlp_fwd_kernel", "inr_forward_kernel"):
        bf16 = [c["HMMA"] for fn, c in sass.items()
                if kernel in fn and "bfloat16" in fn]
        if not bf16 or min(bf16) == 0:
            raise SmokeFailure(f"bf16 {kernel} instantiations without HMMA: {bf16}")
    inr = [c["UBLKCP"] for fn, c in sass.items() if "inr_forward_kernel" in fn]
    if len(inr) != 26 or min(inr) == 0:
        raise SmokeFailure(f"inr_forward_kernel instantiations without UBLKCP: {inr}")
    bwd = {fn: c for fn, c in sass.items()
           if "fused_mlp_bwd_kernel" in fn and "StageClock" not in fn}
    if len(bwd) != 6 or any(c["HMMA"] == 0 or c["LDGSTS"] == 0 for c in bwd.values()):
        raise SmokeFailure(f"fused_mlp_bwd_kernel instantiations without HMMA or "
                           f"LDGSTS: {bwd}")


#: phase 1's ptxas reading of each entry function: mangled name ->
#: {"registers", "spill", "static_smem", "stack"} (phase 10 holds the
#: library's cudaFuncGetAttributes against it)
PTXAS = {}


def ptxas_usage(log: str) -> list:
    """(kernel, registers, spill-store bytes, spill-load bytes, static
    shared bytes, stack-frame bytes) of each entry function in ``nvcc
    -Xptxas -v``'s output; empty when the library came from an earlier
    build."""
    import re
    rows, cur, spill, stack = [], None, (0, 0), 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            stack, spill = int(m.group(1)), (int(m.group(2)), int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((cur, int(m.group(1)), *spill,
                         int(smem.group(1)) if smem else 0, stack))
            cur, spill, stack = None, (0, 0), 0
    return rows


def check(name, got, want, *, atol, rtol=0.0, slack=None):
    """Elementwise |got - want| <= atol + rtol * |want| (+ slack, a tensor
    of per-element allowances, where given), compared in f32."""
    import torch
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise SmokeFailure(f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise SmokeFailure(f"{name}: non-finite output")
    err = (g - w).abs()
    allowed = atol + rtol * w.abs()
    if slack is not None:
        allowed = allowed + slack
    worst = float((err - allowed).max())
    max_err = float(err.max())
    extra = "" if slack is None else (
        f" +slack (max {float(slack.max()):.1e}; "
        f"{int((err > allowed - slack).sum()):,} elements need it)")
    print(f"  {name:<44s} max_abs_err={max_err:.3e}  tol: atol={atol:.1e} "
          f"rtol={rtol:.1e}{extra}  {'ok' if worst <= 0 else 'FAIL'}")
    if worst > 0:
        raise SmokeFailure(f"{name}: max abs err {max_err:.3e} over tolerance")
    return max_err


#: the phases begun so far: (name, host clock at its header)
PHASE_CLOCK: list = []


def phase_header(text: str) -> None:
    """Print a phase's header line, after the wall time of the phase before
    it (host clock)."""
    now = time.perf_counter()
    if PHASE_CLOCK:
        name, t = PHASE_CLOCK[-1]
        print(f"  {name}: {now - t:.1f} s of wall time")
    PHASE_CLOCK.append((text.removeprefix("== ").split(":")[0], now))
    print(text)


def phase_times() -> str:
    """Each phase's wall time, from its header to the next one's (the last:
    to now), and their sum, in seconds."""
    now = time.perf_counter()
    ends = [t for _, t in PHASE_CLOCK[1:]] + [now]
    parts = [f"{name} {end - t:.1f}" for (name, t), end in zip(PHASE_CLOCK, ends)]
    return "; ".join(parts) + f"; the script in all {now - SCRIPT_T0:.1f} s"

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
    """Run ``tick()`` (a serving tick, a training chunk) under
    torch.profiler: (device busy ms, [(kernel name, (ms, count))] by time,
    host wall ms, [(host op, (own CPU ms, count))] by time: PyTorch's ops and
    the CUDA runtime calls, which keep the device waiting while the host is
    the slower side); busy is None when the profiler saw no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tick()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels, host = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and \
                e.self_device_time_total > 0:
            kernels[e.key] = (e.self_device_time_total / 1e3, e.count)
        elif e.device_type == torch.autograd.DeviceType.CPU and e.self_cpu_time_total > 0:
            host[e.key] = (e.self_cpu_time_total / 1e3, e.count)
    busy = sum(ms for ms, _ in kernels.values())
    by_time = lambda d: sorted(d.items(), key=lambda kv: -kv[1][0])
    return (busy or None), by_time(kernels), wall, by_time(host)


def launch_times(fn, symbol: str, reps: int = 3):
    """Device ms of each kernel launch whose name holds ``symbol`` in one
    call of ``fn``, in launch order, averaged over ``reps`` calls under
    torch.profiler; None when the profiler saw no such launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = [e.device_time_total / 1e3 for e in prof.events() if symbol in e.name]
    if not ms or len(ms) % reps:
        return None
    n = len(ms) // reps
    return [sum(ms[i::n]) / reps for i in range(n)]


def kernel_alone_ms(fn, symbol, calls: int = 5):
    """Device ms a call of the kernels whose profiler key holds ``symbol``
    (or one of a tuple of symbols: a call's several kernels), over
    ``calls`` calls of ``fn`` profiled together (``profile_tick``); None
    when the profiler saw no such kernel."""
    symbols = (symbol,) if isinstance(symbol, str) else tuple(symbol)
    fn()
    # a profile that recorded no launch of the symbol at all is taken
    # again, twice at most
    for _ in range(3):
        _, by_kernel, _, _ = profile_tick(lambda: [fn() for _ in range(calls)])
        t = [ms for key, (ms, _) in by_kernel if any(s in key for s in symbols)]
        if t:
            break
    if not t:
        print(f"    (no profiled kernel holds {symbols}; the keys: "
              f"{[key[:80] for key, _ in by_kernel[:6]]})")
    return sum(t) / calls if t else None


def per_launch_ms(fn, symbol: str, calls: int = 5):
    """Device ms a launch of the kernels whose profiler key holds
    ``symbol``, over ``calls`` calls of ``fn`` profiled together: their
    device time over the launches the profiler counted (it may record
    fewer than were made); (None, 0) when it counted none, else (ms,
    launches counted)."""
    fn()
    for _ in range(3):
        _, by_kernel, _, _ = profile_tick(lambda: [fn() for _ in range(calls)])
        hits = [(ms, n) for key, (ms, n) in by_kernel if symbol in key]
        if hits:
            n = sum(c for _, c in hits)
            return sum(ms for ms, _ in hits) / n, n
    return None, 0


def kernels_alone_ms(fn, counts, calls: int = 5):
    """Device ms a call of ``fn``'s kernels, from one profile of ``calls``
    calls: for each ``(symbol, launches a call)`` of ``counts``, the device
    time a launch of the kernels whose name holds the symbol (their time
    over the launches the profiler recorded, as ``per_launch_ms``, so a
    launch it drops biases nothing) times the launches a call; None when a
    symbol matched no launch in three profiles."""
    fn()
    for _ in range(3):
        _, by_kernel, _, _ = profile_tick(lambda: [fn() for _ in range(calls)])
        per = []
        for symbol, n in counts:
            hits = [(ms, c) for key, (ms, c) in by_kernel if symbol in key]
            if not hits:
                break
            per.append(sum(ms for ms, _ in hits) / sum(c for _, c in hits) * n)
        if len(per) == len(counts):
            return sum(per)
    print(f"    (no profiled kernel holds one of {[s for s, _ in counts]})")
    return None


def bound_ms(nbytes: float, flops: float, peak_flops: float = F32_FLOPS,
             bf16_flops: float = 0.0):
    """The least time the card could take: each input read once, each output
    written once at the HBM rate, or the operations at the peak rate of
    their type: ``flops`` at ``peak_flops`` (f32 unless said), plus
    ``bf16_flops``, products of bf16 operands summed in f32, at the bf16
    tensor-core peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / peak_flops + bf16_flops / BF16_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """Live (query, key) pairs of one head under the masks: the work the
    kernel must do (right-aligned positions, as the kernel)."""
    import numpy as np
    q_pos = (Sk - Sq) + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q_pos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(q_pos - window + 1, 0) if window is not None else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def p_deviation(kernel_p, tiled_probabilities, got, q, k, v, tiled_kw) -> float:
    """The largest relative departure of the bf16 flash kernel's float32 p
    (before its bf16 rounding) from ``tiled_probabilities``', over batch 0,
    q head 0 and the rows of the last 128-row q tile: |p_k - p_y| /
    max(p_y, 2^-120) (p below 2^-120 is flushed or moves no output). The
    check instantiation must also give the wrapper's output bit for bit,
    and must write every p the yardstick has above 0."""
    import torch
    out, pk = kernel_p(q, k, v, tiled_kw["causal"], tiled_kw["window"])
    if not torch.equal(out, got):
        raise SmokeFailure("the flash kernel's check instantiation gives "
                           "another output than the kernel")
    py = tiled_probabilities(q[:1, :, :1].float(), k[:1, :, :1].float(),
                             v[:1, :, :1].float(), **tiled_kw)[0, :, 0]
    py = py[py.shape[0] - pk.shape[0]:]
    live = torch.isfinite(py)
    if bool((live & torch.isnan(pk) & (py > 0)).any()):
        raise SmokeFailure("the flash kernel skipped keys the yardstick weighs")
    both = live & torch.isfinite(pk)
    rel = (pk[both] - py[both]).abs() / py[both].clamp_min(2.0 ** -120)
    return float(rel.max()) if rel.numel() else 0.0


def flash_checks(dev) -> float:
    """Phase 2's flash-attention checks (FLASH_CASES); returns the error at
    the first case, the LM phase's shapes and dtype."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (
        KERNEL_BLOCK_K, flash_attention_bf16_p, flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref, attention_tiled_ref, p_rounding_slack,
        tiled_probabilities)

    gen = torch.Generator(device=dev).manual_seed(13)
    errs = []
    for B, Sq, Sk, Hq, Hkv, dh, causal, window, dt in FLASH_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn((B, Sq, Hq, dh), generator=gen, device=dev).to(dtype)
        k = torch.randn((B, Sk, Hkv, dh), generator=gen, device=dev).to(dtype)
        v = torch.randn((B, Sk, Hkv, dh), generator=gen, device=dev).to(dtype)
        label = (f"flash_attention {dt} B={B} Sq={Sq} Sk={Sk} H={Hq}/{Hkv} "
                 f"dh={dh} {'causal' if causal else 'full'}"
                 f"{'' if window is None else f' window={window}'}")
        got = flash_attention_cuda(q, k, v, causal, window)
        want = attention_ref(q, k, v, causal=causal, window=window)
        if dtype == torch.float32:   # JAX's tolerance: online vs two-pass
            errs.append(check(label, got, want, atol=2e-5, rtol=2e-5))
        else:   # the plain version rounds scores and p to bf16, the kernel
            # p only (JAX's tolerance)
            errs.append(check(label, got, want, atol=3e-2))
            # tightly, within one bf16 rounding of the output: the kernel's
            # tile schedule in f32 on the same bf16 values, p computed and
            # rounded to bf16 as the kernel does; a p within 2^-16 of a bf16
            # tie may round either way (the kernel's scores are summed in
            # another order), which p_rounding_slack allows for, element by
            # element. That width is measured first: the kernel's own float32
            # p (batch 0, head 0, the last q tile, from its check
            # instantiation) against the yardstick's
            tiled_kw = dict(causal=causal, window=window, block_k=KERNEL_BLOCK_K)
            dev_p = p_deviation(flash_attention_bf16_p, tiled_probabilities,
                                got, q, k, v, tiled_kw)
            print(f"  {label + ' p vs tiled (rel)':<44s} max={dev_p:.3e}  "
                  f"slack width 2^-16={2.0 ** -16:.3e}  "
                  f"{'ok' if dev_p <= 2.0 ** -16 else 'FAIL'}")
            if not dev_p <= 2.0 ** -16:
                raise SmokeFailure(f"{label}: the kernel's p lies {dev_p:.3e} "
                                   "from the yardstick's, beyond the slack's 2^-16")
            want = attention_tiled_ref(q.float(), k.float(), v.float(),
                                       p_dtype=torch.bfloat16, **tiled_kw)
            slack = p_rounding_slack(q.float(), k.float(), v.float(), **tiled_kw)
            check(f"{label} vs tiled, p bf16", got, want, atol=1e-5, rtol=8e-3,
                  slack=slack)
            del slack
            # and the f32 plain version, row by row (relative L2 error)
            want = attention_ref(q.float(), k.float(), v.float(),
                                 causal=causal, window=window)
            rel = float(((got.float() - want).norm(dim=-1)
                         / want.norm(dim=-1).clamp_min(1e-30)).max())
            print(f"  {label + ' vs f32 (row rel L2)':<44s} max={rel:.3e}  "
                  f"limit 1.0e-02  {'ok' if rel <= 1e-2 else 'FAIL'}")
            if not rel <= 1e-2:
                raise SmokeFailure(f"{label}: row relative L2 error {rel:.3e} "
                                   "against the f32 plain version")
        FLASH_CASE_ERRS[(B, Sq, Sk, Hq, Hkv, dh, causal, window, dt)] = errs[-1]
        del q, k, v, got, want
    torch.cuda.synchronize()
    return errs[0]


def lm_phase(tag: str, dev, flash_err: float) -> dict:
    """Phase 7: serve the dense LM at full width and depth; returns the
    flash kernel's row of the kernels line."""
    import numpy as np
    import torch
    import torch.nn.functional as tF
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import tree_leaves

    cfg = LM_CONFIG or get_config(LM_ARCH)
    dh = cfg.resolved_head_dim
    cut = SHAPES["prefill_32k"]
    B, S, n_dec = LM_BATCH, LM_PROMPT, LM_DECODE
    seq_len = S + n_dec
    phase_header(f"== phase 7: LM serving, {cfg.name}: {cfg.n_layers} layers, "
          f"d={cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {dh}, "
          f"d_ff={cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_count():,} "
          f"{cfg.param_dtype} params, {cfg.compute_dtype} compute")
    print(f"  cut: {cut.name} (B={cut.global_batch}, S={cut.seq_len}) -> "
          f"B={B} x S={S} prompt tokens + {n_dec} greedy decode steps, "
          f"seq_len {seq_len} (the time limit); width and depth not cut")
    # the prompt: uniform token ids from the seed (make_lm_batch's Zipf
    # sampler gives every token vocab-1, ROADMAP §C, which would leave a
    # misplaced cache slot unseen)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    prompt = {"tokens": tokens[:, :S]}
    model = build_model(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"  init on the card: {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")

    def greedy(logits):
        return logits[:, -1].argmax(-1, keepdim=True)

    # warm-up (cuBLAS handles, the allocator's pools), then the main run
    logits, cache = model.prefill(params, prompt, seq_len, impl="cuda")
    model.decode_step(params, cache, greedy(logits))
    del logits, cache
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, prompt, seq_len, impl="cuda")
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = flash_attention_cuda.launches
    finite = torch.isfinite(logits).all()
    tok = greedy(logits)
    t0 = time.perf_counter()
    for _ in range(n_dec):
        step_logits, cache = model.decode_step(params, cache, tok)
        finite &= torch.isfinite(step_logits).all()
        tok = greedy(step_logits)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / n_dec
    launches = flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    print(f"  flash kernel launches: {prefill_launches} in the prefill, "
          f"{launches - prefill_launches} in {n_dec} decode steps")
    if prefill_launches != cfg.n_layers or launches != prefill_launches:
        raise SmokeFailure(f"flash launches: {prefill_launches} per prefill "
                           f"(want {cfg.n_layers}), {launches - prefill_launches} "
                           f"in the decode steps (want 0)")
    if not bool(finite) or int(cache["pos"]) != seq_len:
        raise SmokeFailure(f"serving run: logits finite {bool(finite)}, cache "
                           f"pos {int(cache['pos'])} (want {seq_len})")
    print(f"  prefill {B}x{S}: {prefill_ms:.2f} ms, {B * S / prefill_ms * 1e3:.1f} "
          f"prompt tokens/s; decode {decode_ms:.3f} ms per step ({B} "
          f"sequences, host clock, synchronised) [{tag}]")
    print(f"  peak memory {peak / 2**30:.3f} GiB (max_memory_allocated over the "
          f"run; {base_mem / 2**30:.3f} GiB resident before it) [{tag}]")

    # (c) full depth, bf16: the kernel path against the plain path (its
    # peak memory for phase 15: the weights plus what the call allocates)
    torch.cuda.synchronize()
    plain_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ref_logits, ref_cache = model.prefill(params, prompt, seq_len, impl="ref")
    torch.cuda.synchronize()
    DRYRUN_MEASURED["llama_prefill"] = {
        "ms": prefill_ms, "B": B, "S": S, "arch": LM_ARCH,
        "what": f"phase 7, prefill {B}x{S} (impl='cuda'), host clock",
        "plain_peak": torch.cuda.max_memory_allocated() - plain_base
        + sum(t.numel() * t.element_size() for t in tree_leaves(params)),
        "plain_route": f"phase 7's prefill(impl='ref'), {B}x{S}, seq_len {seq_len}"}
    a, b = logits[:, -1].float(), ref_logits[:, -1].float()
    cos = float(tF.cosine_similarity(a, b, dim=-1).min())
    ok = bool(torch.isfinite(b).all()) and cos >= 0.999
    print(f"  full depth {cfg.compute_dtype}: last-token logits, kernel vs plain "
          f"path: min cosine {cos:.6f} (limit 0.999), max abs diff "
          f"{float((a - b).abs().max()):.4e} of max |logit| "
          f"{float(b.abs().max()):.4f}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"full-depth kernel vs plain path: cosine {cos}")

    # where a prefill's and a decode step's time go
    prefill_kernel_ms = None
    for label, fn in (("prefill", lambda: model.prefill(params, prompt, seq_len,
                                                        impl="cuda")),
                      ("decode step", lambda: model.decode_step(
                          params, ref_cache, greedy(ref_logits)))):
        torch.cuda.synchronize()
        busy, by_kernel, wall, _ = profile_tick(fn)
        if busy is None:
            print(f"  profiled {label}: no device time recorded (not measured) [{tag}]")
            continue
        print(f"  profiled {label}: {wall:.2f} ms host clock, device busy "
              f"{busy:.2f} ms, idle share {1 - busy / wall:.3f} [{tag}]")
        for name, (ms, n) in by_kernel[:8]:
            print(f"    {ms:9.3f} ms  x{n:<4d} {name[:90]}")
        if label == "prefill":   # the kernel's own time on the main path
            fl = [(ms, n) for name, (ms, n) in by_kernel
                  if "flash_attention_kernel" in name]
            if fl:
                prefill_kernel_ms = sum(m for m, _ in fl) / sum(n for _, n in fl)
    del params, cache, logits, ref_logits, ref_cache, step_logits
    torch.cuda.empty_cache()

    # (a), (b): the same width at depth LM_CHECK_LAYERS in float32
    cfg2 = cfg.replace(n_layers=LM_CHECK_LAYERS, compute_dtype="float32")
    m2 = build_model(cfg2)
    p2 = m2.init(torch.Generator(device=dev).manual_seed(1))
    lk, c2 = m2.prefill(p2, prompt, seq_len, impl="cuda")
    lp, _ = m2.prefill(p2, prompt, seq_len, impl="ref")
    check(f"depth {LM_CHECK_LAYERS} f32: kernel vs plain path", lk, lp,
          atol=1e-4 * float(lp.abs().max()))
    ld, _ = m2.decode_step(p2, c2, tokens[:, S:S + 1])
    lt, _ = m2.prefill(p2, {"tokens": tokens}, seq_len, impl="cuda")
    check(f"depth {LM_CHECK_LAYERS} f32: prefill(S)+decode(1) vs prefill(S+1)",
          ld, lt, atol=1e-4 * float(lt.abs().max()))
    del m2, p2, lk, c2, lp, ld, lt
    torch.cuda.empty_cache()

    # the kernel's row, at the prefill's shapes
    cdt = getattr(torch, cfg.compute_dtype)
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((B, S, cfg.n_heads, dh), generator=gen, device=dev).to(cdt)
    k = torch.randn((B, S, cfg.n_kv_heads, dh), generator=gen, device=dev).to(cdt)
    v = torch.randn((B, S, cfg.n_kv_heads, dh), generator=gen, device=dev).to(cdt)
    W = cfg.sliding_window
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))

    def kern():
        return flash_attention_cuda(q, k, v, True, W)

    def plain():
        return attention_ref(q, k, v, causal=True, window=W)

    def library():   # yardstick only: the port never calls it
        return tF.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)

    lib_fn = library if W is None else None   # SDPA has no sliding window
    if lib_fn is not None:
        check("SDPA yardstick vs plain (same function)",
              lib_fn().transpose(1, 2), plain(), atol=3e-2)
    ms = cuda_ms(kern, reps=5)
    pms = cuda_ms(plain, reps=3)
    lms = cuda_ms(lib_fn, reps=10) if lib_fn is not None else None
    pairs = flash_pairs(S, S, True, W)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * B * cfg.n_heads * dh * pairs
    bms, by = bound_ms(nbytes, flops, BF16_FLOPS if cdt == torch.bfloat16 else F32_FLOPS)
    print(f"  flash_attention {ms:9.3f} ms  bound {bms:8.3f} ms ({by}; "
          f"{pairs:,} live pairs per head)  plain {pms:9.3f} ms  SDPA "
          f"{'-' if lms is None else f'{lms:.3f} ms'}  launches/prefill "
          f"{prefill_launches}  kernel alone "
          f"{'not measured' if prefill_kernel_ms is None else f'{prefill_kernel_ms:.4f} ms'}"
          f" per launch in the profiled prefill (profiler) [{tag}]")
    if prefill_kernel_ms is not None:
        print(f"  attention kernels: {prefill_kernel_ms * prefill_launches:.1f} ms "
              f"of the {prefill_ms:.1f} ms prefill "
              f"({prefill_kernel_ms * prefill_launches / prefill_ms:.1%}) [{tag}]")
    # the f32 inputs' CUDA-core kernel at the same shapes (not on this path:
    # the model computes in bf16), with SDPA in f32 as its yardstick
    q32, k32, v32 = q.float(), k.float(), v.float()
    qt32, kt32, vt32 = qt.float(), kt.float(), vt.float()
    kern32 = lambda: flash_attention_cuda(q32, k32, v32, True, W)
    ms32 = cuda_ms(kern32, reps=3)
    pms32 = cuda_ms(lambda: attention_ref(q32, k32, v32, causal=True, window=W),
                    reps=2)
    lms32 = (cuda_ms(lambda: tF.scaled_dot_product_attention(
        qt32, kt32, vt32, is_causal=True, enable_gqa=True), reps=3)
        if W is None else None)
    # the kernel's own device time: one profiled call (torch.profiler's
    # key_averages, as the prefill's profile above)
    _, prof32, _, _ = profile_tick(kern32)
    k32 = [(t, n) for name, (t, n) in prof32 if "flash_attention_kernel" in name]
    k32ms = sum(t for t, _ in k32) / sum(n for _, n in k32) if k32 else None
    bms32, by32 = bound_ms((2 * q.numel() + k.numel() + v.numel()) * 4, flops,
                           F32_FLOPS)
    print(f"  flash_attention f32 (CUDA-core kernel) {ms32:.3f} ms  bound "
          f"{bms32:.3f} ms ({by32})  plain {pms32:.3f} ms  SDPA f32 "
          f"{'-' if lms32 is None else f'{lms32:.3f} ms'}  kernel alone "
          f"{'not measured' if k32ms is None else f'{k32ms:.4f} ms'} "
          f"(profiler) [{tag}]")
    del q32, k32, v32, qt32, kt32, vt32
    return {"name": "flash_attention", "route": "cuda",
            "source": SOURCES["flash_attention"],
            "replaces": REPLACES["flash_attention"], "launches": launches,
            "max_abs_err": flash_err, "ms": ms, "plain_ms": pms,
            "bound_ms": bms, "bound_by": by, "library_ms": lms}


# --------------------------------------------------------------------------- #
# phase 12: the MoE, SSM, hybrid, encoder-decoder and VLM families
# --------------------------------------------------------------------------- #
def family_config(arch, layers):
    """The config phase 12 serves: the published CONFIG (FAMILY_CONFIGS'
    stand-in where given) at ``layers`` (None: not cut)."""
    from repro_torch.configs import get_config
    cfg = FAMILY_CONFIGS.get(arch) or get_config(arch)
    return cfg if layers is None else cfg.replace(n_layers=layers)


def flash_launches_of(cfg) -> int:
    """Attention layers whose prefill reaches the flash kernel."""
    from repro_torch.models.hybrid import group_structure
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return group_structure(cfg)[0]
    if cfg.family == "encdec":
        return cfg.encoder_layers
    return cfg.n_layers


def family_inputs(cfg, dev, B, S, seed=0, extra=FAMILY_SEQ_STEPS + 1):
    """The prompt a family's prefill takes: uniform token ids, or for the
    encoder-decoder N(0,1) source embeddings and a uniform first target
    token, or for the VLM N(0,1) embeddings and uniform M-RoPE positions
    (3, B, S) in [0, S); and (B, S + extra) uniform ids whose first S the
    prompt holds (the rest: teacher forcing, the decode steps' tokens)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S + extra)).astype(np.int32)
    if cfg.family in ("encdec", "vlm"):
        gen = torch.Generator(device=dev).manual_seed(seed)
        src = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
        if cfg.family == "encdec":
            return {"src_embeds": src, "tgt_tokens": tokens[:, :1]}, tokens
        pos = torch.as_tensor(rng.integers(0, S, (3, B, S)).astype(np.int32), device=dev)
        return {"embeds": src, "positions": pos}, tokens
    return {"tokens": tokens[:, :S]}, tokens


class RouteLog:
    """Records each MoE layer's routing (ids (T,k), router probabilities
    (T,E)) while installed in place of ``models.moe.route``."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.calls = moe, moe.route, []

    def __enter__(self):
        import torch

        def logged(cfg, p, x_flat, mean=None):
            w, ids, aux = self.real(cfg, p, x_flat, mean)
            with torch.no_grad():         # no graph kept under training
                probs = torch.softmax(x_flat.float() @ p["router"].float(), dim=-1)
            self.calls.append((ids.detach(), probs))
            return w, ids, aux

        self.moe.route = logged
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real


def route_flips(kern: RouteLog, plain: RouteLog, k: int) -> list:
    """Per MoE layer: (tokens whose chosen expert set differs between the
    two paths, the router probabilities' largest departure between them).
    Each flip must lie where the plain path's k-th and (k+1)-th
    probabilities are within twice that departure (a difference the
    attention path's departure can order either way)."""
    out = []
    for (ik, pk), (ip, pp) in zip(kern.calls, plain.calls):
        dep = float((pk - pp).abs().max())
        flips = (ik.sort(-1).values != ip.sort(-1).values).any(-1)
        top = pp.topk(k + 1, dim=-1).values
        gap = top[:, k - 1] - top[:, k]
        bad = int((flips & (gap > 2 * dep)).sum())
        if bad:
            raise SmokeFailure(f"{bad} routing flips where the router's k-th and "
                               f"(k+1)-th probabilities lie further apart than "
                               f"twice the paths' departure {dep:.3e}")
        out.append((int(flips.sum()), dep))
    if len(kern.calls) != len(plain.calls):
        raise SmokeFailure(f"routing calls {len(kern.calls)} / {len(plain.calls)}")
    return out


#: how much further than the plain path the kernel path's bf16 logits may
#: lie from the float32 computation where the SSD scan runs in bf16 (C8)
SCAN_BF16_FACTOR = 1.5


def scan_yardstick(arch, cfg, params, prompt, seq_len, kern, plain, finite):
    """ROADMAP §C8 on the card: under bf16 compute the SSD scan's log-decays
    are summed in bf16 (JAX's algorithm), whose roundings amplify any
    difference upstream, so the two paths' bf16 logits (``kern``,
    ``plain``, last token, real vocabulary) are held to the float32
    computation of the same params instead: the kernel path no further
    from it, in relative L2, than SCAN_BF16_FACTOR x the plain path. The
    float32 computation's own kernel path is held to its plain path at
    1e-4 of the largest logit, at full depth."""
    from repro_torch.models import build_model
    V = cfg.vocab
    m32 = build_model(cfg.replace(compute_dtype="float32"))
    r, _ = m32.prefill(params, prompt, seq_len, impl="ref")
    rk, _ = m32.prefill(params, prompt, seq_len, impl="cuda")
    check(f"{arch} full depth f32 compute: kernel vs plain path", rk[:, -1, :V],
          r[:, -1, :V], atol=1e-4 * float(r[:, -1, :V].abs().max()))
    r = r[:, -1, :V].float()
    dk, dp = rel_l2(kern, r), rel_l2(plain, r)
    ok = finite and dk <= SCAN_BF16_FACTOR * dp
    print(f"    bf16 against the f32 computation (relative L2 of the last-token "
          f"logits): kernel path {dk:.4e}, plain path {dp:.4e} (limit "
          f"{SCAN_BF16_FACTOR} x the plain path's)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{arch}: bf16 kernel path {dk:.4e} from f32 against "
                           f"the plain path's {dp:.4e}")


def family_f32_checks(arch, cfg, layers, dev, B, S) -> None:
    """The family at ``layers`` in float32: the kernel path against the plain
    path, and prefill then decode against a teacher-forced pass (1e-4 of the
    largest logit)."""
    import dataclasses

    import torch
    from repro_torch.models import build_model
    from repro_torch.models import encdec
    from repro_torch.models.transformer import logits_fn

    c32 = cfg.replace(n_layers=layers, compute_dtype="float32", param_dtype="float32")
    if cfg.family == "encdec":
        c32 = c32.replace(encoder_layers=layers)
    model = build_model(c32)
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    extra = max(FAMILY_SEQ_STEPS + 1, c32.ssm.chunk if c32.ssm is not None else 1)
    prompt, tokens = family_inputs(c32, dev, B, S, seed=1, extra=extra)
    label = f"{arch} depth {layers} f32"
    V = cfg.vocab                     # the padded entries are masked to -1e9
    lk, _ = model.prefill(params, prompt, S + FAMILY_SEQ_STEPS + 1, impl="cuda")
    lp, _ = model.prefill(params, prompt, S + FAMILY_SEQ_STEPS + 1, impl="ref")
    lk, lp = lk[..., :V], lp[..., :V]
    check(f"{label}: kernel vs plain path", lk, lp, atol=1e-4 * float(lp.abs().max()))
    del lk, lp
    if cfg.family == "encdec":
        # prefill (encoder + the first target token) and decode steps against
        # the teacher-forced decoder over the same target prefix
        tgt = torch.as_tensor(tokens[:, :FAMILY_SEQ_STEPS + 1], device=dev).long()
        with torch.no_grad():
            enc = encdec.encode(c32, params, prompt["src_embeds"], impl="cuda")
            want = logits_fn(c32, params, encdec.decode_train(c32, params, tgt, enc,
                                                              impl="cuda"))
        got, cache = model.prefill(params, prompt, S, impl="cuda")
        steps = [got]
        for t in range(1, FAMILY_SEQ_STEPS + 1):
            got, cache = model.decode_step(params, cache, tgt[:, t:t + 1])
            steps.append(got)
        want = want[..., :V]
        check(f"{label}: prefill + {FAMILY_SEQ_STEPS} decode steps vs teacher-"
              f"forced decoder", torch.cat(steps, 1)[..., :V], want,
              atol=1e-4 * float(want.abs().max()))
        return
    if cfg.family == "vlm":
        # prefill(S) + 1 decode step against prefill(S + 1) whose last
        # embedding is the step token's row of the table, at position S in
        # every M-RoPE section
        tok = torch.as_tensor(tokens[:, S:S + 1], device=dev)
        emb = torch.cat([prompt["embeds"], params["embed"]["tok"][tok.long()].float()], 1)
        pos = torch.cat([prompt["positions"], torch.full((3, B, 1), S, dtype=torch.int32,
                                                         device=dev)], 2)
        want, _ = model.prefill(params, {"embeds": emb, "positions": pos}, S + 1,
                                impl="cuda")
        _, cache = model.prefill(params, prompt, S + 1, impl="cuda")
        got, _ = model.decode_step(params, cache, tok)
        got, want = got[:, -1, :V], want[:, -1, :V]
        check(f"{label}: prefill({S}) + 1 decode step vs prefill({S + 1})", got, want,
              atol=1e-4 * float(want.abs().max()))
        return
    if cfg.family in ("ssm", "hybrid"):
        # prefill(S) + Q decode steps against prefill(S + Q): lengths that
        # ssd_chunked takes (multiples of the chunk Q)
        S1, n = S, c32.ssm.chunk
    else:
        # the MoE capacity raised so that it binds in neither pass
        c32 = c32.replace(moe=dataclasses.replace(
            c32.moe, capacity_factor=float(c32.moe.num_experts)))
        model = build_model(c32)
        S1, n = min(S, FAMILY_MOE_CHECK_PROMPT), 1
    tok = torch.as_tensor(tokens[:, :S1 + n], device=dev)
    want, _ = model.prefill(params, {"tokens": tok}, S1 + n, impl="cuda")
    _, cache = model.prefill(params, {"tokens": tok[:, :S1]}, S1 + n, impl="cuda")
    for t in range(n):
        got, cache = model.decode_step(params, cache, tok[:, S1 + t:S1 + t + 1])
    got, want = got[..., :V], want[..., :V]
    check(f"{label}: prefill({S1}) + {n} decode step{'s' * (n > 1)} vs "
          f"prefill({S1 + n})", got, want, atol=1e-4 * float(want.abs().max()))


def families_phase(tag: str, dev) -> dict:
    """Phase 12: serve each of FAMILY_MODELS at published width through
    ``build_model(cfg).prefill / decode_step`` (``impl`` and ``device``
    left at ``"auto"``: the card); returns each model's flash launches."""
    import numpy as np
    import torch
    import torch.nn.functional as tF
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.models import build_model

    B, S, n_dec = LM_BATCH, LM_PROMPT, LM_DECODE
    seq_len = S + n_dec
    phase_header(f"== phase 12: the MoE, SSM, hybrid, encoder-decoder and VLM families at "
          f"published width: {B} x {S} prompt tokens (seamless: source "
          f"frames; qwen2-VL: embeddings and M-RoPE positions) + {n_dec} greedy "
          f"decode steps each [{tag}]")
    launches = {}
    for arch, layers, f32_layers in FAMILY_MODELS:
        cfg = family_config(arch, layers)
        full = family_config(arch, None)
        cut = (f"depth cut {full.n_layers} -> {cfg.n_layers} (device memory)"
               if layers is not None else "depth not cut")
        want_flash = flash_launches_of(cfg)
        if not FAMILY_CONFIGS and want_flash != FAMILY_FLASH[arch]:
            raise SmokeFailure(f"{arch}: {want_flash} attention layers reach "
                               f"the kernel, the table says {FAMILY_FLASH[arch]}")
        print(f"  {arch} ({cfg.family}): d={cfg.d_model}, {cfg.n_layers} layers"
              f"{f' + {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
              f"d_ff={cfg.d_ff}, vocab {cfg.vocab}"
              f"{f', {cfg.moe.num_experts} experts top-{cfg.moe.top_k}' if cfg.moe else ''}"
              f"{f', state {cfg.ssm.state_dim} chunk {cfg.ssm.chunk}' if cfg.ssm else ''}; "
              f"{cfg.param_count():,} {cfg.param_dtype} params, {cfg.compute_dtype} "
              f"compute; {cut}")
        model = build_model(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        print(f"    init on the card: {time.perf_counter() - t0:.2f} s, "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        prompt, _ = family_inputs(cfg, dev, B, S)

        def greedy(logits):
            return logits[:, -1].argmax(-1, keepdim=True)

        # warm-up, then the main run with the counter zeroed just before it
        logits, cache = model.prefill(params, prompt, seq_len, impl=FAMILY_IMPL)
        model.decode_step(params, cache, greedy(logits))
        del logits, cache
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, prompt, seq_len, impl=FAMILY_IMPL)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = flash_attention_cuda.launches
        finite = torch.isfinite(logits).all()
        tok = greedy(logits)
        pos0 = int(cache["pos"])
        t0 = time.perf_counter()
        for _ in range(n_dec):
            step_logits, cache = model.decode_step(params, cache, tok)
            finite &= torch.isfinite(step_logits).all()
            tok = greedy(step_logits)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / n_dec
        n_launch = flash_attention_cuda.launches
        peak = torch.cuda.max_memory_allocated()
        print(f"    flash kernel launches: {prefill_launches} in the prefill "
              f"(want {want_flash}), {n_launch - prefill_launches} in {n_dec} "
              f"decode steps (want 0)")
        if prefill_launches != want_flash or n_launch != prefill_launches:
            raise SmokeFailure(f"{arch}: flash launches {prefill_launches} per "
                               f"prefill, {n_launch - prefill_launches} in decode")
        if not bool(finite) or int(cache["pos"]) != pos0 + n_dec:
            raise SmokeFailure(f"{arch}: logits finite {bool(finite)}, cache pos "
                               f"{int(cache['pos'])} (want {pos0 + n_dec})")
        launches[arch] = n_launch
        n_tok = B * S
        print(f"    prefill {B}x{S}: {prefill_ms:.2f} ms, {n_tok / prefill_ms * 1e3:.1f} "
              f"prompt tokens/s; decode {decode_ms:.3f} ms per step ({B} "
              f"sequences, host clock, synchronised) [{tag}]")
        print(f"    peak memory {peak / 2**30:.3f} GiB (max_memory_allocated over "
              f"the run; {base_mem / 2**30:.3f} GiB resident before it) [{tag}]")
        del step_logits, cache

        # the kernel path against the plain path, at the model's own dtypes,
        # on the real vocabulary (the padded entries are masked to -1e9);
        # for MoE the routed experts of the two paths, layer by layer
        V = cfg.vocab
        with RouteLog() as rk:
            lk, _ = model.prefill(params, prompt, seq_len, impl="cuda")
        with RouteLog() as rp:
            lp, _ = model.prefill(params, prompt, seq_len, impl="ref")
        a, b = lk[:, -1, :V].float(), lp[:, -1, :V].float()
        cos = float(tF.cosine_similarity(a, b, dim=-1).min())
        finite = bool(torch.isfinite(a).all() and torch.isfinite(b).all())
        ok = finite and cos >= 0.999
        print(f"    {cfg.compute_dtype}: last-token logits, kernel vs plain path: min "
              f"cosine {cos:.6f} (limit 0.999{'' if cfg.ssm is None else '; C8: below'}), "
              f"max abs diff {float((a - b).abs().max()):.4e} of max |logit| "
              f"{float(b.abs().max()):.4f}  "
              f"{'ok' if ok else ('see below' if cfg.ssm is not None else 'FAIL')}")
        if cfg.ssm is not None:
            scan_yardstick(arch, cfg, params, prompt, seq_len, a, b, finite)
        elif not ok:
            raise SmokeFailure(f"{arch}: kernel vs plain path: cosine {cos}")
        if cfg.moe is not None:
            flips = route_flips(rk, rp, cfg.moe.top_k)
            T_ = rk.calls[0][0].shape[0]
            print(f"    routed experts, kernel vs plain path: flips per layer "
                  f"{[f for f, _ in flips]} of {T_:,} tokens, the router "
                  f"probabilities' departure per layer "
                  f"{[float(f'{d:.3e}') for _, d in flips]}; each flip within twice "
                  f"its layer's departure of a tie  ok")
        del lk, lp, rk, rp, logits

        # where a prefill's time goes
        torch.cuda.synchronize()
        busy, by_kernel, wall, _ = profile_tick(lambda: model.prefill(
            params, prompt, seq_len, impl=FAMILY_IMPL))
        if busy is None:
            print(f"    profiled prefill: no device time recorded (not measured) [{tag}]")
        else:
            print(f"    profiled prefill: {wall:.2f} ms host clock, device busy "
                  f"{busy:.2f} ms, idle share {1 - busy / wall:.3f} [{tag}]")
            for name, (ms, n) in by_kernel[:6]:
                print(f"      {ms:9.3f} ms  x{n:<5d} {name[:90]}")
        del params, model
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        if f32_layers is None:
            print(f"    float32 checks: none ({arch}'s float32 layer does not fit "
                  f"beside its activations; checked in bf16 above)")
        else:
            family_f32_checks(arch, cfg, f32_layers, dev, B, S)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return launches


def flash_encoder_row(tag: str, dev, launches: int) -> dict:
    """Row 8-nc: the flash kernel at the seamless encoder's shape
    (ENCODER_CASE: non-causal, every (query, key) pair live), timed as phase
    7 times row 8, with SDPA (non-causal) as its yardstick."""
    import torch
    import torch.nn.functional as tF
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref

    B, Sq, Sk, Hq, Hkv, dh, causal, window, dt = ENCODER_CASE
    cdt = getattr(torch, dt)
    gen = torch.Generator(device=dev).manual_seed(8)
    q = torch.randn((B, Sq, Hq, dh), generator=gen, device=dev).to(cdt)
    k = torch.randn((B, Sk, Hkv, dh), generator=gen, device=dev).to(cdt)
    v = torch.randn((B, Sk, Hkv, dh), generator=gen, device=dev).to(cdt)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kern = lambda: flash_attention_cuda(q, k, v, causal, window)
    plain = lambda: attention_ref(q, k, v, causal=causal, window=window)
    library = lambda: tF.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    check("SDPA yardstick vs plain (same function), encoder shape",
          library().transpose(1, 2), plain(), atol=3e-2)
    ms = cuda_ms(kern, reps=5)
    pms = cuda_ms(plain, reps=3)
    lms = cuda_ms(library, reps=10)
    alone = kernel_alone_ms(kern, "flash_attention_kernel")
    pairs = flash_pairs(Sq, Sk, causal, window)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    flops = 4 * B * Hq * dh * pairs
    bms, by = bound_ms(nbytes, flops, BF16_FLOPS if cdt == torch.bfloat16 else F32_FLOPS)
    print(f"  row 8-nc flash_attention {dt} B={B} S={Sq} H={Hq}/{Hkv} dh={dh} "
          f"non-causal: {ms:.3f} ms  bound {bms:.3f} ms ({by}; {pairs:,} live "
          f"pairs per head)  plain {pms:.3f} ms  SDPA {lms:.3f} ms  kernel alone "
          f"{'not measured' if alone is None else f'{alone:.4f} ms'} (profiler)  "
          f"launches {launches} [{tag}]")
    return {"name": "flash_attention_encoder", "route": "cuda",
            "source": SOURCES["flash_attention"],
            "replaces": REPLACES["flash_attention"], "launches": launches,
            "max_abs_err": FLASH_CASE_ERRS[ENCODER_CASE], "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by, "library_ms": lms}


# --------------------------------------------------------------------------- #
# phase 13: LM training
# --------------------------------------------------------------------------- #
def attention_calls_of(cfg) -> int:
    """Attention calls of a training forward pass that reach the flash
    kernel: every self-attention layer, the hybrid's shared block once a
    group, the encoder-decoder's encoder, decoder and cross-attention."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.n_layers
    return flash_launches_of(cfg)


def flash_per_step(cfg) -> int:
    """Flash launches a training step: the forward pass, and again in the
    backward pass's recompute under remat ("dots" or "full")."""
    return attention_calls_of(cfg) * (1 if cfg.remat == "none" else 2)


def _chunks(t):
    """Slices of AdamW.CHUNK elements of ``t`` flattened."""
    from repro_torch.optim import AdamW
    flat, n = t.reshape(-1), AdamW.CHUNK
    for a in range(0, flat.numel(), n):
        yield flat[a:a + n]


def grad_stats(got, want) -> tuple:
    """(cosine, relative L2 ||got - want|| / ||want||) of two gradient lists
    taken as one vector, summed in float64 a slice at a time."""
    dot = nn_ = ww = dd = 0.0
    for g, w in zip(got, want):
        for a, b in zip(_chunks(g), _chunks(w)):
            a, b = a.double(), b.double()
            dot += float((a * b).sum())
            nn_ += float((a * a).sum())
            ww += float((b * b).sum())
            dd += float(((a - b) ** 2).sum())
    return dot / max((nn_ * ww) ** 0.5, 1e-300), (dd / max(ww, 1e-300)) ** 0.5


def loss_and_grads(model, params, batch, impl):
    """The loss and its gradient w.r.t. every param (a list in
    ``tree_leaves`` order), through autograd."""
    import torch
    from repro_torch.optim.adamw import tree_leaves, tree_map
    work = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = model.loss(work, batch, impl=impl)
    gs = torch.autograd.grad(loss, tree_leaves(work), allow_unused=True,
                             materialize_grads=True)
    return float(loss.detach()), list(gs)


def perturbed(grads, rel: float, seed: int = 13) -> list:
    """``grads`` plus Gaussian noise of relative L2 norm ``rel`` (a
    control's planted fault)."""
    import torch
    gen = torch.Generator(device=grads[0].device).manual_seed(seed)
    noise = [torch.randn(g.shape, generator=gen, device=g.device) for g in grads]
    gn = sum(float(g.double().pow(2).sum()) for g in grads) ** 0.5
    nn_ = sum(float(n.double().pow(2).sum()) for n in noise) ** 0.5
    return [(g.float() + n * (rel * gn / nn_)).to(g.dtype) for g, n in zip(grads, noise)]


def check_paths(label, dtype, lk, lp, gk, gp) -> None:
    """The kernel path's loss and gradient against the plain path's: bf16
    compute, loss within 2e-2 relative and gradient cosine >= 0.999;
    float32 compute, loss and gradient (relative L2) within 1e-4."""
    cos, rel = grad_stats(gk, gp)
    lrel = abs(lk - lp) / max(abs(lp), 1e-30)
    f32 = dtype == "float32"
    ok = (lrel <= 1e-4 and rel <= 1e-4) if f32 else (lrel <= 2e-2 and cos >= 0.999)
    print(f"    {label} {dtype}: loss {lk:.6f} kernel / {lp:.6f} plain (relative "
          f"{lrel:.3e}, limit {'1e-4' if f32 else '2e-2'}); gradient cosine "
          f"{cos:.6f}{'' if f32 else ' (limit 0.999)'}, relative L2 {rel:.3e}"
          f"{' (limit 1e-4)' if f32 else ''}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{label} {dtype}: kernel vs plain path: loss {lrel:.3e}, "
                           f"cosine {cos:.6f}, relative L2 {rel:.3e}")


def check_scan_grads(label, gk, gp, g32) -> None:
    """ROADMAP §C8 for training: where the SSD scan runs in bf16, the kernel
    path's gradient no further from the float32 computation's, in relative
    L2, than SCAN_BF16_FACTOR x the plain path's."""
    dk, dp = grad_stats(gk, g32)[1], grad_stats(gp, g32)[1]
    ok = dk <= SCAN_BF16_FACTOR * dp
    print(f"    {label}: bf16 gradient against the f32 computation (relative L2): "
          f"kernel path {dk:.4e}, plain path {dp:.4e} (limit {SCAN_BF16_FACTOR} x "
          f"the plain path's)  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{label}: bf16 kernel path {dk:.4e} from f32 against "
                           f"the plain path's {dp:.4e}")


def path_checks(label, cfg, params, batch, dev) -> dict:
    """Phase 13's check of one model: one loss and gradient under
    ``impl="cuda"`` and one under ``impl="ref"`` from the same params and
    batch (bf16 compute: ``check_paths``; the scan families: C8's yardstick
    against the float32 computation, whose own kernel path is held to its
    plain path at 1e-4 where it has attention), the MoE routing flips, and
    a control with a perturbed gradient that must fail."""
    import torch
    from repro_torch.models import build_model
    model = build_model(cfg)
    with RouteLog() as rk:
        lk, gk = loss_and_grads(model, params, batch, "cuda")
    with RouteLog() as rp:
        lp, gp = loss_and_grads(model, params, batch, "ref")
    out = {"loss_kernel": lk, "loss_plain": lp}
    if cfg.moe is not None:
        flips = route_flips(rk, rp, cfg.moe.top_k)
        print(f"    routed experts, kernel vs plain path (forward and recompute): "
              f"flips per call {[f for f, _ in flips]} of "
              f"{rk.calls[0][0].shape[0]:,} tokens, the router probabilities' "
              f"departure {[float(f'{d:.3e}') for _, d in flips]}; each flip within "
              f"twice its call's departure of a tie  ok")
    del rk, rp
    if cfg.ssm is not None and cfg.compute_dtype != "float32":
        cos, _ = grad_stats(gk, gp)
        print(f"    {label} {cfg.compute_dtype}: loss {lk:.6f} kernel / {lp:.6f} plain; "
              f"gradient cosine {cos:.6f} (C8: held to the f32 computation below)")
        m32 = build_model(cfg.replace(compute_dtype="float32"))
        l32, g32 = loss_and_grads(m32, params, batch, "ref")
        if attention_calls_of(cfg):
            l32k, g32k = loss_and_grads(m32, params, batch, "cuda")
            check_paths(f"{label} full depth", "float32", l32k, l32, g32k, g32)
            del g32k
        check_scan_grads(label, gk, gp, g32)
        dp = grad_stats(gp, g32)[1]
        must_fail(f"{label}: the kernel path's gradient plus noise of twice the "
                  f"plain path's departure", lambda: check_scan_grads(
                      label, perturbed(gk, 2 * dp), gp, g32))
        out["loss_f32"] = l32
    else:
        check_paths(label, cfg.compute_dtype, lk, lp, gk, gp)
        rel = 1e-3 if cfg.compute_dtype == "float32" else 5e-2
        must_fail(f"{label}: the kernel path's gradient plus noise of relative "
                  f"L2 {rel:g}", lambda: check_paths(
                      label, cfg.compute_dtype, lk, lp, perturbed(gk, rel), gp))
    del gk, gp
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


class StepLog:
    """Times each call of the train steps ``make_train_step`` returns while
    installed in its place in ``launch.train`` (synchronised on both sides;
    host clock), counts their flash launches, and profiles the call
    numbered ``profile_at``."""

    def __init__(self, profile_at=None):
        from repro_torch.launch import train
        from repro_torch.kernels.flash_attention import ops as flash_ops
        self.train, self.flash_ops = train, flash_ops
        self.real = train.make_train_step
        self.ms, self.flash, self.profile_at, self.profile = [], [], profile_at, None

    def __enter__(self):
        import torch
        log = self

        def make(*args, **kw):
            step = log.real(*args, **kw)

            def timed(params, opt_state, batch):
                n = log.flash_ops.flash_attention_cuda.launches
                torch.cuda.synchronize()
                if len(log.ms) + (log.profile is not None) == log.profile_at:
                    out = []
                    log.profile = profile_tick(lambda: out.append(
                        step(params, opt_state, batch)))
                    log.profile_flash = log.flash_ops.flash_attention_cuda.launches - n
                    return out[0]
                t0 = time.perf_counter()
                out = step(params, opt_state, batch)
                torch.cuda.synchronize()
                log.ms.append((time.perf_counter() - t0) * 1e3)
                log.flash.append(log.flash_ops.flash_attention_cuda.launches - n)
                return out

            timed.optimizer = step.optimizer
            return timed

        self.train.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.train.make_train_step = self.real


def print_profile(profile, tag, what) -> None:
    """A profiled call's device busy time and idle share, its costliest
    kernels and its costliest host ops (own CPU time)."""
    busy, by_kernel, wall, host = profile
    if busy is None:
        print(f"    profiled {what}: no device time recorded (not measured) [{tag}]")
        return
    print(f"    profiled {what}: {wall:.2f} ms host clock, device busy {busy:.2f} ms, "
          f"idle share {1 - busy / wall:.3f} [{tag}]")
    for name, (ms, n) in by_kernel[:8]:
        print(f"      {ms:9.3f} ms  x{n:<5d} {name[:90]}")
    print(f"      host: {sum(n for _, (_, n) in host):,} op calls; the costliest:")
    for name, (ms, n) in host[:6]:
        print(f"      {ms:9.3f} ms  x{n:<5d} {name[:90]}")


def plain_attention_share(cfg, B, S, dev, step_ms, busy_ms) -> float:
    """The plain attention backward (JAX's: the plain version's VJP,
    recomputed; there is no backward kernel) at a layer's shapes, timed
    with CUDA events, and its share of a training step: x the layers,
    over the step's host clock and over its device busy time."""
    import torch
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    cdt = getattr(torch, cfg.compute_dtype)
    dh = cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((B, S, cfg.n_heads, dh), generator=gen, device=dev).to(cdt)
    k = torch.randn((B, S, cfg.n_kv_heads, dh), generator=gen, device=dev).to(cdt)
    v = torch.randn((B, S, cfg.n_kv_heads, dh), generator=gen, device=dev).to(cdt)
    g = torch.randn((B, S, cfg.n_heads, dh), generator=gen, device=dev).to(cdt)

    def vjp():
        qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
        with torch.enable_grad():
            out = attention_ref(qq, kk, vv, causal=True, window=cfg.sliding_window)
        return torch.autograd.grad(out, (qq, kk, vv), g)

    n = flash_attention_cuda.launches
    bwd = cuda_ms(vjp, reps=5)
    fwd = cuda_ms(lambda: flash_attention_cuda(q, k, v, True, cfg.sliding_window), reps=5)
    flash_attention_cuda.launches = n          # a measurement, not the path
    L = attention_calls_of(cfg)
    share = f", {L * bwd / busy_ms:.3f} of its device busy time" if busy_ms else ""
    print(f"    the plain attention backward (recomputed VJP) at a layer's shapes "
          f"({B} x {S}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {dh}): {bwd:.3f} ms, "
          f"x {L} layers = {L * bwd:.1f} ms, {L * bwd / step_ms:.3f} of a step's "
          f"host clock{share}; the flash forward {fwd:.3f} ms, x {2 * L} a step "
          f"[CUDA events]")
    return bwd


def train_config(arch, layers, experts):
    """The config phase 13 trains: the published CONFIG (TRAIN_CONFIGS'
    stand-in where given), cut to ``layers`` and ``experts``."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = TRAIN_CONFIGS.get(arch) or get_config(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    if experts is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=experts))
    return cfg


def train_steps(model, params, dev, B: int, S: int, n: int) -> tuple:
    """``n`` steps of ``make_train_step`` (the driver's optimizer, its
    batches of B x S tokens), each timed on the host clock between
    synchronisations with the flash counter zeroed just before it:
    (params, opt state, step, losses, ms, flash launches a step)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.train import synth_batch
    from repro_torch.optim import OptConfig
    from repro_torch.train import make_train_step

    step = make_train_step(model, OptConfig(lr=3e-4, schedule="cosine", warmup_steps=10,
                                            total_steps=100, clip_norm=1.0),
                           impl=TRAIN_IMPL)
    opt = step.optimizer.init(params)
    shape = ShapeConfig("t", "train", S, B)
    losses, ms, flash = [], [], []
    for i in range(n):
        batch = synth_batch(model, shape, i, dev)
        torch.cuda.synchronize()
        flash_ops.flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        flash.append(flash_ops.flash_attention_cuda.launches)
        losses.append(float(metrics["loss"]))
    return params, opt, step, losses, ms, flash


def remat_none_run(tag, dev, cfg, B, S, dots_ms) -> int:
    """TRAIN_REMAT_NONE_STEPS steps of ``cfg`` under remat "none" at the
    driver's batch (the driver's optimizer and batches, through
    ``make_train_step``): step ms (median after the first, against the
    "dots" median), peak memory, flash launches a step (the layers, once)
    and a profiled step's idle share and host ops: what the "dots" policy's
    dispatch mode costs. Returns its flash launches."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import build_model

    cfg = cfg.replace(remat="none")
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt, step, losses, ms, flash = train_steps(
        model, model.init(0, device=dev), dev, B, S, TRAIN_REMAT_NONE_STEPS)
    peak = torch.cuda.max_memory_allocated()
    batch = synth_batch(model, ShapeConfig("t", "train", S, B),
                        TRAIN_REMAT_NONE_STEPS, dev)
    flash_ops.flash_attention_cuda.launches = 0
    profile = profile_tick(lambda: step(params, opt, batch))
    flash.append(flash_ops.flash_attention_cuda.launches)
    want = flash_per_step(cfg)
    med = sorted(ms[1:])[len(ms[1:]) // 2]
    print(f"    remat \"none\", {TRAIN_REMAT_NONE_STEPS + 1} steps: losses "
          f"{[round(x, 4) for x in losses]}; step {med:.2f} ms (median after the "
          f"first; {[round(x, 1) for x in ms]}; host clock, synchronised) against "
          f"{dots_ms:.2f} ms under {cfg.name}'s \"dots\" ({dots_ms / med:.2f}x), "
          f"{B * S / med * 1e3:.0f} tokens/s; peak memory {peak / 2**30:.3f} GiB; "
          f"flash launches a step {flash} (want {want}) [{tag}]")
    print_profile(profile, tag, f"remat \"none\" step {TRAIN_REMAT_NONE_STEPS + 1}")
    if not np.isfinite(losses).all() or set(flash) != {want}:
        raise SmokeFailure(f"phase 13 remat none: losses {losses}, flash {flash}")
    del params, opt, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return sum(flash)


def driver_run(tag, dev) -> dict:
    """Phase 13 (a): TRAIN_LM_ARCH through ``launch.train.main`` with
    TRAIN_LM_ARGS, then ``--resume`` to TRAIN_LM_RESUME: step ms (median
    after the first), tokens/s, peak memory, a profiled step's idle share
    and flash launches a step; then the kernel path against the plain path
    (bf16 and float32 compute) at the driver's params and first batch."""
    import shutil

    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import train
    from repro_torch.models import build_model

    ckpt = ROOT / "build" / "lm_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", TRAIN_LM_ARCH, *TRAIN_LM_ARGS, "--ckpt-dir", str(ckpt),
            "--log-every", "1", *TRAIN_LM_EXTRA]
    smoke = "--smoke" in TRAIN_LM_EXTRA
    cfg = get_smoke_config(TRAIN_LM_ARCH) if smoke else get_config(TRAIN_LM_ARCH)
    steps = int(argv[argv.index("--steps") + 1])
    B = int(argv[argv.index("--batch") + 1])
    S = int(argv[argv.index("--seq") + 1])
    print(f"  (a) python -m repro_torch.launch.train {' '.join(argv)}: "
          f"{cfg.name}, {cfg.n_layers} layers, d={cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads, vocab {cfg.vocab}, {cfg.param_count():,} "
          f"{cfg.param_dtype} params, {cfg.compute_dtype} compute, remat "
          f"{cfg.remat}; width and depth not cut; disk free "
          f"{shutil.disk_usage(ROOT).free / 2**30:.0f} GiB")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_ops.flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    with StepLog(profile_at=5) as log:
        r1 = train.main(argv)
        t1 = time.perf_counter()
        r2 = train.main(argv[:argv.index("--steps") + 1] + [str(TRAIN_LM_RESUME)]
                        + argv[argv.index("--steps") + 2:] + ["--resume"])
    t2 = time.perf_counter()
    launches = flash_ops.flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    shutil.rmtree(ckpt, ignore_errors=True)
    losses = [h["loss"] for h in r1["history"] + r2["history"]]
    PHASE13["driver"] = losses
    want_steps = list(range(1, steps + 1)) + list(range(steps + 1, TRAIN_LM_RESUME + 1))
    got_steps = [h["step"] for h in r1["history"] + r2["history"]]
    print(f"    losses by step {dict(zip(got_steps, [round(x, 4) for x in losses]))}")
    if got_steps != want_steps or not np.isfinite(losses).all():
        raise SmokeFailure(f"phase 13 (a): steps {got_steps} (want {want_steps}: the "
                           f"resume must continue at {steps + 1}), losses {losses}")
    want_flash = flash_per_step(cfg)
    per_step = sorted(set(log.flash + [log.profile_flash]))
    print(f"    resumed at step {r2['history'][0]['step']} (not restarted); flash "
          f"launches a step {per_step} (want {want_flash}: {attention_calls_of(cfg)} "
          f"attention layers, x2 for the recompute under remat={cfg.remat!r}); "
          f"{launches} in the {TRAIN_LM_RESUME} steps")
    if per_step != [want_flash] or launches != want_flash * TRAIN_LM_RESUME:
        raise SmokeFailure(f"phase 13 (a): flash launches {per_step} a step, "
                           f"{launches} in all")
    ms = sorted(log.ms[1:])
    med = ms[len(ms) // 2]
    DRYRUN_MEASURED["qwen_step"] = {
        "ms": med, "B": B, "S": S, "arch": TRAIN_LM_ARCH, "cfg": cfg,
        "what": f"phase 13, the driver's median step of {B}x{S} (impl='auto'), "
                f"host clock"}
    print(f"    step {med:.2f} ms (median of {len(ms)} after the first; range "
          f"{ms[0]:.2f}-{ms[-1]:.2f}; first {log.ms[0]:.2f}), {B * S / med * 1e3:.0f} "
          f"tokens/s; peak memory {peak / 2**30:.3f} GiB; the two driver runs "
          f"{t1 - t0:.1f} + {t2 - t1:.1f} s with their checkpoints [{tag}]")
    print_profile(log.profile, tag, f"step {log.profile_at + 1}")
    busy = log.profile[0]
    if busy is not None:
        print(f"    the profiled step's device busy time against the median "
              f"unprofiled step: idle share {1 - busy / med:.3f} [{tag}]")
    attn = plain_attention_share(cfg, B, S, dev, med, busy)
    none_launches = remat_none_run(tag, dev, cfg, B, S, med)
    # the kernel path against the plain path at the driver's params and its
    # first batch (the driver draws both from seed 0 / step 0)
    model = build_model(cfg)
    params = model.init(0, device=dev)
    batch = train.synth_batch(model, ShapeConfig("driver", "train", S, B), 0, dev)
    path_checks(cfg.name, cfg, params, batch, dev)
    path_checks(cfg.name, cfg.replace(compute_dtype="float32"), params, batch, dev)
    del params, batch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {"arch": TRAIN_LM_ARCH, "launches": launches,
            "launches_remat_none": none_launches, "step_ms": med,
            "plain_attention_bwd_ms": attn,
            "tokens_per_s": B * S / med * 1e3, "peak_gib": peak / 2**30,
            "idle": None if log.profile[0] is None else 1 - log.profile[0] / log.profile[2]}


def train_family(tag, dev, arch, layers, experts) -> tuple:
    """Phase 13 (b): one family at published width, ``layers`` / ``experts``
    cut, TRAIN_FAMILY_STEPS steps through ``make_train_step`` (the driver's
    optimizer), then ``path_checks``; returns its flash launches, (causal,
    non-causal): the encoder-decoder's encoder and cross-attention are the
    non-causal ones (row 8-nc)."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import build_model

    cfg = train_config(arch, layers, experts)
    full = TRAIN_CONFIGS.get(arch) or get_config(arch)
    cuts = []
    if layers is not None:
        cuts.append(f"depth {full.n_layers} -> {cfg.n_layers}")
    if experts is not None:
        cuts.append(f"experts {full.moe.num_experts} -> {cfg.moe.num_experts} "
                    f"(top-{cfg.moe.top_k} kept)")
    B, S = TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ
    print(f"  {arch} ({cfg.family}): d={cfg.d_model}, {cfg.n_layers} layers"
          f"{f' + {cfg.encoder_layers} encoder' if cfg.encoder_layers else ''}"
          f"{f', {cfg.moe.num_experts} experts top-{cfg.moe.top_k}' if cfg.moe else ''}; "
          f"{cfg.param_count():,} {cfg.param_dtype} params, {cfg.compute_dtype} "
          f"compute, remat {cfg.remat}; "
          f"{'; '.join(cuts) + ' (device memory)' if cuts else 'width and depth not cut'}"
          f"; {B} x {S} tokens a step")
    model = build_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, opt, step, losses, ms, flash = train_steps(
        model, model.init(torch.Generator(device=dev).manual_seed(0)), dev, B, S,
        TRAIN_FAMILY_STEPS)
    peak = torch.cuda.max_memory_allocated()
    PHASE13[arch] = {"losses": losses, "cfg": cfg}
    want = flash_per_step(cfg)
    print(f"    losses {[round(x, 4) for x in losses]}; step ms "
          f"{[round(x, 1) for x in ms]} (host clock, synchronised); peak memory "
          f"{peak / 2**30:.3f} GiB; flash launches a step {flash} (want {want}) [{tag}]")
    if not np.isfinite(losses).all() or set(flash) != {want}:
        raise SmokeFailure(f"phase 13 {arch}: losses {losses}, flash launches {flash}")
    del opt, step
    gc.collect()
    torch.cuda.empty_cache()
    path_checks(arch, cfg, params,
                synth_batch(model, ShapeConfig("t", "train", S, B), 0, dev), dev)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    causal = (cfg.n_layers * want // attention_calls_of(cfg) * len(flash)
              if cfg.family == "encdec" else sum(flash))
    return causal, sum(flash) - causal


def lm_training_phase(tag: str, dev) -> tuple:
    """Phase 13: LM training on the card (``driver_run``, then
    ``train_family`` for each of TRAIN_FAMILIES); returns each path's flash
    launches, causal (row 8) and non-causal (row 8-nc)."""
    import torch
    phase_header(f"== phase 13: LM training: {TRAIN_LM_ARCH} through the driver, then "
          f"{len(TRAIN_FAMILIES)} more architectures at published width [{tag}]")
    torch.backends.cuda.matmul.allow_tf32 = False
    first = driver_run(tag, dev)
    causal = {f"train {first['arch']}": first["launches"],
              f"train {first['arch']} remat none": first["launches_remat_none"]}
    full = {}
    print(f"  (b) the other families, {TRAIN_FAMILY_STEPS} steps each")
    for arch, layers, experts in TRAIN_FAMILIES:
        c, nc = train_family(tag, dev, arch, layers, experts)
        causal[f"train {arch}"] = c
        if nc:
            full[f"train {arch}"] = nc
    return causal, full


def scatter_requests(coords, res, T: int, F: int, plan, blocks) -> dict:
    """The atomic requests of the corner scatter on these coordinates
    (B,N,3), as the kernels route them: each warp (32 consecutive points of
    a partition) adds one row per distinct corner row of each of the 8
    corners. A direct level's add is one 16-byte global atomic (F=8: two);
    a staged level's (``plan[l]`` true) is one shared-memory compare-and-
    swap loop per 4 features (F=1, 2: one), and a row-atomic flush then adds
    each row a block touched once (``blocks[l]``: the (N,) block of each
    point). Returns {"direct", "shared", "flush_rows"} and "before", the
    8 x F scalar global atomics per (point, level) of the first kernels."""
    import torch
    from repro_torch.kernels.hash_encoding import ref as he_ref
    B, N, _ = coords.shape
    direct = shared = flush = 0
    vec = 2 if F == 8 else 1
    pad = (-N) % 32
    for r, staged, block in zip(res, plan, blocks):
        lo, _ = he_ref._level_corners(coords.reshape(B * N, 3), r)
        idx = torch.stack([he_ref.corner_indices(
            lo + torch.tensor([dx, dy, dz], device=coords.device), r, T)
            for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)], -1)
        idx = idx.reshape(B, N, 8)
        warp = torch.nn.functional.pad(idx, (0, 0, 0, pad), value=-1)
        warp = warp.reshape(B, -1, 32, 8).sort(dim=2).values
        adds = int(((warp[:, :, 1:] != warp[:, :, :-1]) & (warp[:, :, 1:] >= 0)).sum()
                   + (warp[:, :, 0] >= 0).sum())
        if staged:
            shared += adds * max(1, F // 4)
            key = ((torch.arange(B, device=coords.device)[:, None, None]
                    * (int(block.max()) + 1) + block[None, :, None]) * T + idx)
            flush += int(torch.unique(key).numel()) * vec
        else:
            direct += adds * vec
    return {"direct": direct, "shared": shared, "flush_rows": flush,
            "before": 8 * F * len(res) * B * N}


@contextlib.contextmanager
def setting(module, name, value):
    """``module.name = value`` for the block."""
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def step_params(hc, P: int, dev, seed: int) -> dict:
    """Packed train-step state for config ``hc`` (P partitions): MLP
    weights U(-1,1) x sqrt(6 / fan-in), tables U(-0.05, 0.05) (a trained
    model's magnitude), made on the card from ``seed``."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, T, F = hc.n_levels, hc.table_size, hc.n_features_per_level
    W, H, D_out = hc.n_neurons, hc.n_hidden_layers, hc.out_dim

    def u(shape, scale):
        return (torch.rand(shape, generator=gen, device=dev) * 2 - 1) * scale

    return {"tab": u((P, L, T, F), 0.05),
            "win": u((P, L * F, W), (6.0 / (L * F)) ** 0.5),
            "whid": (u((P, H - 1, W, W), (6.0 / W) ** 0.5) if H > 1
                     else torch.zeros((P, 1, W, W), device=dev)),
            "wout": u((P, W, D_out), (6.0 / W) ** 0.5)}


def step_pred(params, H, res, coords):
    """The train step's forward in float64: the (P,N,D_out) predictions."""
    import torch
    from repro_torch.kernels.fused_train_step import ops as fts
    from repro_torch.kernels.hash_encoding.ref import hash_encode_batched_ref
    f64 = torch.float64
    part = torch.arange(coords.shape[0], device=coords.device)
    a = hash_encode_batched_ref(coords, params["tab"].to(f64), res, part)
    for w in fts._unpack(params, H)["mlp"][:-1]:
        a = torch.relu(a @ w.to(f64))
    return a @ params["wout"].to(f64)


def step_grads_f64(params, H, res, coords, target):
    """The plain version's function in float64: the gradients (rounded to
    float32) and the per-partition loss sum, every product and sum in
    float64, each ReLU and each residual's sign taken as the float32 plain
    version's forward takes them. Where the two evaluations disagree, the
    unit's input lies within float32 rounding of 0 and either side is a
    gradient of the function; the count of such units is returned too."""
    import torch
    from repro_torch.kernels.fused_train_step import ops as fts
    from repro_torch.kernels.hash_encoding.ref import (
        hash_encode_batched_bwd_ref, hash_encode_batched_ref)
    f64 = torch.float64
    P, N, _ = coords.shape
    D_out = target.shape[-1]
    part = torch.arange(P, device=coords.device)
    ws32 = fts._unpack(params, H)["mlp"]
    ws = [w.to(f64) for w in ws32]
    h32 = hash_encode_batched_ref(coords, params["tab"], res, part)
    acts = [hash_encode_batched_ref(coords, params["tab"].to(f64), res, part)]
    masks, ties = [], 0
    for w32, w in zip(ws32[:-1], ws[:-1]):
        z32 = torch.matmul(h32, w32)
        h32 = torch.relu(z32)
        z = acts[-1] @ w
        masks.append(z32 > 0)
        ties += int(((z > 0) != masks[-1]).sum())
        acts.append(z * masks[-1])
    diff = acts[-1] @ ws[-1] - target.to(f64)
    sign = torch.sign(torch.matmul(h32, ws32[-1]) - target)
    ties += int((torch.sign(diff) != sign).sum())
    d = sign.to(f64) / (N * D_out)
    dw = [None] * (H + 1)
    dw[H] = acts[H].transpose(1, 2) @ d
    d = d @ ws[H].transpose(1, 2)
    for l in range(H - 1, -1, -1):
        d = d * masks[l]
        dw[l] = acts[l].transpose(1, 2) @ d
        d = d @ ws[l].transpose(1, 2)
    grads = {"tab": hash_encode_batched_bwd_ref(d, coords, res, part,
                                                tuple(params["tab"].shape)),
             "win": dw[0],
             "whid": (torch.stack(dw[1:H], 1) if H > 1
                      else torch.zeros_like(params["whid"], dtype=f64)),
             "wout": dw[H]}
    return ({k: v.float() for k, v in grads.items()},
            diff.abs().sum((1, 2))), ties


#: Decisions taken at a tie. A ReLU's or an L1 residual's input is a tie
#: where its float64 value lies within its band of 0, and under bf16 a
#: value rounded to bfloat16 (an activation, a delta, dx) where its float64
#: value lies within its band of a rounding boundary (the midpoint of two
#: neighbours): the kernel may find it on the other side, and either side is
#: a derivative of the function there. A band is the bound on how far the
#: kernel's evaluation and the plain version's may lie from the exact sum
#: on the plain version's inputs: ``tie_rel(K)`` x the sum of its K terms'
#: magnitudes (any float32 order, the tensor cores' truncating adds
#: included, moves a sum of K terms by at most K x 2^-23 of that; 3xTF32's
#: products, each operand's head and tail kept to 11 bits and the
#: tail-tail product dropped, by at most 3 x 2^-22 = 6 x 2^-23 more, and two
#: more ulps take the two accumulators' sum and the output's rounding; bf16
#: products are exact in float32, so a bf16 sum of K terms moves by its K - 1
#: adds only, and a lone product, exact on both sides, rounds alike on
#: both), plus what the layers above may already
#: have changed in the sum's inputs (through |W|): under float32 each
#: hidden output may differ by its own band and the plain version's; under
#: bf16 only where it lies within its band of a rounding boundary (by that
#: plus one ulp) or of 0. At PRODUCTION256's first layer (K = 20) the band
#: is 2^-18.2 under float32 and 2^-18.8 under bf16, against 2^-21 for
#: 3xTF32's products alone.
TIE_ULP = 2.0 ** -23
#: the train step's features: the kernel's trilinear blend (corner weights
#: and their sum in another order) within this share of sum_c w_c |t_c| of
#: the plain version's (12 float32 ulps and a margin)
FEAT_REL = 2.0 ** -20
#: What each check holds (``check_tie_count``), each as a share of what it
#: counts. The first three count what the plain version's float64 function
#: finds in the operands (no kernel output enters them); the last counts the
#: rows on which the kernel took a tie's other side:
#: - TIE_SHARE_MAX: ReLU or L1 inputs within their own sum's band of 0, of
#:   the decisions;
#: - WIDENED_SHARE_MAX: ReLU or L1 inputs outside that but within the band
#:   widened by the layers above, of the decisions;
#: - ROUND_SHARE_MAX: under bf16, values within their band of a rounding
#:   boundary, of the values rounded;
#: - NEED_ROW_SHARE_MAX: rows whose dx departs from the plain version's by
#:   more than the plain limit, of the rows: the only rows whose ties earn an
#:   allowance on dW (a tie taken the other way moves its row's dx far more,
#:   relative to dx's limit, than it moves dW relative to dW's).
#: Each is set at about 4x the largest reading over the MLP backward's
#: cases, all of them the ABLATION-shaped one under bf16 (3.5e-5, 2.4e-3,
#: 3.5e-2 and, with the kernel's arithmetic emulated, 5.0e-4), read on the
#: CPU before the card ran them: tests/test_torch_mlp_bwd.py's
#: test_bf16_emulation_reproduces_the_ablation_departure runs that case's
#: check there (PERF.md §6).
TIE_SHARE_MAX = 1.5e-4
WIDENED_SHARE_MAX = 1e-2
ROUND_SHARE_MAX = 0.15
NEED_ROW_SHARE_MAX = 2e-3


def tie_rel(K: int, bf16: bool) -> float:
    """The band of a sum of K terms as a share of its terms' magnitudes:
    (K - 1) x 2^-23 for bf16 operands, (K + 8) x 2^-23 for float32 ones
    (3xTF32; see TIE_ULP)."""
    return (K - 1 if bf16 else K + 8) * TIE_ULP


def bf16_rounding_gap(v):
    """Per float64 value: its distance to the nearest bfloat16 rounding
    boundary (the midpoint of two neighbours; inf at 0) and the bfloat16 ulp
    at it, by which rounding to the other neighbour moves it."""
    import torch
    a = v.abs()
    ulp = torch.exp2(torch.floor(torch.log2(a.clamp_min(1e-300))) - 7)
    gap = (torch.remainder(a / ulp, 1.0) - 0.5).abs() * ulp
    return torch.where(a > 0, gap, torch.full_like(a, float("inf"))), ulp


def flip_allowance(ins, masks, wsb, starts, w_rows=None):
    """What the ties' other sides move: for each tie, the plain version's
    backward (float64, its own ReLU masks) of the one change that taking
    the other side makes, in absolute value, summed over the ties. ins[k]
    (B,N,K_k): the input of layer k (x, then each hidden layer's output), k
    = 0..H; masks[k] (B,N,W): hidden layer k's ReLU mask; wsb[k] (B,K_k,N_k):
    layer k's weights for each batch row; starts: (k, ties, change), ties
    (B,N,N_k) bool and change (B,N,N_k) the change of layer k's output
    cotangent a tie makes (after the mask for a hidden layer, the
    residual's for k = H); w_rows (B,N) bool, where given: the rows whose
    ties count towards dW (all rows where not). Returns the allowance on
    the input's cotangent (B,N,K_0) and on each dW_k, per batch row
    (B,K_k,N_k)."""
    import torch
    d_in = torch.zeros_like(ins[0])
    d_w = [torch.zeros_like(w) for w in wsb]
    for k0, ties, change in starts:
        b, n, j = ties.nonzero(as_tuple=True)
        for r in b.unique().tolist():
            rn, rj = n[b == r], j[b == r]
            keep = None if w_rows is None else w_rows[r, rn]
            delta = torch.zeros((len(rn), wsb[k0].shape[-1]), dtype=torch.float64,
                                device=b.device)
            delta[torch.arange(len(rn), device=b.device), rj] = change[r, rn, rj]
            for k in range(k0, -1, -1):
                if keep is None:
                    d_w[k][r] += ins[k][r, rn].abs().T @ delta.abs()
                elif keep.any():
                    d_w[k][r] += ins[k][r, rn[keep]].abs().T @ delta[keep].abs()
                c = delta @ wsb[k][r].T
                if k:
                    delta = c * masks[k - 1][r, rn]
                else:
                    d_in[r].index_add_(0, rn, c.abs())
    return d_in, d_w


def forward_ties(h, w32, dtype, e_in=None) -> dict:
    """The plain version's forward through the hidden layers (h: its
    float32 input rows (B,N,K_0); w32: each layer's float32 weights per
    batch row, the output layer's last; each hidden output rounded to
    ``dtype``) with its float64 function's ties (``tie_rel``): ``e_in``
    (B,N,K_0), where given, bounds how far the kernel's input rows may lie
    from h. Returns {"ins": each layer's float64 input, "masks": the plain
    version's ReLU masks, "ties": (B,N,W) bool a hidden layer, "base": the
    ties within their own sum's band, "da": a bound on how far the kernel's
    last hidden output may lie from the plain version's, "h": that output
    (float32), "round": bf16 values within their own sum's band of a
    rounding boundary, "round_wide": more within the widened bands,
    "rounded": bf16 values rounded}."""
    import torch
    f64 = torch.float64
    bf16 = dtype == torch.bfloat16
    ins, masks, ties, n_base = [h.to(f64)], [], [], 0
    n_round, n_wide, n_rounded, da = 0, 0, 0, e_in
    for w in w32[:-1]:
        w64 = w.to(f64)
        z = torch.matmul(h, w)
        masks.append(z > 0)
        z64 = ins[-1] @ w64
        base = tie_rel(w.shape[-2], bf16) * (ins[-1].abs() @ w64.abs())
        band = base if da is None else base + da @ w64.abs()
        n_base += int((z64.abs() < base).sum())
        ties.append(z64.abs() < band)
        h = torch.relu(z).to(dtype).float()
        ins.append(h.to(f64))
        if bf16:
            # both sides round to one neighbour unless the value lies
            # within its band of a boundary; a ReLU tie's output is within
            # its band of 0 on either side
            gap, ulp = bf16_rounding_gap(torch.relu(z64))
            at, own = gap < band, int((gap < base).sum())
            n_round, n_wide = n_round + own, n_wide + int(at.sum()) - own
            n_rounded += at.numel()
            da = torch.where(at | ties[-1], band + base, 0.0) + torch.where(at, ulp, 0.0)
        else:
            # the kernel's output within its band of the float64 value, the
            # plain version's within its own sum's band
            da = torch.where(z64 > -band, band + base, 0.0)
    return {"ins": ins, "masks": masks, "ties": ties, "base": n_base, "da": da, "h": h,
            "round": n_round, "round_wide": n_wide, "rounded": n_rounded}


def mlp_ties(x, ws, g, part, rows=None) -> dict:
    """The MLP backward's ties on these operands, and the allowance they
    earn: the plain version (fused_mlp/ref.py) run as it runs gives the ReLU
    masks and the bf16 values, its float64 function the ties
    (``forward_ties``; under bf16 also the deltas and dx within their band,
    widened by what the ties above may change in them, of a bfloat16
    rounding boundary). The allowance is flip_allowance's, under bf16 2^-7
    above it (its deltas are bf16), plus one ulp for each dx element at a
    rounding tie; on dW only the ties of ``rows`` (B,N) bool count, where
    given (the rows whose dx departs beyond the plain limit). An
    activation's rounding moves dW only through its own row's term (2^-8 of
    one of the partition's row terms) and is not counted. Returns {"dx"
    (B,N,D_in), "dW" [per partition, the weights' shapes], "ties": ReLU ties
    within their own sum's band, "widened": those within the widened bands
    only, "decisions": ReLU units, "round": bf16 values within their own
    sum's band of a rounding boundary, "round_wide": more within the
    widened bands, "rounded": bf16 values rounded, "n": rows}."""
    import torch
    f64 = torch.float64
    bf16 = x.dtype == torch.bfloat16
    dev = x.device
    idx = torch.as_tensor(part, device=dev).long()
    w32 = [w[idx].float() for w in ws]
    wsb = [w.to(f64) for w in w32]
    fw = forward_ties(x.float(), w32, x.dtype)
    ins, masks, ties = fw["ins"], fw["masks"], fw["ties"]
    n_round, n_wide, n_rounded = fw["round"], fw["round_wide"], fw["rounded"]
    # the backward from the top: under bf16 a delta's rounding band also
    # takes the change the ties above may make to it (``up``: a bound on
    # each delta's change, propagated in magnitudes)
    starts, d, up = [], g.float(), None
    for k in range(len(masks) - 1, -1, -1):
        wt = wsb[k + 1].transpose(1, 2)
        c64 = d.to(f64) @ wt
        tie = ties[k]
        change = torch.where(tie, c64.abs(), 0.0)
        if bf16:
            above = 0.0 if up is None else up @ wt.abs()
            gap, ulp = bf16_rounding_gap(c64)
            own_band = tie_rel(wt.shape[-2], True) * (d.to(f64).abs() @ wt.abs())
            own, rt = masks[k] & (gap < own_band), masks[k] & (gap < own_band + above)
            n_round, n_rounded = n_round + int(own.sum()), n_rounded + int(masks[k].sum())
            n_wide += int(rt.sum()) - int(own.sum())
            up = torch.where(tie, c64.abs() * (1 + 2.0 ** -7) + above, 0.0) \
                + torch.where(rt, above + ulp, 0.0)
            change = change * (1 + 2.0 ** -7) + torch.where(rt, ulp, 0.0)
            tie = tie | rt
        starts.append((k, tie, change))
        d = torch.matmul(d, w32[k + 1].transpose(1, 2)).to(x.dtype).float() * masks[k]
    d_in, d_w = flip_allowance(ins, masks, wsb, starts, rows)
    if bf16:
        wt = wsb[0].transpose(1, 2)
        gap, ulp = bf16_rounding_gap(d.to(f64) @ wt)
        own_band = tie_rel(wt.shape[-2], True) * (d.to(f64).abs() @ wt.abs())
        own, rt = gap < own_band, gap < own_band + up @ wt.abs()
        d_in = d_in * (1 + 2.0 ** -7) + torch.where(rt, ulp, 0.0)
        n_round, n_rounded = n_round + int(own.sum()), n_rounded + rt.numel()
        n_wide += int(rt.sum()) - int(own.sum())
    P = ws[0].shape[0]
    dW = [torch.zeros((P, *w.shape[1:]), dtype=f64, device=dev).index_add_(0, idx, a)
          for w, a in zip(wsb, d_w)]
    return {"dx": d_in.float(), "dW": [a.float() for a in dW], "ties": fw["base"],
            "widened": int(sum(int(t.sum()) for t in ties)) - fw["base"],
            "decisions": sum(t.numel() for t in ties), "round": n_round,
            "round_wide": n_wide, "rounded": n_rounded, "n": x.shape[0] * x.shape[1]}


def check_tie_count(label, counts) -> None:
    """Print a check's tie counts, each (what, count, of what, share), and
    fail where a count exceeds its share of what it counts (at least one)."""
    capped = [(what, n, of, max(1.0, share * of)) for what, n, of, share in counts]
    bad = [c for c in capped if c[1] > c[3]]
    print(f"  {label}: " + "; ".join(f"{what} {n:,} of {of:,} (held to {cap:.0f})"
                                     for what, n, of, cap in capped)
          + f"  {'FAIL' if bad else 'ok'}")
    if bad:
        raise SmokeFailure(f"{label}: " + "; ".join(
            f"{what} {n} of {of}, above {cap:.0f}" for what, n, of, cap in bad))


def must_fail(label, check_fn) -> None:
    """A control: ``check_fn`` holds a planted fault and must raise
    SmokeFailure; fails where it passes."""
    print(f"  control, must fail: {label}")
    try:
        check_fn()
    except SmokeFailure as e:
        print(f"  control caught: {label}: {e}")
        return
    raise SmokeFailure(f"control {label}: the check passed a planted fault")


def step_ties(params, H, res, coords, target):
    """The f32 train step's ties on this batch (``forward_ties``: ReLU
    inputs, and L1 residuals, within their band of 0, from the float32
    plain version's forward in float64; the kernel's features within
    FEAT_REL of the plain version's) and the allowance they earn on each
    gradient (flip_allowance; a residual taken the other way moves its
    cotangent by 2 / (N D_out); the table's share through the plain
    hash-encode backward). Returns ({"tab", "win", "whid", "wout"}, ties
    within their own sum's band, those within the widened bands only,
    decisions)."""
    import torch
    from repro_torch.kernels.fused_train_step import ops as fts
    from repro_torch.kernels.hash_encoding.ref import (
        hash_encode_batched_bwd_ref, hash_encode_batched_ref)
    f64 = torch.float64
    P, N, _ = coords.shape
    D_out = target.shape[-1]
    part = torch.arange(P, device=coords.device)
    ws32 = fts._unpack(params, H)["mlp"]
    wsb = [w.to(f64) for w in ws32]
    h = hash_encode_batched_ref(coords, params["tab"], res, part)
    e_feat = FEAT_REL * hash_encode_batched_ref(coords, params["tab"].abs(), res,
                                                part).to(f64)
    fw = forward_ties(h, ws32, torch.float32, e_feat)
    ins, masks, ties = fw["ins"], fw["masks"], fw["ties"]
    t64, w64 = target.to(f64), wsb[-1]
    r64 = ins[-1] @ w64 - t64
    base = tie_rel(w64.shape[-2] + 1, False) * (ins[-1].abs() @ w64.abs() + t64.abs())
    rties = r64.abs() < base + fw["da"] @ w64.abs()
    step = 1.0 / (N * D_out)
    starts = [(H, rties, torch.full_like(t64, 2 * step))]
    c = torch.sign(torch.matmul(fw["h"], ws32[-1]) - target).to(f64) * step \
        @ wsb[H].transpose(1, 2)
    for k in range(H - 1, -1, -1):
        starts.append((k, ties[k], c.abs()))
        c = (c * masks[k]) @ wsb[k].transpose(1, 2)
    d_feat, d_w = flip_allowance(ins, masks, wsb, starts)
    n_base = fw["base"] + int((r64.abs() < base).sum())
    n_all = int(rties.sum()) + sum(int(t.sum()) for t in ties)
    decisions = rties.numel() + sum(t.numel() for t in ties)
    allow = {"tab": hash_encode_batched_bwd_ref(d_feat, coords, res, part,
                                                tuple(params["tab"].shape)),
             "win": d_w[0],
             "whid": (torch.stack(d_w[1:H], 1) if H > 1
                      else torch.zeros_like(params["whid"], dtype=f64)),
             "wout": d_w[H]}
    return {k: v.float() for k, v in allow.items()}, n_base, n_all - n_base, decisions


def step_wants(params, H, res, coords, target) -> dict:
    """The train step's two yardsticks on this batch: the plain version as
    it runs (float32) and its function in float64 (``step_grads_f64``),
    with the allowance of the batch's ties (``step_ties``)."""
    from repro_torch.kernels.fused_train_step import ref as fts_ref
    want64, ties = step_grads_f64(params, H, res, coords, target)
    allow, n_ties, widened, decisions = step_ties(params, H, res, coords, target)
    return {"float32 plain": fts_ref.train_step_grads_ref(params, H, res, coords,
                                                          target),
            "float64": want64, "ties": ties, "allow": allow,
            "tie_count": n_ties, "widened": widened, "decisions": decisions}


def check_step_grads(label, H, got_g, got_loss, wants, keys=None) -> float:
    """The train step's gradients and loss sum against both yardsticks of
    ``step_wants``: each gradient within 2e-5 x its largest |entry|
    (float32 sums in an order that atomics change from run to run; in-kernel
    draws: uniform rows bit-exact, boundary rows within a few ulp of
    logf/cosf), plus the allowance of the batch's ties (``step_ties``: the
    rows whose ReLU or L1 decision lies within rounding of 0 may take the
    other side in the kernel), the loss sum within 1e-5 relative. Prints,
    per gradient, the departures from each yardstick as fractions of that
    limit without the ties' allowance, the float32 plain version's from
    float64, and the ties (failing above TIE_SHARE_MAX of the decisions)."""
    from repro_torch.kernels.fused_train_step import ops as fts
    keys = keys or [k for k in fts.STATE_KEYS if k != "whid" or H > 1]
    w32, w64 = wants["float32 plain"][0], wants["float64"][0]
    frac = lambda a, b, k: float((a[k] - b[k]).abs().max()) / (
        2e-5 * float(b[k].abs().max()))
    print(f"  train_step ({label}): kernel's departure / limit from the float32 "
          f"plain version, from float64 (the float32 plain version's from "
          f"float64), before the ties' allowance: " + ", ".join(
              f"{k} {frac(got_g, w32, k):.4f}, {frac(got_g, w64, k):.4f} "
              f"({frac(w32, w64, k):.4f})" for k in keys)
          + f"; {wants['ties']} float32 ties")
    check_tie_count(f"train_step ({label})", [
        ("ReLU/L1 ties", wants["tie_count"], wants["decisions"], TIE_SHARE_MAX),
        ("more in the widened bands", wants["widened"], wants["decisions"],
         WIDENED_SHARE_MAX)])
    err = 0.0
    for name in ("float32 plain", "float64"):
        want, want_loss = wants[name]
        for k in keys:
            err = max(err, check(f"train_step ({label}) grad {k} vs {name}",
                                 got_g[k], want[k],
                                 atol=2e-5 * float(want[k].abs().max()),
                                 slack=wants["allow"][k]))
        check(f"train_step ({label}) loss sum vs {name}", got_loss, want_loss,
              atol=0.0, rtol=1e-5)
    return err


@contextlib.contextmanager
def deterministic_algorithms():
    """``torch.use_deterministic_algorithms(True)`` for the block: the
    switch that sends the fused train step down its deterministic route."""
    import torch
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before)


def det_step(label, params, H, res, **batch):
    """The train step's deterministic route on ``batch``: two launches must
    give the same bits (group rows, fixed-point table gradient), no flag
    may be set, and the last partition launched alone must give its row of
    the stacked launch bit for bit (the route's sums do not depend on the
    grid). Returns its gradients and loss sum as the AdamW kernel reads
    them (``det_grads_to_float``)."""
    import torch
    from repro_torch.kernels.fused_train_step import ops as fts
    P = params["tab"].shape[0]
    with deterministic_algorithms():
        a, _ = fts.train_step_cuda(params, H, res, **batch)
        b, _ = fts.train_step_cuda(params, H, res, **batch)
        p = P - 1
        one = {k: v[p:p + 1].contiguous() for k, v in params.items()}
        cut = {k: (v[p:p + 1].contiguous()
                   if k in ("coords", "target", "volumes", "seeds") else v)
               for k, v in batch.items()}
        c, _ = fts.train_step_cuda(one, H, res, **cut)
        if params["win"].shape[2] == 16 and params["tab"].shape[3] == 4:
            det_yardstick_equal(label, a, params, H, res, **batch)
    same = torch.equal(a.partials, b.partials) and torch.equal(a.tab_fx, b.tab_fx)
    alone = torch.equal(c.partials[0], a.partials[p]) and \
        torch.equal(c.tab_fx[0], a.tab_fx[p])
    flags = int(a.flags.max())
    print(f"  train_step ({label}), deterministic route: two launches bit for "
          f"bit {same}; partition {p} alone = its row of the {P}-partition "
          f"launch {alone}; flags {flags}; {a.partials.shape[1]} groups")
    if not (same and alone) or flags:
        raise SmokeFailure(f"train_step ({label}) deterministic route: repeat "
                           f"{same}, alone {alone}, flags {flags}")
    return fts.det_grads_to_float(a, params, H)


def check_step(label, params, H, res, wants, **batch) -> float:
    """The train-step kernel on ``batch`` held by ``check_step_grads``, on
    its default route and on its deterministic one (``det_step``)."""
    from repro_torch.kernels.fused_train_step import ops as fts
    got_g, got_loss = fts.train_step_cuda(params, H, res, **batch)
    err = check_step_grads(label, H, got_g, got_loss, wants)
    det_g, det_loss = det_step(label, params, H, res, **batch)
    DET_ERRS["train_step_det"] = max(DET_ERRS["train_step_det"], check_step_grads(
        f"{label}, deterministic route", H, det_g, det_loss, wants))
    return err


def under_det(fn):
    """``fn`` run under ``deterministic_algorithms`` (for the timers)."""
    def run():
        with deterministic_algorithms():
            return fn()
    return run


#: the deterministic route's largest departures in phase 2's checks so far
#: (read after the main batch's: the kernels line's max_abs_err of its rows)
DET_ERRS = {"train_step_det": 0.0, "train_step_det_bf16": 0.0}


#: a bf16 kernel's largest departure from its bf16 plain version, as a
#: fraction of the output's largest |entry|, per output (see check_bf16).
#: Each lies between two readings of this script's phase 2 over three runs
#: (NVIDIA H100 80GB HBM3, 700.00 W): the kernel's largest departure over
#: every batch (train step tab 1.3e-5, win 5.3e-5, whid 8e-6, wout 4.4e-7;
#: MLP backward dx 0, dW 3.9e-6) and the float32 policy's smallest (tab
#: 1.2e-3, win 9.6e-4, whid 5.9e-4, wout 2.1e-5; dx 0.50, dW 1.7e-3), which
#: misses every bf16 rounding point
BF16_LIMITS = {"tab": 1e-4, "win": 2e-4, "whid": 1e-4, "wout": 5e-6,
               "dx": 1e-4, "dW": 1e-4}
#: ``whid`` in the contention cell: the kernel departs by 3.3e-4 there, the
#: float32 policy by 3.8e-4, so no limit tells them apart; this one only
#: catches a gross fault
BF16_WHID_CONTENTION = 1e-3
#: the first 16 losses of a run with bf16 params or compute against
#: ``backend="ref"`` under the same policy, relative (phase 5; see
#: bf16_training), set from readings of this script over seven runs
#: (NVIDIA H100 80GB HBM3, 700.00 W): the float32 policy's departure from
#: the same bf16 reference is systematic, 8.38e-4 to 8.62e-4; a run with
#: the bf16 kernels departs by the noise of atomic sum orders, 1.4e-5 to 3.1e-4
#: (mixed policies included). The bound sits 2x above that noise's
#: largest reading and 1.4x under the float32 policy's
BF16_LOSS_RTOL = 6e-4


def loss_departure(losses, ref) -> float:
    """The largest |losses - ref| / |ref| over the first COMPARE_STEPS."""
    import torch
    got = torch.as_tensor(losses[:COMPARE_STEPS], dtype=torch.float64)
    return float(((got - ref).abs() / ref.abs()).max())


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float32."""
    import torch
    return float(torch.linalg.vector_norm((a.float() - b.float()).reshape(-1))
                 / torch.linalg.vector_norm(b.float().reshape(-1)).clamp_min(1e-30))


def check_bf16(label, got, want, want32, limit, separable=True, slack=None) -> float:
    """A bf16 training kernel's output against its bf16 plain version
    (``want``) and the float32 policy's plain version on the same values
    widened (``want32``). The kernel rounds where the plain version rounds,
    but sums in float32 in another order, so a value within float32
    rounding of a bf16 tie may round the other way and move what follows it
    by one bf16 ulp (2^-8 relative): every entry within ``limit`` x the
    largest |entry| (BF16_LIMITS). Where the readings separate the two
    (``separable``), the kernel must also hold the bf16 rounding points by
    relative L2: its departure at most a quarter of the float32 policy's.
    Not where they do not: in the contention cell's ``whid`` the samples are
    near-copies, so one flip between float32 sum orders hits most of them at
    once and the kernel's departure nears the float32 policy's (printed, not
    held); nor where no rounding point reaches the output (the float32
    policy's departure is 0, as for dW_in of a one-hidden-layer MLP, whose
    delta g W_out^T is exact in bf16). ``slack``: the allowance of ties (``mlp_ties``), added to each
    entry's limit and taken off its departure in the relative L2. Prints
    both departures."""
    import torch
    lim = limit * max(1e-30, float(want.float().abs().max()))
    dep = float((got.float() - want.float()).abs().max())
    d32 = float((want32.float() - want.float()).abs().max())
    excess = (got.float() - want.float()).abs()
    if slack is not None:
        excess = (excess - slack).clamp_min(0.0)
    r = float(torch.linalg.vector_norm(excess.reshape(-1))
              / torch.linalg.vector_norm(want.float().reshape(-1)).clamp_min(1e-30))
    r32 = rel_l2(want32, want)
    # where no rounding point reaches this output (r32 = 0: the two
    # policies agree), there is nothing for the L2 bound to hold
    held = separable and r32 > 0
    ok = r <= 0.25 * r32 or not held
    print(f"  {label}: departure from the bf16 plain version / limit "
          f"{dep / lim:.4f} (the float32 policy's {d32 / lim:.4f}); relative "
          f"L2 {r:.3e} (the float32 policy's {r32:.3e}"
          f"{', limit a quarter of it' if held else '; not held'})"
          f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{label}: relative L2 departure {r:.3e} from the "
                           f"bf16 plain version, not below a quarter of the "
                           f"float32 policy's {r32:.3e}")
    return check(f"{label} vs bf16 plain", got, want, atol=lim, slack=slack)


def step_wants_bf16(params16, H, res, coords, target) -> dict:
    """The bf16 train step's yardsticks on this batch: the bf16 plain
    version, and the float32 policy's plain version on the same values."""
    from repro_torch.kernels.fused_train_step import ref as fts_ref
    return {"bf16 plain": fts_ref.train_step_grads_ref(params16, H, res, coords,
                                                       target),
            "float32 plain": fts_ref.train_step_grads_ref(
                {k: v.float() for k, v in params16.items()}, H, res, coords,
                target)}


def check_step_bf16(label, params16, H, res, wants, contention=False,
                    **batch) -> float:
    """The bf16 train-step kernel on ``batch`` held by ``check_bf16``
    gradient by gradient (``contention``: the one-cell batch, whose ``whid``
    the readings cannot separate); the loss sum within 1e-3 relative of the
    bf16 plain version's (a prediction's rounding flip moves one |diff| by
    an ulp)."""
    from repro_torch.kernels.fused_train_step import ops as fts
    (want, want_loss), want32 = wants["bf16 plain"], wants["float32 plain"][0]
    errs = {}
    for route, (got_g, got_loss) in (
            ("", fts.train_step_cuda(params16, H, res, **batch)),
            (", deterministic route", det_step(f"bf16 {label}", params16, H, res,
                                               **batch))):
        err = 0.0
        for k in fts.STATE_KEYS:
            if k != "whid" or H > 1:
                loose = contention and k == "whid"
                err = max(err, check_bf16(
                    f"train_step bf16 ({label}{route}) grad {k}", got_g[k],
                    want[k], want32[k],
                    BF16_WHID_CONTENTION if loose else BF16_LIMITS[k],
                    separable=not loose))
        check(f"train_step bf16 ({label}{route}) loss sum", got_loss, want_loss,
              atol=0.0, rtol=1e-3)
        errs[route] = err
    DET_ERRS["train_step_det_bf16"] = max(DET_ERRS["train_step_det_bf16"],
                                          errs[", deterministic route"])
    return errs[""]


def check_mlp_bwd(label, x, ws, g, part, got=None) -> float:
    """The MLP backward kernel on (x, ws, g) (or ``got``, its (dx, dW)
    output) against its plain version, plus the allowance of the operands'
    ties (``mlp_ties``, on dW only from the rows whose dx departs beyond
    the plain limit; the tie counts and those rows printed and held,
    ``check_tie_count``): float32 dx within 2e-6 x max|dx| (W-term sums on
    the tensor cores in another order), each dW within 2e-5 x its max (sums
    over a partition's rows, per warp, per block, then atomic adds); bf16
    by ``check_bf16`` at BF16_LIMITS against the bf16 plain version and the
    float32 policy's. Returns dx's largest error."""
    import torch
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_bwd_cuda
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_batched_bwd_ref
    part_d = torch.tensor(part, device=x.device)
    dx_k, dws_k = fused_mlp_bwd_cuda(x, ws, g, part) if got is None else got
    dx_p, dws_p = fused_mlp_batched_bwd_ref(x, ws, g, part_d)
    f32 = x.dtype == torch.float32
    limit = (2e-6 if f32 else BF16_LIMITS["dx"]) * max(
        1e-30, float(dx_p.float().abs().max()))
    departs = (dx_k.float() - dx_p.float()).abs() > limit
    rows = departs.any(-1)
    ties = mlp_ties(x, ws, g, part_d, rows)
    counts = [("ReLU ties", ties["ties"], ties["decisions"], TIE_SHARE_MAX),
              ("more in the widened bands", ties["widened"], ties["decisions"],
               WIDENED_SHARE_MAX)]
    if not f32:
        counts.append(("values at a rounding tie", ties["round"], ties["rounded"],
                       ROUND_SHARE_MAX))
        print(f"  fused_mlp_bwd {label}: {ties['round_wide']:,} more values at a "
              f"rounding tie in the widened bands (each earns an allowance on its "
              f"own row only, where the rows are held)")
    counts.append((f"rows whose dx needed the allowance ({int(departs.sum()):,} "
                   f"elements)", int(rows.sum()), ties["n"], NEED_ROW_SHARE_MAX))
    check_tie_count(f"fused_mlp_bwd {label}", counts)
    if f32:
        err = check(f"fused_mlp_bwd {label} dx", dx_k, dx_p,
                    atol=2e-6 * max(1e-30, float(dx_p.abs().max())), slack=ties["dx"])
        for i, (a, b) in enumerate(zip(dws_k, dws_p)):
            check(f"fused_mlp_bwd {label} dW[{i}]", a, b,
                  atol=2e-5 * float(b.abs().max()), slack=ties["dW"][i])
        return err
    dx_32, dws_32 = fused_mlp_batched_bwd_ref(
        x.float(), [w.float() for w in ws], g.float(), part_d)
    err = check_bf16(f"fused_mlp_bwd {label} dx", dx_k, dx_p, dx_32,
                     BF16_LIMITS["dx"], slack=ties["dx"])
    for i, (a, b, c) in enumerate(zip(dws_k, dws_p, dws_32)):
        check_bf16(f"fused_mlp_bwd {label} dW[{i}]", a, b, c, BF16_LIMITS["dW"],
                   slack=ties["dW"][i])
    return err


def mlp_bwd_controls(label, x, ws, g, part, got) -> None:
    """Phase 2's controls of ``check_mlp_bwd`` at the full batch, each of
    which must fail with the ties' allowance applied: the kernel's output
    ``got`` with one 16-row pass left out of dW (the plain version's dW of
    16 rows of the first batch row, from row N/2 on a tile boundary, taken
    off; dx as the kernel gave it) and, under bf16, the float32 policy's dx
    (rounded to bf16) and dW on the same values."""
    import torch
    from repro_torch.kernels.fused_mlp.ref import fused_mlp_batched_bwd_ref
    dx_k, dws_k = got
    part_d = torch.tensor(part, device=x.device)
    s = x.shape[1] // 2 // 32 * 32
    _, dws_c = fused_mlp_batched_bwd_ref(x[:1, s:s + 16], ws, g[:1, s:s + 16],
                                         part_d[:1])
    must_fail(f"fused_mlp_bwd {label}, one 16-row pass left out of dW",
              lambda: check_mlp_bwd(f"{label} (pass left out)", x, ws, g, part,
                                    (dx_k, [a - c for a, c in zip(dws_k, dws_c)])))
    if x.dtype == torch.bfloat16:
        dx_32, dws_32 = fused_mlp_batched_bwd_ref(
            x.float(), [w.float() for w in ws], g.float(), part_d)
        must_fail(f"fused_mlp_bwd {label}, the float32 policy's dx and dW",
                  lambda: check_mlp_bwd(f"{label} (float32 policy)", x, ws, g, part,
                                        (dx_32.to(x.dtype), dws_32)))


def mlp_bwd_case_checks(dev) -> None:
    """Phase 2's further MLP backward cases, float32 and bf16, each held by
    ``check_mlp_bwd``: N not a multiple of 32, H = 1 (CLOVERLEAF_CACHE: the
    dummy hidden slab), H = 3 (NEKRS), W = 32, W = 64 with D_in = 80
    (ABLATION: L = 10, F = 8, H = 3), D_out = 3, a permuted ``part`` over
    P = 5 partitions, and D_in = 5 (odd: x copied in 4-byte cp.async units
    under float32, stored value by value under bf16). Inputs of the training path's magnitudes:
    features U(-0.05, 0.05), weights U(-1,1) x sqrt(6 / fan-in), cotangents
    +-1/N; from a generator of their own."""
    import numpy as np
    import torch
    rng = np.random.default_rng(18)
    for label, P, part, N, D_in, W, H, D_out in MLP_BWD_CASES:
        dims = [D_in] + [W] * H + [D_out]
        ws = [torch.as_tensor(rng.uniform(-1, 1, (P, a, b)) * np.sqrt(6.0 / a),
                              dtype=torch.float32, device=dev)
              for a, b in zip(dims[:-1], dims[1:])]
        B = len(part)
        x = torch.as_tensor(rng.uniform(-0.05, 0.05, (B, N, D_in)),
                            dtype=torch.float32, device=dev)
        g = torch.as_tensor(rng.choice([-1.0, 1.0], (B, N, D_out)) / N,
                            dtype=torch.float32, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            check_mlp_bwd(f"{label} {str(dt)[6:]}", x.to(dt), [w.to(dt) for w in ws],
                          g.to(dt), part)
        del ws, x, g
    torch.cuda.synchronize()


#: the further table draws the host-sampled train-step check is re-run on
#: (U(-0.05, 0.05) from np.random.default_rng(seed)): the draw that failed
#: (shared_generator_tables) and these, which a scratch probe found to
#: include others that fail without the ties' allowance
TIE_DRAW_SEEDS = tuple(range(1, 13))


def shared_generator_tables(shape, cfg):
    """Phase 2's U(-0.05, 0.05) table draw for the training kernels as it was
    when the INR inference checks drew their coordinates from the shared
    generator (np.random.default_rng(0)) instead of one of their own: the
    draw on which the host-sampled train-step check failed on tab at 15.45x
    its limit (ROADMAP §C). Replays that generator's draws in phase 2's
    order."""
    import numpy as np
    rng = np.random.default_rng(0)
    P, B = 8, 16
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    D_in, W = L * F, cfg.n_neurons
    rng.integers(0, P, B)                                   # part
    rng.uniform(-1, 1, (P, L, T, F))                        # the tables
    for N, lo, hi in ((CHECK_N[0], 0.0, 1.0), (CHECK_N[1], -0.25, 1.25)):
        rng.uniform(lo, hi, (B, N, 3))                      # hash_encode's
    for H, D_out, N in ((cfg.n_hidden_layers, cfg.out_dim, CHECK_N[0]),
                        (1, 1, 1_000), (3, 3, CHECK_N[1])):
        dims = [D_in] + [W] * H + [D_out]
        for a, b in zip(dims[:-1], dims[1:]):
            rng.uniform(-1, 1, (P, a, b))                   # the MLP's weights
        rng.uniform(-1, 1, (B, N, D_in))                    # its rows
        for lo, hi in ((0.0, 1.0), (-0.25, 1.25)):
            rng.uniform(lo, hi, (B, N, 3))                  # the INR checks'
    for Rn, S in ((CHECK_N[0], 67), (1_000, 5)):
        rng.uniform(0, 1, (Rn, S, 4))                       # compositing's
    return rng.uniform(-0.05, 0.05, shape)


def step_tie_draws(dev, params, H, res, coords, target, cfg) -> None:
    """Phase 2: the host-sampled train-step check (``check_step_grads``,
    with the ties' allowance) on the table draw that failed before it
    (``shared_generator_tables``) and on TIE_DRAW_SEEDS' draws, each with
    its departures before the allowance and its tie rows printed; counts
    the draws that depart beyond the limit without the allowance. On the
    first draw a control must fail: the kernel's gradients with 16 samples
    of partition 0 left out (their plain gradients taken off)."""
    import numpy as np
    import torch
    from repro_torch.kernels.fused_train_step import ops as fts
    from repro_torch.kernels.fused_train_step import ref as fts_ref
    shape = tuple(params["tab"].shape)
    draws = [("the shared generator's draw", shared_generator_tables(shape, cfg))]
    draws += [(f"seed {s}", np.random.default_rng(s).uniform(-0.05, 0.05, shape))
              for s in TIE_DRAW_SEEDS]
    keys = [k for k in fts.STATE_KEYS if k != "whid" or H > 1]
    beyond = []
    for label, tab in draws:
        p = dict(params, tab=torch.as_tensor(tab, dtype=torch.float32, device=dev))
        wants = step_wants(p, H, res, coords, target)
        got_g, got_loss = fts.train_step_cuda(p, H, res, coords=coords, target=target)
        worst = max(float((got_g[k] - w[0][k]).abs().max())
                    / (2e-5 * float(w[0][k].abs().max()))
                    for w in (wants["float32 plain"], wants["float64"]) for k in keys)
        if worst > 1:
            beyond.append(label)
        check_step_grads(f"host-sampled, tables of {label}", H, got_g, got_loss, wants)
        if label == draws[0][0]:
            # the control: 16 samples of partition 0 left out of every gradient
            part16, _ = fts_ref.train_step_grads_ref(p, H, res, coords[:, :16],
                                                     target[:, :16])
            short = {k: v.clone() for k, v in got_g.items()}
            for k in short:
                short[k][0] -= part16[k][0] * (16 / coords.shape[1])
            must_fail(f"train_step, tables of {label}, 16 samples left out",
                      lambda: check_step_grads(f"16 samples left out, tables of {label}",
                                               H, short, got_loss, wants))
            del part16, short
        del p, wants, got_g
    print(f"  train_step tie draws: {len(beyond)} of {len(draws)} depart beyond the "
          f"limit without the ties' allowance ({beyond}); every one passes with it")


def step_case_checks(dev, vols_c, tseeds, cfg) -> None:
    """Phase 2's further train-step cases: every sample in one coarse cell
    (the warp pre-reduction under contention), PRODUCTION's T=2^16, F=1 (a
    ragged batch) and F=2, an ABLATION-shaped step (W=64, H=3, L=10, F=8,
    T=2^19). Each held by ``check_step``, host-sampled and, where the batch
    can be drawn, drawing in the kernel; and the bf16 kernel on the same
    params rounded to bf16, held by ``check_step_bf16``."""
    import numpy as np
    import torch
    from repro_torch.configs.dvnr import ABLATION, PRODUCTION
    from repro_torch.core.sampling import n_boundary
    from repro_torch.kernels.fused_train_step import ref as fts_ref

    rng = np.random.default_rng(5)
    cases = (
        ("contention: one coarse cell", cfg, 8, cfg.batch_size, (0.30, 0.31)),
        ("PRODUCTION T=2^16", PRODUCTION, 8, PRODUCTION.batch_size, None),
        ("F=1, N=40,009", cfg.replace(n_features_per_level=1), 8, 40_009, None),
        ("F=2", cfg.replace(n_features_per_level=2), 4, cfg.batch_size, None),
        ("ABLATION W=64 H=3 L=10 F=8 T=2^19", ABLATION, 2, ABLATION.batch_size,
         None),
    )
    for i, (label, hc, hP, hN, cell) in enumerate(cases):
        res, H = hc.level_resolutions(), hc.n_hidden_layers
        params = step_params(hc, hP, dev, seed=100 + i)
        if cell is None:
            n_uni = hN - n_boundary(hN, hc.boundary_lambda)
            draw = dict(n_batch=hN, n_uniform=n_uni, sigma=hc.boundary_sigma,
                        ghost=1)
            coords, target = fts_ref.sample_batch(
                vols_c[:hP], tseeds[:hP], n_batch=hN,
                boundary_lambda=hc.boundary_lambda, sigma=hc.boundary_sigma,
                ghost=1)
        else:
            # targets above every prediction: the cotangents share one
            # sign, so the sums into the cell's rows do not cancel
            coords = torch.as_tensor(rng.uniform(*cell, (hP, hN, 3)),
                                     dtype=torch.float32, device=dev)
            target = torch.full(
                (hP, hN, 1), float(step_pred(params, H, res, coords).max()) + 1.0,
                device=dev)
        wants = step_wants(params, H, res, coords, target)
        check_step(f"{label}, host-sampled", params, H, res, wants,
                   coords=coords, target=target)
        if cell is None:
            check_step(f"{label}, in-kernel sampling", params, H, res, wants,
                       volumes=vols_c[:hP], seeds=tseeds[:hP], **draw)
        params16 = {k: v.to(torch.bfloat16) for k, v in params.items()}
        wants = step_wants_bf16(params16, H, res, coords, target)
        check_step_bf16(f"{label}, host-sampled", params16, H, res, wants,
                        contention=cell is not None, coords=coords,
                        target=target)
        if cell is None:
            check_step_bf16(f"{label}, in-kernel sampling", params16, H, res,
                            wants, volumes=vols_c[:hP], seeds=tseeds[:hP], **draw)
        del params, params16, coords, target, wants
    # the deterministic split against its fused yardstick on a ragged batch
    # at W = 16, F = 4 (where the yardstick is built), both variants
    from repro_torch.kernels.fused_train_step import ops as fts
    res, H, hN = cfg.level_resolutions(), cfg.n_hidden_layers, 40_009
    params = step_params(cfg, 4, dev, seed=99)
    draw = dict(n_batch=hN, n_uniform=hN - n_boundary(hN, cfg.boundary_lambda),
                sigma=cfg.boundary_sigma, ghost=1)
    coords = torch.as_tensor(rng.uniform(0, 1, (4, hN, 3)), dtype=torch.float32,
                             device=dev)
    for label, batch in (
            ("host-sampled", dict(coords=coords, target=torch.as_tensor(
                rng.uniform(0, 1, (4, hN, 1)), dtype=torch.float32, device=dev))),
            ("in-kernel sampling", dict(volumes=vols_c[:4], seeds=tseeds[:4], **draw))):
        with deterministic_algorithms():
            got, _ = fts.train_step_cuda(params, H, res, **batch)
        det_yardstick_equal(f"ragged N={hN:,}, {label}", got, params, H, res, **batch)
    torch.cuda.synchronize()


def fwd_case_checks(dev) -> None:
    """Phase 2's further hash-encode forward cases: PRODUCTION (T=2^16,
    levels 8..128) and ABLATION (L=10, F=8, T=2^19) tables, f32 and bf16,
    coordinates inside and outside [0,1], at the tolerances of the
    PRODUCTION256 cases."""
    import numpy as np
    import torch
    from repro_torch.configs.dvnr import ABLATION, PRODUCTION
    from repro_torch.kernels.hash_encoding.ops import hash_encode_cuda
    from repro_torch.kernels.hash_encoding.ref import hash_encode_batched_ref

    rng = np.random.default_rng(6)
    for name, hc, P, B, N in (("PRODUCTION", PRODUCTION, 4, 6, 30_011),
                              ("ABLATION", ABLATION, 2, 3, 20_011)):
        res, L = hc.level_resolutions(), hc.n_levels
        T, F = hc.table_size, hc.n_features_per_level
        gen = torch.Generator(device=dev).manual_seed(len(name))
        tables32 = torch.rand((P, L, T, F), generator=gen, device=dev) * 2 - 1
        part = [int(x) for x in rng.integers(0, P, B)]
        part_d = torch.tensor(part, device=dev)
        for lo, hi, where in ((0.0, 1.0, "in [0,1]"), (-0.25, 1.25, "in [-0.25,1.25]")):
            coords = torch.as_tensor(rng.uniform(lo, hi, (B, N, 3)),
                                     dtype=torch.float32, device=dev)
            for dt in (torch.float32, torch.bfloat16):
                tab = tables32.to(dt)
                want = hash_encode_batched_ref(coords, tab, res, part_d)
                got = hash_encode_cuda(coords, tab, res, part)
                scale = max(1.0, float(want.float().abs().max()))
                label = f"hash_encode {name} {str(dt)[6:]} N={N} coords {where}"
                if dt == torch.float32:
                    check(label, got, want, atol=2e-6 * scale)
                else:
                    check(label, got, want, atol=1e-6 * scale, rtol=2.0 ** -7)
                del tab, want, got
        del tables32
    torch.cuda.synchronize()


#: the INR inference kernel's plan at each config's widths (f32, bf16):
#: the levels' letters phase 1 requires of fwd_layout and of the library
INR_PLANS = {"PRODUCTION256": ("sssdd", "sssss"), "PRODUCTION": ("ssddd", "ssddd"),
             "ABLATION": ("dddddddddd", "ssdddddddd"), "SMOKE": (None, None)}


def inr_layout_checks() -> None:
    """Phase 1: the inference kernel's layout (which levels it stages, the
    warps with a tile, the shared bytes, the block's threads) as ``fwd_layout``
    computes it and as the library does (``repro_inr_forward_plan``), at
    each config's widths in f32 and bf16, by the rule and with a mixed plan
    forced; they must agree, and the rule must give ``INR_PLANS``'s
    letters. Then each design's residency there (blocks, threads and warps
    an SM): at least one block must fit."""
    from repro_torch.configs import dvnr
    from repro_torch.kernels.inr_forward import ops as iops

    widths = [(name, getattr(dvnr, name).n_neurons, getattr(dvnr, name).n_features_per_level,
               plans) for name, plans in INR_PLANS.items()]
    # every other block: PRODUCTION256's levels at W = 32, and at F = 8
    widths += [("PRODUCTION256", 32, 4, (None, None)), ("PRODUCTION256", 16, 8, (None, None))]
    for name, W, F, (want32, want16) in widths:
        hc = getattr(dvnr, name)
        res, T = hc.level_resolutions(), hc.table_size
        L, H = hc.n_levels, hc.n_hidden_layers
        for isz, want in ((4, want32), (2, want16)):
            for plan in (None, "s" * (L // 2) + "d" * (L - L // 2)):
                py = iops.fwd_layout(res, T, F, W, H, isz, plan)
                lib = iops.native_layout(res, T, F, W, H, isz, plan)
                print(f"  inr_forward layout {name} W={W} F={F} "
                      f"{'f32' if isz == 4 else 'bf16'} "
                      f"{'rule' if plan is None else 'forced ' + plan}: {lib}")
                if py != lib:
                    raise SmokeFailure(f"inr_forward layout {name}: fwd_layout {py} "
                                       f"against the library's {lib}")
                if plan is None and want is not None and lib["plan"] != want:
                    raise SmokeFailure(f"inr_forward plan {name}: {lib['plan']}, "
                                       f"want {want}")
            # the warps an SM holds (the occupancy calculator), each design
            for design in iops.DESIGNS:
                if design == "grid" and (W, F) not in iops.GRID_WIDTHS:
                    continue
                occ = iops.residency(res, T, F, W, H, isz, design)
                print(f"  inr_forward {design} design {name} W={W} F={F} "
                      f"{'f32' if isz == 4 else 'bf16'}: {occ['blocks']} block(s) of "
                      f"{occ['threads']} threads an SM, {occ['warps']} warps, "
                      f"{occ['bytes']} B of dynamic shared memory a block")
                if occ["blocks"] < 1:
                    raise SmokeFailure(f"inr_forward {design} design {name}: no block fits "
                                       f"an SM")


#: phase 2's further INR inference cases: (label, L, F, T, W, H, D_out,
#: base resolution, P, B, N); None for a config's own widths
INR_CASES = (("PRODUCTION", None, None, None, None, None, 1, None, 4, 6, 30_011),
             ("ABLATION", None, None, None, None, None, 1, None, 2, 3, 20_011),
             ("F=1 W=32 D_out=3 T=3001", 8, 1, 3001, 32, 2, 3, 4, 3, 4, 9_001),
             ("F=2 W=32 H=1 D_out=8", 16, 2, 1 << 14, 32, 1, 8, 4, 2, 2, 5_003),
             ("L=32 F=1 W=16 D_out=2", 32, 1, 1 << 10, 16, 2, 2, 2, 2, 2, 4_097),
             ("F=8 W=16 H=3", 6, 8, 1 << 12, 16, 3, 1, 4, 2, 3, 6_007),
             ("B=65535 N=5", 5, 4, 1 << 13, 16, 2, 1, 4, 2, 65_535, 5))


def inr_check(label, coords, got, want) -> float:
    """The INR inference kernel against its plain version at the fused MLP's
    limits (f32 2e-6 x scale; bf16 2^-7 x scale plus 2^-7 relative), the
    scale the largest |want| of the rows held: the rows whose coordinates
    lie in [0,1] apart from the rows outside it (extrapolated, their
    outputs up to ~1e15), so that the ordinary rows keep their own tight
    limit. Returns the largest error."""
    import torch
    inside = ((coords >= 0) & (coords <= 1)).all(-1)
    worst = 0.0
    for rows, what in ((inside, ""), (~inside, ", rows outside [0,1]")):
        if not bool(rows.any()):
            continue
        if bool(rows.all()):
            g, w = got, want
        else:
            g, w = got[rows], want[rows]
            what = what or ", rows in [0,1]"
        scale = max(1.0, float(w.float().abs().max()))
        if want.dtype == torch.float32:
            e = check(label + what, g, w, atol=2e-6 * scale)
        else:
            e = check(label + what, g, w, atol=2.0 ** -7 * scale, rtol=2.0 ** -7)
        worst = max(worst, e)
    return worst


def inr_case_checks(dev) -> float:
    """Phase 2's further INR inference cases against the plain version at
    the f32 and bf16 limits of the PRODUCTION256 checks, coordinates inside
    and outside [0,1]: PRODUCTION (T=2^16, levels 8..128) and ABLATION
    (L=10, F=8, W=64, T=2^19) widths, every F and W, 32 levels, D_out up to
    8, T not a power of two, B = 65535; then PRODUCTION256's widths with
    half the levels forced into shared memory and the rest direct (the
    measurement entry). Returns the largest f32 error."""
    import numpy as np
    import torch
    from repro_torch.configs import dvnr
    from repro_torch.kernels.inr_forward.ops import inr_forward_cuda, inr_forward_with
    from repro_torch.kernels.inr_forward.ref import inr_forward_ref

    rng = np.random.default_rng(28)
    worst = 0.0

    def one(label, coords, tab, ws, part, res, got):
        nonlocal worst
        want = inr_forward_ref(coords, tab, ws, torch.tensor(part, device=dev), res)
        e = inr_check(label, coords, got, want)
        if tab.dtype == torch.float32:
            worst = max(worst, e)

    for label, L, F, T, W, H, D_out, base, P, B, N in INR_CASES:
        if L is None:
            hc = getattr(dvnr, label)
            res, L, T = hc.level_resolutions(), hc.n_levels, hc.table_size
            F, W, H = hc.n_features_per_level, hc.n_neurons, hc.n_hidden_layers
        else:
            res = [max(2, int(base * 1.5 ** l)) for l in range(L)]
        gen = torch.Generator(device=dev).manual_seed(L * 100 + F)
        tables32 = torch.rand((P, L, T, F), generator=gen, device=dev) * 2 - 1
        dims = [L * F] + [W] * H + [D_out]
        ws32 = [torch.as_tensor(rng.uniform(-1, 1, (P, a, b)) * np.sqrt(6.0 / a),
                                dtype=torch.float32, device=dev)
                for a, b in zip(dims[:-1], dims[1:])]
        part = [int(x) for x in rng.integers(0, P, B)]
        for lo, hi, where in ((0.0, 1.0, "in [0,1]"), (-0.25, 1.25, "in [-0.25,1.25]")):
            coords = torch.as_tensor(rng.uniform(lo, hi, (B, N, 3)), dtype=torch.float32,
                                     device=dev)
            for dt in (torch.float32, torch.bfloat16):
                tab, ws = tables32.to(dt), [w.to(dt) for w in ws32]
                one(f"inr_forward {label} {str(dt)[6:]} coords {where}", coords, tab, ws,
                    part, res, inr_forward_cuda(coords, tab, ws, part, res))
                del tab, ws
        del tables32
    # PRODUCTION256's widths, levels 0..1 staged and 2..4 direct
    hc = dvnr.PRODUCTION256
    res, L, T, F = hc.level_resolutions(), hc.n_levels, hc.table_size, hc.n_features_per_level
    P, B, N = 4, 6, 30_011
    plan = "s" * (L // 2) + "d" * (L - L // 2)
    tables32 = torch.rand((P, L, T, F), device=dev) * 2 - 1
    dims = [L * F] + [hc.n_neurons] * hc.n_hidden_layers + [1]
    ws32 = [torch.as_tensor(rng.uniform(-1, 1, (P, a, b)) * np.sqrt(6.0 / a),
                            dtype=torch.float32, device=dev)
            for a, b in zip(dims[:-1], dims[1:])]
    part = [int(x) for x in rng.integers(0, P, B)]
    coords = torch.as_tensor(rng.uniform(-0.25, 1.25, (B, N, 3)), dtype=torch.float32,
                             device=dev)
    for dt in (torch.float32, torch.bfloat16):
        tab, ws = tables32.to(dt), [w.to(dt) for w in ws32]
        one(f"inr_forward PRODUCTION256 {str(dt)[6:]} plan {plan}", coords, tab, ws, part,
            res, inr_forward_with(coords, tab, ws, part, res, plan=plan))
    torch.cuda.synchronize()
    return worst


def stage_shares(cycles) -> str:
    """The stage clock's counts (``INR_STAGES``) as shares of their sum,
    then the warps' summed lifetime in ms."""
    from repro_torch.kernels.inr_forward.ops import INR_STAGES
    n = len(INR_STAGES)
    total = max(1, sum(cycles[:n]))
    parts = [f"{s} {c / total:.3f}" for s, c in zip(INR_STAGES, cycles[:n])]
    return ", ".join(parts) + f"; cycles {total:,}; warps' lifetimes {cycles[n] / 1e6:.1f} ms"


def inr_designs(tag, dev, coords, sp, rows, res, hitm) -> dict:
    """Phase 6's account of the INR inference kernel at the tick's shapes,
    f32 and bf16: the kernel by its plan's rule and with other plans forced
    (every level direct; half the levels staged; every level staged where
    that fits), each against the rule's output (the same bits expected) and
    timed once; the grid-stride one-warp design before it against the same;
    the stage clock of both; their times in turns (grid, persistent,
    persistent, grid); the kernel-alone time of both (the profiler, which
    must see the kernel's). Returns, by dtype, the kernel's events and
    kernel-alone ms, the yardstick's, the rule's plan and each plan's ms."""
    import torch
    from repro_torch.kernels.inr_forward import ops as iops

    L = len(res)
    _, _, T, F = sp["tables"].shape
    W, H = sp["mlp"][0].shape[-1], len(sp["mlp"]) - 1
    out = {}
    for key, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        tab, ws = sp["tables"].to(dt), [w.to(dt) for w in sp["mlp"]]
        isz = tab.element_size()
        lay = iops.fwd_layout(res, T, F, W, H, isz)
        print(f"  inr_forward {key}: layout {lay} [{tag}]")
        run = lambda plan=None, design="persistent": iops.inr_forward_with(
            coords, tab, ws, rows, res, design=design, plan=plan)
        rule = run()
        scale = max(1.0, float(rule[hitm].float().abs().max()))
        atol, rtol = (2e-6 * scale, 0.0) if key == "f32" else (2.0 ** -7 * scale, 2.0 ** -7)
        plans = sorted(p for p in {lay["plan"], "d" * L, "s" * (L // 2) + "d" * (L - L // 2),
                                   "s" * L}
                       if iops.fwd_layout(res, T, F, W, H, isz, p)["warps"] > 0)
        times = {}
        for plan in plans:
            got = run(plan)
            same = torch.equal(got, rule)
            check(f"inr_forward {key} plan {plan} vs the rule's (hit rays"
                  f"{'; bit for bit' if same else ''})", got[hitm], rule[hitm],
                  atol=atol, rtol=rtol)
            times[plan] = cuda_ms(lambda plan=plan: run(plan), reps=10)
            del got
        print(f"  inr_forward {key} by plan: "
              + ", ".join(f"{p} {ms:.4f} ms" + (" (the rule's)" if p == lay["plan"] else "")
                          for p, ms in times.items()) + f" (events) [{tag}]")
        got = run(design="grid")
        check(f"inr_forward {key} grid design vs the kernel (hit rays)", got[hitm],
              rule[hitm], atol=atol, rtol=rtol)
        del got, rule
        for design in ("grid", "persistent"):
            cyc = iops.inr_forward_stage_cycles(coords, tab, ws, rows, res, design=design)
            print(f"  inr_forward {key} stage clock, {design} design: "
                  f"{stage_shares(cyc)} [{tag}]")
        turns, alone = design_turns(run, key)
        print(f"  inr_forward {key}: {turns_line(turns, alone)} [{tag}]")
        if alone["persistent"][0] is None:
            raise SmokeFailure(f"inr_forward {key}: the profiler saw no launch of the kernel")
        out[key] = {"ms": min(turns["persistent"]), "kernel_ms": alone["persistent"][0],
                    "grid_ms": min(turns["grid"]), "grid_kernel_ms": alone["grid"][0],
                    "plan": lay["plan"], "plans_ms": times}
        del tab, ws
    torch.cuda.synchronize()
    return out


#: the profiler's names of the INR inference designs' kernels
INR_SYMBOLS = {"persistent": "inr_forward_kernel<", "grid": "inr_forward_grid_kernel<"}


def design_turns(run, key, reps: int = 10):
    """The persistent design against the grid-stride yardstick on one input
    (``run(design=...)``): events ms in turns (grid, persistent, persistent,
    grid), then each one's kernel-alone ms per launch (the profiler: (ms,
    launches counted), or (None, 0))."""
    turns = {d: [] for d in INR_SYMBOLS}
    for design in ("grid", "persistent", "persistent", "grid"):
        turns[design].append(cuda_ms(lambda design=design: run(design=design), reps=reps))
    alone = {d: per_launch_ms(lambda d=d: run(design=d),
                              sym + ("float," if key == "f32" else "__nv_bfloat16,"))
             for d, sym in INR_SYMBOLS.items()}
    return turns, alone


def turns_line(turns, alone) -> str:
    return ("events in turns: " + "; ".join(f"{d} {[round(x, 4) for x in ms]} ms"
                                            for d, ms in turns.items())
            + "; kernel alone (profiler, per launch counted): "
            + "; ".join(f"{d} " + ("not measured" if ms is None else
                                   f"{ms:.4f} ms over {n} launches")
                        for d, (ms, n) in alone.items()))


#: phase 6's other widths for the inference designs: (config, B, N, P)
INR_WIDTH_RUNS = (("PRODUCTION", 4, 1 << 20, 4), ("ABLATION", 4, 1 << 20, 4))


def inr_widths(tag, dev) -> None:
    """Phase 6: the persistent design against the grid-stride yardstick at
    PRODUCTION's (T = 2^16, levels 8..128) and ABLATION's (L = 10, F = 8,
    W = 64, T = 2^19) widths, f32 and bf16, uniform random points in [0,1]:
    the plan, each design's residency, the two designs against each other,
    their events ms in turns and kernel-alone ms."""
    import numpy as np
    import torch
    from repro_torch.configs import dvnr
    from repro_torch.kernels.inr_forward import ops as iops

    rng = np.random.default_rng(6)
    for name, B, N, P in INR_WIDTH_RUNS:
        hc = getattr(dvnr, name)
        res, L, T = hc.level_resolutions(), hc.n_levels, hc.table_size
        F, W, H = hc.n_features_per_level, hc.n_neurons, hc.n_hidden_layers
        gen = torch.Generator(device=dev).manual_seed(L * 100 + F)
        tables32 = torch.rand((P, L, T, F), generator=gen, device=dev) * 2 - 1
        dims = [L * F] + [W] * H + [1]
        ws32 = [torch.as_tensor(rng.uniform(-1, 1, (P, a, b)) * np.sqrt(6.0 / a),
                                dtype=torch.float32, device=dev)
                for a, b in zip(dims[:-1], dims[1:])]
        rows = [b % P for b in range(B)]
        coords = torch.rand((B, N, 3), generator=gen, device=dev)
        for key, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            tab, ws = tables32.to(dt), [w.to(dt) for w in ws32]
            isz = tab.element_size()
            run = lambda design="persistent": iops.inr_forward_with(
                coords, tab, ws, rows, res, design=design)
            a, g = run(), run(design="grid")
            scale = max(1.0, float(g.float().abs().max()))
            check(f"inr_forward {name} {key} persistent vs grid design", a, g,
                  atol=2e-6 * scale if key == "f32" else 2.0 ** -7 * scale,
                  rtol=0.0 if key == "f32" else 2.0 ** -7)
            del a, g
            occ = {d: iops.residency(res, T, F, W, H, isz, d)["warps"] for d in INR_SYMBOLS}
            turns, alone = design_turns(run, key, reps=5)
            print(f"  inr_forward {name} {key} B={B} N=2^{N.bit_length() - 1}: plan "
                  f"{iops.fwd_layout(res, T, F, W, H, isz)['plan']}, warps an SM "
                  f"{occ}; {turns_line(turns, alone)} [{tag}]")
            del tab, ws
        del tables32, ws32, coords
    torch.cuda.synchronize()


def bf16_training(tparts, vols, cfg, train_wrappers, tag, f32_run) -> dict:
    """Phase 5 under the bf16 policy (bf16 params and compute, float32
    master and moments): the same TRAIN_STEPS steps through
    ``api.train(precision="bf16", backend="cuda")``, fused (the bf16 train
    step and the master AdamW, every launch of theirs the bf16 kernel's)
    and unfused (``fuse_train_step="off"``: the bf16 MLP and hash-encode
    backward kernels), counters zeroed just before each. The loss must
    fall; the first 16 losses of both must agree with ``backend="ref"``
    bf16 within BF16_LOSS_RTOL (bf16 rounds every feature, activation and
    delta, so a rounding flip between float32 sum orders moves a value by
    2^-8 relative, and Adam's normalised first steps pass such differences
    on), printed beside the float32 policy's departure from the same
    reference (``f32_run["losses"]``); the two runs' PSNRs within 1 dB.
    Each ``evaluate`` must take the bf16 INR inference kernel (counters
    zeroed just before it). Returns the bf16 kernels' launches of the two
    runs (``inr_forward``: their evaluates'; ``fused_mlp_fwd``: the MLP
    forward's, every one of them bf16 under this policy)."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_cuda
    from repro_torch.kernels.inr_forward.ops import inr_forward_cuda
    TP, Nb = len(tparts), cfg.batch_size
    print(f"  bf16 policy: {TRAIN_STEPS} steps, fused then unfused")
    runs, out = {}, {}
    for fuse in ("auto", "off"):
        for w in train_wrappers.values():
            w.launches = w.bf16_launches = 0
        fused_mlp_cuda.launches = 0
        torch.cuda.synchronize()
        _, info = api.train(tparts, cfg, backend="cuda", steps=TRAIN_STEPS,
                            key=0, log_every=1, precision="bf16",
                            fuse_train_step=fuse)
        torch.cuda.synchronize()
        fwd_launches = fused_mlp_cuda.launches
        st = info["state"]
        launches = {n: (w.launches, w.bf16_launches)
                    for n, w in train_wrappers.items()}
        print(f"  bf16 {'fused' if fuse == 'auto' else 'unfused'}: launches "
              f"(all, bf16 kernel) {launches}")
        path = ("train_step", "adamw_apply") if fuse == "auto" else \
            ("hash_encode_bwd", "fused_mlp_bwd")
        for n in path:
            every, bf16 = launches[n]
            if bf16 <= 0 or every != bf16:
                raise SmokeFailure(f"bf16 run ({fuse}): {n} launched {every} "
                                   f"times, {bf16} of them the bf16 kernel")
        if fuse == "auto" and launches["train_step"][1] != TRAIN_STEPS:
            raise SmokeFailure(f"the bf16 train step launched "
                               f"{launches['train_step'][1]} times in "
                               f"{TRAIN_STEPS} steps")
        if st.params["tables"].dtype != torch.bfloat16 or \
                st.opt["mw"]["tables"].dtype != torch.float32:
            raise SmokeFailure("the bf16 run's state is not bf16 params with "
                               "an f32 master")
        losses = np.array([l for _, l in info["loss_history"]])
        if losses.shape != (TRAIN_STEPS,) or not np.isfinite(losses).all():
            raise SmokeFailure(f"bf16 loss trace {losses.shape}, finite "
                               f"{bool(np.isfinite(losses).all())}")
        first, last = float(losses[:16].mean()), float(losses[-16:].mean())
        if not last < 0.5 * first:
            raise SmokeFailure(f"bf16 ({fuse}): the loss did not fall: first 16 "
                               f"{first:.6f}, last 16 {last:.6f}")
        inr_forward_cuda.launches = inr_forward_cuda.bf16_launches = 0
        ev = info["trainer"].evaluate(st, vols, (TRAIN_EDGE,) * 3)
        if not np.isfinite(ev["psnr"]):
            raise SmokeFailure(f"bf16 evaluate: PSNR {ev['psnr']}")
        inr = (inr_forward_cuda.launches, inr_forward_cuda.bf16_launches)
        if inr[1] <= 0 or inr[0] != inr[1]:
            raise SmokeFailure(f"bf16 evaluate: {inr[0]} INR inference "
                               f"launches, {inr[1]} of them the bf16 kernel")
        ms = info["train_time_s"] * 1e3 / TRAIN_STEPS
        runs[fuse] = {"losses": losses, "psnr": ev["psnr"], "ms": ms}
        out[fuse] = {n: b for n, (_, b) in launches.items()}
        out[fuse]["inr_forward"] = inr[1]
        out[fuse]["fused_mlp_fwd"] = fwd_launches
        print(f"  bf16 {'fused' if fuse == 'auto' else 'unfused'}: "
              f"{info['train_time_s']:.3f} s, {ms:.4f} ms per step, "
              f"{TP * Nb * TRAIN_STEPS / info['train_time_s']:.4g} samples/s, "
              f"loss first 16 {first:.6f} last 16 {last:.6f}, PSNR "
              f"{ev['psnr']:.4f} dB (host clock, synchronised) [{tag}]")
        del info, st
    print(f"  f32 vs bf16 (fused, {TRAIN_STEPS} steps): {f32_run['ms_step']:.4f} "
          f"vs {runs['auto']['ms']:.4f} ms per step, {f32_run['sps']:.4g} vs "
          f"{TP * Nb / runs['auto']['ms'] * 1e3:.4g} samples/s, PSNR "
          f"{f32_run['psnr']:.4f} vs {runs['auto']['psnr']:.4f} dB [{tag}]")
    dpsnr = abs(runs["auto"]["psnr"] - runs["off"]["psnr"])
    print(f"  bf16 fused vs unfused PSNR: {runs['auto']['psnr']:.4f} vs "
          f"{runs['off']['psnr']:.4f} dB, |diff| {dpsnr:.4f} (limit 1 dB)  "
          f"{'ok' if dpsnr < 1.0 else 'FAIL'}")
    if not dpsnr < 1.0:
        raise SmokeFailure(f"bf16 fused and unfused PSNRs {dpsnr:.3f} dB apart")
    _, rinfo = api.train(tparts, cfg, backend="ref", steps=COMPARE_STEPS, key=0,
                         log_every=1, precision="bf16")
    ref = torch.tensor([l for _, l in rinfo["loss_history"]], dtype=torch.float64)
    print(f"  first {COMPARE_STEPS} losses against the bf16 plain path (ref), "
          f"largest relative departure: fused "
          f"{loss_departure(runs['auto']['losses'], ref):.3e}, unfused "
          f"{loss_departure(runs['off']['losses'], ref):.3e}, the float32 "
          f"policy's fused run {loss_departure(f32_run['losses'], ref):.3e} "
          f"(limit {BF16_LOSS_RTOL:.0e})")
    for fuse, label in (("auto", "fused"), ("off", "unfused")):
        check(f"bf16 first {COMPARE_STEPS} losses: {label} vs plain path (ref)",
              torch.from_numpy(runs[fuse]["losses"][:COMPARE_STEPS]), ref,
              atol=0.0, rtol=BF16_LOSS_RTOL)
    return out


def mixed_policy_checks(tparts, cfg, train_wrappers) -> None:
    """The mixed policies ``"bf16/f32/f32"`` (bf16 params and float32
    compute: the float32 train step on the params cast to float32, the
    master AdamW) and ``"f32/bf16/f32"`` (float32 params and bf16 compute:
    the bf16 train step on the params cast to bf16, the float32 AdamW),
    COMPARE_STEPS steps each through ``api.train(backend="cuda")``, fused
    and unfused, counters zeroed just before each: every launch must be the
    kernel of the policy's dtype, and the losses must agree with
    ``backend="ref"`` under the same policy within BF16_LOSS_RTOL: bf16
    compute rounds as the bf16 policy does, and with bf16 params a master
    that differs in its last float32 bits between the paths may round a
    param to the other bf16 neighbour (2^-8 relative), so float32 compute
    alone does not bring the float32 policy's 1e-4."""
    import torch
    from repro_torch import api
    for policy, bf16_compute, master in (("bf16/f32/f32", False, True),
                                         ("f32/bf16/f32", True, False)):
        _, rinfo = api.train(tparts, cfg, backend="ref", steps=COMPARE_STEPS,
                             key=0, log_every=1, precision=policy)
        ref = torch.tensor([l for _, l in rinfo["loss_history"]],
                           dtype=torch.float64)
        for fuse in ("auto", "off"):
            for w in train_wrappers.values():
                w.launches = w.bf16_launches = 0
            torch.cuda.synchronize()
            _, info = api.train(tparts, cfg, backend="cuda", steps=COMPARE_STEPS,
                                key=0, log_every=1, precision=policy,
                                fuse_train_step=fuse)
            torch.cuda.synchronize()
            launches = {n: (w.launches, w.bf16_launches)
                        for n, w in train_wrappers.items()}
            label = f"{policy} {'fused' if fuse == 'auto' else 'unfused'}"
            print(f"  {label}: launches (all, bf16 kernel) {launches}")
            want = {"train_step": bf16_compute, "adamw_apply": master} \
                if fuse == "auto" else {"hash_encode_bwd": bf16_compute,
                                        "fused_mlp_bwd": bf16_compute}
            for n, bf16 in want.items():
                every, b = launches[n]
                if every <= 0 or b != (every if bf16 else 0):
                    raise SmokeFailure(f"{label}: {n} launched {every} times, "
                                       f"{b} of them the bf16 kernel")
            losses = torch.tensor([l for _, l in info["loss_history"]],
                                  dtype=torch.float64)
            print(f"  {label}: first {COMPARE_STEPS} losses' largest relative "
                  f"departure from the plain path {loss_departure(losses, ref):.3e}")
            check(f"{label}: first {COMPARE_STEPS} losses vs plain path (ref)",
                  losses, ref, atol=0.0, rtol=BF16_LOSS_RTOL)
            del info
        del rinfo


def det_training(tparts, vols, cfg, wrappers, tag, rinfo) -> dict:
    """Phase 5, the deterministic route: two clean TRAIN_STEPS-step runs of
    the 8 PRODUCTION256 partitions under ``deterministic_algorithms``, f32
    and bf16, must be the same bits in every parameter, moment, master,
    loss average and loss of the trace, and the route must carry every step
    (its counter); the f32 run's first COMPARE_STEPS losses against the
    plain path (``rinfo``) at 1e-4, as the default route's. Returns each
    policy's launches, ms a step and PSNR."""
    import torch
    from repro_torch import api, interop
    from repro_torch.kernels.fused_train_step import ops as fts
    from repro_torch.optim.adamw import tree_leaves
    out = {}
    for policy in ("f32", "bf16"):
        kw = {} if policy == "f32" else {"precision": "bf16"}
        runs = []
        for _ in range(2):
            for w in wrappers.values():
                w.launches = 0
            fts.train_step_cuda.det_launches = 0
            torch.cuda.synchronize()
            with deterministic_algorithms():
                _, info = api.train(tparts, cfg, backend="cuda", steps=TRAIN_STEPS,
                                    key=0, log_every=1, **kw)
            torch.cuda.synchronize()
            runs.append((info, {n: w.launches for n, w in wrappers.items()},
                         fts.train_step_cuda.det_launches))
        (ia, la, da), (ib, _, _) = runs
        leaves = [tree_leaves(interop.state_tree(i["state"])) for i in (ia, ib)]
        same = all(torch.equal(x, y) for x, y in zip(*leaves))
        traces = [[l for _, l in i["loss_history"]] for i in (ia, ib)]
        ms = ia["train_time_s"] * 1e3 / TRAIN_STEPS
        ev = ia["trainer"].evaluate(ia["state"], vols, (TRAIN_EDGE,) * 3)
        print(f"  deterministic route, {policy}: two clean {TRAIN_STEPS}-step runs "
              f"bit for bit in every parameter, moment and loss average: {same}; "
              f"loss traces equal: {traces[0] == traces[1]}; {da} of "
              f"{la['train_step']} train-step launches on the route, "
              f"{la['adamw_apply']} AdamW; {ms:.4f} ms per step (host clock), "
              f"PSNR {ev['psnr']:.4f} dB [{tag}]")
        if not same or traces[0] != traces[1]:
            raise SmokeFailure(f"deterministic route ({policy}): two clean runs differ")
        if da != TRAIN_STEPS or la["train_step"] != TRAIN_STEPS or \
                la["adamw_apply"] != TRAIN_STEPS:
            raise SmokeFailure(f"deterministic route ({policy}): launches {la}, "
                               f"{da} on the route")
        if policy == "f32":
            other = torch.tensor([l for _, l in rinfo["loss_history"]],
                                 dtype=torch.float64)
            check(f"first {COMPARE_STEPS} losses: deterministic route vs plain "
                  f"path (ref)", torch.tensor(traces[0][:COMPARE_STEPS],
                                              dtype=torch.float64), other,
                  atol=0.0, rtol=1e-4)
        out[policy] = {"launches": la, "ms_step": ms, "psnr": ev["psnr"]}
        del runs, ia, ib, leaves
    return out


def det_repeat_alone(label, launch, cut) -> None:
    """The unfused route's bits: two launches of ``launch()`` (under
    ``deterministic_algorithms``) must be equal, and the last partition
    launched alone (``cut()``) equal to its row of the stacked launch.
    Each returns a tuple of tensors with the partition axis first."""
    import torch
    with deterministic_algorithms():
        a, b, c = launch(), launch(), cut()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    alone = all(torch.equal(z[0], x[-1]) for x, z in zip(a, c))
    print(f"  {label}, deterministic route: two launches bit for bit {same}; "
          f"the last partition alone = its row of the stacked launch {alone}")
    if not (same and alone):
        raise SmokeFailure(f"{label} deterministic route: repeat {same}, "
                           f"alone {alone}")


def unfused_det_checks(g_feat, coords, res, shape, feats, ws, g_out, feats16,
                       ws16, g_out16, tag) -> dict:
    """Phase 2, the unfused path's deterministic routes at the training
    shapes (phase 2's inputs): the hash backward (f32 and bf16 cotangent,
    also every point in one coarse cell) and the MLP backward (f32 and
    bf16) held against their plain versions within the default route's
    yardsticks (``check``, ``check_mlp_bwd``), with controls that must fail
    (16 samples left out of the table gradient; ``mlp_bwd_controls``), two
    launches bit for bit and the last partition alone equal to its row.
    Returns each route's largest departure. Then the scatter layer against
    its yardstick bit for bit (``fx_yardstick_checks``)."""
    import numpy as np
    import torch
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_bwd_cuda
    from repro_torch.kernels.hash_encoding.ops import (fx_letters, fx_plan,
                                                       hash_encode_bwd_cuda)
    from repro_torch.kernels.hash_encoding.ref import hash_encode_batched_bwd_ref
    P = shape[0]
    dev = coords.device
    plan = fx_letters(fx_plan(res, shape[2], shape[3]))
    rows, rows_d = list(range(P)), torch.arange(P, device=dev)
    errs = {}
    cell = torch.rand(coords.shape, generator=torch.Generator(device=dev)
                      .manual_seed(5), device=dev) * 0.01 + 0.30
    for label, g, x in (("hash_encode_bwd_det", g_feat, coords),
                        ("hash_encode_bwd_det_bf16", g_feat.to(torch.bfloat16), coords),
                        ("hash_encode_bwd_det contention: one coarse cell", g_feat,
                         cell)):
        one = (1,) + tuple(shape[1:])
        det_repeat_alone(label, lambda: (hash_encode_bwd_cuda(g, x, res, rows, shape),),
                         lambda: (hash_encode_bwd_cuda(g[-1:].contiguous(),
                                                       x[-1:].contiguous(), res,
                                                       [0], one),))
        with deterministic_algorithms():
            got = hash_encode_bwd_cuda(g, x, res, rows, shape)
        want = hash_encode_batched_bwd_ref(g, x, res, rows_d, shape)
        atol = 2e-5 * float(want.abs().max())
        err = check(f"{label} (int64 fixed point, levels {plan})", got, want,
                    atol=atol)
        if "contention" not in label:
            errs[label] = err
            s = g.shape[1] // 2
            g_cut = g.clone()
            g_cut[0, s:s + 16] = 0
            cut = hash_encode_batched_bwd_ref(g_cut, x, res, rows_d, shape)
            must_fail(f"{label}, 16 samples left out",
                      lambda: check(f"{label} (16 samples left out)", got, cut,
                                    atol=atol))
        del got, want
    for label, x, w, g in (("fused_mlp_bwd_det", feats, ws, g_out),
                           ("fused_mlp_bwd_det_bf16", feats16, ws16, g_out16)):
        det_repeat_alone(label, lambda: (lambda r: (r[0], *r[1]))(
                             fused_mlp_bwd_cuda(x, w, g, rows)),
                         lambda: (lambda r: (r[0], *r[1]))(fused_mlp_bwd_cuda(
                             x[-1:].contiguous(), [t[-1:].contiguous() for t in w],
                             g[-1:].contiguous(), [0])))
        with deterministic_algorithms():
            got = fused_mlp_bwd_cuda(x, w, g, rows)
        errs[label] = check_mlp_bwd(f"P={P} {label}", x, w, g, rows, got)
        mlp_bwd_controls(f"P={P} {label}", x, w, g, rows, got)
        del got
    fx_yardstick_checks(g_feat, coords, res, shape, np.random.default_rng(7), dev)
    print(f"  the unfused deterministic routes held [{tag}]")
    return errs


def unfused_det_training(tparts, vols, cfg, wrappers, tag, rinfo) -> dict:
    """Phase 5, the unfused path (``fuse_train_step="off"``) under
    ``deterministic_algorithms``: two clean DET_UNFUSED_STEPS-step runs, f32
    and bf16, must be the same bits in every parameter, moment, master, loss
    average and loss, with no error from PyTorch's switch; every step must
    take the routes (the hash backward's L levels and the MLP backward's
    launch each step, counted by their ``det_launches``) and no fused step;
    the f32 run's first COMPARE_STEPS losses against the plain path
    (``rinfo``) at 1e-4. Returns each policy's route launches, ms a step
    and PSNR."""
    import torch
    from repro_torch import api, interop
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_bwd_cuda
    from repro_torch.kernels.hash_encoding.ops import hash_encode_bwd_cuda
    from repro_torch.optim.adamw import tree_leaves
    out = {}
    routes = {"hash_encode_bwd": hash_encode_bwd_cuda, "fused_mlp_bwd": fused_mlp_bwd_cuda}
    for policy in ("f32", "bf16"):
        kw = {} if policy == "f32" else {"precision": "bf16"}
        runs = []
        for _ in range(2):
            for w in (*wrappers.values(), *routes.values()):
                w.launches = 0
            for w in routes.values():
                w.det_launches = 0
            torch.cuda.synchronize()
            with deterministic_algorithms():
                _, info = api.train(tparts, cfg, backend="cuda",
                                    steps=DET_UNFUSED_STEPS, key=0, log_every=1,
                                    fuse_train_step="off", **kw)
            torch.cuda.synchronize()
            runs.append((info, {n: w.launches for n, w in wrappers.items()},
                         {n: w.det_launches for n, w in routes.items()}))
        (ia, la, da), (ib, _, _) = runs
        leaves = [tree_leaves(interop.state_tree(i["state"])) for i in (ia, ib)]
        same = all(torch.equal(x, y) for x, y in zip(*leaves))
        traces = [[l for _, l in i["loss_history"]] for i in (ia, ib)]
        ms = ia["train_time_s"] * 1e3 / DET_UNFUSED_STEPS
        ev = ia["trainer"].evaluate(ia["state"], vols, (TRAIN_EDGE,) * 3)
        print(f"  unfused deterministic route, {policy}: two clean "
              f"{DET_UNFUSED_STEPS}-step runs bit for bit in every parameter, moment "
              f"and loss average: {same}; loss traces equal: "
              f"{traces[0] == traces[1]}; route launches {da} of {la}; {ms:.4f} ms "
              f"per step (host clock), PSNR "
              f"{ev['psnr']:.4f} dB [{tag}]")
        if not same or traces[0] != traces[1]:
            raise SmokeFailure(f"unfused deterministic route ({policy}): two clean "
                               "runs differ")
        L = cfg.n_levels
        if da["hash_encode_bwd"] != L * DET_UNFUSED_STEPS or \
                la["hash_encode_bwd"] != L * DET_UNFUSED_STEPS or \
                da["fused_mlp_bwd"] != DET_UNFUSED_STEPS or \
                la["fused_mlp_bwd"] != DET_UNFUSED_STEPS or la["train_step"]:
            raise SmokeFailure(f"unfused deterministic route ({policy}): launches "
                               f"{la}, {da} on the routes")
        if policy == "f32":
            other = torch.tensor([l for _, l in rinfo["loss_history"]],
                                 dtype=torch.float64)
            check(f"first {COMPARE_STEPS} losses: unfused deterministic route vs "
                  f"plain path (ref)", torch.tensor(traces[0][:COMPARE_STEPS],
                                                    dtype=torch.float64), other,
                  atol=0.0, rtol=1e-4)
        out[policy] = {"launches": da, "ms_step": ms, "psnr": ev["psnr"]}
        del runs, ia, ib, leaves
    return out


# --------------------------------------------------------------------------- #
# the deterministic route's scatter layer: its plan, its yardsticks, its clock
# --------------------------------------------------------------------------- #
#: the kernels whose SASS phase 1 reads for their atomic instructions (a
#: substring of the mangled name): the scatter layer, its yardstick, and the
#: train step's fused yardstick
FX_SASS_KERNELS = ("hash_encode_bwd_fx_kernel", "hash_encode_bwd_fx_block_kernel",
                   "train_step_det_fused_kernel")
#: each such instantiation's atomic and reduction opcodes with their counts
#: (filled by ``sass_counts``' function)
SASS_ATOMICS = {}
#: the plans forced once each in phase 2 against the yardstick (a force a
#: level, repeated over the levels): every letter, every cluster size
FX_FORCED = ("d", "s", ("c", 2), ("c", 4), ("c", 8))


def fx_configs():
    """The configurations whose plans phase 1 prints and holds."""
    from repro_torch.configs import dvnr
    return {"PRODUCTION256": dvnr.PRODUCTION256, "PRODUCTION": dvnr.PRODUCTION,
            "ABLATION": dvnr.ABLATION, "SMOKE": dvnr.SMOKE}


def fx_plan_checks() -> None:
    """Phase 1: the Python mirror of the scatter layer's plan
    (``hash_encoding.ops.fx_plan``) equals the C plan
    (``repro_hash_encode_bwd_fx_plan``) at every config, at F = 1, 2, 4 and
    8 and under every force the C entry takes; prints each config's letters
    and cluster dimensions."""
    from repro_torch.kernels.hash_encoding import ops as hops
    n = 0
    for name, hc in fx_configs().items():
        res, T = hc.level_resolutions(), hc.table_size
        for F in (1, 2, 4, 8):
            for force in (None,) + tuple([f] * len(res) for f in FX_FORCED):
                py = hops.fx_plan(res, T, F, force)
                c = hops.native_fx_plan(res, T, F, force)
                n += 1
                if py != c:
                    raise SmokeFailure(f"fx plan {name} F={F} force {force}: Python "
                                       f"{py} != C {c}")
        plan = hops.fx_plan(res, T, hc.n_features_per_level)
        print(f"  fx plan {name} (F={hc.n_features_per_level}, T={T}): "
              f"{hops.fx_letters(plan)}; cluster dims "
              f"{[(p.cluster, 1, 1) for p in plan]}; slab bytes a block "
              f"{[p.smem for p in plan]}; points a block {[p.points for p in plan]}")
    print(f"  fx plan: Python mirror = C plan in {n} cases")


def fx_sass_checks() -> None:
    """Phase 1: the scatter layer's atomics in the SASS (``SASS_ATOMICS``,
    filled by ``sass_checks``). The sm_90 shared-memory unit has no 64-bit
    add (a 64-bit shared atomicAdd is an ATOMS.CAST.SPIN.64 loop: the
    design before this layer, ``hash_encode_bwd_fx_block_kernel``, shows
    it), so every one-block slab instantiation ('s') adds with 32-bit
    ATOMS.ADD and has no compare-and-swap; every cluster instantiation ('c')
    adds to another block's slab with the native 64-bit ATOM.E.ADD.64 (its
    own share, one add in C, is a compare-and-swap loop)."""
    for fn, ops in sorted(SASS_ATOMICS.items()):
        print(f"  SASS atomics {fn}: {dict(sorted(ops.items()))}")
    fx = {fn: ops for fn, ops in SASS_ATOMICS.items() if "hash_encode_bwd_fx_kernel" in fn}
    slab = {fn: ops for fn, ops in fx.items() if "Lc115E" in fn}
    cluster = {fn: ops for fn, ops in fx.items() if "Lc99E" in fn}
    if len(slab) != 8 or len(cluster) != 8:
        raise SmokeFailure(f"{len(slab)} 's' and {len(cluster)} 'c' instantiations of "
                           f"hash_encode_bwd_fx_kernel in the SASS, 8 each expected")
    bad = [fn for fn, ops in slab.items()
           if not any(o.startswith("ATOMS.ADD") and ".64" not in o for o in ops)
           or any("CAS" in o for o in ops)]
    bad += [fn for fn, ops in cluster.items()
            if not any(o.startswith("ATOM.E.ADD.64") for o in ops)]
    if bad:
        raise SmokeFailure(f"scatter-layer instantiations without their native "
                           f"shared adds: {bad}")


def fx_yardstick_equal(label, g, coords, res, part, shape, plan=None) -> None:
    """The scatter layer's int64 sums and flags (``plan``: None for the rule,
    else one force a level) against its yardstick (the design before the
    clusters) on the same operands: bit for bit."""
    import torch
    from repro_torch.kernels.hash_encoding import ops as hops
    a, fa, _ = hops.hash_encode_bwd_fx_with(g, coords, res, part, shape,
                                            plan=plan, convert=False)
    b, fb, _ = hops.hash_encode_bwd_fx_with(g, coords, res, part, shape,
                                            design="block", convert=False)
    same = torch.equal(a, b) and torch.equal(fa, fb)
    letters = hops.fx_letters(hops.fx_plan(res, shape[2], shape[3], plan))
    print(f"  hash_encode_bwd_det {label} (levels {letters}): int64 sums and flags "
          f"= the yardstick's bit for bit {same}; nonzero entries "
          f"{int((a != 0).sum()):,}")
    if not same:
        raise SmokeFailure(f"hash_encode_bwd_det {label} ({letters}): differs from "
                           f"its yardstick in {int((a != b).sum())} entries")


def fx_yardstick_checks(g_feat, coords, res, shape, rng, dev) -> None:
    """Phase 2: the scatter layer against its yardstick bit for bit: at the
    training shapes (f32 and bf16 cotangent), every point in one coarse cell
    (contention), CHECK_N's ragged rows, PRODUCTION's levels (T = 2^16) and
    ABLATION's (T = 2^19, L = 10; the yardstick is built at F = 4), and
    every plan letter and cluster size forced once at the training
    shapes."""
    import torch
    from repro_torch.configs.dvnr import ABLATION, PRODUCTION
    from repro_torch.kernels.hash_encoding import ops as hops
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    P = shape[0]
    rows = list(range(P))
    fx_yardstick_equal("f32", g_feat, coords, res, rows, shape)
    fx_yardstick_equal("bf16 cotangent", g_feat.to(torch.bfloat16), coords, res,
                       rows, shape)
    cell = t(rng.uniform(0.30, 0.31, coords.shape))
    fx_yardstick_equal("contention: one coarse cell", g_feat, cell, res, rows, shape)
    n = CHECK_N[0]
    fx_yardstick_equal(f"ragged N={n:,}", g_feat[:, :n].contiguous(),
                       coords[:, :n].contiguous(), res, rows, shape)
    fits = [hops.level_rows(r, shape[2]) * shape[3] * 8 <= hops.FX_STAGE_BUDGET
            for r in res]
    for f in FX_FORCED:   # 's' where one block holds the slab, else 'd'
        fx_yardstick_equal(f"forced {f}", g_feat, coords, res, rows, shape,
                           plan=[f if f != "s" or ok else "d" for ok in fits])
    for label, hc in (("PRODUCTION T=2^16", PRODUCTION), ("ABLATION T=2^19 F=4", ABLATION)):
        hres, hT, hL, hN = hc.level_resolutions(), hc.table_size, hc.n_levels, \
            hc.batch_size
        hP = 2
        hcoords = t(rng.uniform(0.0, 1.0, (hP, hN, 3)))
        hg = t(rng.standard_normal((hP, hN, hL * 4)) * 1e-5)
        fx_yardstick_equal(label, hg, hcoords, hres, list(range(hP)),
                           (hP, hL, hT, 4))
        del hcoords, hg
    torch.cuda.synchronize()


def det_yardstick_equal(label, got, params, H, res, **batch) -> None:
    """The train step's deterministic split (``got``, a ``DetGrads``)
    against the route's fused yardstick on the same batch: the fixed-point
    table gradient, the group rows and the flags bit for bit (W = 16, F = 4,
    where the yardstick is built)."""
    import torch
    from repro_torch.kernels.fused_train_step import ops as fts
    y, _ = fts.train_step_det_with(params, H, res, design="fused", **batch)
    same = torch.equal(got.tab_fx, y.tab_fx) and \
        torch.equal(got.partials, y.partials) and torch.equal(got.flags, y.flags)
    print(f"  train_step ({label}), deterministic split = the fused yardstick bit "
          f"for bit (tab_fx, partials, flags): {same}")
    if not same:
        raise SmokeFailure(f"train_step ({label}): the split differs from the "
                           f"fused yardstick: tab_fx "
                           f"{int((got.tab_fx != y.tab_fx).sum())}, partials "
                           f"{int((got.partials != y.partials).sum())} entries")


def det_step_clock(tag, params, H, res, **batch) -> dict:
    """The fused yardstick's stage clock at these shapes (float32, in-kernel
    sampling): each warp's cycles of the table scatter at the dense levels,
    at the hashed levels and of the rest of the step, as shares of their
    sum, and the warps' clock rate over their lifetimes. Returns the
    shares."""
    import torch
    from repro_torch.kernels.fused_train_step import ops as fts
    clocks = torch.zeros(4, dtype=torch.int64, device=params["tab"].device)
    fts.train_step_det_with(params, H, res, design="fused", clocks=clocks, **batch)
    torch.cuda.synchronize()
    c = [int(x) for x in clocks.tolist()]
    total = max(1, sum(c[:3]))
    shares = dict(zip(("rest", "dense scatter", "hashed scatter"),
                      (x / total for x in c[:3])))
    print(f"  train_step deterministic route, the fused yardstick by stage (cycles, "
          f"a clock on each warp): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                                shares.items())
          + f"; the warps' cycles over their lifetimes {total / max(1, c[3]):.3f} "
          f"GHz, lifetimes {c[3] / 1e6:.3f} warp-ms [{tag}]")
    return shares


def fx_level_times(tag, g, coords, res, part, shape) -> None:
    """The hash backward's deterministic route level by level: each level
    launched alone (its resolution, its columns of the cotangent, a table
    of one level), the scatter layer and its yardstick; the layer also on a
    zero cotangent (every add of 0: the slabs' flushes then add nothing, so
    the difference is the flush's time); device ms a launch by the profiler
    (``per_launch_ms``), and the flush's share of each level's time."""
    import torch
    from repro_torch.kernels.hash_encoding import ops as hops
    P, L, T, F = shape
    letters = hops.fx_letters(hops.fx_plan(res, T, F))
    for design, symbol in (("cluster", "hash_encode_bwd_fx_kernel<"),
                           ("block", "hash_encode_bwd_fx_block_kernel<")):
        per = {"g": [], "zero": []}
        for l in range(L):
            gl = g[..., l * F:(l + 1) * F].contiguous()
            # (the yardstick's flush share was read before the redesign: PERF.md)
            for which, gg in (("g", gl), ("zero", torch.zeros_like(gl)))[
                    :2 if design == "cluster" else 1]:
                ms, _ = per_launch_ms(lambda: hops.hash_encode_bwd_fx_with(
                    gg, coords, [res[l]], part, (P, 1, T, F), design=design,
                    convert=False), symbol, calls=3)
                per[which].append(ms)
        if any(x is None for x in per["g"] + per["zero"]):
            print(f"  hash_encode_bwd_det {design} per level: not measured (the "
                  f"profiler matched no launch) {per} [{tag}]")
            continue
        flush = [max(0.0, a - b) / a if a else 0.0 for a, b in zip(per["g"], per["zero"])]
        print(f"  hash_encode_bwd_det per level, "
              f"{'the scatter layer (' + letters + ')' if design == 'cluster' else 'the yardstick'}: "
              f"{[round(x, 4) for x in per['g']]} ms, sum {sum(per['g']):.4f} ms"
              + (f"; on a zero cotangent {[round(x, 4) for x in per['zero']]}; the "
                 f"flush's share {[round(x, 3) for x in flush]}" if per["zero"] else "")
              + f" (profiler, each level launched alone) [{tag}]")


def det_design_turns(label, new, old, new_syms, old_syms, tag, new_alone=None) -> dict:
    """A deterministic-route row beside its yardstick in the same run: each
    design's events ms a call in turns (new, yardstick, yardstick, new; 10
    calls each) and its kernels' device time a call alone (profiler,
    ``kernels_alone_ms`` of its ``(symbol, launches a call)`` lists; the
    new design's taken as ``new_alone`` where the caller measured it).
    Returns {"new": (ms, alone), "yardstick": (ms, alone)}."""
    runs = [cuda_ms(f, reps=10) for f in (new, old, old, new)]
    alone = {"new": new_alone if new_alone is not None else kernels_alone_ms(new, new_syms),
             "yardstick": kernels_alone_ms(old, old_syms)}
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"
    print(f"  {label}: the new design {runs[0]:.4f} / {runs[3]:.4f} ms, its "
          f"yardstick {runs[1]:.4f} / {runs[2]:.4f} ms (events, in turns); kernels "
          f"alone: new {fmt(alone['new'])}, yardstick {fmt(alone['yardstick'])} "
          f"a call (profiler) [{tag}]")
    return {"new": ((runs[0] + runs[3]) / 2, alone["new"]),
            "yardstick": ((runs[1] + runs[2]) / 2, alone["yardstick"])}


def det_probe() -> int:
    """Phases 1, 2 and 6's parts of the deterministic route's scatter alone,
    at the PRODUCTION256 training shapes on random data from seed 0: the
    build with its registers and spills, the atomics in the SASS, the plan
    checks, the yardstick checks, the fused yardstick's stage clock and the
    hash backward's levels. ``python3 -c "import chip_smoke;
    chip_smoke.det_probe()"`` on the card: the quickest look at the route."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    from repro_torch.configs.dvnr import PRODUCTION256 as cfg
    from repro_torch.core.sampling import n_boundary, step_seeds
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_train_step import ops as fts
    from repro_torch.kernels.fused_train_step import ref as fts_ref
    dev = torch.device(DEVICE)
    tag = card_tag()
    print(tag)
    t0 = time.perf_counter()
    build.library()
    print(f"  built in {time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds:.1f} s)")
    for fn, regs, st, ld, smem, stack in ptxas_usage(build.build_log):
        if any(k in fn for k in FX_SASS_KERNELS) or ("train_step_kernel" in fn and
                                                      "Lb1ELb1E" in fn):
            print(f"    {regs:4d} registers, spill stores {st} B, loads {ld} B, "
                  f"static shared {smem} B, stack {stack} B  {fn}")
    sass = sass_counts(build.build())
    fx_plan_checks()
    rng = np.random.default_rng(0)
    P, Nb = 8, cfg.batch_size
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    H, res = cfg.n_hidden_layers, cfg.level_resolutions()
    E = TRAIN_EDGE + 2
    vols = torch.rand((P, E, E, E, 1), generator=torch.Generator(device=dev)
                      .manual_seed(0), device=dev)
    tseeds = step_seeds(0, 0, P).to(dev)
    draw = dict(n_batch=Nb, n_uniform=Nb - n_boundary(Nb, cfg.boundary_lambda),
                sigma=cfg.boundary_sigma, ghost=1)
    params = step_params(cfg, P, dev, seed=0)
    coords, _ = fts_ref.sample_batch(vols, tseeds, n_batch=Nb,
                                     boundary_lambda=cfg.boundary_lambda,
                                     sigma=cfg.boundary_sigma, ghost=1)
    g_feat = torch.as_tensor(rng.standard_normal((P, Nb, L * F)) * 1e-5,
                             dtype=torch.float32, device=dev)
    fx_yardstick_checks(g_feat, coords, res, (P, L, T, F), rng, dev)
    kw = dict(volumes=vols, seeds=tseeds, **draw)
    for label, pr in (("f32", params), ("bf16", {k: v.to(torch.bfloat16)
                                                 for k, v in params.items()})):
        got, _ = fts.train_step_det_with(pr, H, res, design="split", **kw)
        det_yardstick_equal(f"{label}, in-kernel sampling", got, pr, H, res, **kw)
    det_step_clock(tag, params, H, res, **kw)
    fx_level_times(tag, g_feat, coords, res, list(range(P)), (P, L, T, F))
    sass_checks(sass)
    fx_sass_checks()
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def cached_phase(model, requests, wrappers, tag, dev, uncached) -> None:
    """Phase 4b: the cached serving path and the temporal path on phase 4's
    model (8 PRODUCTION256 partitions, tables U(-1,1)).

    A ``BrickCache`` of CACHE_EDGE^3 voxels a partition in bricks of
    BRICK_EDGE, CACHE_BUDGET bytes of pool: a cold ``ensure`` (host clock,
    then again under the profiler for the fills' device time; one INR
    inference launch per fill chunk, no encode or MLP forward launch), warm
    ``ensure`` calls, the pool against the same fill through the plain path
    (``backend="ref"``, phase 3's decode tolerance). Ticks of
    ``RenderService(model, cache=...)``, counters zeroed just before them:
    a cold tick (the cache cleared) and CACHED_WARM_TICKS warm ones, the
    inference kernel launching in the cold tick's fills and never in a warm
    one, compositing in every tick, the encode and MLP forward kernels never;
    the cold tick's frames against the same requests warm (bit for bit) and
    against the plain path's cached frames (1e-5); cached and uncached ticks
    in turns, host clock and peak memory above each tick's start (the
    cached at most the uncached + 2 GiB); one profiled cached tick. A bf16
    pool (bf16 storage and decode) against the f32 pool's frames (0.05).
    The temporal path: a ``TemporalModelCache(window=2)`` of the model and a
    perturbed copy, raw (``compress=False``) and compressed, served at
    timesteps 0, 1, 0, 1, 1 through a fresh cache of the same geometry:
    each switch of timestep evicts 2 x working set - slots bricks, every
    one of the stale timestep, and the last ``ensure`` is all hits."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.temporal import TemporalModelCache
    from repro_torch.kernels.inr_forward.ops import inr_forward_cuda
    from repro_torch.serving import BrickCache, RenderService
    from repro_torch.serving.cache import FILL_POINTS

    cfg, P = model.cfg, model.n_partitions
    geo = dict(grid_shape=(CACHE_EDGE,) * 3, brick_edge=BRICK_EDGE,
               budget_bytes=CACHE_BUDGET, device=dev)
    cache = BrickCache(cfg, backend="cuda", **geo)
    bpp = cache.bricks_per_partition(0)
    work, E = P * bpp, BRICK_EDGE + 1
    per_chunk = max(1, FILL_POINTS // E ** 3)
    fill_launches = P * -(-bpp // per_chunk)
    print(f"  BrickCache {CACHE_EDGE}^3 a partition in bricks of {BRICK_EDGE}: "
          f"{bpp:,} bricks a partition, {work:,} in all; {cache.slot_bytes:,} B a "
          f"slot, {cache.n_slots:,} slots ({cache.pool_bytes:,} B pool); working "
          f"set {work * cache.slot_bytes:,} B; one fill {work * E ** 3:,} points "
          f"in {fill_launches} INR calls")

    def zero():
        for w in wrappers.values():
            w.launches = 0

    def counts():
        return {n: w.launches for n, w in wrappers.items()}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    # ---- the fills: cold (host clock, synchronised), then under the
    # profiler (the fills' device time), then warm ensure calls
    zero()
    _, cold_ms = timed(lambda: cache.ensure(model))
    cold = counts()
    print(f"  cold ensure: {cold_ms:.2f} ms (host clock, synchronised), launches "
          f"{cold} [{tag}]")
    if cold["inr_forward"] != fill_launches or cold["hash_encode"] or \
            cold["fused_mlp_fwd"]:
        raise SmokeFailure(f"the cold fill did not take the inference route "
                           f"({fill_launches} chunks): {cold}")
    cache.clear()
    busy, by_kernel, wall, _ = profile_tick(lambda: cache.ensure(model))
    if busy is None:
        print(f"  profiled cold ensure: no device time recorded (not measured) "
              f"[{tag}]")
    else:
        print(f"  profiled cold ensure: {wall:.2f} ms host clock, device busy "
              f"{busy:.2f} ms (the fills' device time), idle share "
              f"{1 - busy / wall:.3f} [{tag}]")
        for name, (ms, n) in by_kernel[:6]:
            print(f"    {ms:9.3f} ms  x{n:<4d} {name[:90]}")
    warm_ms = [timed(lambda: cache.ensure(model))[1] for _ in range(3)]
    print(f"  warm ensure: {[round(x, 3) for x in warm_ms]} ms (host clock; "
          f"{work:,} lookups, all hits) [{tag}]")
    ref = BrickCache(cfg, backend="ref", **geo)
    _, ref_ms = timed(lambda: ref.ensure(model))
    print(f"  the same cold fill through the plain path: {ref_ms:.2f} ms [{tag}]")
    scale = max(1.0, float(ref.pool.abs().max()))
    check("brick pool: cuda fill vs ref fill", cache.pool, ref.pool,
          atol=2e-6 * scale)

    # ---- cached ticks: cold, then warm
    svc = RenderService(model, backend="cuda", cache=cache)
    plain = RenderService(model, backend="ref", cache=ref)

    def frames_of(service, reqs):
        for req in reqs:
            service.submit(req)
        resp = service.tick()
        if len(resp) != len(reqs):
            raise SmokeFailure(f"{len(resp)} responses for {len(reqs)} requests")
        out = np.stack([r.frame for r in resp])
        if not np.isfinite(out).all():
            raise SmokeFailure("a cached tick rendered a non-finite frame")
        return out

    cache.clear()
    zero()
    tick_ms, per_tick, first = [], [], None
    for i in range(1 + CACHED_WARM_TICKS):
        before = counts()
        f, ms = timed(lambda: frames_of(svc, requests(i)))
        after = counts()
        per_tick.append({n: after[n] - before[n] for n in after})
        tick_ms.append(ms)
        first = f if first is None else first
    launches = counts()
    print(f"  launches during the {1 + CACHED_WARM_TICKS} cached ticks: "
          f"{launches}; per tick {per_tick}")
    if per_tick[0]["inr_forward"] != fill_launches or \
            any(t["inr_forward"] for t in per_tick[1:]) or \
            any(t["composite"] <= 0 for t in per_tick) or \
            launches["hash_encode"] or launches["fused_mlp_fwd"]:
        raise SmokeFailure(f"cached ticks: the inference kernel must launch in "
                           f"the cold tick's fills only and compositing in every "
                           f"tick: {per_tick}")
    print(f"  cached ticks: cold {tick_ms[0]:.2f} ms (fills included), warm "
          f"{[round(x, 3) for x in tick_ms[1:]]} ms (host clock incl. frame "
          f"copy) [{tag}]")
    warm0 = frames_of(svc, requests(0))
    if not np.array_equal(first, warm0):
        raise SmokeFailure(f"cold-cache and warm-cache frames differ: "
                           f"{float(np.abs(first - warm0).max()):.3e}")
    print("  cold-cache frames == warm-cache frames, bit for bit  ok")
    check("cached tick frames: cuda vs ref", torch.from_numpy(warm0),
          torch.from_numpy(frames_of(plain, requests(0))), atol=1e-5)
    del plain, ref

    # ---- cached and uncached ticks in turns: host clock, peak memory above
    # each tick's start (the pools were allocated before either)
    def tick_run(service):
        for req in requests(1):
            service.submit(req)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        service.tick()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3,
                (torch.cuda.max_memory_allocated() - base) / 2 ** 30)

    turns = {"cached": [], "uncached": []}
    for label in ("uncached", "cached", "cached", "uncached"):
        turns[label].append(tick_run(svc if label == "cached" else uncached))
    for label, rs in turns.items():
        print(f"  {label} tick: {[round(ms, 3) for ms, _ in rs]} ms (host clock), "
              f"peak memory above the tick's start {[round(g, 3) for _, g in rs]} "
              f"GiB [{tag}]")
    peak_c = max(g for _, g in turns["cached"])
    peak_u = max(g for _, g in turns["uncached"])
    if peak_c > peak_u + 2.0:
        raise SmokeFailure(f"the cached tick's peak {peak_c:.3f} GiB exceeds the "
                           f"uncached {peak_u:.3f} GiB + 2 GiB")
    for req in requests(2):
        svc.submit(req)
    torch.cuda.synchronize()
    busy, by_kernel, wall, _ = profile_tick(svc.tick)
    if busy is None:
        print(f"  profiled cached tick: no device time recorded (not measured) "
              f"[{tag}]")
    else:
        print(f"  profiled cached tick: {wall:.2f} ms host clock, device busy "
              f"{busy:.2f} ms, idle share {1 - busy / wall:.3f} [{tag}]")
        for name, (ms, n) in by_kernel[:12]:
            print(f"    {ms:9.3f} ms  x{n:<4d} {name[:90]}")
    del svc, cache
    torch.cuda.empty_cache()

    # ---- a bf16 pool (bf16 storage, bf16 decode) against the f32 frames
    bf = BrickCache(cfg, backend="cuda", dtype="bfloat16",
                    compute_dtype="bfloat16", **geo)
    svc16 = RenderService(model, backend="cuda", cache=bf)
    inr_forward_cuda.bf16_launches = 0
    f16 = frames_of(svc16, requests(0))
    if inr_forward_cuda.bf16_launches != fill_launches:
        raise SmokeFailure(f"the bf16 pool's fills made "
                           f"{inr_forward_cuda.bf16_launches} bf16 inference "
                           f"launches, not {fill_launches}")
    check("bf16 pool frames vs f32 pool frames", torch.from_numpy(f16),
          torch.from_numpy(warm0), atol=0.05)
    del svc16, bf
    torch.cuda.empty_cache()

    # ---- the temporal path
    sp = model.stacked_params()
    bumped = {"tables": sp["tables"] + 0.05, "mlp": sp["mlp"]}
    for compress in (False, True):
        tc = TemporalModelCache(cfg, window=2, device=dev)
        _, append_ms = timed(lambda: (tc.append(0, sp, compress=compress),
                                      tc.append(1, bumped, compress=compress)))
        tcache = BrickCache(cfg, backend="cuda", trace=True, **geo)
        stale = max(0, 2 * work - tcache.n_slots)
        tsvc = RenderService(temporal=tc, cfg=cfg, parts_meta=model.parts_meta,
                             grange=model.grange, backend="cuda", cache=tcache)
        per_call, trace_ms, by_ts = [], [], {}
        for k, ts in enumerate((0, 1, 0, 1, 1)):
            n = len(tcache.events)
            reqs = [dataclasses.replace(r, timestep=ts) for r in requests(k)]
            f, ms = timed(lambda: frames_of(tsvc, reqs))
            trace_ms.append(ms)
            by_ts.setdefault(ts, f)
            evicted = [key for kind, key in tcache.events[n:] if kind == "evict"]
            if any(key[2] != 1 - ts for key in evicted):
                raise SmokeFailure(f"timestep {ts}: a brick of the requested "
                                   f"timestep was evicted")
            per_call.append(len(evicted))
        st = tcache.stats()
        label = "compressed" if compress else "raw f16"
        print(f"  temporal ({label}, {tc.total_bytes:,} B for 2 x {P} "
              f"partitions, appended in {append_ms:.1f} ms): evictions per "
              f"ensure {per_call}, hit rate {st['hit_rate']:.4f}, warm "
              f"timesteps {tsvc.warm_timesteps}, ticks "
              f"{[round(x, 1) for x in trace_ms]} ms (host clock) [{tag}]")
        last = tcache.events[-work:]
        if per_call != [0, stale, stale, stale, 0] or \
                any(kind != "hit" for kind, _ in last):
            raise SmokeFailure(f"temporal ({label}): evictions {per_call}, want "
                               f"[0, {stale}, {stale}, {stale}, 0] and the last "
                               f"ensure all hits")
        if np.array_equal(by_ts[0], by_ts[1]):
            raise SmokeFailure(f"temporal ({label}): timesteps 0 and 1 rendered "
                               f"the same frames")
        del tsvc, tcache, tc
        torch.cuda.empty_cache()


def dvnr_phases():
    """Phases 1-6 (the DVNR kernels, decode, serving, training and their
    report); returns (card tag, the kernels' rows, the flash check's error)."""
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
    import re

    import numpy as np

    from repro_torch import api
    from repro_torch.configs.dvnr import PRODUCTION256
    from repro_torch.core import inr as inr_mod
    from repro_torch.core import render as R
    from repro_torch.data.volume import make_partition
    from repro_torch.kernels import build
    from repro_torch.core.sampling import n_boundary, step_seeds
    from repro_torch.core.trainer import _opt_config, init_params
    from repro_torch.kernels.composite.ops import composite_cuda
    from repro_torch.kernels.composite.ref import composite_ref
    from repro_torch.kernels.fused_mlp.ops import (BWD_STAGES, fused_mlp_bwd_cuda,
                                                   fused_mlp_bwd_stage_cycles,
                                                   fused_mlp_cuda)
    from repro_torch.kernels.fused_mlp.ref import (fused_mlp_batched_bwd_ref,
                                                   fused_mlp_batched_ref)
    from repro_torch.kernels.fused_train_step import ops as fts
    from repro_torch.kernels.fused_train_step import ref as fts_ref
    from repro_torch.kernels.hash_encoding import ops as hops
    from repro_torch.kernels.hash_encoding.ops import (hash_encode_bwd_cuda,
                                                       hash_encode_cuda)
    from repro_torch.kernels.hash_encoding.ref import (
        hash_encode_batched_bwd_ref, hash_encode_batched_ref)
    from repro_torch.kernels.inr_forward import ops as inr_ops
    from repro_torch.kernels.inr_forward.ops import inr_forward_cuda
    from repro_torch.kernels.inr_forward.ref import inr_forward_ref
    from repro_torch.optim.adamw import AdamW
    from repro_torch.precision import resolve_precision
    from repro_torch.serving import RenderService

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    tag = card_tag()
    print(f"card: {tag}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    wrappers = {"hash_encode": hash_encode_cuda, "fused_mlp_fwd": fused_mlp_cuda,
                "composite": composite_cuda, "inr_forward": inr_forward_cuda}
    train_wrappers = {"hash_encode_bwd": hash_encode_bwd_cuda,
                      "fused_mlp_bwd": fused_mlp_bwd_cuda,
                      "train_step": fts.train_step_cuda,
                      "adamw_apply": fts.adamw_apply_cuda}
    every_wrapper = {**wrappers, **train_wrappers}
    cfg = PRODUCTION256
    res = cfg.level_resolutions()
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features_per_level
    rng = np.random.default_rng(0)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dtype)

    # ---------------------------------------------------------------- 1
    phase_header("== phase 1: build")
    t0 = time.perf_counter()
    build.library()
    print(f"  built {sorted(p.name for p in build.CSRC.glob('*.cu'))} in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {build.build_seconds:.1f} s)")
    done = re.findall(r"== (\S+) \(done after ([0-9.]+) s\)", build.build_log)
    if done:
        print("  nvcc, each source done after (s): " + ", ".join(
            f"{name} {t}" for name, t in sorted(done, key=lambda d: -float(d[1]))))
    usage = ptxas_usage(build.build_log)
    if not usage:
        print("    (the library came from an earlier build: its registers and "
              "spills were read by the run that built it)")
    for fn, regs, st, ld, smem, stack in usage:
        print(f"    {regs:4d} registers, spill stores {st} B, loads {ld} B, "
              f"static shared {smem} B, stack {stack} B  {fn}")
        PTXAS[fn] = {"registers": regs, "spill": st + ld, "static_smem": smem,
                     "stack": stack}
    # (the clocked instantiations, StageClock and InrStageClock, are a
    # measurement of phase 6 and not held)
    spilled = [fn for fn, _, st, ld, *_ in usage if (st or ld) and (any(
        k in fn for k in ("fused_mlp_fwd_kernel", "fused_mlp_bwd_kernel",
                          "inr_forward_kernel", "inr_forward_grid_kernel")
        + FX_SASS_KERNELS) or re.search(r"train_step_kernelI.*Lb1EEEv", fn))
        and "StageClock" not in fn]
    if spilled:
        raise SmokeFailure(f"MLP forward / backward, INR inference, deterministic "
                           f"scatter or train-step kernels that spill: {spilled}")
    sass = sass_counts(build.build())
    t0 = time.perf_counter()
    inr_layout_checks()
    print(f"  inr_forward layout checks: {time.perf_counter() - t0:.1f} s")
    fx_plan_checks()
    # ---------------------------------------------------------------- 2
    phase_header("== phase 2: kernels against their plain versions "
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
    fwd_case_checks(dev)
    D_in = L * F
    W = cfg.n_neurons
    inr_errs, rng_inr = {}, np.random.default_rng(17)
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
        # the INR inference kernel on the same weights and tables (its
        # coordinates from a generator of its own: the later checks keep
        # their inputs)
        for lo, hi, where in ((0.0, 1.0, "in [0,1]"),
                              (-0.25, 1.25, "in [-0.25,1.25]")):
            coords = t(rng_inr.uniform(lo, hi, (B, N, 3)))
            for policy, tab, wss, cdt in (
                    ("f32", tables32, ws, None),
                    ("bf16", tables32.to(torch.bfloat16),
                     [w.to(torch.bfloat16) for w in ws], None),
                    ("f32/bf16/f32", tables32, ws, "bfloat16")):
                want = inr_forward_ref(coords, tab, wss, part_d, res, cdt)
                got = inr_forward_cuda(coords, tab, wss, part, res, cdt)
                key = "inr_forward" if want.dtype == torch.float32 else "inr_forward_bf16"
                e = inr_check(f"inr_forward {policy} H={H} D_out={D_out} N={N} {where}",
                              coords, got, want)
                inr_errs[key] = max(inr_errs.get(key, 0.0), e)
                del want, got
    inr_errs["inr_forward"] = max(inr_errs["inr_forward"], inr_case_checks(dev))
    # an output wider than the kernel's n = 8 tile: the wrapper launches it
    # once per 8 columns (two launches, the second ragged)
    N = CHECK_N[1]
    dims = [D_in, W, W, 9]
    ws = [t(rng_inr.uniform(-1, 1, (P, a, b)) * np.sqrt(6.0 / a))
          for a, b in zip(dims[:-1], dims[1:])]
    x = t(rng_inr.uniform(-1, 1, (B, N, D_in)))
    for dt in (torch.float32, torch.bfloat16):
        xs, wss = x.to(dt), [w.to(dt) for w in ws]
        want = fused_mlp_batched_ref(xs, wss, part_d)
        got = fused_mlp_cuda(xs, wss, part)
        scale = max(1.0, float(want.float().abs().max()))
        if dt == torch.float32:
            check(f"fused_mlp f32 H=2 D_out=9 N={N}", got, want, atol=2e-6 * scale)
        else:
            check(f"fused_mlp bf16 H=2 D_out=9 N={N}", got, want,
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

    # the training kernels, at the training shapes: the 8 partitions' batch
    # of 65,536 drawn by the plain sampler from their 258^3 volumes
    TP, Nb = 8, cfg.batch_size
    H, D_out = cfg.n_hidden_layers, cfg.out_dim
    print(f"  training kernels: P={TP} partitions x N={Nb}, f32, 2x2x2 "
          f"CloverLeaf {TRAIN_EDGE}^3 partitions")
    tparts = [make_partition("cloverleaf", p, (2, 2, 2), (TRAIN_EDGE,) * 3,
                             t=0.3, device=dev) for p in range(TP)]
    vols = torch.stack([p.normalized() for p in tparts])
    vols_c = vols[..., None]
    n_uni = Nb - n_boundary(Nb, cfg.boundary_lambda)
    draw = dict(n_batch=Nb, n_uniform=n_uni, sigma=cfg.boundary_sigma, ghost=1)
    tseeds = step_seeds(0, 0, TP).to(dev)
    coords_t, target_t = fts_ref.sample_batch(
        vols_c, tseeds, n_batch=Nb, boundary_lambda=cfg.boundary_lambda,
        sigma=cfg.boundary_sigma, ghost=1)
    tparams = {k: v.to(dev) for k, v in
               fts._pack(init_params(cfg, 0, TP))[0].items()}
    # tables of a trained model's magnitude: the init's +-1e-4 would leave
    # every MLP input near 0
    tparams["tab"] = t(rng.uniform(-0.05, 0.05, (TP, L, T, F)))
    rows_t = list(range(TP))
    rows_td = torch.arange(TP, device=dev)
    g_feat = t(rng.standard_normal((TP, Nb, L * F)) * 1e-5)
    got = hash_encode_bwd_cuda(g_feat, coords_t, res, rows_t, (TP, L, T, F))
    want = hash_encode_batched_bwd_ref(g_feat, coords_t, res, rows_td,
                                       (TP, L, T, F))
    # float32 sums of up to ~4,200 atomic adds per address (dense level 0)
    # in an order that changes from run to run
    errs = {"hash_encode_bwd": check(
        "hash_encode_bwd (atomic scatter)", got, want,
        atol=2e-5 * float(want.abs().max()))}
    # a bf16 cotangent: the kernel widens it, as the plain version does, so
    # the float32 limit holds
    g_feat16 = g_feat.to(torch.bfloat16)
    got = hash_encode_bwd_cuda(g_feat16, coords_t, res, rows_t, (TP, L, T, F))
    want = hash_encode_batched_bwd_ref(g_feat16, coords_t, res, rows_td,
                                       (TP, L, T, F))
    errs["hash_encode_bwd_bf16"] = check(
        "hash_encode_bwd bf16 cotangent (atomic scatter)", got, want,
        atol=2e-5 * float(want.abs().max()))
    del got, want
    # the scatter's other routes: every point in one coarse cell (the
    # warp pre-reduction and the shared-memory staging under contention),
    # PRODUCTION's T=2^16 (its fine levels' slabs exceed the staging budget:
    # direct vector atomics), and F = 1, 2 and 8 (ABLATION: T=2^19, F=8)
    from repro_torch.configs.dvnr import ABLATION, PRODUCTION
    from repro_torch.kernels.hash_encoding.ops import bwd_plan
    for label, hc, hP, hF, (lo, hi) in (
            ("contention: one coarse cell", cfg, TP, F, (0.30, 0.31)),
            ("PRODUCTION T=2^16", PRODUCTION, TP, F, (0.0, 1.0)),
            ("F=1", cfg, 4, 1, (-0.25, 1.25)),
            ("F=2", cfg, 4, 2, (0.0, 1.0)),
            ("ABLATION F=8 T=2^19", ABLATION, 2, 8, (0.0, 1.0))):
        hres, hT, hL = hc.level_resolutions(), hc.table_size, hc.n_levels
        hN = hc.batch_size
        hcoords = t(rng.uniform(lo, hi, (hP, hN, 3)))
        hg = t(rng.standard_normal((hP, hN, hL * hF)) * 1e-5)
        plan = "".join("s" if x else "d" for x in bwd_plan(hres, hT, hF))
        for hgd in (hg, hg.to(torch.bfloat16)):
            got = hash_encode_bwd_cuda(hgd, hcoords, hres, list(range(hP)),
                                       (hP, hL, hT, hF))
            want = hash_encode_batched_bwd_ref(hgd, hcoords, hres,
                                               torch.arange(hP, device=dev),
                                               (hP, hL, hT, hF))
            check(f"hash_encode_bwd {str(hgd.dtype)[6:]} {label} (levels {plan})",
                  got, want, atol=2e-5 * float(want.abs().max()))
            del got, want
        del hcoords, hg
    feats_t = hash_encode_cuda(coords_t, tparams["tab"], res, rows_t)
    ws_t = fts._unpack(tparams, H)["mlp"]
    g_out = t(rng.choice([-1.0, 1.0], (TP, Nb, D_out)) / Nb)
    got = fused_mlp_bwd_cuda(feats_t, ws_t, g_out, rows_t)
    errs["fused_mlp_bwd"] = check_mlp_bwd(f"P={TP} N={Nb}", feats_t, ws_t, g_out,
                                          rows_t, got)
    mlp_bwd_controls(f"P={TP} N={Nb}", feats_t, ws_t, g_out, rows_t, got)
    # bf16 operands (the unfused bf16 step's): the features of the bf16
    # tables, the weights and the cotangent rounded to bf16 (+-1/N is exact)
    tparams16 = {k: v.to(torch.bfloat16) for k, v in tparams.items()}
    feats16 = hash_encode_cuda(coords_t, tparams16["tab"], res, rows_t)
    ws16 = fts._unpack(tparams16, H)["mlp"]
    g_out16 = g_out.to(torch.bfloat16)
    got = fused_mlp_bwd_cuda(feats16, ws16, g_out16, rows_t)
    errs["fused_mlp_bwd_bf16"] = check_mlp_bwd(f"P={TP} N={Nb} bf16", feats16, ws16,
                                               g_out16, rows_t, got)
    mlp_bwd_controls(f"P={TP} N={Nb} bf16", feats16, ws16, g_out16, rows_t, got)
    del got
    mlp_bwd_case_checks(dev)
    errs.update(unfused_det_checks(
        g_feat, coords_t, res, (TP, L, T, F), feats_t, ws_t, g_out, feats16,
        ws16, g_out16, tag))
    step_tie_draws(dev, tparams, H, res, coords_t, target_t, cfg)
    wants_t = step_wants(tparams, H, res, coords_t, target_t)
    errs["train_step"] = max(
        check_step("host-sampled batch", tparams, H, res, wants_t,
                   coords=coords_t, target=target_t),
        check_step("in-kernel sampling", tparams, H, res, wants_t,
                   volumes=vols_c, seeds=tseeds, **draw))
    errs["train_step_det"] = DET_ERRS["train_step_det"]    # this batch's
    got_g, got_loss = fts.train_step_cuda(tparams, H, res, volumes=vols_c,
                                          seeds=tseeds, **draw)
    # the two-launch split (the kernel writes the feature cotangent, the
    # level-major backward scatters it): the same gradient
    cot = torch.empty((TP, Nb, L * F), device=dev)
    split_g, split_loss = fts.train_step_cuda(tparams, H, res, cotangent_out=cot,
                                              volumes=vols_c, seeds=tseeds, **draw)
    split_g["tab"] = hash_encode_bwd_cuda(cot, coords_t, res, rows_t, (TP, L, T, F))
    check_step_grads("split: cotangent + hash_encode_bwd", H, split_g, split_loss,
                     wants_t, keys=["tab"])
    del cot, split_g, split_loss, wants_t
    wants16 = step_wants_bf16(tparams16, H, res, coords_t, target_t)
    errs["train_step_bf16"] = max(
        check_step_bf16("host-sampled batch", tparams16, H, res, wants16,
                        coords=coords_t, target=target_t),
        check_step_bf16("in-kernel sampling", tparams16, H, res, wants16,
                        volumes=vols_c, seeds=tseeds, **draw))
    errs["train_step_det_bf16"] = DET_ERRS["train_step_det_bf16"]
    got_g16, got_loss16 = fts.train_step_cuda(tparams16, H, res, volumes=vols_c,
                                              seeds=tseeds, **draw)
    del wants16
    step_case_checks(dev, vols_c, tseeds, cfg)
    errs["train_step_v3"] = velocity_step_checks(dev, tseeds, cfg)
    adam = AdamW(_opt_config(cfg, resolve_precision(cfg.precision)))
    sched = fts.schedule_table(torch.zeros(TP, dtype=torch.int32, device=dev),
                               adam.cfg, adam, 1)[0]
    sched[TP // 2, 3] = 0.0                  # one converged (gated) partition
    moments = {k: (t(rng.standard_normal(tparams[k].shape) * 1e-3),
                   t(rng.uniform(0, 1e-6, tparams[k].shape)))
               for k in fts.STATE_KEYS}
    adam_kw = dict(beta1=adam.cfg.beta1, beta2=adam.cfg.beta2, eps=adam.cfg.eps,
                   weight_decay=adam.cfg.weight_decay, n_hidden=H)

    def adam_state():
        return ({k: v.clone() for k, v in tparams.items()},
                {k: m.clone() for k, (m, _) in moments.items()},
                {k: v.clone() for k, (_, v) in moments.items()})

    pk, mk, vk = adam_state()
    fts.adamw_apply_cuda(pk, mk, vk, got_g, sched, got_loss, n_valid=Nb, **adam_kw)
    pp, mp, vp = adam_state()
    fts_ref.adamw_apply_ref(pp, mp, vp, None, got_g, sched, **adam_kw)
    # every operation rounded once, in the plain version's order: bit-exact
    for k in fts.STATE_KEYS:
        for name, a, b in (("param", pk, pp), ("m", mk, mp), ("v", vk, vp)):
            e = check(f"adamw_apply {k} {name}", a[k], b[k], atol=0.0)
            errs["adamw_apply"] = max(errs.get("adamw_apply", 0.0), e)

    def master_state():   # the bf16 policy's: bf16 params, f32 master
        p, m, v = adam_state()
        return {k: x.to(torch.bfloat16) for k, x in p.items()}, m, v, p

    pk, mk, vk, wk = master_state()
    fts.adamw_apply_cuda(pk, mk, vk, got_g16, sched, got_loss16, n_valid=Nb,
                         flat_mw=wk, **adam_kw)
    pp, mp, vp, wp = master_state()
    fts_ref.adamw_apply_ref(pp, mp, vp, wp, got_g16, sched, **adam_kw)
    # the same operations on the master, the bf16 params its rounding
    for k in fts.STATE_KEYS:
        for name, a, b in (("master", wk, wp), ("bf16 param", pk, pp),
                           ("m", mk, mp), ("v", vk, vp)):
            e = check(f"adamw_apply master {k} {name}", a[k], b[k], atol=0.0)
            errs["adamw_apply_master"] = max(errs.get("adamw_apply_master", 0.0), e)
    # the deterministic route's AdamW (it sums the train step's group rows in
    # group order and converts the fixed-point table gradient) against the
    # plain AdamW on det_grads_to_float's gradients, the same arithmetic:
    # params, moments, master and the mean loss bit for bit
    with deterministic_algorithms():
        det32, _ = fts.train_step_cuda(tparams, H, res, volumes=vols_c,
                                       seeds=tseeds, **draw)
        det16, _ = fts.train_step_cuda(tparams16, H, res, volumes=vols_c,
                                       seeds=tseeds, **draw)
    for name, det, src in (("adamw_det", det32, tparams), ("adamw_det_master", det16,
                                                           tparams16)):
        master = name.endswith("master")
        ks, ps = (master_state(), master_state()) if master else \
            ((*adam_state(), None), (*adam_state(), None))
        with deterministic_algorithms():
            loss_k = fts.adamw_apply_cuda(*ks[:3], det, sched, None, n_valid=Nb,
                                          flat_mw=ks[3], **adam_kw)
        g_ref, loss_sum_ref = fts.det_grads_to_float(det, src, H)
        fts_ref.adamw_apply_ref(*ps[:3], ps[3], g_ref, sched, **adam_kw)
        errs[name] = check(f"{name} loss", loss_k, loss_sum_ref / float(Nb), atol=0.0)
        for k in fts.STATE_KEYS:
            for i, part_name in enumerate(("param", "m", "v", "master")[:4 if master else 3]):
                errs[name] = max(errs[name], check(
                    f"{name} {k} {part_name}", ks[i][k], ps[i][k], atol=0.0))
    del det32, det16
    torch.cuda.synchronize()
    flash_err = flash_checks(dev)

    # ---------------------------------------------------------------- 3
    phase_header(f"== phase 3: decode_grid of one {DECODE_EDGE}^3 partition")
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
    # the inference route: one INR inference launch per chunk, neither
    # kernel of the encode + MLP pair
    n_chunks = -(-DECODE_EDGE ** 3 // DECODE_CHUNK)
    if decode_launches["inr_forward"] != n_chunks or \
            decode_launches["hash_encode"] or decode_launches["fused_mlp_fwd"]:
        raise SmokeFailure(f"decode_grid did not take the inference route "
                           f"({n_chunks} chunks): {decode_launches}")
    del grid_k, grid_p

    # ---------------------------------------------------------------- 4
    phase_header("== phase 4: RenderService over 8 PRODUCTION256 partitions "
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

    svc = RenderService(model, backend="cuda", use_cache=False)
    for w in wrappers.values():
        w.launches = 0
    tick_ms, first_frames, inr_per_tick = [], None, []
    for tick in range(TICKS):
        for req in requests(tick):
            svc.submit(req)
        torch.cuda.synchronize()
        before = inr_forward_cuda.launches
        t0 = time.perf_counter()
        resp = svc.tick()
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        inr_per_tick.append(inr_forward_cuda.launches - before)
        if len(resp) != C:
            raise SmokeFailure(f"tick {tick}: {len(resp)} responses for {C}")
        for r in resp:
            if r.frame.shape != (Hd, Wd, 4) or not np.isfinite(r.frame).all():
                raise SmokeFailure(f"tick {tick}: bad frame {r.frame.shape}")
        if first_frames is None:
            first_frames = np.stack([r.frame for r in resp])
    launches = {n: w.launches for n, w in wrappers.items()}
    print(f"  launches during the {TICKS} ticks: {launches}; INR inference "
          f"per tick {inr_per_tick}")
    if min(inr_per_tick) <= 0 or launches["composite"] <= 0 or \
            launches["hash_encode"] or launches["fused_mlp_fwd"]:
        raise SmokeFailure(f"the serving path did not take the inference "
                           f"route in every tick: {launches}, {inr_per_tick}")
    for i, ms in enumerate(tick_ms):
        print(f"  tick {i}: {ms:.2f} ms ({C} clients {Wd}x{Hd}x{S}, host clock "
              f"incl. frame copy) [{tag}]")
    plain = RenderService(model, backend="ref", use_cache=False)
    for req in requests(0):
        plain.submit(req)
    plain_frames = np.stack([r.frame for r in plain.tick()])
    frame_err = check("tick 0 frames: cuda vs ref", torch.from_numpy(first_frames),
                      torch.from_numpy(plain_frames), atol=1e-5)
    print(f"  frame alpha mean {float(first_frames[..., 3].mean()):.4f}, "
          f"rgb mean {float(first_frames[..., :3].mean()):.4f}")
    del plain

    # ---------------------------------------------------------------- 4b
    phase_header(f"== phase 4b: cached serving and the temporal path on phase 4's "
          f"model")
    cached_phase(model, requests, wrappers, tag, dev, svc)

    # ---------------------------------------------------------------- 5
    phase_header(f"== phase 5: api.train of {TP} PRODUCTION256 partitions (2x2x2 "
          f"split of {2 * TRAIN_EDGE}^3), {TRAIN_STEPS} steps at batch {Nb}")
    for w in every_wrapper.values():
        w.launches = 0
    torch.cuda.synchronize()
    tmodel, tinfo = api.train(tparts, cfg, backend="cuda", steps=TRAIN_STEPS,
                              key=0, log_every=1)
    torch.cuda.synchronize()
    train_launches = {n: w.launches for n, w in every_wrapper.items()}
    print(f"  launches during the {TRAIN_STEPS} steps: {train_launches}")
    for n in ("train_step", "adamw_apply"):
        if train_launches[n] <= 0:
            raise SmokeFailure(f"the training path launched no {n} kernel")
    losses = np.array([l for _, l in tinfo["loss_history"]])
    if losses.shape != (TRAIN_STEPS,) or not np.isfinite(losses).all():
        raise SmokeFailure(f"loss trace {losses.shape}, finite "
                           f"{bool(np.isfinite(losses).all())}")
    ms_step = tinfo["train_time_s"] * 1e3 / TRAIN_STEPS
    sps = TP * Nb * TRAIN_STEPS / tinfo["train_time_s"]
    DRYRUN_MEASURED["dvnr_train"] = {"ms": ms_step, "partitions": TP,
                                     "what": f"phase 5, api.train(backend='cuda'): "
                                             f"{TRAIN_STEPS} fused steps, host clock"}
    first, last = float(losses[:16].mean()), float(losses[-16:].mean())
    print(f"  {TRAIN_STEPS} steps in {tinfo['train_time_s']:.3f} s: "
          f"{ms_step:.4f} ms per step, {sps:.4g} samples/s (host clock, "
          f"synchronised) [{tag}]")
    print(f"  loss: step 1 {losses[0]:.6f}, mean of the first 16 {first:.6f}, "
          f"of the last 16 {last:.6f}")
    if not last < 0.5 * first:
        raise SmokeFailure(f"the loss did not fall: first 16 {first:.6f}, "
                           f"last 16 {last:.6f}")
    ev = tinfo["trainer"].evaluate(tinfo["state"], vols, (TRAIN_EDGE,) * 3)
    if not np.isfinite(ev["psnr"]):
        raise SmokeFailure(f"evaluate: PSNR {ev['psnr']}")
    print(f"  evaluate: PSNR {ev['psnr']:.4f} dB over {TP} x {TRAIN_EDGE}^3 "
          f"voxels after {TRAIN_STEPS} steps [{tag}]")
    # the first steps of the same run through the plain path and through the
    # unfused kernel path (hash-encode and MLP forward and backward kernels)
    _, rinfo = api.train(tparts, cfg, backend="ref", steps=COMPARE_STEPS,
                         key=0, log_every=1)
    for w in every_wrapper.values():
        w.launches = 0
    torch.cuda.synchronize()
    _, uinfo = api.train(tparts, cfg, backend="cuda", steps=COMPARE_STEPS,
                         key=0, log_every=1, fuse_train_step="off")
    torch.cuda.synchronize()
    unfused_launches = {n: w.launches for n, w in every_wrapper.items()}
    print(f"  launches during the {COMPARE_STEPS} unfused steps: {unfused_launches}")
    for n in ("hash_encode", "fused_mlp_fwd", "hash_encode_bwd", "fused_mlp_bwd"):
        if unfused_launches[n] <= 0:
            raise SmokeFailure(f"the unfused training path launched no {n} kernel")
    head = torch.from_numpy(losses[:COMPARE_STEPS])
    # the paths sum in different orders (atomics, block reductions, cuBLAS),
    # and Adam's normalised first steps amplify the sign of near-zero
    # gradient entries: the traces agree to a relative 1e-4, not bit for bit
    for label, info in (("plain path (ref)", rinfo), ("unfused kernels", uinfo)):
        other = torch.tensor([l for _, l in info["loss_history"]],
                             dtype=torch.float64)
        check(f"first {COMPARE_STEPS} losses: fused vs {label}", head, other,
              atol=0.0, rtol=1e-4)
    det_runs = det_training(tparts, vols, cfg, every_wrapper, tag, rinfo)
    udet_runs = unfused_det_training(tparts, vols, cfg, every_wrapper, tag, rinfo)
    # the unfused path warm (its first run above pays its first calls), and
    # the fused path over the same number of steps
    _, uinfo = api.train(tparts, cfg, backend="cuda", steps=COMPARE_STEPS,
                         key=1, log_every=1, fuse_train_step="off")
    _, finfo = api.train(tparts, cfg, backend="cuda", steps=COMPARE_STEPS,
                         key=1, log_every=1)
    print(f"  {COMPARE_STEPS} steps, second run: unfused kernel path "
          f"{uinfo['train_time_s'] * 1e3 / COMPARE_STEPS:.4f} ms per step, fused "
          f"{finfo['train_time_s'] * 1e3 / COMPARE_STEPS:.4f} (host clock, "
          f"synchronised; {TRAIN_STEPS} fused steps above: {ms_step:.4f}) [{tag}]")
    del rinfo, uinfo, finfo
    bf16_runs = bf16_training(tparts, vols, cfg, train_wrappers, tag,
                              {"ms_step": ms_step, "sps": sps, "psnr": ev["psnr"],
                               "losses": losses})
    mixed_policy_checks(tparts, cfg, train_wrappers)
    sass_checks(sass)                 # phase 1's, its listing made meanwhile
    fx_sass_checks()

    # ---------------------------------------------------------------- 6
    phase_header(f"== phase 6: per-kernel times at the tick's shapes [{tag}]")
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
    # launches on each kernel's path, counted from zero just before it:
    # compositing in the ticks; the encode and MLP forward kernels in the
    # unfused training steps (the ticks take the INR inference kernel)
    path_launches = {"hash_encode": (unfused_launches["hash_encode"], "unfused step",
                                     COMPARE_STEPS),
                     "fused_mlp_fwd": (unfused_launches["fused_mlp_fwd"],
                                       "unfused step", COMPARE_STEPS),
                     "composite": (launches["composite"], "tick", TICKS)}
    for name, kern, plain_fn, lib_fn, nbytes, flops in specs:
        got, want = kern(), plain_fn()
        if name != "composite":
            got, want = got[hitm], want[hitm]
        err = check(f"{name} at tick shapes (hit rays)", got, want,
                    atol=2e-6 * max(1.0, float(want.abs().max())))
        del got, want
        ms = cuda_ms(kern, reps=10)
        pms = cuda_ms(plain_fn, reps=1 if name == "hash_encode" else 3)   # ~2 s a call
        lms = cuda_ms(lib_fn, reps=5) if lib_fn is not None else None
        bms, by = bound_ms(nbytes, flops)
        n_path, path, n_runs = path_launches[name]
        print(f"  {name:<14s} {ms:9.3f} ms  bound {bms:8.3f} ms ({by})  "
              f"plain {pms:9.3f} ms  library "
              f"{'-' if lms is None else f'{lms:.3f} ms'}  "
              f"launches/{path} {n_path / n_runs:.0f} [{tag}]")
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": n_path,
                        "max_abs_err": err, "ms": ms, "plain_ms": pms,
                        "bound_ms": bms, "bound_by": by, "library_ms": lms})
    # the INR inference kernel at the tick's shapes, f32 (the serving
    # policy; launches: the ticks') and bf16 (launches: the bf16 training
    # run's evaluate): the kernel's plans, clock and kernel-alone time
    # against the grid-stride yardstick (inr_designs; inr_widths: the same
    # at PRODUCTION's and ABLATION's widths), then the wrapper
    # against the encode + MLP pair back to back and the plain version.
    # Bound: the coordinates in and the output out (16 B a point in f32),
    # tables and weights read once; the encode's float work at the f32
    # peak, the MLP's products at the peak of their type
    designs = inr_designs(tag, dev, coords, sp, rows, res, hitm)
    inr_widths(tag, dev)
    enc_pt = L * (25 + 16 * F)
    mlp_pt = 2 * (D_in * W + (nH - 1) * W * W + W * cfg.out_dim)
    n_w1 = sum(w.shape[1] * w.shape[2] for w in sp["mlp"])
    sp16 = {"tables": sp["tables"].to(torch.bfloat16),
            "mlp": [w.to(torch.bfloat16) for w in sp["mlp"]]}
    for name, key, spx, n_inr in (("inr_forward", "f32", sp, launches["inr_forward"]),
                                  ("inr_forward_bf16", "bf16", sp16,
                                   bf16_runs["auto"]["inr_forward"])):
        isz = spx["tables"].element_size()
        kern = lambda spx=spx: inr_forward_cuda(coords, spx["tables"], spx["mlp"],
                                                rows, res)
        pair = lambda spx=spx: fused_mlp_cuda(
            hash_encode_cuda(coords, spx["tables"], res, rows), spx["mlp"], rows)
        plain_fn = lambda spx=spx: inr_forward_ref(coords, spx["tables"],
                                                   spx["mlp"], rows_d, res)
        got, want = kern()[hitm], plain_fn()[hitm]
        scale = max(1.0, float(want.float().abs().max()))
        if isz == 4:
            err = check(f"{name} at tick shapes (hit rays)", got, want,
                        atol=2e-6 * scale)
        else:
            err = check(f"{name} at tick shapes (hit rays)", got, want,
                        atol=2.0 ** -7 * scale, rtol=2.0 ** -7)
        del got, want
        ms, pair_ms = cuda_ms(kern, reps=10), cuda_ms(pair, reps=10)
        pms = cuda_ms(plain_fn, reps=1)
        nbytes = Bn * Nn * (12 + cfg.out_dim * isz) + P * (L * T * F + n_w1) * isz
        if isz == 4:
            bms, by = bound_ms(nbytes, Bn * Nn * (enc_pt + mlp_pt))
        else:
            bms, by = bound_ms(nbytes, Bn * Nn * enc_pt, bf16_flops=Bn * Nn * mlp_pt)
        d = designs[key]
        print(f"  {name:<16s} {ms:9.3f} ms  kernel alone {d['kernel_ms']:.4f} ms  "
              f"bound {bms:8.3f} ms ({by})  plan {d['plan']}  the grid-stride design "
              f"{d['grid_ms']:.3f} ms  the encode + MLP pair {pair_ms:.3f} ms  "
              f"plain {pms:9.3f} ms  launches {n_inr} [{tag}]")
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": n_inr,
                        "max_abs_err": max(err, inr_errs[name]), "ms": ms,
                        "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                        "library_ms": None})
    # row 2b, the MLP forward under bf16 at the tick's shapes (bf16 features
    # and weights): against its plain version and the bf16 bmm + relu
    # chain; bound: bf16 features in and out, weights once, the products at
    # the bf16 peak; launches: the bf16 unfused training run's
    tick16 = feats.to(torch.bfloat16)

    def mlp_chain16():
        h = tick16
        for w in sp16["mlp"][:-1]:
            h = torch.relu(torch.bmm(h, w[rows_d]))
        return torch.bmm(h, sp16["mlp"][-1][rows_d])

    kern = lambda: fused_mlp_cuda(tick16, sp16["mlp"], rows)
    plain_fn = lambda: fused_mlp_batched_ref(tick16, sp16["mlp"], rows_d)
    got, want = kern()[hitm], plain_fn()[hitm]
    scale = max(1.0, float(want.float().abs().max()))
    err = check("fused_mlp_fwd_bf16 at tick shapes (hit rays)", got, want,
                atol=2.0 ** -7 * scale, rtol=2.0 ** -7)
    del got, want
    ms, pms, lms = cuda_ms(kern, reps=10), cuda_ms(plain_fn, reps=3), \
        cuda_ms(mlp_chain16, reps=5)
    bms, by = bound_ms(Bn * Nn * (D_in + cfg.out_dim) * 2 + P * 2 * sum(
        w.shape[1] * w.shape[2] for w in sp["mlp"]), 0.0,
        bf16_flops=2 * Bn * Nn * (D_in * W + (nH - 1) * W * W + W * cfg.out_dim))
    n16 = bf16_runs["off"]["fused_mlp_fwd"]
    print(f"  {'fused_mlp_fwd_bf16':<16s} {ms:9.3f} ms  bound {bms:8.3f} ms ({by})  "
          f"plain {pms:9.3f} ms  library {lms:.3f} ms (bf16 bmm+relu chain)  "
          f"launches/unfused bf16 step {n16 / TRAIN_STEPS:.0f} [{tag}]")
    kernels.append({"name": "fused_mlp_fwd_bf16", "route": "cuda",
                    "source": SOURCES["fused_mlp_fwd_bf16"],
                    "replaces": REPLACES["fused_mlp_fwd_bf16"], "launches": n16,
                    "max_abs_err": err, "ms": ms, "plain_ms": pms,
                    "bound_ms": bms, "bound_by": by, "library_ms": lms})
    # row 2b: the kernel's own device time per launch (rows 9 and 9b:
    # inr_designs above)
    per = kernel_alone_ms(lambda: fused_mlp_cuda(tick16, sp16["mlp"], rows),
                          "fused_mlp_fwd_kernel<__nv_bfloat16,")
    print(f"  fused_mlp_fwd bf16 at the tick's shapes: kernel alone "
          f"{'not measured' if per is None else f'{per:.4f} ms'} per call "
          f"(profiler) [{tag}]")
    del sp16, tick16
    # where the forward's time goes: the same call on the first k levels
    # only (the coarse levels are dense and L1-resident, the fine ones
    # hashed and read from L2)
    prefix = []
    for k in range(1, L + 1):
        tk = sp["tables"][:, :k].contiguous()
        prefix.append(cuda_ms(lambda: hash_encode_cuda(coords, tk, res[:k], rows),
                              reps=10))
    print(f"  hash_encode on levels 0..k-1, k = 1..{L}: "
          f"{[round(x, 3) for x in prefix]} ms (events) [{tag}]")
    del feats, v, rgba, coords, local

    # phase-3 shapes: one decode chunk of 2^22 points, one partition, on
    # uniform random points (the earlier readings' inputs) and on the
    # decode's own first chunk of cell centres (what phase 3 runs)
    Nd = DECODE_CHUNK
    sp1 = {"tables": model1.params["tables"][None],
           "mlp": [w[None] for w in model1.params["mlp"]]}
    ax = (torch.arange(DECODE_EDGE, dtype=torch.float32, device=dev) + 0.5) / DECODE_EDGE
    centres = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1) \
        .reshape(-1, 3)[:Nd][None].contiguous()
    for where, cd in (("uniform random points", torch.rand((1, Nd, 3), device=dev)),
                      ("the decode's first chunk", centres)):
        fd = hash_encode_cuda(cd, sp1["tables"], res, [0])
        for name, kern, nbytes, flops in (
                ("hash_encode", lambda: hash_encode_cuda(cd, sp1["tables"], res, [0]),
                 Nd * (12 + L * F * 4) + L * T * F * 4, Nd * L * (25 + 16 * F)),
                ("fused_mlp_fwd", lambda: fused_mlp_cuda(fd, sp1["mlp"], [0]),
                 Nd * (D_in + 1) * 4, 2 * Nd * (D_in * W + (nH - 1) * W * W + W))):
            ms = cuda_ms(kern, reps=10)
            bms, by = bound_ms(nbytes, flops)
            print(f"  decode chunk {name:<14s} N=2^22, {where}: {ms:.3f} ms  bound "
                  f"{bms:.3f} ms ({by}) [{tag}]")
        inr1 = lambda: inr_forward_cuda(cd, sp1["tables"], sp1["mlp"], [0], res)
        pair1 = lambda: fused_mlp_cuda(hash_encode_cuda(cd, sp1["tables"], res, [0]),
                                       sp1["mlp"], [0])
        ms, pair_ms = cuda_ms(inr1, reps=10), cuda_ms(pair1, reps=10)
        bms, by = bound_ms(Nd * 16 + (L * T * F + n_w1) * 4,
                           Nd * (enc_pt + 2 * (D_in * W + (nH - 1) * W * W + W)))
        print(f"  decode chunk inr_forward N=2^22, {where}: {ms:.3f} ms  bound "
              f"{bms:.3f} ms ({by}); the encode + MLP pair {pair_ms:.3f} ms; "
              f"{decode_launches['inr_forward']} launches per {DECODE_EDGE}^3 decode "
              f"[{tag}]")
        # the two designs through the measurement entry alike (the path's
        # wrapper above adds its own host time)
        turns, alone = design_turns(
            lambda design: inr_ops.inr_forward_with(cd, sp1["tables"], sp1["mlp"], [0],
                                                    res, design=design), "f32")
        print(f"  decode chunk designs, {where}: {turns_line(turns, alone)} [{tag}]")
        for design in ("grid", "persistent"):
            cyc = inr_ops.inr_forward_stage_cycles(cd, sp1["tables"], sp1["mlp"], [0],
                                                   res, design=design)
            print(f"  decode chunk stage clock, {design} design, {where}: "
                  f"{stage_shares(cyc)} [{tag}]")
        del fd
    del cd, centres
    print(f"  frame max err vs plain {frame_err:.3e}; ticks "
          f"{[round(x, 3) for x in tick_ms]} ms")

    # a tick with the inference route and with the encode + MLP pair (the
    # route switched off), in turns: host time and the peak device memory
    # above what the tick started with
    def tick_run():
        for req in requests(TICKS):
            svc.submit(req)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        svc.tick()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3,
                (torch.cuda.max_memory_allocated() - base) / 2 ** 30)

    def through(label):   # the pair: the route switched off for the block
        return setting(inr_mod, "_inference", lambda *a: False) \
            if label == "pair" else contextlib.nullcontext()

    runs = {"route": [], "pair": []}
    for label in ("route", "pair", "pair", "route"):
        with through(label):
            runs[label].append(tick_run())
    for label, rs in runs.items():
        print(f"  tick through the {label}: "
              f"{[round(ms, 3) for ms, _ in rs]} ms (host clock), peak memory "
              f"above the tick's start {[round(g, 3) for _, g in rs]} GiB [{tag}]")

    # where a tick's time goes: one more tick under torch.profiler, through
    # the route and through the pair
    for label in ("route", "pair"):
        for req in requests(TICKS):
            svc.submit(req)
        torch.cuda.synchronize()
        with through(label):
            busy, by_kernel, wall, _ = profile_tick(svc.tick)
        if busy is None:
            print(f"  profiled tick ({label}): no device time recorded (not "
                  f"measured) [{tag}]")
            continue
        print(f"  profiled tick ({label}): {wall:.2f} ms host clock, device "
              f"busy {busy:.2f} ms, idle share {1 - busy / wall:.3f} [{tag}]")
        for name, (ms, n) in by_kernel[:12]:
            print(f"    {ms:9.3f} ms  x{n:<4d} {name[:90]}")

    # ---- the training kernels at the training shapes (phase 2's inputs)
    print(f"  training kernels at P={TP} x N={Nb} (the training step's "
          f"shapes) [{tag}]")
    from repro_torch.kernels.hash_encoding import ref as he_ref
    n_w = D_in * W + (nH - 1) * W * W + W * D_out
    n_tab = TP * L * T * F
    rows = TP * Nb
    base = (rows_td * (L * T)).repeat_interleave(Nb)
    xs = coords_t.reshape(rows, 3)

    def scatter_operands(g):   # index_add_'s operands for the cotangent g
        idx, val = [], []
        gl = g.float().reshape(rows, L, F)
        for l in range(L):
            lo, wl = he_ref._level_corners(xs, res[l])
            for dx in (0, 1):
                for dy in (0, 1):
                    for dz in (0, 1):
                        corner = lo + torch.tensor([dx, dy, dz], device=dev)
                        idx.append(he_ref.corner_indices(corner, res[l], T)
                                   + base + l * T)
                        val.append(he_ref._corner_weight(wl, dx, dy, dz)[:, None]
                                   * gl[:, l])
        return torch.cat(idx), torch.cat(val)

    flat_idx, flat_val = scatter_operands(g_feat)
    _, flat_val16 = scatter_operands(g_feat16)   # the widened bf16 cotangent
    scatter_buf = torch.zeros((n_tab // F, F), device=dev)
    # the distinct voxels this batch's trilinear corners touch (the bytes of
    # the volume the train step must read)
    pos = coords_t * TRAIN_EDGE - 0.5 + 1
    lo_v = torch.clamp(torch.floor(pos), 0, TRAIN_EDGE).long()
    nv = TRAIN_EDGE + 2
    vox = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                vox.append(((rows_td[:, None] * nv + lo_v[..., 0] + dx) * nv
                            + lo_v[..., 1] + dy) * nv + lo_v[..., 2] + dz)
    n_vox = int(torch.unique(torch.cat([v.reshape(-1) for v in vox])).numel())
    del vox, pos, lo_v

    def mlp_bwd_chain(x, ws, g):   # yardstick: autograd of bmm + relu per layer
        xs_ = x.detach().requires_grad_(True)
        ws_ = [w.detach().requires_grad_(True) for w in ws]
        h = xs_
        for w in ws_[:-1]:
            h = torch.relu(torch.bmm(h, w))
        return torch.autograd.grad(torch.bmm(h, ws_[-1]), [xs_, *ws_], g)

    pk, mk, vk = adam_state()
    pp, mp, vp = adam_state()
    pk16, mk16, vk16, wk16 = master_state()
    pp16, mp16, vp16, wp16 = master_state()
    sample_kw = dict(volumes=vols_c, seeds=tseeds, **draw)
    enc_flops = rows * L * (25 + 8 * (3 + 2 * F))
    mlp_flops = 6 * rows * n_w     # forward, deltas and dW: the MLP's products
    other_flops = enc_flops + rows * (16 * L * F + 8 * 3 + 20)
    n_par = n_tab + TP * n_w

    def plain_step(params):
        return fts_ref.train_step_grads_ref(params, H, res, *fts_ref.sample_batch(
            vols_c, tseeds, n_batch=Nb, boundary_lambda=cfg.boundary_lambda,
            sigma=cfg.boundary_sigma, ghost=1))

    # (name, kernel, plain version, library call or None, bytes, (f32
    # operations, products of bf16 operands), launches on the main path, its
    # steps, the kernel's symbol: the demangled name up to its type
    # argument); the bf16 rows' launches are the bf16 runs' (fused: train
    # step and AdamW; unfused: the backwards), each of TRAIN_STEPS steps
    b_fused, b_unfused = bf16_runs["auto"], bf16_runs["off"]
    # the deterministic route's gradients and fresh AdamW states for its rows
    with deterministic_algorithms():
        det_g, _ = fts.train_step_cuda(tparams, H, res, **sample_kw)
        det_g16, _ = fts.train_step_cuda(tparams16, H, res, **sample_kw)
    pkd, mkd, vkd = adam_state()
    ppd, mpd, vpd = adam_state()
    pkd16, mkd16, vkd16, wkd16 = master_state()
    ppd16, mpd16, vpd16, wpd16 = master_state()
    groups = det_g.partials.shape[1]
    part_floats = TP * groups * (n_w + 1)
    det_launch = {p: det_runs[p]["launches"] for p in ("f32", "bf16")}
    sym = lambda tp, det: f"train_step_kernel<{tp}, {W}, {F}, true, {det}>"
    tspecs = [
        ("hash_encode_bwd",
         lambda: hash_encode_bwd_cuda(g_feat, coords_t, res, rows_t, (TP, L, T, F)),
         lambda: hash_encode_batched_bwd_ref(g_feat, coords_t, res, rows_td,
                                             (TP, L, T, F)),
         lambda: scatter_buf.index_add_(0, flat_idx, flat_val),
         rows * (12 + L * F * 4) + n_tab * 4, (enc_flops, 0),
         unfused_launches["hash_encode_bwd"], COMPARE_STEPS,
         "hash_encode_bwd_kernel<float,"),
        ("fused_mlp_bwd", lambda: fused_mlp_bwd_cuda(feats_t, ws_t, g_out, rows_t),
         lambda: fused_mlp_batched_bwd_ref(feats_t, ws_t, g_out, rows_td),
         lambda: mlp_bwd_chain(feats_t, ws_t, g_out),
         rows * (2 * D_in + D_out) * 4 + 2 * TP * n_w * 4, (mlp_flops, 0),
         unfused_launches["fused_mlp_bwd"], COMPARE_STEPS,
         "fused_mlp_bwd_kernel<float,"),
        # bound: float work only; the ~300 integer operations of each
        # sample's Threefry draws are not counted
        ("train_step", lambda: fts.train_step_cuda(tparams, H, res, **sample_kw),
         lambda: plain_step(tparams), None,
         2 * n_par * 4 + n_vox * 4 + TP * 4, (other_flops + mlp_flops, 0),
         train_launches["train_step"], TRAIN_STEPS, sym("float", "false")),
        ("adamw_apply",
         lambda: fts.adamw_apply_cuda(pk, mk, vk, got_g, sched, got_loss,
                                      n_valid=Nb, **adam_kw),
         lambda: fts_ref.adamw_apply_ref(pp, mp, vp, None, got_g, sched, **adam_kw),
         None, n_par * 7 * 4 + TP * 4 * 4, (n_par * 15, 0),
         train_launches["adamw_apply"], TRAIN_STEPS, "adamw_kernel<false, false>"),
        # the deterministic route: the same function (the same bound); AdamW
        # also reads the group rows and the int64 table gradient and sums
        # the rows
        ("train_step_det",
         under_det(lambda: fts.train_step_cuda(tparams, H, res, **sample_kw)),
         lambda: plain_step(tparams), None,
         2 * n_par * 4 + n_vox * 4 + TP * 4, (other_flops + mlp_flops, 0),
         det_launch["f32"]["train_step"], TRAIN_STEPS,
         [(sym("float", "true"), 1), ("hash_encode_bwd_fx_kernel<", L)]),
        ("adamw_det",
         under_det(lambda: fts.adamw_apply_cuda(pkd, mkd, vkd, det_g, sched, None,
                                                n_valid=Nb, **adam_kw)),
         lambda: fts_ref.adamw_apply_ref(
             ppd, mpd, vpd, None, fts.det_grads_to_float(det_g, tparams, H)[0],
             sched, **adam_kw),
         None, n_par * 6 * 4 + n_tab * 8 + part_floats * 4 + TP * 4 * 4,
         (n_par * 15 + part_floats, 0),
         det_launch["f32"]["adamw_apply"], TRAIN_STEPS, "adamw_kernel<false, true>"),
        # the bf16 policy's kernels: bf16 operands read, float32 gradients
        # written; the MLP's products take bf16 operands and sum in float32,
        # which the card runs at its bf16 peak, the rest is float32 work
        ("hash_encode_bwd_bf16",
         lambda: hash_encode_bwd_cuda(g_feat16, coords_t, res, rows_t, (TP, L, T, F)),
         lambda: hash_encode_batched_bwd_ref(g_feat16, coords_t, res, rows_td,
                                             (TP, L, T, F)),
         lambda: scatter_buf.index_add_(0, flat_idx, flat_val16),
         rows * (12 + L * F * 2) + n_tab * 4, (enc_flops, 0),
         b_unfused["hash_encode_bwd"], TRAIN_STEPS,
         "hash_encode_bwd_kernel<__nv_bfloat16,"),
        ("fused_mlp_bwd_bf16",
         lambda: fused_mlp_bwd_cuda(feats16, ws16, g_out16, rows_t),
         lambda: fused_mlp_batched_bwd_ref(feats16, ws16, g_out16, rows_td),
         lambda: mlp_bwd_chain(feats16, ws16, g_out16),
         rows * (2 * D_in + D_out) * 2 + TP * n_w * (2 + 4), (0, mlp_flops),
         b_unfused["fused_mlp_bwd"], TRAIN_STEPS,
         "fused_mlp_bwd_kernel<__nv_bfloat16,"),
        ("train_step_bf16",
         lambda: fts.train_step_cuda(tparams16, H, res, **sample_kw),
         lambda: plain_step(tparams16), None,
         n_par * (2 + 4) + n_vox * 4 + TP * 4, (other_flops, mlp_flops),
         b_fused["train_step"], TRAIN_STEPS, sym("__nv_bfloat16", "false")),
        ("adamw_apply_master",
         lambda: fts.adamw_apply_cuda(pk16, mk16, vk16, got_g16, sched, got_loss16,
                                      n_valid=Nb, flat_mw=wk16, **adam_kw),
         lambda: fts_ref.adamw_apply_ref(pp16, mp16, vp16, wp16, got_g16, sched,
                                         **adam_kw),
         None, n_par * (4 * 4 + 3 * 4 + 2) + TP * 4 * 4, (n_par * 15, 0),
         b_fused["adamw_apply"], TRAIN_STEPS, "adamw_kernel<true, false>"),
        ("train_step_det_bf16",
         under_det(lambda: fts.train_step_cuda(tparams16, H, res, **sample_kw)),
         lambda: plain_step(tparams16), None,
         n_par * (2 + 4) + n_vox * 4 + TP * 4, (other_flops, mlp_flops),
         det_launch["bf16"]["train_step"], TRAIN_STEPS,
         [(sym("__nv_bfloat16", "true"), 1), ("hash_encode_bwd_fx_kernel<", L)]),
        ("adamw_det_master",
         under_det(lambda: fts.adamw_apply_cuda(pkd16, mkd16, vkd16, det_g16, sched,
                                                None, n_valid=Nb, flat_mw=wkd16,
                                                **adam_kw)),
         lambda: fts_ref.adamw_apply_ref(
             ppd16, mpd16, vpd16, wpd16,
             fts.det_grads_to_float(det_g16, tparams16, H)[0], sched, **adam_kw),
         None, n_par * (3 * 4 + 3 * 4 + 2) + n_tab * 8 + part_floats * 4 + TP * 4 * 4,
         (n_par * 15 + part_floats, 0),
         det_launch["bf16"]["adamw_apply"], TRAIN_STEPS, "adamw_kernel<true, true>"),
    ]
    # the kernels' own device time per launch (the CUDA-event times above
    # span back-to-back wrapper calls, host work included)
    det_alone = {}
    _, dev_ms, _, _ = profile_tick(lambda: [k() for _, k, *_ in tspecs for _ in range(5)])
    for name, kern, plain_fn, lib_fn, nbytes, (flops, bf16_flops), launches, \
            steps, symbol in tspecs:
        ms = cuda_ms(kern, reps=10)
        pms = cuda_ms(plain_fn, reps=3)
        lms = cuda_ms(lib_fn, reps=5) if lib_fn is not None else None
        bms, by = bound_ms(nbytes, flops, bf16_flops=bf16_flops)
        # times are per wrapper call (5 in the profile), summed over the
        # kernels that carry the symbol: the hash backward launches once per
        # level, and its counter counts those launches (L per call). The
        # deterministic route's split (a list of (symbol, launches a call):
        # the step and its scatter, whose float32 scatter both policies
        # launch) is profiled alone
        if isinstance(symbol, list):
            alone_ms = kernels_alone_ms(kern, symbol)
            kdev = [] if alone_ms is None else [alone_ms]
            det_alone[name] = alone_ms
        else:
            kt = [t for key, (t, _) in dev_ms if symbol in key]
            kdev = [sum(kt) / 5] if kt else []
        print(f"  {name:<20s} {ms:9.3f} ms  bound {bms:8.3f} ms ({by})  "
              f"plain {pms:9.3f} ms  library "
              f"{'-' if lms is None else f'{lms:.3f} ms'}  "
              f"launches/step {launches / steps:.0f}  kernel alone "
              f"{f'{kdev[0]:.4f} ms' if kdev else 'not measured'} per call "
              f"(profiler) [{tag}]")
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": launches,
                        "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
                        "bound_ms": bms, "bound_by": by, "library_ms": lms})
    # the unfused backwards' deterministic routes (phase 5's runs under the
    # switch), each computing its default row's function (the same bound),
    # its time beside that row's; profiled a row at a time: the MLP route
    # launches the default route's kernel (on another grid), then its sum
    default_ms = {r["name"]: r["ms"] for r in kernels}
    ud = {p: udet_runs[p]["launches"] for p in ("f32", "bf16")}
    dspecs = [
        ("hash_encode_bwd_det",
         under_det(lambda: hash_encode_bwd_cuda(g_feat, coords_t, res, rows_t,
                                                (TP, L, T, F))),
         lambda: hash_encode_batched_bwd_ref(g_feat, coords_t, res, rows_td,
                                             (TP, L, T, F)),
         lambda: scatter_buf.index_add_(0, flat_idx, flat_val),
         rows * (12 + L * F * 4) + n_tab * 4, (enc_flops, 0),
         ud["f32"]["hash_encode_bwd"], DET_UNFUSED_STEPS,
         [("hash_encode_bwd_fx_kernel<float,", L), ("fx_to_float_kernel", 1)],
         "hash_encode_bwd"),
        ("hash_encode_bwd_det_bf16",
         under_det(lambda: hash_encode_bwd_cuda(g_feat16, coords_t, res, rows_t,
                                                (TP, L, T, F))),
         lambda: hash_encode_batched_bwd_ref(g_feat16, coords_t, res, rows_td,
                                             (TP, L, T, F)),
         lambda: scatter_buf.index_add_(0, flat_idx, flat_val16),
         rows * (12 + L * F * 2) + n_tab * 4, (enc_flops, 0),
         ud["bf16"]["hash_encode_bwd"], DET_UNFUSED_STEPS,
         [("hash_encode_bwd_fx_kernel<__nv_bfloat16,", L), ("fx_to_float_kernel", 1)],
         "hash_encode_bwd_bf16"),
        ("fused_mlp_bwd_det",
         under_det(lambda: fused_mlp_bwd_cuda(feats_t, ws_t, g_out, rows_t)),
         lambda: fused_mlp_batched_bwd_ref(feats_t, ws_t, g_out, rows_td),
         lambda: mlp_bwd_chain(feats_t, ws_t, g_out),
         rows * (2 * D_in + D_out) * 4 + 2 * TP * n_w * 4, (mlp_flops, 0),
         ud["f32"]["fused_mlp_bwd"], DET_UNFUSED_STEPS,
         [("fused_mlp_bwd_kernel<float,", 1), ("mlp_dw_reduce_kernel", 1)],
         "fused_mlp_bwd"),
        ("fused_mlp_bwd_det_bf16",
         under_det(lambda: fused_mlp_bwd_cuda(feats16, ws16, g_out16, rows_t)),
         lambda: fused_mlp_batched_bwd_ref(feats16, ws16, g_out16, rows_td),
         lambda: mlp_bwd_chain(feats16, ws16, g_out16),
         rows * (2 * D_in + D_out) * 2 + TP * n_w * (2 + 4), (0, mlp_flops),
         ud["bf16"]["fused_mlp_bwd"], DET_UNFUSED_STEPS,
         [("fused_mlp_bwd_kernel<__nv_bfloat16,", 1), ("mlp_dw_reduce_kernel", 1)],
         "fused_mlp_bwd_bf16"),
    ]
    for name, kern, plain_fn, lib_fn, nbytes, (flops, bf16_flops), launches, \
            steps, symbols, default in dspecs:
        ms = cuda_ms(kern, reps=10)
        pms = cuda_ms(plain_fn, reps=3)
        lms = cuda_ms(lib_fn, reps=5)
        bms, by = bound_ms(nbytes, flops, bf16_flops=bf16_flops)
        kdev = kernels_alone_ms(kern, symbols)
        row = {"name": name, "route": "cuda", "source": SOURCES[name],
               "replaces": REPLACES[name], "launches": launches,
               "max_abs_err": errs[name], "ms": ms, "plain_ms": pms,
               "bound_ms": bms, "bound_by": by, "library_ms": lms}
        lib_note = f"library {lms:.3f} ms"
        if name.startswith("hash_encode_bwd_det"):
            # the deterministic route computes a deterministic sum: the
            # library call that computes the same function is index_add_
            # under the same switch (outside it, an unordered atomic sum)
            try:
                det_lms = cuda_ms(under_det(lib_fn), reps=5)
                det_note = f"{det_lms:.3f} ms"
            except RuntimeError as e:       # PyTorch has no deterministic one
                det_lms, det_note = None, f"none ({str(e).splitlines()[0][:80]})"
            row.update(library_ms=det_lms, library_ms_unordered=lms)
            lib_note = (f"library index_add_ {det_note} deterministic (the same "
                        f"function), {lms:.3f} ms unordered")
        print(f"  {name:<24s} {ms:9.3f} ms (default route {default_ms[default]:.3f})  "
              f"bound {bms:8.3f} ms ({by})  plain {pms:9.3f} ms  {lib_note}  "
              f"launches/step {launches / steps:.0f}  kernel alone "
              f"{'not measured' if kdev is None else f'{kdev:.4f} ms'} per call "
              f"(profiler) [{tag}]")
        if name.startswith("hash_encode_bwd_det"):
            # the scatter layer beside its yardstick (the design before the
            # clusters), through the same measurement entry
            gg = g_feat16 if name.endswith("bf16") else g_feat
            tp = "__nv_bfloat16" if name.endswith("bf16") else "float"
            fx_call = lambda design: (lambda: hops.hash_encode_bwd_fx_with(
                gg, coords_t, res, rows_t, (TP, L, T, F), design=design))
            det_design_turns(
                f"{name} (levels {hops.fx_letters(hops.fx_plan(res, T, F))})",
                fx_call("cluster"), fx_call("block"),
                [(f"hash_encode_bwd_fx_kernel<{tp},", L), ("fx_to_float_kernel", 1)],
                [(f"hash_encode_bwd_fx_block_kernel<{tp},", L),
                 ("fx_to_float_kernel", 1)], tag)
            if tp == "float":
                fx_level_times(tag, g_feat, coords_t, res, rows_t, (TP, L, T, F))
        kernels.append(row)
    # where the MLP backward's time goes, at the main path's shapes: its
    # clocked instantiation's cycles by stage (each a share of the warps'
    # summed cycles, and per warp per 16-row pass), its kernel time beside
    # the unclocked kernel's
    passes = TP * -(-Nb // 32) * 2
    for label, args, symbol in (
            ("float32", (feats_t, ws_t, g_out), "fused_mlp_bwd_kernel<float,"),
            ("bf16", (feats16, ws16, g_out16), "fused_mlp_bwd_kernel<__nv_bfloat16,")):
        staged = lambda: fused_mlp_bwd_stage_cycles(*args, rows_t)
        *cyc, ns = staged()
        clocked = launch_times(staged, "StageClock")
        unclocked = launch_times(lambda: fused_mlp_bwd_cuda(*args, rows_t), symbol)
        total = max(1, sum(cyc))
        print(f"  fused_mlp_bwd {label} by stage (cycles, a clock on each warp): "
              + ", ".join(f"{s} {c / total:.3f} ({c / passes:.0f} a pass)"
                          for s, c in zip(BWD_STAGES, cyc))
              + f"; {passes:,} passes; the warps' cycles over their lifetimes "
              f"{total / max(1, ns):.3f} GHz, lifetimes {ns / 1e6:.3f} warp-ms; "
              f"kernel clocked "
              f"{'not measured' if clocked is None else f'{clocked[0]:.4f} ms'}, "
              f"unclocked {'not measured' if unclocked is None else f'{unclocked[0]:.4f} ms'}"
              f" (profiler) [{tag}]")
    # the host-sampled variant (fused_train_step, fuse_sampling="off"): the
    # same kernel reading coordinates and targets instead of drawing them
    host_kw = dict(coords=coords_t, target=target_t)
    ms = cuda_ms(lambda: fts.train_step_cuda(tparams, H, res, **host_kw), reps=10)
    pms = cuda_ms(lambda: fts_ref.train_step_grads_ref(tparams, H, res, coords_t,
                                                       target_t), reps=3)
    _, dev_host, _, _ = profile_tick(
        lambda: [fts.train_step_cuda(tparams, H, res, **host_kw) for _ in range(5)])
    kdev = [t / n for key, (t, n) in dev_host if "train_step_kernel<float," in key]
    bms, by = bound_ms(2 * (n_tab + TP * n_w) * 4 + rows * (3 + D_out) * 4 + TP * 4,
                       enc_flops + rows * (6 * n_w + 16 * L * F + 20))
    print(f"  train_step (host-sampled batch) {ms:.3f} ms  bound {bms:.3f} ms "
          f"({by})  plain {pms:.3f} ms  kernel alone "
          f"{f'{kdev[0]:.4f} ms' if kdev else 'not measured'} (profiler); "
          f"not on the default path [{tag}]")
    host_det = under_det(lambda: fts.train_step_cuda(tparams, H, res, **host_kw))
    det_syms = lambda tp, smp: [(f"train_step_kernel<{tp}, {W}, {F}, {smp}, true>", 1),
                                ("hash_encode_bwd_fx_kernel<", L)]
    ms_hd = cuda_ms(host_det, reps=10)
    per_hd = kernels_alone_ms(host_det, det_syms("float", "false"))
    print(f"  train_step (host-sampled batch), deterministic route {ms_hd:.3f} ms  "
          f"bound {bms:.3f} ms ({by})  kernels alone (the step and its scatter) "
          f"{'not measured' if per_hd is None else f'{per_hd:.4f} ms'} "
          f"(profiler) [{tag}]")
    # rows 5-d, 6-d and 6-b-d beside the route's fused yardstick (the design
    # before the split), and the yardstick's stage clock
    for label, pr, tp, kw, smp, row in (
            ("5-d train_step host-sampled f32", tparams, "float", host_kw, "false", None),
            ("6-d train_step_det f32", tparams, "float", sample_kw, "true",
             "train_step_det"),
            ("6-b-d train_step_det_bf16", tparams16, "__nv_bfloat16", sample_kw, "true",
             "train_step_det_bf16")):
        det_design_turns(
            f"{label}, deterministic route (split: the step + the scatter "
            f"{hops.fx_letters(hops.fx_plan(res, T, F))})",
            lambda: fts.train_step_det_with(pr, H, res, design="split", **kw),
            lambda: fts.train_step_det_with(pr, H, res, design="fused", **kw),
            det_syms(tp, smp), [(f"train_step_det_fused_kernel<{tp}, {smp}", 1)], tag,
            new_alone=per_hd if row is None else det_alone.get(row))
    det_step_clock(tag, tparams, H, res, **sample_kw)
    # the backward's levels one by one (one launch each) on the staging plan,
    # and with every level sent the direct route (a budget of 0 bytes)
    bwd_call = lambda: hash_encode_bwd_cuda(g_feat, coords_t, res, rows_t,
                                            (TP, L, T, F))
    for label, b in (("staged (the plan)", hops.STAGE_BUDGET_BYTES), ("all direct", 0)):
        with setting(hops, "STAGE_BUDGET_BYTES", b):
            per = launch_times(bwd_call, "hash_encode_bwd_kernel<float,")
        print(f"  hash_encode_bwd per level, {label}: "
              f"{'not measured' if per is None else [round(x, 4) for x in per]}"
              f"{'' if per is None else f' ms, sum {sum(per):.4f} ms'} (profiler) [{tag}]")
    plan = hops.bwd_plan(res, T, F)
    ppb = (ctypes.c_int * L)()
    res_h, plan_h = hops.levels_arg(res), (ctypes.c_int * L)(*plan)
    build.library().repro_hash_encode_bwd_points_per_block(
        ctypes.addressof(res_h), ctypes.addressof(plan_h), L, T, ctypes.addressof(ppb))
    req = scatter_requests(coords_t, res, T, F, plan,
                           [torch.arange(Nb, device=dev) // n for n in ppb])
    print(f"  hash_encode_bwd atomic requests per call: "
          f"{req['direct'] + req['flush_rows']:,} global (16-byte rows), "
          f"{req['shared']:,} shared (row compare-and-swap loops); the kernel "
          f"before this design: {req['before']:,} scalar global [{tag}]")

    # the train step's launch shape and its scatter's requests (every level
    # straight to device memory: staged slabs measured slower, PERF.md)
    shape = (ctypes.c_longlong * 4)()
    for det in (0, 1):
        build.check(build.library().repro_train_step_shape(
            TP, Nb, L, F, W, H, D_out, det, ctypes.addressof(shape)),
            "repro_train_step_shape")
        tile, gx, smem, n_groups = list(shape)
        print(f"  train_step{', deterministic route' if det else ''}: "
              + ("levels all direct" if not det else "split: the cotangent (and "
                 "coordinates) to scratch, then the scatter, levels "
                 + hops.fx_letters(hops.fx_plan(res, T, F)))
              + f"; {tile} threads x {gx} blocks per partition, {smem} B "
              f"shared memory per block"
              + (f", {n_groups} groups of 4 tiles a partition" if det else ""))
    req = scatter_requests(coords_t, res, T, F, [False] * L, [None] * L)
    rows_added = req["direct"] // (2 if F == 8 else 1)
    print(f"  train_step scatter requests per step: {req['direct']:,} global "
          f"16-byte adds, no shared updates; the deterministic route's fused "
          f"yardstick: {rows_added * F:,} global 8-byte integer adds ({F} a row) "
          f"and {part_floats:,} group-row floats stored; the kernel before this "
          f"design: {req['before']:,} scalar global atomics [{tag}]")
    step_call = lambda: fts.train_step_cuda(tparams, H, res, **sample_kw)
    # the yardstick split: the kernel writes the feature cotangent (its
    # scatter replaced by a 42 MB store), the level-major backward scatters it
    cot = torch.empty((TP, Nb, L * F), device=dev)
    cot_call = lambda: fts.train_step_cuda(tparams, H, res, cotangent_out=cot,
                                           **sample_kw)

    def split_call():
        cot_call()
        return hash_encode_bwd_cuda(cot, coords_t, res, rows_t, (TP, L, T, F))

    ms_fused = cuda_ms(step_call, reps=20)
    per_fused = launch_times(step_call, sym("float", "false"))
    ms_split = cuda_ms(split_call, reps=20)
    ms_cot = cuda_ms(cot_call, reps=20)
    per_cot = launch_times(cot_call, sym("float", "false"))
    alone = lambda per: "not measured" if per is None else f"{per[0]:.4f} ms"
    print(f"  train_step fused {ms_fused:.4f} ms, alone {alone(per_fused)}; the "
          f"split (kernel writing the feature cotangent + hash_encode_bwd) "
          f"{ms_split:.4f} ms; the kernel "
          f"without its scatter (writing the cotangent) {ms_cot:.4f} ms, alone "
          f"{alone(per_cot)} (events; profiler) [{tag}]")
    # the deterministic route beside the default one, in turns (default,
    # route, route, default), f32 and bf16: the kernel alone and the step
    # (train step + AdamW, events)
    for tp, params_ in (("float", tparams), ("__nv_bfloat16", tparams16)):
        call = lambda: fts.train_step_cuda(params_, H, res, **sample_kw)
        runs = [kernel_alone_ms(call, sym(tp, "false")),
                kernels_alone_ms(under_det(call), det_syms(tp, "true")),
                kernels_alone_ms(under_det(call), det_syms(tp, "true")),
                kernel_alone_ms(call, sym(tp, "false"))]
        if all(r is not None for r in runs):
            d = (runs[0] + runs[3]) / 2
            r = (runs[1] + runs[2]) / 2
            print(f"  train_step {tp}: default route alone {runs[0]:.4f} / "
                  f"{runs[3]:.4f} ms, deterministic route {runs[1]:.4f} / "
                  f"{runs[2]:.4f} ms: the route costs {100 * (r - d) / d:.1f}% "
                  f"of the kernel's time (profiler, in turns) [{tag}]")
        else:
            print(f"  train_step {tp}: the route's kernel time not measured "
                  f"(the profiler matched no launch) [{tag}]")
    del cot
    # AdamW with the L2 flushed before each launch, as a step finds its
    # 36.8 MB of state after the train step's kernel
    flush = torch.empty(64 << 20, device=dev)   # 256 MB, 5x the L2
    pk, mk, vk = adam_state()
    cold = lambda: fts.adamw_apply_cuda(pk, mk, vk, got_g, sched, got_loss,
                                        n_valid=Nb, **adam_kw)
    pk16, mk16, vk16, wk16 = master_state()
    cold16 = lambda: fts.adamw_apply_cuda(pk16, mk16, vk16, got_g16, sched,
                                          got_loss16, n_valid=Nb, flat_mw=wk16,
                                          **adam_kw)
    cold_det = under_det(lambda: fts.adamw_apply_cuda(
        pkd, mkd, vkd, det_g, sched, None, n_valid=Nb, **adam_kw))
    cold_det16 = under_det(lambda: fts.adamw_apply_cuda(
        pkd16, mkd16, vkd16, det_g16, sched, None, n_valid=Nb, flat_mw=wkd16,
        **adam_kw))
    for label, fn, symbol in (("adamw_apply", cold, "adamw_kernel<false, false>"),
                              ("adamw_apply_master", cold16, "adamw_kernel<true, false>"),
                              ("adamw_det", cold_det, "adamw_kernel<false, true>"),
                              ("adamw_det_master", cold_det16,
                               "adamw_kernel<true, true>")):
        _, dev_cold, _, _ = profile_tick(lambda: [(flush.zero_(), fn()) for _ in range(5)])
        kc = [t / n for key, (t, n) in dev_cold if symbol in key]
        print(f"  {label} with the L2 flushed before each launch: kernel alone "
              f"{f'{kc[0]:.4f} ms' if kc else 'not measured'} (profiler) [{tag}]")
    del flush, det_g, det_g16
    print(f"  train step bytes: {n_vox} distinct volume voxels read, tables "
          f"and MLP {TP * (L * T * F + n_w) * 4} B read and their gradients "
          f"written [{tag}]")
    del flat_idx, flat_val, flat_val16, scatter_buf

    # where a training chunk's time goes: PROFILE_STEPS more steps
    trainer, tstate = tinfo["trainer"], tinfo["state"]
    torch.cuda.synchronize()
    busy, by_kernel, wall, _ = profile_tick(
        lambda: trainer.train_chunk(tstate, vols, PROFILE_STEPS, key=1))
    if busy is None:
        print(f"  profiled chunk: no device time recorded (not measured) [{tag}]")
    else:
        print(f"  profiled {PROFILE_STEPS}-step chunk: {wall:.2f} ms host clock, "
              f"device busy {busy:.2f} ms, idle share {1 - busy / wall:.3f} "
              f"[{tag}]")
        for name, (ms, n) in by_kernel[:8]:
            print(f"    {ms:9.3f} ms  x{n:<4d} {name[:90]}")
        # the profiler slows the host's side of every launch: the same chunk
        # unprofiled, against the device time the profile measured
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_chunk(tstate, vols, PROFILE_STEPS, key=2)
        torch.cuda.synchronize()
        wall_np = (time.perf_counter() - t0) * 1e3
        print(f"  the same chunk unprofiled: {wall_np:.2f} ms host clock, "
              f"idle share {max(0.0, 1 - busy / wall_np):.3f} against the "
              f"profiled device time [{tag}]")

    # where an unfused step's time goes (fuse_train_step="off": the encode
    # and MLP kernels forward and backward, the glue between them): a
    # PROFILE_STEPS chunk under each policy, after a warm-up run
    for policy in ("f32", "bf16"):
        kw = {} if policy == "f32" else {"precision": "bf16"}
        _, winfo = api.train(tparts, cfg, backend="cuda", steps=COMPARE_STEPS, key=1,
                             log_every=1, fuse_train_step="off", **kw)
        wtrainer, wstate = winfo["trainer"], winfo["state"]
        torch.cuda.synchronize()
        busy, by_kernel, wall, host = profile_tick(
            lambda: wtrainer.train_chunk(wstate, vols, PROFILE_STEPS, key=4))
        label, steps = f"unfused {policy} {PROFILE_STEPS}-step chunk", PROFILE_STEPS
        if busy is None:
            print(f"  profiled {label}: no device time recorded (not measured) [{tag}]")
        else:
            print(f"  profiled {label}: {wall:.2f} ms host clock ({wall / steps:.3f} "
                  f"a step), device busy {busy:.2f} ms ({busy / steps:.3f} a step), "
                  f"idle share {1 - busy / wall:.3f}; host ops' own CPU time "
                  f"{sum(ms for _, (ms, _) in host):.2f} ms [{tag}]")
            for name, (ms, n) in by_kernel[:8]:
                print(f"    device {ms:9.3f} ms  x{n:<5d} {name[:90]}")
            for name, (ms, n) in host[:12]:
                print(f"    host   {ms:9.3f} ms  x{n:<5d} {name[:90]}")
        del winfo, wtrainer, wstate
    return tag, kernels, flash_err, errs


def velocity_step_checks(dev, tseeds, cfg) -> float:
    """Phase 2: the train step at the velocity models' D_out = 3 (the
    pathline study's models, phase 8): 8 partitions x 65,536 samples of
    3-component velocity volumes of TRAIN_EDGE^3, f32, host-sampled and
    drawing in the kernel, each held by ``check_step`` (the tie-aware
    yardstick of the f32 checks). Returns the largest departure."""
    import torch
    from repro_torch.core.sampling import n_boundary
    from repro_torch.data.volume import make_partition
    from repro_torch.kernels.fused_train_step import ref as fts_ref

    vcfg = cfg.replace(out_dim=3)
    res, H, P, Nb = vcfg.level_resolutions(), vcfg.n_hidden_layers, 8, vcfg.batch_size
    vols = torch.stack([make_partition("velocity", p, (2, 2, 2), (TRAIN_EDGE,) * 3,
                                       t=0.45, device=dev).normalized()
                        for p in range(P)])
    draw = dict(n_batch=Nb, n_uniform=Nb - n_boundary(Nb, vcfg.boundary_lambda),
                sigma=vcfg.boundary_sigma, ghost=1)
    coords, target = fts_ref.sample_batch(
        vols, tseeds[:P], n_batch=Nb, boundary_lambda=vcfg.boundary_lambda,
        sigma=vcfg.boundary_sigma, ghost=1)
    params = step_params(vcfg, P, dev, seed=200)
    wants = step_wants(params, H, res, coords, target)
    err = max(check_step("velocity D_out=3, host-sampled", params, H, res, wants,
                         coords=coords, target=target),
              check_step("velocity D_out=3, in-kernel sampling", params, H, res,
                         wants, volumes=vols, seeds=tseeds[:P], **draw))
    del vols, coords, target, params, wants
    torch.cuda.synchronize()
    return err


# --------------------------------------------------------------------------- #
# phase 8: the in situ runtime
# --------------------------------------------------------------------------- #
def sync(dev) -> None:
    """Wait for the card (a no-op for a CPU device)."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timed_calls(owner, name, dev, log: list):
    """``owner.name`` replaced for the block by a version that records the
    host clock of each call, the card synchronised before and after, in
    ``log``."""
    fn = getattr(owner, name)

    def timed(*a, **k):
        sync(dev)
        t0 = time.perf_counter()
        out = fn(*a, **k)
        sync(dev)
        log.append(time.perf_counter() - t0)
        return out

    with setting(owner, name, timed):
        yield


def insitu_plan():
    """JAX's acceptance plan (tests/test_resilience.py), seed 11, on
    INSITU_CYCLES cycles, and the health() its rules give."""
    from repro_torch.resilience import FaultPlan, FaultSpec
    plan = FaultPlan(11, [
        FaultSpec("nan_field", cycle=2, partition=1, magnitude=1.0),
        FaultSpec("drop_partition", cycle=3, partition=0),
        FaultSpec("corrupt_blob", cycle=4, partition=0, magnitude=0.02),
        FaultSpec("slow_tick", cycle=6, latency_s=9.0),
        FaultSpec("kernel_exception", cycle=7),
    ])
    # the NaN partition: one retry (max_retries=1), then frozen; the dropped
    # rank: masked out; the slow tick: the deadline spent before training;
    # the kernel fault: the previous DVNR reused
    expect = {"cycles": INSITU_CYCLES, "trained": INSITU_CYCLES - 2,
              "retries": 1, "retry_cycles": (2,), "degraded": {2: (1,), 3: (0,)},
              "deadline_missed": (6,), "fallbacks": (6, 7), "blob_repairs": 1,
              "blob_repair_cycles": (4,)}
    return plan, expect


def run_session(cfg, dev, wrappers, per_tick: bool):
    """Phase 8(a)'s session: 8 ranks x INSITU_EDGE^3 of CloverLeaf under
    ``insitu_plan``, the window of compressed models, recovery, the
    injected deadline clock, and the shock trigger (a device reduction of
    the published field) whose actions render the current step, extract its
    isosurface and render every model in the window. ``per_tick`` runs it a
    cycle at a time and reads the launch counters and the host clock of
    each part of a tick; else one ``run(INSITU_CYCLES)``. Returns (session,
    the per-tick rows, the actions' outputs, the counters' totals)."""
    import torch
    from repro_torch import api
    from repro_torch.core import isosurface as iso_mod
    from repro_torch.core.trainer import DVNRTrainer
    from repro_torch.insitu import InSituSession, SimulationConfig, render_action
    from repro_torch.resilience import RecoveryPolicy

    plan, _ = insitu_plan()
    sess = InSituSession(
        SimulationConfig("cloverleaf", n_ranks=8, local_shape=(INSITU_EDGE,) * 3,
                         dt=0.03),
        cfg, window=INSITU_WINDOW, compress=True, cache_mode="dvnr",
        impl=INSITU_IMPL, device=dev, fault_plan=plan,
        recovery=RecoveryPolicy(max_retries=1), deadline_s=1.0,
        deadline_clock="injected")
    fracs, out = [], {}

    def shock(parts):   # the shell's share of the voxels, on the device
        present = [p.data for p in parts if p is not None]
        frac = float(torch.stack([(d > SHOCK_LEVEL).float().mean()
                                  for d in present]).mean())
        fracs.append(frac)
        return frac > SHOCK_FRAC

    def on_fire(tick):
        sync(dev)
        t0 = time.perf_counter()
        out["tick"] = tick
        out["value"] = sess.dvnr.value()
        out["frames"] = [sess.render_now(width=IMAGE, height=IMAGE,
                                         n_samples=SAMPLES, impl=INSITU_IMPL)]
        n0 = wrappers["inr_forward"].launches
        sync(dev)
        t1 = time.perf_counter()
        march = []
        with timed_calls(iso_mod, "marching_tets", dev, march):
            out["points"] = sess.isosurface_now(resolution=ISO_RES,
                                                impl=INSITU_IMPL)
        sync(dev)
        out["iso_s"] = time.perf_counter() - t1
        out["march_s"] = sum(march)
        out["iso_launches"] = wrappers["inr_forward"].launches - n0
        out["history"] = sess.window.values()
        out["frames"] += [render_action(v, width=IMAGE, height=IMAGE,
                                        n_samples=SAMPLES, impl=INSITU_IMPL)
                          for v in out["history"]]
        sync(dev)
        out["actions_s"] = time.perf_counter() - t0

    sess.add_trigger("shock", shock, [on_fire])
    for w in wrappers.values():
        w.launches = 0
    rows = []
    if not per_tick:
        sess.run(INSITU_CYCLES)
        sync(dev)
        return sess, rows, out, fracs, {n: w.launches for n, w in wrappers.items()}
    publish, chunks, compress = [], [], []
    totals = dict.fromkeys(wrappers, 0)
    with timed_calls(DVNRTrainer, "train_chunk", dev, chunks), \
            timed_calls(api.DVNRModel, "compress", dev, compress), \
            timed_calls(sess.sim, "publish", dev, publish):
        for _ in range(INSITU_CYCLES):
            for w in wrappers.values():
                w.launches = 0
            del publish[:], chunks[:], compress[:]
            sess.run(1)
            sync(dev)
            rec = sess.records[-1]
            launches = {n: w.launches for n, w in wrappers.items()}
            for n, c in launches.items():
                totals[n] += c
            value = sess.dvnr._cache
            rows.append({"cycle": rec.cycle, "step_s": rec.step_time_s,
                         "publish_s": sum(publish),
                         "train_s": value.train_time_s if rec.dvnr_trained else 0.0,
                         "retry_s": sum(chunks[1:]), "compress_s": sum(compress),
                         "actions_s": (out["actions_s"] if out.get("tick") ==
                                       sess.rt.tick else 0.0),
                         "launches": launches, "cache_bytes": rec.cache_bytes,
                         "raw_equiv_bytes": rec.raw_equiv_bytes,
                         "trained": rec.dvnr_trained, "fallback": rec.fallback})
    return sess, rows, out, fracs, totals


def check_isosurface(cfg, value, pts, dev, tag) -> None:
    """Phase 8(a): the trigger's isosurface against the plain path's on the
    card. Per partition the vertex grids agree within the inference
    kernel's f32 limit (phase 2's 2e-6 x max(1, |value|)); a vertex may sit
    on the other side of the iso value than in the plain grid only where its
    plain value lies within that limit of the iso value (a tie), and the
    triangles may differ only in the cells that touch a tie. Then the point
    clouds: their counts differ by at most 36 points a tie cell, and their
    Chamfer distance stays under a tenth of a cell's edge."""
    import torch
    from repro_torch import api
    from repro_torch.core import isosurface as iso_mod

    model = value.model
    gmin, gmax = model.grange
    R = ISO_RES
    n_ties = n_flips = n_tie_cells = n_diff = crossed = 0
    edge = float("inf")
    for p in range(model.n_partitions):
        meta = model.parts_meta[p]
        iso_local = (gmin + 0.5 * (gmax - gmin) - meta.vmin) / max(
            meta.vmax - meta.vmin, 1e-12)
        if not (0.0 <= iso_local <= 1.0):
            continue
        crossed += 1
        edge = min(edge, min(meta.extent) / (R - 1))
        params = model.partition(p).params
        gk = iso_mod.inr_vertex_grid(model.cfg, params, (R,) * 3, "cuda")
        gp = iso_mod.inr_vertex_grid(model.cfg, params, (R,) * 3, "ref")
        tol = 2e-6 * max(1.0, float(gp.abs().max()))
        check(f"isosurface vertex grid, partition {p}", gk, gp, atol=tol)
        lev = torch.tensor(iso_local, dtype=torch.float32, device=dev)
        tie = (gp - lev).abs() <= tol
        flip = (gk > lev) != (gp > lev)
        if (flip & ~tie).any():
            raise SmokeFailure(f"isosurface partition {p}: "
                               f"{int((flip & ~tie).sum())} vertices change side "
                               f"of the iso value beyond the kernel's limit")
        cells = torch.zeros((R - 1,) * 3, dtype=torch.bool, device=dev)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    cells |= tie[dx:R - 1 + dx, dy:R - 1 + dy, dz:R - 1 + dz]
        _, vk = iso_mod.marching_tets(gk, iso_local, meta.origin, meta.extent)
        _, vp = iso_mod.marching_tets(gp, iso_local, meta.origin, meta.extent)
        diff = vk != vp
        if (diff & ~cells.reshape(-1).repeat_interleave(12)).any():
            raise SmokeFailure(f"isosurface partition {p}: triangles differ in "
                               f"cells that touch no tie")
        n_ties += int(tie.sum())
        n_flips += int(flip.sum())
        n_tie_cells += int(cells.sum())
        n_diff += int(diff.sum())
        del gk, gp, tie, flip, cells, vk, vp
    plain = api.isosurface(model, 0.5, resolution=R, backend="ref")
    if crossed == 0 or len(pts) == 0:
        raise SmokeFailure("the isosurface crosses no partition")
    if abs(len(pts) - len(plain)) > 36 * n_tie_cells:
        raise SmokeFailure(f"isosurface: {len(pts)} points against the plain "
                           f"path's {len(plain)}, beyond the {n_tie_cells} tie "
                           f"cells' allowance")
    chamfer = iso_mod.chamfer_distance(torch.as_tensor(pts, device=dev), plain)
    print(f"  isosurface at {R}^3 a partition, {crossed} partitions crossed: "
          f"{len(pts):,} points (plain path {len(plain):,}); {n_ties} vertices "
          f"within the kernel's limit of the iso value, {n_flips} on the other "
          f"side, {n_tie_cells} cells touch them, {n_diff} triangle slots "
          f"differ; Chamfer distance {chamfer:.3e} (limit {0.1 * edge:.3e}: a "
          f"tenth of a cell edge) [{tag}]")
    if not chamfer <= 0.1 * edge:
        raise SmokeFailure(f"isosurface Chamfer distance {chamfer:.3e} over "
                           f"{0.1 * edge:.3e}")


def session_phase(cfg, dev, wrappers, tag) -> None:
    """Phase 8(a) and (d): the session under faults, twice, its checks and
    its times and memory."""
    import torch
    from repro_torch.core.trainer import train_iterations
    from repro_torch.insitu import InSituSession, SimulationConfig, render_action

    _, expect = insitu_plan()
    steps = train_iterations(cfg, INSITU_EDGE ** 3)
    print(f"  session: 8 ranks x {INSITU_EDGE}^3 CloverLeaf (dt 0.03), "
          f"{steps} steps a trained tick, window {INSITU_WINDOW}, compressed, "
          f"RecoveryPolicy(max_retries=1), deadline 1 s (injected clock), "
          f"seed-11 fault plan on {INSITU_CYCLES} cycles")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    sess, rows, out, fracs, totals = run_session(cfg, dev, wrappers, per_tick=True)
    peak = (f"{(torch.cuda.max_memory_allocated(dev) - base_mem) / 2**30:.3f} GiB"
            if dev.type == "cuda" else "not measured")
    health = sess.health()
    print(f"  health(): {health}")
    if health != expect:
        raise SmokeFailure(f"session health {health} != expected {expect}")
    fired = sess.rt._triggers[0].fired_at
    above = [c for c, f in enumerate(fracs, 1) if f > SHOCK_FRAC]
    print(f"  shock fraction (voxels above {SHOCK_LEVEL}) by cycle: "
          + ", ".join(f"{c}: {f:.5f}" for c, f in enumerate(fracs, 1))
          + f"; threshold {SHOCK_FRAC}; fired at cycles {[t + 1 for t in fired]}")
    if not above or fired != [above[0] - 1] or len(above) < 2 or \
            above != list(range(above[0], INSITU_CYCLES + 1)):
        raise SmokeFailure(f"shock trigger: above the threshold at {above}, "
                           f"fired at ticks {fired} (one rising edge expected)")
    fire_cycle = above[0]
    for r in rows:
        c, n = r["cycle"], r["launches"]
        want_steps = 0 if c in expect["fallbacks"] else \
            steps * (2 if c in expect["retry_cycles"] else 1)
        frames = 1 + INSITU_WINDOW if c == fire_cycle else 0
        print(f"  cycle {c}: tick {r['step_s']:.3f} s = publish "
              f"{r['publish_s']:.3f} + train {r['train_s']:.3f} (retry "
              f"{r['retry_s']:.3f}) + compress {r['compress_s']:.3f} + actions "
              f"{r['actions_s']:.3f} + rest; cache {r['cache_bytes']:,} B, raw "
              f"{r['raw_equiv_bytes']:,} B; launches {n} (host clock, synchronised) "
              f"[{tag}]")
        if n["train_step"] != want_steps or n["adamw_apply"] != want_steps:
            raise SmokeFailure(f"cycle {c}: {n['train_step']} train-step and "
                               f"{n['adamw_apply']} AdamW launches, {want_steps} "
                               f"expected")
        if (n["inr_forward"] > 0) != (c == fire_cycle) or n["composite"] != frames:
            raise SmokeFailure(f"cycle {c}: {n['inr_forward']} inference and "
                               f"{n['composite']} compositing launches "
                               f"({frames} frames rendered)")
        if any(n[k] for k in ("hash_encode", "fused_mlp_fwd", "fused_mlp_bwd",
                              "hash_encode_bwd")):
            raise SmokeFailure(f"cycle {c}: the encode / MLP / backward kernels "
                               f"launched: {n}")
    last = rows[-1]
    print(f"  the window after {INSITU_CYCLES} cycles: {last['cache_bytes']:,} B "
          f"of compressed models against {last['raw_equiv_bytes']:,} B of raw "
          f"steps: {last['raw_equiv_bytes'] / last['cache_bytes']:.1f}x (Fig. 12); "
          f"the session's peak device memory above its start {peak} [{tag}]")
    print(f"  isosurface at {ISO_RES}^3: {out['iso_launches']} inference launches, "
          f"{out['iso_s']:.3f} s in all, marching {out['march_s']:.3f} s; the "
          f"fire cycle's actions {out['actions_s']:.3f} s (host clock, "
          f"synchronised) [{tag}]")
    # the actions' outputs against the plain path on the card
    values = [out["value"]] + list(out["history"])
    for i, (v, frame) in enumerate(zip(values, out["frames"])):
        want = render_action(v, width=IMAGE, height=IMAGE, n_samples=SAMPLES,
                             impl="ref")
        check(f"trigger frame {i} ({'current' if i == 0 else 'window'}) vs plain",
              frame, want, atol=1e-5)
    check_isosurface(cfg, out["value"], out["points"], dev, tag)
    del values, out, sess
    # the whole session again, in one run(): the same health, triggers and
    # launches
    sess2, _, out2, _, totals2 = run_session(cfg, dev, wrappers, per_tick=False)
    print(f"  second run: health {'identical' if sess2.health() == health else sess2.health()}, "
          f"fired at ticks {sess2.rt._triggers[0].fired_at}, launches {totals2}")
    if sess2.health() != health or sess2.rt._triggers[0].fired_at != fired or \
            totals2 != totals:
        raise SmokeFailure(f"the second run differs: {sess2.health()}, "
                           f"{totals2} against {totals}")
    del sess2, out2
    # the paper's 'Data Cache' arm: raw copies in the window (nothing trains)
    raw = InSituSession(
        SimulationConfig("cloverleaf", n_ranks=8, local_shape=(INSITU_EDGE,) * 3,
                         dt=0.03),
        cfg, window=INSITU_WINDOW, cache_mode="raw", impl=INSITU_IMPL, device=dev)
    rrec = raw.run(INSITU_WINDOW)[-1]
    print(f"  cache_mode='raw': {rrec.cache_bytes:,} B for {rrec.cache_len} steps "
          f"(ghosts included), dvnr {last['cache_bytes']:,} B: "
          f"{rrec.cache_bytes / last['cache_bytes']:.1f}x [{tag}]")
    if not last["cache_bytes"] < rrec.cache_bytes:
        raise SmokeFailure("the compressed window is not smaller than the raw one")
    del raw


def recovery_phase(cfg, dev, wrappers, tag) -> None:
    """Phase 8(b): ``api.train(recovery=RecoveryPolicy())`` on the 8
    PRODUCTION256 partitions for TRAIN_STEPS steps with partition 1 all
    NaN, on the train step's deterministic route: the run ends finite,
    partition 1 frozen at its init after the ladder, the healthy partitions
    bit for bit with a clean run of the same key, and two clean runs bit
    for bit with each other; then, on the default route (float atomics),
    the first COMPARE_STEPS steps' loss averages within 1e-4."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core.sampling import split
    from repro_torch.core.trainer import init_params
    from repro_torch.data.volume import VolumePartition, make_partition
    from repro_torch.resilience import RecoveryPolicy

    parts = [make_partition("cloverleaf", p, (2, 2, 2), (TRAIN_EDGE,) * 3, t=0.3,
                            device=dev) for p in range(8)]
    bad = parts[1]
    poisoned = list(parts)
    poisoned[1] = VolumePartition(torch.full_like(bad.data, float("nan")),
                                  bad.origin, bad.extent, bad.ghost, bad.vmin,
                                  bad.vmax)
    for w in wrappers.values():
        w.launches = 0
    with deterministic_algorithms():
        model, info = api.train(poisoned, cfg, steps=TRAIN_STEPS, key=0,
                                backend=INSITU_IMPL, recovery=RecoveryPolicy())
        sync(dev)
        launches = wrappers["train_step"].launches
        clean, cinfo = api.train(parts, cfg, steps=TRAIN_STEPS, key=0,
                                 backend=INSITU_IMPL)
        clean2, cinfo2 = api.train(parts, cfg, steps=TRAIN_STEPS, key=0,
                                   backend=INSITU_IMPL)
    r = info["recovery"]
    print(f"  recovery alone: {TRAIN_STEPS} steps, partition 1 all NaN: "
          f"{r['retries']} retries, events {r['events']}, frozen "
          f"{r['frozen_partitions']}, {launches} train-step launches; "
          f"{info['train_time_s']:.3f} s against the clean run's "
          f"{cinfo['train_time_s']:.3f} s (host clock) [{tag}]")
    if r["frozen_partitions"] != (1,) or r["retries"] != 3 or \
            launches != 4 * TRAIN_STEPS or bool(info["state"].active[1]):
        raise SmokeFailure(f"recovery: {r}, {launches} launches")
    leaves = [model.params["tables"], *model.params["mlp"]]
    if not all(bool(torch.isfinite(x).all()) for x in leaves):
        raise SmokeFailure("recovery: the run ended non-finite")
    init = init_params(cfg, split(0)[0], 8)
    for got, want in zip(leaves, [init["tables"], *init["mlp"]]):
        if not torch.equal(got[1].cpu(), want[1]):
            raise SmokeFailure("recovery: the frozen partition moved from its init")
    # the healthy partitions against the clean run, and two clean runs
    # against each other, on the deterministic route: bit for bit (held),
    # the largest parameter departure, the loss averages' and the evaluated
    # PSNRs' departures after TRAIN_STEPS steps
    healthy = [p for p in range(8) if p != 1]
    vols = torch.stack([p.normalized() for p in parts])

    def compare(a, ia, b, ib):
        la, lb = ([m.params["tables"], *m.params["mlp"]] for m in (a, b))
        same = all(torch.equal(x[healthy], y[healthy]) for x, y in zip(la, lb))
        dep = max(float((x[healthy] - y[healthy]).abs().max()) for x, y in zip(la, lb))
        ma, mb = ia["state"].loss_ma[healthy], ib["state"].loss_ma[healthy]
        ea, eb = (np.array(i["trainer"].evaluate(i["state"], vols, (TRAIN_EDGE,) * 3)
                           ["mse_per_partition"])[healthy] for i in (ia, ib))
        return (same, dep, float(((ma - mb).abs() / mb.abs()).max()),
                float(np.abs(10 * np.log10(ea / eb)).max()))

    for label, (same, dep, rel, db) in (
            ("recovered vs clean", compare(model, info, clean, cinfo)),
            ("clean vs clean", compare(clean2, cinfo2, clean, cinfo))):
        print(f"  {label}, healthy partitions after {TRAIN_STEPS} steps on the "
              f"deterministic route: bit for bit {'yes' if same else 'no'}; "
              f"largest param departure {dep:.3e}, loss averages {rel:.3e} "
              f"relative, PSNR {db:.4f} dB [{tag}]")
        if not same:
            raise SmokeFailure(f"recovery ({label}): the healthy partitions are "
                               f"not bit for bit on the deterministic route")
    # held on the default route (its float atomics): the first COMPARE_STEPS
    # steps (PERF.md §2's f32 trajectory limit, 1e-4 relative), on each
    # healthy partition's loss average
    _, s_info = api.train(poisoned, cfg, steps=COMPARE_STEPS, key=0,
                          backend=INSITU_IMPL, recovery=RecoveryPolicy())
    _, c_info = api.train(parts, cfg, steps=COMPARE_STEPS, key=0,
                          backend=INSITU_IMPL)
    ma, cma = s_info["state"].loss_ma[healthy], c_info["state"].loss_ma[healthy]
    rel = float(((ma - cma).abs() / cma.abs()).max())
    print(f"  after {COMPARE_STEPS} steps, the healthy partitions' loss averages "
          f"{'equal' if torch.equal(ma, cma) else 'differ'}: {rel:.3e} relative "
          f"(limit 1e-4, PERF.md §2's f32 trajectory limit) [{tag}]")
    if not rel <= 1e-4:
        raise SmokeFailure(f"recovery: healthy loss averages depart {rel:.3e} "
                           f"after {COMPARE_STEPS} steps")
    del parts, poisoned, model, info, clean, cinfo, clean2, cinfo2, vols


def pathline_bound(cfg, values, seeds, dt, substeps, eps):
    """A per-seed bound on how far the kernel path's backward pathline may
    lie from the plain path's when every velocity query departs by at most
    ``eps``: along the plain trajectory, an RK2 substep of h carries an
    error e to e (1 + hL + (hL)^2 / 2) + h eps (1 + hL / 2), L the local
    slope of the velocity field (twice the largest finite-difference slope,
    steps of 1e-4 that stay in the point's partition, at the point and at
    the midpoint). A seed whose query point comes within its bound of an
    internal partition face may be evaluated by the other partition's INR
    on one path: it is reported and not held. Returns (bound (N,), near
    (N,) bool)."""
    import torch
    from repro_torch.core.pathlines import _query_velocity

    delta, h = 1e-4, dt / substeps
    pts = seeds
    e = torch.zeros(len(seeds), dtype=torch.float64, device=seeds.device)
    near = torch.zeros(len(seeds), dtype=torch.bool, device=seeds.device)
    for v in reversed(values):               # newest first, as traced
        stacked, meta = v.model.stacked_params(), list(v.model.parts_meta)
        lo = torch.tensor([m.origin for m in meta], device=seeds.device)
        hi = lo + torch.tensor([m.extent for m in meta], device=seeds.device)
        faces = [sorted({float(o) for o in lo[:, ax].tolist() if 0.0 < o < 1.0})
                 for ax in range(3)]

        def owner(x):
            inside = ((x[:, None] >= lo) & (x[:, None] <= hi)).all(-1)
            return torch.where(inside.any(1), inside.float().argmax(1), -1)

        def slope(x):
            base = _query_velocity(cfg, stacked, meta, x, "ref")
            own, s = owner(x), torch.zeros(len(x), device=x.device)
            for ax in range(3):
                d = torch.zeros(3, device=x.device)
                d[ax] = delta
                x2 = torch.where((owner(x + d) == own)[:, None], x + d, x - d)
                moved = _query_velocity(cfg, stacked, meta, x2, "ref")
                s = torch.maximum(s, (moved - base).norm(dim=-1) / delta)
            return 2 * s.double()

        def close(x, err):
            c = torch.zeros(len(x), dtype=torch.bool, device=x.device)
            for ax in range(3):
                for f in faces[ax]:
                    c |= (x[:, ax].double() - f).abs() <= err + 1e-6
            return c

        for _ in range(substeps):
            v1 = -_query_velocity(cfg, stacked, meta, pts, "ref")
            mid = torch.clamp(pts + 0.5 * h * v1, 0.0, 1.0)
            L = torch.maximum(slope(pts), slope(mid))
            near |= close(pts, e) | close(mid, e + h * eps)
            e = e * (1 + h * L + (h * L) ** 2 / 2) + h * eps * (1 + h * L / 2)
            v2 = -_query_velocity(cfg, stacked, meta, mid, "ref")
            pts = torch.clamp(pts + h * v2, 0.0, 1.0)
    return e.float(), near


def pathlines_phase(cfg, dev, wrappers, errs, tag) -> dict:
    """Phase 8(c): two velocity models (PRODUCTION256 at out_dim 3, PATH_RANKS
    x INSITU_EDGE^3, t = 0.40 and 0.45, PATH_STEPS steps each), the
    pathlines action with PATH_SEEDS seeds against the plain path within a
    bound derived from the inference kernel's limit, the deviation from the
    analytic field's pathlines, and row 6-v: the train step at D_out = 3 at
    these shapes. Returns that kernel row."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core.inr import _inr_apply
    from repro_torch.core.pathlines import (_query_velocity, pathline_deviation,
                                            trace_ground_truth)
    from repro_torch.core.sampling import n_boundary, step_seeds
    from repro_torch.data.volume import make_partition, partition_grid
    from repro_torch.insitu.actions import pathlines_action
    from repro_torch.kernels.fused_train_step import ops as fts
    from repro_torch.kernels.fused_train_step import ref as fts_ref
    from repro_torch.kernels.hash_encoding import ops as hops
    from repro_torch.reactive import DVNRValue

    vcfg = cfg.replace(out_dim=3)
    grid = partition_grid(PATH_RANKS)
    values, n_train = [], 0
    for i, t in enumerate((0.40, 0.45)):
        parts = [make_partition("velocity", r, grid, (INSITU_EDGE,) * 3, t=t,
                                device=dev) for r in range(PATH_RANKS)]
        wrappers["train_step"].launches = 0
        model, info = api.train(parts, vcfg, steps=PATH_STEPS, key=i,
                                backend=INSITU_IMPL, log_every=PATH_STEPS)
        n_train += wrappers["train_step"].launches
        values.append(DVNRValue(model, info["train_time_s"], info["steps"]))
        print(f"  velocity model t={t}: {PATH_RANKS} x {INSITU_EDGE}^3, "
              f"{PATH_STEPS} steps in {info['train_time_s']:.3f} s, last loss "
              f"{info['loss_history'][-1][1]:.6f} [{tag}]")
    vols = torch.stack([p.normalized() for p in parts])
    seeds = torch.as_tensor(np.random.default_rng(0).uniform(
        0.3, 0.7, (PATH_SEEDS, 3)).astype(np.float32), device=dev)
    dt, substeps = 0.05, 4
    for w in wrappers.values():
        w.launches = 0
    sync(dev)
    t0 = time.perf_counter()
    traj = pathlines_action(values, seeds, dt, substeps=substeps, impl=INSITU_IMPL)
    sync(dev)
    path_s = time.perf_counter() - t0
    n_inf = wrappers["inr_forward"].launches
    plain = pathlines_action(values, seeds, dt, substeps=substeps, impl="ref")
    # every velocity query within eps of the plain one: the inference
    # kernel's f32 limit (phase 2: 2e-6 x max(1, |v01|)), de-normalized
    eps = 0.0
    for v in values:
        m = v.model
        for p in range(m.n_partitions):
            v01 = _inr_apply(vcfg, m.partition(p).params, torch.clamp(seeds, 0, 1),
                             "ref")
            span = m.parts_meta[p].vmax - m.parts_meta[p].vmin
            eps = max(eps, 2e-6 * max(1.0, float(v01.abs().max())) * span)
    bound, near = pathline_bound(vcfg, values, seeds, dt, substeps, eps)
    held = ~near
    err = check(f"pathlines ({PATH_SEEDS} seeds, {2 * substeps} substeps) vs "
                f"plain, {int(held.sum())} seeds held", traj[:, held],
                plain[:, held], atol=0.0,
                slack=bound[held][None, :, None].expand_as(traj[:, held]))
    if int(near.sum()) > PATH_SEEDS // 100:
        raise SmokeFailure(f"pathlines: {int(near.sum())} seeds pass within "
                           f"their bound of a partition face")
    gt = trace_ground_truth("velocity", [0.45, 0.40], seeds, dt, substeps=substeps)
    dev_gt = pathline_deviation(traj, gt)
    print(f"  pathlines: {path_s:.3f} s, {n_inf} inference launches; per-seed "
          f"bound median {float(bound.median()):.3e}, max {float(bound.max()):.3e} "
          f"(eps {eps:.2e}), {int(near.sum())} seeds near a partition face not "
          f"held; departure {err:.3e}; "
          f"deviation from the analytic pathlines: mean {dev_gt['mean']:.4e}, "
          f"max {dev_gt['max']:.4e}, final mean {dev_gt['final_mean']:.4e} "
          f"(host clock, synchronised) [{tag}]")
    if n_inf != 4 * substeps * PATH_RANKS:
        raise SmokeFailure(f"pathlines: {n_inf} inference launches, "
                           f"{4 * substeps * PATH_RANKS} expected")
    # row 6-v: the sampling train step at D_out = 3 at these shapes (the
    # t = 0.45 model's params and volumes); bound by row 6's formula
    flat = {k: v.contiguous() for k, v in fts._pack(values[1].model.params)[0].items()}
    H, res = vcfg.n_hidden_layers, vcfg.level_resolutions()
    L_, T_, F_, W_ = vcfg.n_levels, vcfg.table_size, vcfg.n_features_per_level, vcfg.n_neurons
    P, Nb, D_out = PATH_RANKS, vcfg.batch_size, 3
    vseeds = step_seeds(0, 0, P).to(dev)
    draw = dict(n_batch=Nb, n_uniform=Nb - n_boundary(Nb, vcfg.boundary_lambda),
                sigma=vcfg.boundary_sigma, ghost=1)
    kern = lambda: fts.train_step_cuda(flat, H, res, volumes=vols, seeds=vseeds,
                                       **draw)
    coords, target = fts_ref.sample_batch(
        vols, vseeds, n_batch=Nb, boundary_lambda=vcfg.boundary_lambda,
        sigma=vcfg.boundary_sigma, ghost=1)
    plain_fn = lambda: fts_ref.train_step_grads_ref(
        flat, H, res, *fts_ref.sample_batch(
            vols, vseeds, n_batch=Nb, boundary_lambda=vcfg.boundary_lambda,
            sigma=vcfg.boundary_sigma, ghost=1))
    ms, pms = cuda_ms(kern, reps=10), cuda_ms(plain_fn, reps=3)
    n_w = L_ * F_ * W_ + (H - 1) * W_ * W_ + W_ * D_out
    n_par = P * (L_ * T_ * F_ + n_w)
    rows = P * Nb
    E = INSITU_EDGE
    pos = coords * E - 0.5 + 1
    lo = torch.clamp(torch.floor(pos), 0, E).long()
    vox = torch.cat([(((torch.arange(P, device=dev)[:, None] * (E + 2) + lo[..., 0] + dx)
                       * (E + 2) + lo[..., 1] + dy) * (E + 2) + lo[..., 2] + dz).reshape(-1)
                     for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])
    n_vox = int(torch.unique(vox).numel())
    enc_flops = rows * L_ * (25 + 8 * (3 + 2 * F_))
    flops = enc_flops + rows * (16 * L_ * F_ + 8 * 3 * D_out + 20) + 6 * rows * n_w
    bms, by = bound_ms(2 * n_par * 4 + n_vox * D_out * 4 + P * 4, flops)
    ms_det = cuda_ms(under_det(kern), reps=10)
    v_syms = [(f"train_step_kernel<float, {W_}, {F_}, true, true>", 1),
              ("hash_encode_bwd_fx_kernel<", L_)]
    per_det = kernels_alone_ms(under_det(kern), v_syms)
    vkw = dict(volumes=vols, seeds=vseeds, **draw)
    if W_ == 16 and F_ == 4:   # where the route's fused yardstick is built
        det_design_turns(
            f"6-v-d train_step_v3, deterministic route (split: the step + the "
            f"scatter {hops.fx_letters(hops.fx_plan(res, T_, F_))})",
            lambda: fts.train_step_det_with(flat, H, res, design="split", **vkw),
            lambda: fts.train_step_det_with(flat, H, res, design="fused", **vkw),
            v_syms, [("train_step_det_fused_kernel<float, true", 1)], tag)
    # the kernel alone by profile_tick's keys: the only train-step kernel
    # of the profile (its profiles before the deterministic route's,
    # taken first in this phase, recorded no device kernel at all)
    per = kernels_alone_ms(kern, [(f"train_step_kernel<float, {W_}, {F_}, true, false>", 1)])
    print(f"  train_step_v3 (D_out=3, P={P} x N={Nb}) {ms:.3f} ms  bound "
          f"{bms:.3f} ms ({by})  plain {pms:.3f} ms  launches on the pathline "
          f"path {n_train}  kernel alone "
          f"{'not measured' if per is None else f'{per:.4f} ms'} (profiler) "
          f"[{tag}]")
    print(f"  train_step_v3, deterministic route {ms_det:.3f} ms  bound {bms:.3f} ms "
          f"({by})  kernel alone "
          f"{'not measured' if per_det is None else f'{per_det:.4f} ms'} (profiler) "
          f"[{tag}]")
    del vols, coords, target, vox
    return {"name": "train_step_v3", "route": "cuda",
            "source": SOURCES["train_step"], "replaces": REPLACES["train_step"],
            "launches": n_train, "max_abs_err": errs["train_step_v3"], "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by, "library_ms": None}


def insitu_phase(tag, dev, errs) -> dict:
    """Phase 8: the reactive in situ loop on PRODUCTION256 (see the module
    notes); returns the kernels line's row 6-v."""
    import gc
    import torch
    from repro_torch.configs.dvnr import PRODUCTION256
    from repro_torch.kernels.composite.ops import composite_cuda
    from repro_torch.kernels.fused_mlp.ops import fused_mlp_bwd_cuda, fused_mlp_cuda
    from repro_torch.kernels.fused_train_step import ops as fts
    from repro_torch.kernels.hash_encoding.ops import (hash_encode_bwd_cuda,
                                                       hash_encode_cuda)
    from repro_torch.kernels.inr_forward.ops import inr_forward_cuda

    cfg = PRODUCTION256
    wrappers = {"hash_encode": hash_encode_cuda, "fused_mlp_fwd": fused_mlp_cuda,
                "composite": composite_cuda, "inr_forward": inr_forward_cuda,
                "hash_encode_bwd": hash_encode_bwd_cuda,
                "fused_mlp_bwd": fused_mlp_bwd_cuda,
                "train_step": fts.train_step_cuda,
                "adamw_apply": fts.adamw_apply_cuda}
    phase_header(f"== phase 8: in situ: InSituSession(...).run({INSITU_CYCLES}) -> "
          f"health() on PRODUCTION256, recovery, pathlines [{tag}]")
    session_phase(cfg, dev, wrappers, tag)
    gc.collect()
    recovery_phase(cfg, dev, wrappers, tag)
    gc.collect()
    row = pathlines_phase(cfg, dev, wrappers, errs, tag)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return row


# --------------------------------------------------------------------------- #
# phase 9: DVNR across ranks
# --------------------------------------------------------------------------- #
def _rank_entry(rank: int, world: int, fn_name: str, workdir: str, kwargs: dict):
    """A spawned rank: join the ``gloo`` group through a ``file://`` store in
    ``workdir``, run ``fn_name``, leave its result (``torch.save``) or its
    traceback in ``workdir``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)     # the ranks share the host's cores
    out = Path(workdir)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{out / 'store'}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=DIST_TIMEOUT_S))
        try:
            # every rank connected before any works, and none leaves while
            # another may still be connecting (init has no barrier of its own)
            dist.barrier()
            result = globals()[fn_name](rank, world, out, **kwargs)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        torch.save(result, out / f"result_{rank}.pt")
    except BaseException:
        (out / f"error_{rank}.txt").write_text(traceback.format_exc())
        raise


def spawn_ranks(fn_name: str, world: int, workdir: Path, **kwargs) -> list:
    """``fn_name`` on ``world`` spawned ranks of one ``gloo`` process group;
    their results in rank order. The ranks are joined against a deadline
    and killed past it or when one fails; none outlives the call."""
    import torch
    import torch.multiprocessing as mp
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(_rank_entry, args=(world, fn_name, str(workdir), kwargs),
                             nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise SmokeFailure(f"{fn_name} on {world} ranks did not end within "
                                   f"{DIST_TIMEOUT_S} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        # every rank's traceback: the first rank's is often a peer's loss
        errs = sorted(workdir.glob("error_*.txt"))
        raise SmokeFailure(f"{fn_name} failed on a rank:\n" + (
            "\n".join(f"[{f.stem}] {f.read_text()}" for f in errs) if errs
            else str(e))) from None
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
    return [torch.load(workdir / f"result_{r}.pt", weights_only=False)
            for r in range(world)]


def _faces(v):
    """The six one-cell-thick faces of a ghost-padded volume, on the host."""
    return [v.narrow(ax, 0 if side == 0 else v.shape[ax] - 1, 1).cpu()
            for ax in range(3) for side in (0, 1)]


def _zero_ghosts(v):
    import torch
    bare = torch.zeros_like(v)
    bare[..., 1:-1, 1:-1, 1:-1] = v[..., 1:-1, 1:-1, 1:-1]
    return bare


def _host_state(state) -> dict:
    from repro_torch import interop
    from repro_torch.optim.adamw import tree_map
    return tree_map(lambda x: x.detach().cpu(), interop.state_tree(state))


def dist_rank(rank, world, out, cfg, edge, steps, save_at, image, samples,
              impl, device, ckpt):
    """Phase 9 on one rank of the 2x2x2 mesh: (a) its partition loaded
    without ghosts and filled by ``halo_exchange``; (b) ``api.train(mesh=)``
    of its partition under the deterministic switch for ``save_at`` steps,
    a checkpoint (rank 0 gathers and writes), ``steps - save_at`` more, a
    chunk with rank 1's partition masked out, each under
    ``count_collectives``, and a control ring shift; (c) the distributed
    render step of its trained partition."""
    import torch
    from repro_torch import api, interop
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import render as R
    from repro_torch.core.sampling import as_key, split
    from repro_torch.data.halo import _neighbor_table, halo_exchange
    from repro_torch.data.volume import make_partition
    from repro_torch.kernels.composite.ops import composite_cuda
    from repro_torch.kernels.fused_train_step import ops as fts
    from repro_torch.kernels.inr_forward import ops as inr_ops
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.parallel import collectives as C
    from repro_torch.parallel.sharding import Sharder, partition_shardings

    mesh = make_mesh_for(world, model_parallel=2, pods=2, device=device)
    dev, p, grid = mesh.device, mesh.index, (2, 2, 2)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    part = make_partition("cloverleaf", p, grid, (edge,) * 3, t=0.3, device=dev)
    res = {"partition": p, "mesh": dict(mesh.shape), "backend": mesh.backend}
    # (a) the halo
    sync()
    t0 = time.perf_counter()
    filled = halo_exchange(_zero_ghosts(part.data)[None], grid, mesh, 1)[0]
    sync()
    res["halo_s"] = time.perf_counter() - t0
    res["faces"] = _faces(filled)
    nbr = _neighbor_table(grid)

    def face(v, ax, side):      # a face's ghost cells over the owned extent
        sl = [slice(1, -1)] * 3
        sl[ax] = slice(0, 1) if side == 0 else slice(-1, None)
        return v[tuple(sl)]

    res["faces_equal_make_partition"] = all(
        torch.equal(face(filled, ax, side), face(part.data, ax, side))
        for ax in range(3) for side in (0, 1) if nbr[p, ax, side] >= 0)
    res["owned_unchanged"] = torch.equal(filled[1:-1, 1:-1, 1:-1],
                                         part.data[1:-1, 1:-1, 1:-1])
    del filled
    # (b) training on the deterministic route, counted
    for w in (fts.train_step_cuda, fts.adamw_apply_cuda):
        w.launches = 0
    fts.train_step_cuda.det_launches = 0
    k_train = split(as_key(0))[1]
    vols = part.normalized()[None]
    with deterministic_algorithms():
        sync()
        t0 = time.perf_counter()
        with C.count_collectives() as c1:
            _, info = api.train([part], cfg, backend=impl, mesh=mesh,
                                steps=save_at, key=0)
        sync()
        t_first = time.perf_counter() - t0
        state, trainer = info["state"], info["trainer"]
        tree = interop.state_tree(state)
        CheckpointManager(ckpt, mesh=mesh, async_save=False).save(
            save_at, tree, metadata={"ranks": world},
            shardings=partition_shardings(tree, Sharder(mesh)))
        sync()
        t0 = time.perf_counter()
        with C.count_collectives() as c2:
            state, _ = trainer.train(state, vols, steps=steps - save_at, key=k_train)
        sync()
        t_second = time.perf_counter() - t0
        res["launches"] = {"train_step": fts.train_step_cuda.launches,
                           "det": fts.train_step_cuda.det_launches,
                           "adamw_apply": fts.adamw_apply_cuda.launches}
        with C.count_collectives() as c3:
            api.train([part], cfg, backend=impl, mesh=mesh, steps=16, key=0,
                      train_mask=[p != 1])
    res["collectives"] = {"first chunk": c1.count, "second chunk": c2.count,
                          "rank 1 masked out": c3.count}
    res["ms_step"] = (t_first + t_second) * 1e3 / steps
    res["state"] = _host_state(state)
    with C.count_collectives() as c4:
        got = C.ppermute(torch.full((1,), float(p), device=dev),
                         [(i, (i + 1) % world) for i in range(world)],
                         group=mesh.group)
    res["control"] = (c4.count, float(got[0]))
    # the static check over this rank's chunk (a throwaway 2-step chunk of
    # its trainer on its volume, the route on) and over the control shift
    from repro_torch.analysis import capture, run_checks
    from repro_torch.analysis.programs import train_chunk_program, train_context
    with deterministic_algorithms():
        chunk = run_checks(train_chunk_program(trainer, volumes=vols),
                           train_context(trainer), checks=["zero_collectives"])
    ctl = run_checks(capture(lambda: C.ppermute(
        torch.full((1,), float(p), device=dev),
        [(i, (i + 1) % world) for i in range(world)], group=mesh.group)),
        checks=["zero_collectives"])
    res["analysis"] = (chunk.result("zero_collectives").status,
                       ctl.result("zero_collectives").status)
    # (c) the distributed render step
    ranges = C.all_gather(torch.tensor([part.vmin, part.vmax], dtype=torch.float64),
                          group=mesh.group)
    grange = (float(ranges[:, 0].min()), float(ranges[:, 1].max()))
    step = R.make_distributed_render_step(cfg, mesh, n_samples=samples, impl=impl)
    origins, dirs = R.make_rays(R.Camera(), image, image, dev)
    inr_ops.inr_forward_cuda.launches = composite_cuda.launches = 0
    sync()
    t0 = time.perf_counter()
    frame = step(state.params, part.origin, part.extent, (part.vmin, part.vmax),
                 origins, dirs, R.default_tf(device=dev), grange)
    sync()
    res["render_s"] = time.perf_counter() - t0
    res["render_launches"] = {"inr_forward": inr_ops.inr_forward_cuda.launches,
                              "composite": composite_cuda.launches}
    res["frame"] = frame[0].cpu()
    res["grange"] = grange
    return res


def dist_restart_rank(rank, world, out, cfg, edge, steps, survivors, impl, device,
                      ckpt):
    """Phase 9(d) on one rank of the restarted group: ``plan_restart``,
    ``elastic_restore`` of the checkpoint onto the new mesh (two partitions
    a rank), and training to ``steps`` on the deterministic route."""
    import torch
    from repro_torch import interop
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.sampling import as_key, split
    from repro_torch.core.trainer import DVNRTrainer
    from repro_torch.data.volume import make_partition
    from repro_torch.kernels.fused_train_step import ops as fts
    from repro_torch.launch.elastic import elastic_restore, plan_restart
    from repro_torch.parallel import collectives as C

    plan = plan_restart(survivors, global_batch=cfg.batch_size, model_parallel=2,
                        device=device)
    trainer = DVNRTrainer(cfg, 8, mesh=plan.mesh, impl=impl)
    parts = [make_partition("cloverleaf", p, (2, 2, 2), (edge,) * 3, t=0.3,
                            device=plan.mesh.device) for p in trainer.partitions]
    vols = torch.stack([q.normalized() for q in parts])
    k_init, k_train = split(as_key(0))
    like = interop.state_tree(trainer.init(k_init))
    tree, meta = elastic_restore(CheckpointManager(ckpt, mesh=plan.mesh), like, cfg,
                                 plan)
    state = interop.state_from_tree(tree)
    fts.train_step_cuda.det_launches = 0
    with deterministic_algorithms(), C.count_collectives() as c:
        state, _ = trainer.train(state, vols, steps=steps - state.step, key=k_train)
    return {"partitions": trainer.partitions, "devices": plan.devices,
            "note": plan.note, "meta": meta, "resumed_from": int(tree["step"]),
            "collectives": c.count, "det": fts.train_step_cuda.det_launches,
            "state": _host_state(state)}


def distributed_phase(tag, dev) -> None:
    """Phase 9: DVNR across ranks (the ROADMAP's item 14) on one card: 8
    ``gloo`` ranks share it (NCCL refuses two ranks on one device; the
    halo's and the swap's traffic is staged through host copies), one
    PRODUCTION256 partition of the 512^3 CloverLeaf each. (a) the halo,
    (b) training with zero collectives, each rank's state against the
    single-process stacked run, (c) the binary-swap frame against
    ``api.render``, (d) an elastic restart from 8 ranks to 4."""
    import shutil

    import torch
    from repro_torch import api
    from repro_torch.configs.dvnr import PRODUCTION256
    from repro_torch.data.halo import halo_exchange_ref
    from repro_torch.data.volume import make_partition
    from repro_torch.kernels import build
    from repro_torch.optim.adamw import tree_leaves

    cfg, grid, P = PRODUCTION256, (2, 2, 2), DIST_RANKS
    phase_header(f"== phase 9: DVNR across ranks: {P} gloo ranks on one card, a 2x2x2 "
          f"mesh of PRODUCTION256 partitions of the {2 * TRAIN_EDGE}^3 CloverLeaf "
          f"[{tag}]")
    build.library()          # built here, before any rank loads it
    work = ROOT / "build" / "phase9"
    shutil.rmtree(work, ignore_errors=True)
    parts = [make_partition("cloverleaf", p, grid, (TRAIN_EDGE,) * 3, t=0.3,
                            device=dev) for p in range(P)]
    # the references: the halo of the stacked volumes, and the single-process
    # stacked run on the deterministic route
    ref_faces = [_faces(v) for v in halo_exchange_ref(
        _zero_ghosts(torch.stack([q.data for q in parts])), grid, 1)]
    with deterministic_algorithms():
        ref_model, ref_info = api.train(parts, cfg, steps=DIST_STEPS, key=0,
                                        backend=INSITU_IMPL)
    ref_state = _host_state(ref_info["state"])
    req = api.RenderRequest(width=IMAGE, height=IMAGE, n_samples=SAMPLES)
    ref_frame = api.render(ref_model, req, backend=INSITU_IMPL).reshape(-1, 4).cpu()
    del ref_info
    kw = dict(cfg=cfg, edge=TRAIN_EDGE, steps=DIST_STEPS, impl=INSITU_IMPL,
              device=DEVICE, ckpt=str(work / "ckpt"))
    t0 = time.perf_counter()
    res = spawn_ranks("dist_rank", P, work / "run", save_at=DIST_SAVE_AT,
                      image=IMAGE, samples=SAMPLES, **kw)
    wall = time.perf_counter() - t0
    print(f"  {P} ranks, mesh {res[0]['mesh']}, backend {res[0]['backend']}: "
          f"{wall:.1f} s from spawn to join (each process reaches the card "
          f"on its own) [{tag}]")
    # (a)
    halo_ok = all(all(torch.equal(a, b) for a, b in zip(r["faces"], ref_faces[i]))
                  for i, r in enumerate(res))
    print(f"  (a) halo: every rank's ghost shell bit for bit against "
          f"halo_exchange_ref: {halo_ok}; interior faces equal make_partition's "
          f"ghosts: {all(r['faces_equal_make_partition'] for r in res)}; owned "
          f"cells untouched: {all(r['owned_unchanged'] for r in res)}; exchange "
          f"{max(r['halo_s'] for r in res):.3f} s (6 ppermutes of one "
          f"{TRAIN_EDGE + 2}^2 slab, staged through the host) [{tag}]")
    if not halo_ok or not all(r["faces_equal_make_partition"] and r["owned_unchanged"]
                              for r in res):
        raise SmokeFailure("phase 9 (a): the halo exchange")
    # (b)
    counts = [r["collectives"] for r in res]
    print(f"  (b) collectives counted on rank 0: {counts[0]}, on every rank "
          f"{sum(sum(c.values()) for c in counts)} in all; over the control "
          f"ring shift {[r['control'][0] for r in res]}; launches on rank 0 "
          f"{res[0]['launches']} [{tag}]")
    if any(any(c.values()) for c in counts) or \
            any(r["control"][0] < 1 or r["control"][1] != (i - 1) % P
                for i, r in enumerate(res)):
        raise SmokeFailure(f"phase 9 (b): collectives {counts}, control "
                           f"{[r['control'] for r in res]}")
    if any(r["launches"]["det"] != DIST_STEPS or r["launches"]["train_step"] != DIST_STEPS
           or r["launches"]["adamw_apply"] != DIST_STEPS for r in res):
        raise SmokeFailure(f"phase 9 (b): launches {[r['launches'] for r in res]}")
    print(f"  (b) zero_collectives (repro_torch.analysis) over each rank's chunk "
          f"and over its control shift: {[r['analysis'] for r in res]} [{tag}]")
    if any(r["analysis"] != ("PASS", "FAIL") for r in res):
        raise SmokeFailure(f"phase 9 (b): the static check {[r['analysis'] for r in res]}")
    kept = lambda st: tree_leaves({k: st[k] for k in ("params", "opt", "loss_ma")})
    same = [all(torch.equal(a[0], b[i]) for a, b in zip(kept(r["state"]),
                                                        kept(ref_state)))
            for i, r in enumerate(res)]
    print(f"  (b) each rank's params, moments and loss average bit for bit "
          f"those of its partition in the single-process stacked run: {same}; "
          f"ms a step by rank {[round(r['ms_step'], 4) for r in res]} (host "
          f"clock; {P} processes time-share one card) [{tag}]")
    if not all(same):
        raise SmokeFailure(f"phase 9 (b): ranks against the stacked run {same}")
    # (c)
    frames = [r["frame"] for r in res]
    equal = all(torch.equal(f, frames[0]) for f in frames[1:])
    err = float((frames[0] - ref_frame).abs().max())
    print(f"  (c) binary swap at {IMAGE}^2 x {SAMPLES}: every rank's frame the "
          f"same {equal}; against api.render of the stacked model "
          f"{err:.3e} (limit 1e-5); launches a rank "
          f"{res[0]['render_launches']}; render + swap "
          f"{max(r['render_s'] for r in res):.3f} s [{tag}]")
    if not equal or not err <= 1e-5 or not float(frames[0][:, 3].max()) > 0 or \
            any(min(r["render_launches"].values()) < 1 for r in res):
        raise SmokeFailure(f"phase 9 (c): frames equal {equal}, err {err:.3e}")
    # (d)
    t0 = time.perf_counter()
    res4 = spawn_ranks("dist_restart_rank", 4, work / "restart",
                       survivors=DIST_SURVIVORS, **kw)
    wall = time.perf_counter() - t0
    same4 = [all(torch.equal(a[j], b[0]) for a, b in zip(
        kept(r["state"]), kept(res[p]["state"])))
        for r in res4 for j, p in enumerate(r["partitions"])]
    print(f"  (d) elastic restart: {res4[0]['note']}; partitions "
          f"{[r['partitions'] for r in res4]}, resumed from step "
          f"{res4[0]['resumed_from']} of the checkpoint {res4[0]['meta']}, "
          f"collectives in training {[r['collectives'] for r in res4]}; trained to "
          f"{DIST_STEPS}: bit for bit the uninterrupted ranks' {same4}; "
          f"{wall:.1f} s [{tag}]")
    if not all(same4) or any(r["collectives"] for r in res4) or \
            res4[0]["devices"] != 4 or res4[0]["resumed_from"] != DIST_SAVE_AT or \
            any(r["det"] != DIST_STEPS - DIST_SAVE_AT for r in res4):
        raise SmokeFailure(f"phase 9 (d): {same4}, {[r['det'] for r in res4]}")
    shutil.rmtree(work, ignore_errors=True)
    del parts, ref_model


# --------------------------------------------------------------------------- #
# phase 10: the static checks on the card
# --------------------------------------------------------------------------- #
def _plant(kind):
    """A ``DVNRTrainer._mask_convergence`` that also plants a violation in
    every step: an all-reduce (a one-rank gloo group), an f32 product under
    the bf16 policy, or a host RNG draw."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.trainer import DVNRTrainer
    orig = DVNRTrainer._mask_convergence

    def mask(self, loss, loss_ma, active):
        if kind == "collective":
            dist.all_reduce(loss.clone())
        elif kind == "f32_product":
            torch.ones(4, 4, device=loss.device) @ torch.ones(4, 4, device=loss.device)
        else:
            torch.rand(1, device=loss.device)
        return orig(self, loss, loss_ma, active)

    return mask


def analysis_phase(tag, dev) -> None:
    """Phase 10: ``python -m repro_torch.analysis --config production256
    --backend cuda`` on the card (every check of every standard program
    passes, exit 0), then the same programs in this process:
    ``kernel_budget`` at level ``"device"`` reads every kernel the programs
    launched, and its registers, local memory and static shared memory
    must agree with phase 1's ``ptxas`` numbers; the committed analysis
    lock holds on the card (``lock_check``; its CLI runs beside the rest);
    the trainer's ``static_checks="error"`` builds on the clean config and
    raises ``StaticCheckError`` on each control (a collective, an f32
    product under bf16, an RNG draw) on the card."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.analysis import StaticCheckError, analyze_config
    from repro_torch.configs.dvnr import PRODUCTION256
    from repro_torch.core.trainer import DVNRTrainer
    from repro_torch.kernels import budgets
    phase_header(f"== phase 10: static checks of the production256 programs on the card "
          f"[{tag}]")
    t0 = time.perf_counter()
    lock_cli = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "lock", "verify", "--device",
         "cuda", "--config", "quickstart,smoke"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")})
    cli = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--config",
                          "production256", "--backend", "cuda"],
                         capture_output=True, text=True, timeout=600,
                         env={**__import__("os").environ,
                              "PYTHONPATH": str(ROOT / "src")})
    print("\n".join("    " + l for l in cli.stdout.splitlines()))
    print(f"  python -m repro_torch.analysis --config production256 --backend "
          f"cuda: exit {cli.returncode}, {time.perf_counter() - t0:.1f} s")
    if cli.returncode:
        raise SmokeFailure(f"phase 10: the analysis CLI exited {cli.returncode}: "
                           f"{cli.stderr[-2000:]}")
    reports = analyze_config("production256", backend="cuda")
    launched = {}
    for rep in reports:
        kb = rep.result("kernel_budget")
        if not rep.passed or kb.status != "PASS" or not kb.details["launched"]:
            raise SmokeFailure(f"phase 10: {rep.render()}")
        for r in kb.details["launched"]:
            launched[r["name"]] = r
    rows, disagree = [], []
    for name, r in sorted(launched.items()):
        ref = PTXAS.get(name)
        fam = budgets.family_of(name)
        b = budgets.KERNEL_BUDGETS[fam]
        rows.append(f"    {fam:<24s} registers {r['registers']:3d} (ptxas "
                    f"{ref['registers'] if ref else '?'}; budget {b.registers}), local "
                    f"{r['local_bytes']} B (ptxas stack {ref['stack'] if ref else '?'}, "
                    f"spill {ref['spill'] if ref else '?'}), shared {r['static_smem']} "
                    f"+ {r['dynamic_smem']} B (ptxas static "
                    f"{ref['static_smem'] if ref else '?'}; budget {b.smem_bytes}), "
                    f"{r['launches']} launches  {name[:60]}")
        if ref is None or ref["registers"] != r["registers"] or \
                ref["static_smem"] != r["static_smem"] or ref["spill"] or \
                ref["stack"] != r["local_bytes"]:
            disagree.append(name)
    print(f"  kernel_budget at level device: {len(launched)} kernels launched by "
          f"the {len(reports)} programs, each within its budget [{tag}]")
    print("\n".join(rows))
    if not PTXAS or disagree:
        raise SmokeFailure(f"phase 10: cudaFuncGetAttributes and ptxas disagree on "
                           f"{disagree or 'every kernel (no ptxas reading)'}")
    families = {budgets.family_of(n) for n in launched}
    print(f"  launched kernel families: {sorted(families)}")
    if not {"train_step_kernel", "adamw_kernel", "inr_forward_kernel",
            "composite_kernel"} <= families:
        raise SmokeFailure(f"phase 10: the programs launched {sorted(families)}")
    lock_check(tag, reports, lock_cli)
    cfg = PRODUCTION256.replace(static_checks="error")
    tr = DVNRTrainer(cfg, 2, impl="cuda", volume_shape=(12, 12, 12))
    print(f"  DVNRTrainer(static_checks='error') builds on the clean config: "
          f"{tr.run_static_checks(strict=True).passed}")
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=0,
                                world_size=1)
        try:
            for kind in ("collective", "f32_product", "rng"):
                prec = "bf16" if kind == "f32_product" else "f32"
                with setting(DVNRTrainer, "_mask_convergence", _plant(kind)):
                    try:
                        DVNRTrainer(cfg.replace(precision=prec), 2, impl="cuda",
                                    volume_shape=(12, 12, 12))
                    except StaticCheckError as e:
                        print(f"  control caught: {kind}: "
                              f"{str(e).splitlines()[1][:110]}")
                        continue
                raise SmokeFailure(f"phase 10: the {kind} control built a trainer")
        finally:
            dist.destroy_process_group()
    torch.cuda.synchronize()
    print(f"  phase 10: {time.perf_counter() - t0:.1f} s [{tag}]")


def lock_check(tag, reports, cli) -> None:
    """Phase 10's lock: the committed ``src/repro_torch/analysis/lock.json``
    (derived on the CPU) against the card: the production256 programs'
    fingerprints from ``reports`` (captured once, in this process), the
    other configs through ``cli``, the running ``python -m
    repro_torch.analysis lock verify --device cuda --config
    quickstart,smoke``."""
    from repro_torch.analysis import lock
    drift = lock.diff_locks(lock.read_lock(), {
        "version": lock.LOCK_VERSION,
        "entries": lock.entries_of("production256", "cuda", reports)},
        configs=["production256"])
    print(f"  lock, production256 [cuda]: {len(reports)} programs of this process "
          f"against the committed entries: {len(drift)} difference(s)")
    for line in drift:
        print(f"    {line}")
    t0 = time.perf_counter()
    out, err = cli.communicate(timeout=600)
    print("\n".join("    " + l for l in out.splitlines()[-12:]))
    print(f"  python -m repro_torch.analysis lock verify --device cuda --config "
          f"quickstart,smoke (run beside the phase): exit {cli.returncode}; waited "
          f"{time.perf_counter() - t0:.1f} s for it here [{tag}]")
    if drift or cli.returncode:
        raise SmokeFailure(f"phase 10: the analysis lock drifted on the card "
                           f"(exit {cli.returncode}): {drift} {err[-2000:]}")


# --------------------------------------------------------------------------- #
# phase 11: the port's examples
# --------------------------------------------------------------------------- #
def examples_phase(tag) -> None:
    """Phase 11: ``examples/quickstart_torch.py`` (its 200 steps cut to 100)
    and ``examples/insitu_reactive_torch.py`` (24 simulation steps cut to
    20, the trigger's cycle 18 kept) on the card, through their ``main``:
    their summary lines printed, PSNR, compression ratio and mean alpha in
    range, the trigger fired and frames rendered."""
    import importlib.util
    out = {}
    for name, argv in (("quickstart_torch", ["--steps", "100"]),
                       ("insitu_reactive_torch", ["--steps", "20"])):
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples"
                                                      / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        phase_header(f"== phase 11: examples/{name}.py {' '.join(argv)} [{tag}]")
        t0 = time.perf_counter()
        out[name] = mod.main(argv)
        print(f"  {name}: {out[name]}, {time.perf_counter() - t0:.1f} s [{tag}]")
    q, s = out["quickstart_torch"], out["insitu_reactive_torch"]
    if not (q["psnr"] > 15 and q["ratio"] > 3 and 0 < q["alpha"] < 1):
        raise SmokeFailure(f"phase 11: quickstart {q}")
    if not (s["trained"] > 0 and s["fired"] and s["frames"] > 0 and s["saving"] > 1):
        raise SmokeFailure(f"phase 11: in situ {s}")


# --------------------------------------------------------------------------- #
# phase 14: the transformer LMs on a mesh of ranks
# --------------------------------------------------------------------------- #
def mesh_config(arch, layers=None, experts=None):
    """The config phase 14 runs: the published CONFIG (MESH_CONFIGS' stand-in
    where given), cut to ``layers`` and ``experts``."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = MESH_CONFIGS.get(arch) or get_config(arch)
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    if experts is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, num_experts=experts))
    return cfg


def mesh_families():
    """(d)'s (arch, config): each of MESH_FAMILIES' published CONFIG
    (MESH_CONFIGS' stand-in where given) with its changes."""
    from repro_torch.configs import get_config
    return [(a, (MESH_CONFIGS.get(a) or get_config(a)).replace(**ch))
            for a, ch in MESH_FAMILIES]


def family_slots(cfg, S: int, n: int) -> int:
    """(d)'s serving cache length: room for the prompt (the encoder-decoder:
    the BOS token) and ``n`` steps, rounded up to a multiple of MESH_WORLD
    so that the (1, 4) ranks each hold a block of the slots."""
    need = (1 if cfg.family == "encdec" else S) + n
    return -(-need // MESH_WORLD) * MESH_WORLD


def serve_logits(model, params, prompt, steps, seq_len, dev, sharder=None,
                 impl="auto", after_prefill=None):
    """The prefill's last-token logits and each decode step's (``steps``:
    (B, n) token ids), on the host: (B, n + 1, vocab) float32.
    ``after_prefill()`` runs between the prefill and the steps."""
    import torch
    logits, cache = model.prefill(params, {k: v.to(dev) for k, v in prompt.items()},
                                  seq_len, sharder, impl=impl)
    seq = [logits[:, -1].float().cpu()]
    if after_prefill is not None:
        after_prefill()
    for t in range(steps.shape[1]):
        logits, cache = model.decode_step(params, cache, steps[:, t:t + 1].to(dev),
                                          sharder)
        seq.append(logits[:, -1].float().cpu())
    return torch.stack(seq, 1)[..., :model.config.vocab]


def unbound(cfg):
    """``cfg`` with its MoE capacity raised so that it binds nowhere."""
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def _flag(args, name) -> int:
    return int(args[list(args).index(name) + 1])


def driver_config():
    from repro_torch.configs import get_config, get_smoke_config
    return (get_smoke_config(TRAIN_LM_ARCH) if "--smoke" in TRAIN_LM_EXTRA
            else get_config(TRAIN_LM_ARCH))


def mesh_references(dev, work: Path) -> Path:
    """Phase 14's one-rank references, computed on the card before the ranks
    start and kept on the host: in ``work/refs.pt`` (b) MESH_DENSE's prefill
    and teacher-forced decode logits and (c) each MESH_MOE model's
    last-token prefill logits and routing, the expert-parallel one also at
    a capacity that does not bind; in ``work/grad_<key>.pt`` (the ranks map
    them, each reading its blocks) the step-1 loss and gradient of (a) the
    driver's model, (b) MESH_DENSE and (c) each MESH_MOE model (the
    expert-parallel one at the capacity that does not bind); (d) each
    family's prompt, decode tokens and serving logits, its step-1 loss and
    gradient, and for the scan families (bf16 compute) the same from the
    float32 computation of the same params (C8's yardstick) in
    ``grad_<arch>_f32.pt``, with the one-rank bf16 gradient's relative L2
    from it."""
    import gc

    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel.sharding import tree_paths

    def free():
        gc.collect()
        sync(dev)
        torch.cuda.empty_cache()

    def gradient(model, params, B, S, key):
        """The one-rank loss and gradient of step 1's batch, to the host."""
        leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
        batch = synth_batch(model, ShapeConfig("t", "train", S, B), 0, dev)
        loss, _ = model.loss(params, batch, impl=TRAIN_IMPL)
        # (the VLM's embedding table, which embeds mode never reads: zeros)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        torch.save({"loss": float(loss.detach()), "grad": {k: g.cpu() for k, g in
                                                  zip(tree_paths(params), grads)}},
                   work / f"grad_{key}.pt")
        for t in leaves:
            t.requires_grad_(False)
        del grads, loss, batch
        free()

    refs = {}
    cfg = driver_config()
    model = build_model(cfg)
    params = model.init(0, device=dev)
    gradient(model, params, _flag(TRAIN_LM_ARGS, "--batch"), _flag(TRAIN_LM_ARGS, "--seq"),
             "driver")
    del params
    free()

    arch, layers = MESH_DENSE
    cfg = mesh_config(arch, layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    B, S, n = MESH_SERVE
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (B, S + n)).astype(np.int32)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens[:, :S]}, S + n,
                                      impl=TRAIN_IMPL)
        seq = [logits[:, -1].float().cpu()]
        for t in range(n):
            logits, cache = model.decode_step(
                params, cache, torch.as_tensor(tokens[:, S + t:S + t + 1], device=dev))
            seq.append(logits[:, -1].float().cpu())
    refs["serve"] = {"tokens": tokens, "logits": torch.stack(seq, 1)}
    del cache, logits
    free()
    gradient(model, params, MESH_TRAIN[0], MESH_TRAIN[1], "dense")
    del params
    free()

    B, S = MESH_MOE_PROMPT
    for arch, layers, experts in MESH_MOE:
        cfg = mesh_config(arch, layers, experts)
        tokens = np.random.default_rng(1).integers(0, cfg.vocab, (B, S)).astype(np.int32)
        params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
        refs[arch] = {"tokens": tokens}
        ep = cfg.moe.expert_sharding == "ep"
        for label, c in [("config", cfg)] + ([("unbound", unbound(cfg))] if ep else []):
            with RouteLog() as rl, torch.no_grad():
                logits, _ = build_model(c).prefill(params, {"tokens": tokens}, S,
                                                   impl=TRAIN_IMPL)
            refs[arch][label] = {"logits": logits[:, -1].float().cpu(),
                                 "ids": [i.cpu() for i, _ in rl.calls],
                                 "probs": [q.cpu() for _, q in rl.calls]}
            del logits, rl
            free()
        gradient(build_model(unbound(cfg) if ep else cfg), params, MESH_TRAIN[0],
                 MESH_TRAIN[1], arch)
        del params
        free()

    B, S, n = MESH_FAMILY_SERVE
    for arch, cfg in mesh_families():
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        prompt, tokens = family_inputs(cfg, "cpu", B, S, extra=n)
        prompt = {k: torch.as_tensor(v) for k, v in prompt.items()}
        steps = torch.as_tensor(tokens[:, S:S + n])
        refs[arch] = {"prompt": prompt, "steps": steps}
        c8 = cfg.ssm is not None and cfg.compute_dtype != "float32"
        kinds = [("bf16", cfg)] + ([("f32", cfg.replace(compute_dtype="float32"))]
                                   if c8 else [])
        with torch.no_grad():
            for label, c in kinds:
                refs[arch][label] = serve_logits(build_model(c), params, prompt, steps,
                                                 family_slots(cfg, S, n), dev,
                                                 impl=TRAIN_IMPL)
        free()
        gradient(model, params, MESH_TRAIN[0], MESH_TRAIN[1], arch)
        if c8:
            gradient(build_model(kinds[1][1]), params, MESH_TRAIN[0], MESH_TRAIN[1],
                     f"{arch}_f32")
            a = torch.load(work / f"grad_{arch}.pt", mmap=True, weights_only=False)
            b = torch.load(work / f"grad_{arch}_f32.pt", mmap=True, weights_only=False)
            d2 = w2 = 0.0
            for k, g32 in b["grad"].items():
                for x, y in zip(_chunks(a["grad"][k]), _chunks(g32)):
                    x, y = x.double(), y.double()
                    d2 += float(((x - y) ** 2).sum())
                    w2 += float((y * y).sum())
            refs[arch]["grad_c8"] = (d2 / w2) ** 0.5
            del a, b
        del params
        free()
    path = work / "refs.pt"
    torch.save(refs, path)
    return path


def fsdp_reckon(cfg, shape) -> dict:
    """Bytes a rank holds training ``cfg`` on a ("data", "model") mesh of
    ``shape``, from the global shapes and the placements: ``blocks``, its
    blocks of the weights, of their gradients and of AdamW's two float32
    moments; ``gathered``, the most it holds whole over a "data" axis wider
    than 1 at once (one layer of a stack, the hybrid's shared block, or the
    head / tied table, each its block over "model") with that set's
    unreduced gradient, an upper bound (each leaf's gradient is
    reduce-scattered as soon as it is made). The activations are not
    reckoned here."""
    import types

    import numpy as np
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.parallel.sharding import Sharder, fsdp_split, held_shardings, tree_paths
    specs = build_model(cfg).param_specs()
    mesh = types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)),
                                 coords={"data": 0, "model": 0})
    sh = Sharder(mesh, shape[0])
    blocks, sets = 0, {}
    for path, t, p in zip(tree_paths(specs), tree_leaves(specs),
                          tree_leaves(held_shardings(specs, cfg, sh))):
        n = int(np.prod(p.local_shape(t.shape)))
        blocks += n * (2 * t.element_size() + 8)
        if shape[0] > 1 and fsdp_split(p, sh)[0]:
            whole = n * shape[0] * t.element_size()
            keys = path.split("/")
            stack = next((i for i, k in enumerate(keys) if k in ("layers", "groups", "tail")),
                         None)
            if stack is None:         # gathered alone (a table) or as a block
                key = keys[0] if keys[0] == "shared" else path
            else:                     # one layer of the stack at a time
                key, whole = "/".join(keys[:stack + 1]), whole / t.shape[0]
            sets[key] = sets.get(key, 0) + whole
    return {"blocks": blocks, "gathered": 2 * int(max(sets.values(), default=0))}


def mesh_route_flips(calls, ref_ids, ref_probs, k: int) -> list:
    """``route_flips`` for a rank's routing (``calls``: (ids, probs) per MoE
    layer, of its tokens) against the one-rank run's on the same tokens."""
    out = []
    for (ik, pk), ip, pp in zip(calls, ref_ids, ref_probs):
        pk, ik = pk.float().cpu(), ik.cpu()
        dep = float((pk - pp).abs().max())
        flips = (ik.sort(-1).values != ip.sort(-1).values).any(-1)
        top = pp.topk(k + 1, dim=-1).values
        gap = top[:, k - 1] - top[:, k]
        bad = int((flips & (gap > 2 * dep)).sum())
        out.append((int(flips.sum()), dep, bad, int(pk.shape[0])))
    return out


def _min_cos(a, b) -> float:
    import torch.nn.functional as tF
    return float(tF.cosine_similarity(a.float(), b.float(), dim=-1).min())


def _dots(g, b):
    """(g.b, g.g, b.b) in float64, 2^24 elements at a time."""
    import torch
    g, b = g.reshape(-1), b.reshape(-1)
    out = torch.zeros(3, dtype=torch.float64, device=g.device)
    for lo in range(0, g.numel(), 1 << 24):
        x, y = g[lo:lo + (1 << 24)].double(), b[lo:lo + (1 << 24)].double()
        out += torch.stack([(x * y).sum(), (x * x).sum(), (y * y).sum()])
    return out


def largest_draw(model) -> int:
    """Bytes of the largest float32 draw ``model.init`` holds at once: a
    whole leaf, or one chunk of a narrow-dtype leaf drawn in chunks."""
    import torch
    from repro_torch.models import layers
    from repro_torch.optim.adamw import tree_leaves
    return 4 * max(t.numel() if t.dtype == torch.float32 or t.numel() <= layers._DRAW_CHUNK
                   else layers._DRAW_CHUNK for t in tree_leaves(model.param_specs()))


#: the init's peak may pass its blocks and largest draw by this much (the
#: norm scales and biases, made whole and then cut; the allocator's rounding)
INIT_SLACK = 128 * 2**20


def _nbytes(tree) -> int:
    from repro_torch.optim.adamw import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if hasattr(t, "element_size"))


def mesh_rank(rank, world, out, refs_path, st):
    """Phase 14 on one rank: (a), (b), (c) and (d) of ``mesh_phase``; this
    rank's numbers and checks' inputs."""
    import gc
    import os

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.launch import train
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.optim.compressed import cut_axes
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.collectives import count_collectives
    from repro_torch.parallel.sharding import (Sharder, _unflatten_like, held_shardings,
                                               tree_paths)
    from repro_torch.train import make_train_step

    dev = torch.device(st["device"])
    impl = st["impl"]
    work = Path(refs_path).parent
    # four ranks' caching allocators share one card: segments that grow in
    # place keep each rank's cached but unused memory small
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    refs = torch.load(refs_path, weights_only=False)
    mesh14 = build_mesh((1, world), ("data", "model"), device=dev)
    mesh22 = build_mesh((2, world // 2), ("data", "model"), device=dev)
    res = {"rank": rank}
    cuda = dev.type == "cuda"

    def tidy():
        gc.collect()
        sync(dev)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0

    def reserved():
        return torch.cuda.max_memory_reserved() / 2**30 if cuda else 0.0

    def held():
        return torch.cuda.memory_allocated() if cuda else 0

    def flash():
        return getattr(flash_ops.flash_attention_cuda, "launches", 0)

    def init_blocks(model, sharder, rng):
        """This rank's blocks of the init from ``rng``, drawn the driver's
        way (each leaf cut as it is drawn); with the init's peak over what
        the rank held before, its bound (the blocks and the largest draw)
        and the whole tree's size, in bytes."""
        tidy()
        base = held()
        params = model.init(rng, device=dev, sharder=sharder)
        sync(dev)
        blocks = _nbytes(params)
        return params, {"peak": torch.cuda.max_memory_allocated() - base if cuda else 0,
                        "bound": blocks + largest_draw(model) + INIT_SLACK,
                        "blocks": blocks, "whole": _nbytes(model.param_specs())}

    def seed0():
        return torch.Generator(device=dev).manual_seed(0)

    def ref_dots(model, cfg, sharder, grads, key):
        """This rank's share of (g.b, g.g, b.b) for its gradient blocks
        ``grads`` against the one-rank gradient (``work/grad_<key>.pt``,
        mapped: the rank reads its blocks), and that run's loss; the psum
        over the mesh gives the gathered gradient's."""
        mesh = sharder.mesh
        ref = torch.load(work / f"grad_{key}.pt", mmap=True, weights_only=False)
        acc = torch.zeros(3, dtype=torch.float64, device=dev)
        for path, g, pl in zip(tree_paths(grads), tree_leaves(grads),
                               tree_leaves(held_shardings(model.param_specs(), cfg,
                                                          sharder))):
            # each block once: from the ranks at 0 on every axis that does
            # not cut the leaf (a whole leaf: one rank)
            cut = set(cut_axes(pl))
            if all(mesh.coords[a] == 0 for a in mesh.axis_names if a not in cut):
                b = ref["grad"][path]
                acc += _dots(g, b[pl.slices(b.shape)].to(dev))
        return acc, ref["loss"]

    def cosine(acc, mesh) -> float:
        acc = col.psum(acc, mesh, mesh.axis_names)
        return float(acc[0] / torch.sqrt(acc[1] * acc[2]))

    def rel_from(acc, mesh) -> float:
        """||g - b|| / ||b|| of the gathered gradient g and the reference b
        from this rank's share of (g.b, g.g, b.b)."""
        acc = col.psum(acc, mesh, mesh.axis_names)
        return float(torch.sqrt(torch.clamp(acc[1] - 2 * acc[0] + acc[2], min=0) / acc[2]))

    def counted(c):
        return (c.count, dict(c.kinds), c.nbytes, dict(c.kind_bytes))

    def train_run(model, cfg, sharder, params, B, S, steps, key, c8=False):
        """``steps`` train steps from ``params``, each timed: the first's
        collectives counted (its dispatch mode runs Python on every op) and
        its gradient, before clipping, held against the one-rank run's
        (``key``: ``grad_check``'s numbers, from the trained step itself;
        with ``c8`` also its relative L2 from the float32 computation's,
        ``grad_<key>_f32.pt``)."""
        first: dict = {}

        def hold(grads):
            if not first:
                first["acc"], first["want"] = ref_dots(model, cfg, sharder, grads, key)
                if c8:
                    first["acc32"], _ = ref_dots(model, cfg, sharder, grads, f"{key}_f32")
            return grads

        step = make_train_step(model, OptConfig(**st["opt"]), sharder, impl=impl,
                               grad_transform=hold)
        opt = step.optimizer.init(params)
        losses, ms, fl, counts = [], [], [], None
        dims = train.batch_dims(model)
        for i in range(steps):
            batch = train.batch_block(train.synth_batch(
                model, ShapeConfig("t", "train", S, B), i, dev), sharder, dims)
            sync(dev)
            n0 = flash()
            t0 = time.perf_counter()
            if i == 0:
                with count_collectives() as c:
                    params, opt, metrics = step(params, opt, batch)
                counts = counted(c)
            else:
                params, opt, metrics = step(params, opt, batch)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            fl.append(flash() - n0)
            losses.append(float(metrics["loss"]))
        grad = {"loss": losses[0], "want": first["want"],
                "cos": cosine(first["acc"], sharder.mesh), "coll": counts}
        if c8:
            grad["c8"] = rel_from(first["acc32"], sharder.mesh)
        return {"losses": losses, "ms": ms, "flash": fl, "coll": counts, "peak": peak(),
                "reserved": reserved(), "grad": grad}

    # (a) the driver on the mesh, its first step's gradient (before
    # clipping) held against the one-rank run's
    cfg = st["driver_cfg"]
    real, ms, fl, init, first = train.make_train_step, [], [], {}, {}

    def timed_maker(model, opt_cfg, sharder, **kw):  # each step timed, its flash counted
        def hold(grads):
            if not first:
                first["acc"], first["want"] = ref_dots(model, cfg, sharder, grads,
                                                       "driver")
                first["mesh"] = sharder.mesh
            return grads

        step = real(model, opt_cfg, sharder, grad_transform=hold, **kw)

        def timed(p, o, b):
            if not init:                # the driver's init, up to its first step
                init.update(peak=torch.cuda.max_memory_allocated() - base if cuda else 0,
                            bound=_nbytes((p, o)) + largest_draw(model) + INIT_SLACK,
                            blocks=_nbytes(p), state=_nbytes((p, o)),
                            whole=_nbytes(model.param_specs()))
            sync(dev)
            n0, t0 = flash(), time.perf_counter()
            if ms:
                out = step(p, o, b)
            else:
                with count_collectives() as c:
                    out = step(p, o, b)
                first["coll"] = counted(c)
            sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            fl.append(flash() - n0)
            return out

        timed.optimizer = step.optimizer
        return timed

    train.make_train_step = timed_maker
    base = held()
    try:
        run = train.main(st["driver_argv"])
    finally:
        train.make_train_step = real
    res["a"] = {"losses": [h["loss"] for h in run["history"]], "ms": ms,
                "flash": fl, "peak": peak(), "init": init}
    res["a_grad"] = {"loss": res["a"]["losses"][0], "want": first["want"],
                     "cos": cosine(first["acc"], first["mesh"]), "coll": first["coll"]}
    tidy()
    res["held"] = [("after (a)", held())]

    # (b) the dense LM: prefill and decode on (1, 4), then the step-1
    # gradient and train steps on (2, 2)
    cfg = st["dense"]
    model = build_model(cfg)
    B, S, n = st["serve"]
    sharder = Sharder(mesh14, B)
    params, res["b_init"] = init_blocks(model, sharder, seed0())
    tokens = torch.as_tensor(refs["serve"]["tokens"], device=dev)
    sync(dev)
    n0 = flash()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens[:, :S]}, S + n, sharder,
                                  impl=impl)
    sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_flash = flash() - n0
    seq = [logits[:, -1].float().cpu()]
    t0 = time.perf_counter()
    for t in range(n):
        logits, cache = model.decode_step(params, cache, tokens[:, S + t:S + t + 1],
                                          sharder)
        seq.append(logits[:, -1].float().cpu())
    sync(dev)
    V = cfg.vocab
    got, want = torch.stack(seq, 1)[..., :V], refs["serve"]["logits"][..., :V]
    res["b_serve"] = {"prefill_ms": prefill_ms, "prefill_flash": prefill_flash,
                      "decode_ms": (time.perf_counter() - t0) * 1e3 / n,
                      "decode_flash": flash() - n0 - prefill_flash,
                      "cos": _min_cos(got.reshape(-1, V), want.reshape(-1, V)),
                      "finite": bool(torch.isfinite(got).all()),
                      "slots": tuple(cache["k"].shape), "peak": peak()}
    del logits, cache, seq, params
    B, S, _ = st["train"]
    sharder = Sharder(mesh22, B)
    params, _ = init_blocks(model, sharder, seed0())
    res["b_train"] = train_run(model, cfg, sharder, params, B, S, 1, "dense")
    del params
    tidy()
    res["held"].append(("after (b)", held()))

    # (c) each MoE model on (2, 2): prefill, the step-1 gradient, train steps
    Bp, Sp = st["moe_prompt"]
    res["c"] = {}
    for arch, cfg in st["moe"]:
        r = res["c"][arch] = {}
        model = build_model(cfg)
        sharder = Sharder(mesh22, Bp)
        params, r["init"] = init_blocks(model, sharder, seed0())
        tokens = torch.as_tensor(refs[arch]["tokens"], device=dev)
        d, m = mesh22.coords["data"], mesh22.coords["model"]
        b = Bp // mesh22.shape["data"]
        rows = slice(d * b, (d + 1) * b)
        ep = cfg.moe.expert_sharding == "ep"
        h = Sp // mesh22.shape["model"]
        kinds = [("config", cfg)] + ([("unbound", unbound(cfg))] if ep else [])
        for label, c in kinds:
            ref = refs[arch][label]
            sync(dev)
            n0 = flash()
            t0 = time.perf_counter()
            with RouteLog() as rl:
                logits, _ = build_model(c).prefill(params, {"tokens": tokens[rows]}, Sp,
                                                   sharder, impl=impl)
            sync(dev)
            k = cfg.moe.top_k
            # the rank's tokens: its rows (tp) or its rows' block of the
            # sequence (a2a) of the one-rank run's
            sel = (lambda t: t.reshape(Bp, Sp, -1)[rows, h * m:h * (m + 1)].reshape(
                -1, t.shape[-1])) if ep else \
                (lambda t: t.reshape(Bp, Sp, -1)[rows].reshape(-1, t.shape[-1]))
            r[label] = {"ms": (time.perf_counter() - t0) * 1e3, "flash": flash() - n0,
                        "flips": mesh_route_flips(rl.calls, [sel(i) for i in ref["ids"]],
                                                  [sel(q) for q in ref["probs"]], k),
                        "cos": _min_cos(logits[:, -1, :c.vocab].cpu(),
                                        ref["logits"][rows, :c.vocab]),
                        "finite": bool(torch.isfinite(logits).all()), "peak": peak()}
            del logits, rl
            tidy()
        B, S, _ = st["train"]
        # expert-parallel: the step at the capacity that does not bind,
        # where a2a drops what the one-rank scatter drops (nothing): its
        # gradient is held, and no one-rank run holds its loss
        g = unbound(cfg) if ep else cfg
        res["held"].append((f"{arch}'s blocks, before its steps", held()))
        r["train"] = train_run(build_model(g), g, Sharder(mesh22, B), params, B, S, 1,
                               arch)
        del params
        tidy()

    # (d) the SSM, hybrid, encoder-decoder and VLM families: prefill and
    # decode on (1, 4), then one train step on (2, 2)
    Bs, Ss, n = st["fam_serve"]
    res["d"] = {}
    for arch, cfg in st["families"]:
        r = res["d"][arch] = {}
        model = build_model(cfg)
        sharder = Sharder(mesh14, Bs)
        params, r["init"] = init_blocks(model, sharder, seed0())
        ref = refs[arch]
        marks = {}
        sync(dev)
        n0 = flash()
        t0 = time.perf_counter()

        def prefilled():
            sync(dev)
            marks.update(ms=(time.perf_counter() - t0) * 1e3, flash=flash() - n0,
                         t=time.perf_counter(), sent=c.nbytes)

        with count_collectives() as c:
            got = serve_logits(model, params, ref["prompt"], ref["steps"],
                               family_slots(cfg, Ss, n), dev, sharder, impl, prefilled)
        sync(dev)
        V = cfg.vocab
        r["serve"] = {"prefill_ms": marks["ms"], "prefill_flash": marks["flash"],
                      "decode_ms": (time.perf_counter() - marks["t"]) * 1e3 / n,
                      "decode_flash": flash() - n0 - marks["flash"],
                      "decode_sent": (c.nbytes - marks["sent"]) / n,
                      "in_proj": sum(t.nbytes for k, t in zip(tree_paths(params),
                                                               tree_leaves(params))
                                     if k.endswith("in_proj")),
                      "cos": _min_cos(got.reshape(-1, V), ref["bf16"].reshape(-1, V)),
                      "finite": bool(torch.isfinite(got).all()), "coll": counted(c),
                      "peak": peak()}
        if "f32" in ref:              # C8: both paths against the f32 computation
            r["serve"]["c8"] = (rel_l2(got, ref["f32"]), rel_l2(ref["bf16"], ref["f32"]))
        del params, got
        tidy()
        B, S, steps = st["train"]
        sharder = Sharder(mesh22, B)
        params, r["train_init"] = init_blocks(model, sharder, seed0())
        res["held"].append((f"{arch}'s blocks, before its step", held()))
        r["train"] = train_run(model, cfg, sharder, params, B, S,
                               steps if arch == st["update"] else 1, arch,
                               c8="f32" in ref)
        del params
        tidy()
    return res


def mesh_phase(tag: str, dev) -> tuple:
    """Phase 14: the LMs on MESH_WORLD gloo ranks sharing the card (see the
    settings above); returns each path's flash launches (all ranks'),
    causal (row 8) and non-causal (row 8-nc: the encoder-decoder's encoder
    and cross-attention)."""
    import gc
    import shutil

    import numpy as np
    import torch

    world = MESH_WORLD
    phase_header(f"== phase 14: the LMs on a mesh of {world} gloo ranks "
          f"sharing the card (collectives staged through the host: the gloo "
          f"wire on one card, not NVLink's) [{tag}]")
    work = ROOT / "build" / "mesh_phase"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    refs_path = mesh_references(dev, work)
    gc.collect()
    sync(dev)
    torch.cuda.empty_cache()
    print(f"  one-rank references on the card, kept on the host: "
          f"{time.perf_counter() - t0:.1f} s")
    dcfg = driver_config()
    B, S = _flag(TRAIN_LM_ARGS, "--batch"), _flag(TRAIN_LM_ARGS, "--seq")
    dense = mesh_config(*MESH_DENSE)
    moe = [(a, mesh_config(a, l, e)) for a, l, e in MESH_MOE]
    st = {"device": "cuda:0" if DEVICE == "cuda" else DEVICE, "impl": TRAIN_IMPL,
          "driver_cfg": dcfg, "driver_bs": (B, S),
          "driver_argv": ["--arch", TRAIN_LM_ARCH, "--steps", str(MESH_DRIVER_STEPS),
                          "--batch", str(B), "--seq", str(S), "--log-every", "1",
                          *TRAIN_LM_EXTRA],
          "dense": dense, "serve": MESH_SERVE, "train": MESH_TRAIN,
          "moe": moe, "moe_prompt": MESH_MOE_PROMPT,
          "families": mesh_families(), "fam_serve": MESH_FAMILY_SERVE,
          "update": MESH_UPDATE,
          "opt": dict(lr=3e-4, schedule="cosine", warmup_steps=10, total_steps=100,
                      clip_norm=1.0)}
    from repro_torch.configs import get_config
    full = {a: mesh_config(a) for a in [MESH_DENSE[0]] + [a for a, *_ in MESH_MOE]}
    half = world // 2
    gib = 2**30

    def heads(cfg, m):
        if cfg.n_heads % m:
            return (f"{cfg.n_heads} q heads do not divide {m}: sequence mode, "
                    f"K/V gathered")
        kv = (f"{cfg.n_kv_heads // m} of {cfg.n_kv_heads} K/V heads"
              if cfg.n_kv_heads % m == 0 else f"the {cfg.n_kv_heads} K/V heads gathered")
        return f"head mode: {cfg.n_heads // m} of {cfg.n_heads} q heads and {kv} a rank"

    print(f"  (a) {TRAIN_LM_ARCH} through launch.train.main on make_mesh_for({world}) = "
          f"(1, {world}), {heads(dcfg, world)}; {MESH_DRIVER_STEPS} steps of {B} x {S} "
          f"tokens; width and depth not cut")
    print(f"  (b) {dense.name}: depth {full[MESH_DENSE[0]].n_layers} -> {dense.n_layers} "
          f"(device memory: four ranks' AdamW state); on (1, {world}), "
          f"{heads(dense, world)}: prefill {MESH_SERVE[0]} x {MESH_SERVE[1]} + "
          f"{MESH_SERVE[2]} decode steps; on (2, {half}), {heads(dense, half)}: "
          f"1 step of {MESH_TRAIN[0]} x {MESH_TRAIN[1]}, its gradient held")
    for a, cfg in moe:
        f = full[a]
        ep = f.moe.expert_sharding == "ep"
        print(f"  (c) {a}: depth {f.n_layers} -> {cfg.n_layers}, experts "
              f"{f.moe.num_experts} -> {cfg.moe.num_experts} (device memory); on (2, "
              f"{half}) ({'moe_block_a2a' if ep else 'moe_block_tp'}): prefill "
              f"{MESH_MOE_PROMPT[0]} x {MESH_MOE_PROMPT[1]}, then "
              f"1 step of {MESH_TRAIN[0]} x {MESH_TRAIN[1]}"
              f"{' at a capacity that does not bind' if ep else ''}, step 1's gradient "
              f"held")
    fams = st["families"]
    Bs, Ss, ns = MESH_FAMILY_SERVE
    for a, cfg in fams:
        f = MESH_CONFIGS.get(a) or get_config(a)
        depth = (f"{f.encoder_layers} + {f.n_layers} -> {cfg.encoder_layers} + "
                 f"{cfg.n_layers}" if cfg.family == "encdec" else
                 f"{f.n_layers} -> {cfg.n_layers}")
        print(f"  (d) {a} ({cfg.family}): depth {depth} (the gloo wire's time), width "
              f"not cut; on (1, {world}): prefill {Bs} x {Ss}"
              f"{' source frames' if cfg.family == 'encdec' else ''} + {ns} decode "
              f"steps against one rank; on (2, {half}): "
              f"{MESH_TRAIN[2] if a == MESH_UPDATE else 1} step(s) of {MESH_TRAIN[0]} x "
              f"{MESH_TRAIN[1]}, its gradient and loss held"
              f"{' (the second: an AdamW update of the fsdp blocks)' if a == MESH_UPDATE else ''}")
    reck = {"(a)": fsdp_reckon(dcfg, (1, world)), "(b)": fsdp_reckon(dense, (2, half)),
            **{a: fsdp_reckon(c, (2, half)) for a, c in moe},
            **{a: fsdp_reckon(c, (2, half)) for a, c in fams}}
    print("  reckoned a rank's training state before the run, GiB (x4 ranks, plus "
          "four CUDA contexts and the activations): " + "; ".join(
              f"{k} {r['blocks'] / gib:.3f} (blocks of the weights, their gradients "
              f"and AdamW moments) + {r['gathered'] / gib:.3f} (the largest leaf set "
              f"gathered over 'data' at once, with its unreduced gradient)"
              for k, r in reck.items()))
    t0 = time.perf_counter()
    got = spawn_ranks("mesh_rank", world, work / "ranks", refs_path=str(refs_path), st=st)
    print(f"  the ranks: {time.perf_counter() - t0:.1f} s (spawn, init and all three "
          f"parts)")
    fails = []
    by_path = {}

    def rel(x, y):
        return abs(x - y) / abs(y)

    def grad_line(g, label, c8_one=None):
        """Print and hold step 1's loss and gathered gradient on the mesh
        (``c8_one``: the one-rank bf16 gradient's relative L2 from the
        float32 computation's; the scan families pass by the cosine or by
        C8's yardstick, the mesh gradient no further from the float32 one
        than SCAN_BF16_FACTOR x that)."""
        n, kinds, nbytes, kb = g["coll"]
        c8 = ""
        ok = g["cos"] >= MESH_COS
        if c8_one is not None:
            c8 = (f"; C8: relative L2 from the f32 gradient {g['c8']:.4e} on the mesh, "
                  f"{c8_one:.4e} on one rank (limit {SCAN_BF16_FACTOR} x)")
            ok = ok or g["c8"] <= SCAN_BF16_FACTOR * c8_one
        print(f"      step 1 on the mesh: loss {g['loss']:.6f} (one rank "
              f"{g['want']:.6f}, rel {rel(g['loss'], g['want']):.2e}); gathered "
              f"gradient's cosine to one rank {g['cos']:.6f} (>= {MESH_COS}){c8}; its "
              f"pass: {n} collectives {kinds}, "
              f"{nbytes / 2**20:.1f} MiB ({mib(kb)}) [{tag}]")
        if not ok or not rel(g["loss"], g["want"]) <= MESH_LOSS_RTOL:
            fails.append(f"{label} step 1: loss {g['loss']} vs {g['want']}, "
                         f"cosine {g['cos']}")

    def mib(kb) -> str:
        """MiB sent by collective kind."""
        return ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in sorted(kb.items()))

    def init_line(i, label):
        """Print and hold the init's peak to its blocks and largest draw."""
        if DEVICE != "cuda":
            return
        state = f", with AdamW state {i['state'] / gib:.3f}" if "state" in i else ""
        print(f"      init on the mesh: peak {i['peak'] / gib:.3f} GiB over what the "
              f"rank held (bound {i['bound'] / gib:.3f}: blocks {i['blocks'] / gib:.3f}"
              f"{state}, the largest draw and {INIT_SLACK >> 20} MiB); the whole tree "
              f"{i['whole'] / gib:.3f} GiB [{tag}]")
        if i["peak"] > i["bound"]:
            fails.append(f"{label} init peak {i['peak']} over {i['bound']}")

    def train_line(tr, label, want, fl, r, note=""):
        """Print and hold the train steps: losses, flash and finiteness;
        the peak beside the reckoning ``r`` (``fsdp_reckon``)."""
        print(f"      train: losses {[round(x, 4) for x in tr['losses']]}"
              f"{'' if want is None else f' (one rank {[round(x, 4) for x in want]}{note})'}"
              f"; step ms {[round(x, 1) for x in tr['ms']]} (the first under the "
              f"collective counter); flash a step "
              f"{tr['flash']} (want {fl}); the first step's collectives {tr['coll'][0]} "
              f"{tr['coll'][1]}, {tr['coll'][2] / 2**20:.1f} MiB ({mib(tr['coll'][3])}); peak "
              f"{tr['peak']:.3f} GiB, reserved {tr['reserved']:.3f} (reckoned "
              f"{r['blocks'] / gib:.3f} + "
              f"{r['gathered'] / gib:.3f} = {(r['blocks'] + r['gathered']) / gib:.3f} "
              f"GiB and the activations) [{tag}]")
        held = want is not None and not note
        if not np.isfinite(tr["losses"]).all() or (held and max(
                rel(x, y) for x, y in zip(tr["losses"], want)) > MESH_LOSS_RTOL):
            fails.append(f"{label} losses {tr['losses']} vs {want}")
        if st_flash(tr["flash"], fl):
            fails.append(f"{label} train flash launches {tr['flash']}")

    if DEVICE == "cuda":
        for g in got:
            print(f"    rank {g['rank']} device memory held between the parts, GiB: " +
                  ", ".join(f"{k} {v / gib:.3f}" for k, v in g["held"]) + f" [{tag}]")
    # (a)
    want_a = PHASE13["driver"][:MESH_DRIVER_STEPS]
    fl_a = flash_per_step(dcfg)
    for g in got:
        a = g["a"]
        r = max(rel(x, y) for x, y in zip(a["losses"], want_a))
        print(f"    rank {g['rank']} (a): losses {[round(x, 4) for x in a['losses']]} "
              f"(one rank {[round(x, 4) for x in want_a]}, worst rel {r:.2e}, limit "
              f"{MESH_LOSS_RTOL}); step ms {[round(x, 1) for x in a['ms']]}; peak "
              f"{a['peak']:.3f} GiB; flash a step {a['flash']} (want {fl_a}) [{tag}]")
        init_line(a["init"], f"(a) rank {g['rank']}")
        grad_line(g["a_grad"], f"(a) rank {g['rank']}")
        if r > MESH_LOSS_RTOL or not np.isfinite(a["losses"]).all():
            fails.append(f"(a) rank {g['rank']} losses {a['losses']} vs {want_a}")
        if st_flash(a["flash"], fl_a):
            fails.append(f"(a) rank {g['rank']} flash launches {a['flash']}")
    by_path[f"mesh {TRAIN_LM_ARCH} driver"] = sum(sum(g["a"]["flash"]) for g in got)
    # (b)
    want_b = phase13_losses(MESH_DENSE[0], dense)
    fl_b = flash_per_step(dense)
    for g in got:
        sv = g["b_serve"]
        print(f"    rank {g['rank']} (b) serve: prefill {sv['prefill_ms']:.1f} ms "
              f"(flash {sv['prefill_flash']}, want {dense.n_layers}), decode "
              f"{sv['decode_ms']:.1f} ms a step (flash {sv['decode_flash']}, want 0), "
              f"logits' min cosine to one rank {sv['cos']:.6f}, cache block "
              f"{sv['slots']}, peak {sv['peak']:.3f} GiB [{tag}]")
        init_line(g["b_init"], f"(b) rank {g['rank']}")
        if not sv["finite"] or sv["cos"] < MESH_COS:
            fails.append(f"(b) rank {g['rank']} serve cosine {sv['cos']}")
        if st_flash([sv["prefill_flash"]], dense.n_layers) or sv["decode_flash"]:
            fails.append(f"(b) rank {g['rank']} serve flash launches")
        print(f"    rank {g['rank']} (b) on (2, {half}):")
        grad_line(g["b_train"]["grad"], f"(b) rank {g['rank']}")
        train_line(g["b_train"], f"(b) rank {g['rank']}", want_b, fl_b, reck["(b)"])
    by_path[f"mesh {MESH_DENSE[0]}"] = sum(g["b_serve"]["prefill_flash"]
                                          + sum(g["b_train"]["flash"]) for g in got)
    # (c)
    for a, cfg in moe:
        fl_c = flash_per_step(cfg)
        ep = cfg.moe.expert_sharding == "ep"
        for g in got:
            r = g["c"][a]
            print(f"    rank {g['rank']} (c) {a}:")
            init_line(r["init"], f"(c) {a} rank {g['rank']}")
            for label in ("config", "unbound"):
                if label not in r:
                    continue
                x = r[label]
                flips = [f for f, *_ in x["flips"]]
                bad = sum(b for *_, b, _ in x["flips"])
                checked = label == "unbound" or not ep
                print(f"      prefill at the {label} capacity: "
                      f"{x['ms']:.1f} ms, flash {x['flash']} (want {cfg.n_layers}); "
                      f"routing flips per layer {flips} of {x['flips'][0][3]} tokens, "
                      f"{bad} not near a tie; last-token logits' min cosine to one rank "
                      f"{x['cos']:.6f}{'' if checked else ' (drops differ: not held)'}; "
                      f"peak {x['peak']:.3f} GiB [{tag}]")
                if bad or not x["finite"] or (checked and x["cos"] < MESH_COS):
                    fails.append(f"(c) {a} rank {g['rank']} {label}: {bad} flips off "
                                 f"ties, cosine {x['cos']}")
                if st_flash([x["flash"]], cfg.n_layers):
                    fails.append(f"(c) {a} rank {g['rank']} prefill flash {x['flash']}")
            grad_line(r["train"]["grad"], f"(c) {a} rank {g['rank']}")
            # phase 13 trained the config's capacity: none to hold the
            # expert-parallel run's losses to
            train_line(r["train"], f"(c) {a} rank {g['rank']}",
                       None if ep else phase13_losses(a, cfg), fl_c, reck[a])
        by_path[f"mesh {a}"] = sum(sum(x["flash"] for k, x in g["c"][a].items()
                                       if k in ("config", "unbound"))
                                   + sum(g["c"][a]["train"]["flash"]) for g in got)
    # (d)
    nc_by_path = {}
    refs = torch.load(refs_path, weights_only=False)
    for a, cfg in fams:
        fl_d = flash_per_step(cfg)
        fl_serve = flash_launches_of(cfg)
        c8_one = refs[a].get("grad_c8")
        for g in got:
            r = g["d"][a]
            sv = r["serve"]
            n, kinds, nbytes, kb = sv["coll"]
            c8 = ""
            ok = sv["finite"] and sv["cos"] >= MESH_COS
            if "c8" in sv:
                dm, d1 = sv["c8"]
                c8 = (f"; C8: relative L2 from the f32 computation {dm:.4e} on the mesh, "
                      f"{d1:.4e} on one rank (limit {SCAN_BF16_FACTOR} x)")
                ok = sv["finite"] and (ok or dm <= SCAN_BF16_FACTOR * d1)
            wire = (f"; a decode step sends {sv['decode_sent'] / 2**10:.1f} KiB (the "
                    f"rank's in_proj blocks: {sv['in_proj'] / 2**20:.1f} MiB, none "
                    f"moved)" if sv["in_proj"] else "")
            print(f"    rank {g['rank']} (d) {a} on (1, {world}): prefill "
                  f"{sv['prefill_ms']:.1f} ms (flash {sv['prefill_flash']}, want "
                  f"{fl_serve}), decode {sv['decode_ms']:.1f} ms a step (flash "
                  f"{sv['decode_flash']}, want 0); logits' min cosine to one rank "
                  f"{sv['cos']:.6f} (>= {MESH_COS}){c8}; {n} collectives {kinds}, "
                  f"{nbytes / 2**20:.1f} MiB ({mib(kb)}){wire}; peak {sv['peak']:.3f} "
                  f"GiB [{tag}]")
            init_line(r["init"], f"(d) {a} rank {g['rank']}")
            if sv["in_proj"] and sv["decode_sent"] >= sv["in_proj"]:
                fails.append(f"(d) {a} rank {g['rank']} serve moves weights: "
                             f"{sv['decode_sent']} bytes a decode step")
            if not ok:
                fails.append(f"(d) {a} rank {g['rank']} serve: cosine {sv['cos']}"
                             f"{c8}")
            if st_flash([sv["prefill_flash"]], fl_serve) or sv["decode_flash"]:
                fails.append(f"(d) {a} rank {g['rank']} serve flash launches")
            print(f"    rank {g['rank']} (d) {a} on (2, {half}):")
            init_line(r["train_init"], f"(d) {a} rank {g['rank']}")
            grad_line(r["train"]["grad"], f"(d) {a} rank {g['rank']}", c8_one)
            train_line(r["train"], f"(d) {a} rank {g['rank']}", phase13_losses(a, cfg),
                       fl_d, reck[a])
        serve = sum(g["d"][a]["serve"]["prefill_flash"] for g in got)
        trained = sum(sum(g["d"][a]["train"]["flash"]) for g in got)
        if cfg.family == "encdec":    # the encoder's and cross-attention's: 8-nc
            causal = trained * cfg.n_layers // attention_calls_of(cfg)
            by_path[f"mesh {a}"] = causal
            nc_by_path[f"mesh {a}"] = serve + trained - causal
        else:
            by_path[f"mesh {a}"] = serve + trained
    shutil.rmtree(work, ignore_errors=True)
    if fails:
        raise SmokeFailure("phase 14: " + "; ".join(fails))
    return by_path, nc_by_path


def phase13_losses(arch, cfg):
    """Phase 13's one-rank losses of ``arch`` where it trained ``cfg``
    (the same init and batches), else None."""
    run = PHASE13.get(arch)
    return run["losses"] if run is not None and run["cfg"] == cfg else None


def st_flash(seen, want: int) -> bool:
    """Whether flash launches ``seen`` (a list, one a call) miss ``want``
    each (the counter does not move on the CPU rehearsal's plain path)."""
    return DEVICE == "cuda" and set(seen) != {want}



# --------------------------------------------------------------------------- #
# phase 15: the dry-run against the card
# --------------------------------------------------------------------------- #
def dryrun_cells(spec: dict) -> dict:
    """Phase 15's subprocess: the one-card dry-run cells of ``spec``
    (``repro_torch.launch.cells``, ``repro_torch.core.dryrun_cells`` with
    ``mesh=None``: the single-card route, which phases 5, 7 and 13 run;
    a one-rank mesh would take the mesh's code paths): each cell's
    roofline record (a dict of JSON numbers), and ``seconds``, its own wall
    time. Nothing is allocated; nothing runs on the card."""
    import warnings
    warnings.filterwarnings("ignore")
    t0 = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ShapeConfig, get_config, get_smoke_config
    from repro_torch.configs.dvnr import DVNRConfig
    from repro_torch.core.dryrun_cells import build_train_cell, model_flops_train
    from repro_torch.launch.cells import build_cell, measure, roofline_record
    from repro_torch.utils import hw

    mesh = None
    out = {}
    d = spec["dvnr"]
    cfg = DVNRConfig(**d["cfg"])
    fn, args, meta, mode = build_train_cell(mesh, cfg, partitions_per_rank=d["partitions"],
                                            part_n=d["edge"])
    _, an, mem = measure(fn, args, mode)
    out["dvnr_train"] = roofline_record(an, mem, model_flops_train(cfg, d["partitions"]),
                                        1, hw.PEAK_FLOPS_F32)
    for key, kind in (("llama_prefill", "prefill"), ("qwen_step", "train")):
        arch, B, S = spec[key]
        mcfg = get_smoke_config(arch) if spec["smoke"] else get_config(arch)
        cell = build_cell(arch, key, mesh, config=mcfg, shape=ShapeConfig(key, kind, S, B))
        _, an, mem = measure(cell.fn, cell.args, cell.fake_mode)
        out[key] = roofline_record(an, mem, cell.meta["model_flops_global"], 1,
                                   hw.peak_flops(mcfg.compute_dtype))
    out["seconds"] = time.perf_counter() - t0
    return out


def plain_peak(dev, make_args, run) -> int:
    """The peak memory of one plain-route call on the card, counted as the
    dry run counts it: the inputs ``make_args()`` allocates plus the most
    the call holds beyond them (``max_memory_allocated``)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = make_args()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del args
    torch.cuda.empty_cache()
    return peak


def start_dryrun_cells():
    """Phase 15's subprocess (``dryrun_cells``) at the shapes phases 5, 7 and
    13 ran, started before phase 14 so that it runs beside that phase's
    ranks (which wait on the gloo wire): (process, its start time)."""
    import dataclasses

    from repro_torch.configs.dvnr import PRODUCTION256
    m = DRYRUN_MEASURED
    spec = {"dvnr": {"cfg": dataclasses.asdict(PRODUCTION256),
                     "partitions": m["dvnr_train"]["partitions"], "edge": TRAIN_EDGE},
            "llama_prefill": [m["llama_prefill"][k] for k in ("arch", "B", "S")],
            "qwen_step": [m["qwen_step"][k] for k in ("arch", "B", "S")],
            "smoke": "--smoke" in TRAIN_LM_EXTRA}
    return subprocess.Popen(
        [sys.executable, "-c", "import json, sys, chip_smoke; print(json.dumps("
         "chip_smoke.dryrun_cells(json.loads(sys.argv[1]))))", json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(ROOT),
        env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")}), \
        time.perf_counter()


def dryrun_phase(tag: str, dev, child) -> None:
    """Phase 15: the dry-run cells at the shapes phases 5, 7 and 13 measured,
    on one card (``child``, :func:`start_dryrun_cells`: a subprocess, so
    that its fake tensors and modes never meet this process's); their
    predictions beside the measured times, then the predicted peak against
    the same plain route's peak on the card."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.dvnr import PRODUCTION256
    from repro_torch.core.sampling import step_seeds
    from repro_torch.core.trainer import DVNRTrainer
    from repro_torch.launch.cells import opt_config
    from repro_torch.launch.train import synth_batch
    from repro_torch.models import build_model
    from repro_torch.train import make_train_step
    from repro_torch.utils import hw

    phase_header(f"== phase 15: the dry-run against the card: one-card cells at the "
                 f"shapes phases 5, 7 and 13 measured [{tag}]")
    t0 = time.perf_counter()
    m = DRYRUN_MEASURED
    P = m["dvnr_train"]["partitions"]
    proc, started = child
    out, err = proc.communicate(timeout=600)
    if proc.returncode:
        raise SmokeFailure(f"phase 15: the dry-run subprocess exited "
                           f"{proc.returncode}: {err[-3000:]}")
    recs = json.loads(out.strip().splitlines()[-1])
    print(f"  dry-run subprocess (one card, FakeTensorMode, impl='ref'): "
          f"{recs['seconds']:.1f} s beside phase 14 (started {t0 - started:.1f} s "
          f"before this phase), waited {time.perf_counter() - t0:.1f} s here")
    if recs["dvnr_train"]["collective_calls"]:
        raise SmokeFailure(f"phase 15: the DVNR step's cell sent "
                           f"{recs['dvnr_train']['collective_calls']}")
    # the plain routes' peaks on the card (phase 7 measured the prefill's)
    side = TRAIN_EDGE + 2

    def dvnr_args():
        tr = DVNRTrainer(PRODUCTION256, P, impl="ref", ghost=1, volume_shape=(side,) * 3,
                         device=dev)
        st = tr.init(0)
        return (tr, st, torch.rand((P, side, side, side), device=dev),
                step_seeds(0, 0, P).to(dev))

    m["dvnr_train"]["plain_peak"] = plain_peak(
        dev, dvnr_args, lambda tr, st, v, sd: tr._spmd_step(
            st.params, st.opt, v, sd, st.active, st.loss_ma, None))
    m["dvnr_train"]["plain_route"] = (f"one DVNRTrainer(impl='ref') step of {P} x "
                                      f"{side}^3, here")
    q = m["qwen_step"]
    qmodel = build_model(q["cfg"])

    def qwen_args():
        step = make_train_step(qmodel, opt_config(q["cfg"]), impl="ref")
        params = qmodel.init(0, device=dev)
        return (step, params, step.optimizer.init(params),
                synth_batch(qmodel, ShapeConfig("d", "train", q["S"], q["B"]), 0, dev))

    q["plain_peak"] = plain_peak(dev, qwen_args, lambda st, p, o, b: st(p, o, b))
    q["plain_route"] = f"one make_train_step(impl='ref') step of {q['B']}x{q['S']}, here"
    print(f"  predicted (dry run, the plain route's counts on the H100's constants) "
          f"against measured (the kernel route's time) [{tag}]:")
    for key, label in (("dvnr_train", f"DVNR fused f32 step, {P} PRODUCTION256 "
                                      f"partitions x {PRODUCTION256.batch_size:,}"),
                       ("llama_prefill", f"{m['llama_prefill']['arch']} bf16 prefill "
                                         f"{m['llama_prefill']['B']}x"
                                         f"{m['llama_prefill']['S']}"),
                       ("qwen_step", f"{q['arch']} driver step {q['B']}x{q['S']}")):
        r, meas = recs[key], m[key]
        rf, s = r["roofline"], meas["ms"] / 1e3
        peak = hw.PEAK_FLOPS_F32 if key == "dvnr_train" else hw.PEAK_FLOPS_BF16
        mem = r["memory_analysis"]
        gap = mem["peak_bytes"] / meas["plain_peak"] - 1
        print(f"  {label}:\n"
              f"    model FLOPs {r['model_flops_global']:.4e}; counted FLOPs "
              f"{r['counted_flops_per_device']:.4e} {r['flops_by_dtype']}; op bytes "
              f"{r['op_bytes_per_device']:.4e}; predicted peak {mem['peak_bytes']:,} B\n"
              f"    roofline: compute {rf['compute_s'] * 1e3:.4f} ms, memory "
              f"{rf['memory_s'] * 1e3:.4f} ms -> step {rf['step_time_s'] * 1e3:.4f} ms "
              f"({rf['dominant']}); measured {meas['ms']:.4f} ms ({meas['what']})\n"
              f"    model FLOPs / (measured x {peak:.3g}) = "
              f"{r['model_flops_global'] / (s * peak):.4f}; roofline step / measured "
              f"= {rf['step_time_s'] / s:.4f}\n"
              f"    peak: predicted {mem['peak_bytes'] / 2**30:.3f} GiB against "
              f"{meas['plain_peak'] / 2**30:.3f} GiB measured on the plain route "
              f"({meas['plain_route']}): {gap:+.1%} [{tag}]")
        if not all(x > 0 for x in (r["model_flops_global"], r["counted_flops_per_device"],
                                   r["op_bytes_per_device"], mem["peak_bytes"],
                                   rf["step_time_s"], meas["plain_peak"])):
            raise SmokeFailure(f"phase 15: {key}: a zero in {r}")
    print(f"  phase 15: {time.perf_counter() - t0:.1f} s [{tag}]")


def main() -> int:
    tag, kernels, flash_err, errs = dvnr_phases()
    import gc

    import torch
    gc.collect()                      # the DVNR phases' tensors
    torch.cuda.empty_cache()
    kernels.append(lm_phase(tag, torch.device(DEVICE), flash_err))
    gc.collect()                      # the LM's weights
    torch.cuda.empty_cache()
    kernels.append(insitu_phase(tag, torch.device(DEVICE), errs))
    gc.collect()
    torch.cuda.empty_cache()
    distributed_phase(tag, torch.device(DEVICE))
    gc.collect()
    torch.cuda.empty_cache()
    analysis_phase(tag, torch.device(DEVICE))
    examples_phase(tag)
    gc.collect()
    torch.cuda.empty_cache()
    fam = families_phase(tag, torch.device(DEVICE))
    gc.collect()
    torch.cuda.empty_cache()
    trained, trained_nc = lm_training_phase(tag, torch.device(DEVICE))
    gc.collect()
    torch.cuda.empty_cache()
    dryrun = start_dryrun_cells()
    meshed, meshed_nc = mesh_phase(tag, torch.device(DEVICE))
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_phase(tag, torch.device(DEVICE), dryrun)
    # the flash kernel's launches on each main path: phase 7's, the
    # families' causal prefills and the causal training steps in row 8, the
    # encoder's and the cross-attention's in row 8-nc
    flash = next(r for r in kernels if r["name"] == "flash_attention")
    by_path = {LM_ARCH: flash["launches"]}
    by_path.update({a: n for a, n in fam.items() if a != "seamless_m4t_large_v2"})
    by_path.update(trained)
    by_path.update(meshed)
    flash["launches"] = sum(by_path.values())
    flash["launches_by_path"] = by_path
    nc_by_path = {"seamless_m4t_large_v2": fam["seamless_m4t_large_v2"], **trained_nc,
                  **meshed_nc}
    encoder = flash_encoder_row(tag, torch.device(DEVICE), sum(nc_by_path.values()))
    encoder["launches_by_path"] = nc_by_path
    kernels.append(encoder)
    print(f"wall time by phase (host clock, s): {phase_times()} [{tag}]")
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
