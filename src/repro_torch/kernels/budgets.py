"""The declared resource budget of every CUDA kernel of the port: registers
a thread, a stack frame a thread (local memory that is not a spill; a
spill must be zero) and shared memory a block (static plus dynamic),
written down once for the static check
``kernel_budget`` (:mod:`repro_torch.analysis.checks`), which holds each
kernel a program launches to its family's budget. The budgets are the
designs' own limits, not the build's readings: a change that spills, grows
a register file past the occupancy its launch bounds were chosen for, or
asks a block for more shared memory than its layout plans fails the check.

On the card the check reads each launched kernel's ``cudaFuncGetAttributes``
through ``repro_kernel_launches`` (``csrc/launch_notes.cu``); on the CPU it
can hold only the dynamic shared memory each wrapper would request at the
program's shapes (:func:`launch_plan` of each kernel module) against the
budget and the H100's opt-in limit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

#: the dynamic shared memory an H100 block may opt in to (cudaFuncSetAttribute)
H100_SMEM_OPTIN = 232448
#: the static shared memory a block may declare
STATIC_SMEM_LIMIT = 48 * 1024


@dataclass(frozen=True)
class KernelBudget:
    registers: int          # a thread's registers
    stack_bytes: int        # a thread's stack frame: its local memory, no spill
    smem_bytes: int         # a block's static + dynamic shared memory


#: kernel family (the kernel's name in the sources) -> its budget. The
#: register budgets are each family's launch bounds' room: 64 for the
#: one-pair-a-thread kernels and the reductions, the occupancy the tensor-core
#: kernels were sized for (fused_mlp.cu fwd_min_blocks / bwd_min_blocks,
#: inr_forward.cu, the train step's 128-thread tiles), 255 (the ISA's limit)
#: for the float32 MLP backward at W = 64.
KERNEL_BUDGETS = {
    "hash_encode_fwd_kernel": KernelBudget(64, 0, 0),
    # the staged levels' slab: hash_encoding.ops.STAGE_BUDGET_BYTES
    "hash_encode_bwd_kernel": KernelBudget(64, 0, 200 * 1024),
    # the deterministic route's scatter: a level's int64 slab in one block, or
    # a block's share of a cluster's (hash_encoding.ops.FX_STAGE_BUDGET);
    # 1,024-thread launch bounds; its yardstick (the design before the
    # clusters) the same
    "hash_encode_bwd_fx_kernel": KernelBudget(64, 0, 200 * 1024),
    "hash_encode_bwd_fx_block_kernel": KernelBudget(64, 0, 200 * 1024),
    "fx_to_float_kernel": KernelBudget(64, 0, 0),
    "fused_mlp_fwd_kernel": KernelBudget(160, 0, H100_SMEM_OPTIN),
    "fused_mlp_bwd_kernel": KernelBudget(255, 0, H100_SMEM_OPTIN),
    "mlp_dw_reduce_kernel": KernelBudget(64, 0, 0),
    # one block an SM of as many warps as the one-warp design held there:
    # 64 registers at W = 16, up to the ISA's 255 at W = 64 under float32
    "inr_forward_kernel": KernelBudget(255, 0, H100_SMEM_OPTIN),
    "composite_kernel": KernelBudget(64, 0, STATIC_SMEM_LIMIT),
    # 64 B of stack: the per-level resolutions of StepArgs, indexed at run
    # time in the sampling variants (16 B in the host-sampled ones)
    "train_step_kernel": KernelBudget(176, 64, H100_SMEM_OPTIN),
    # the deterministic route's fused yardstick (the design before the split)
    "train_step_det_fused_kernel": KernelBudget(176, 64, H100_SMEM_OPTIN),
    "adamw_kernel": KernelBudget(64, 0, 0),
    "flash_attention_kernel_bf16_wgmma": KernelBudget(168, 0, H100_SMEM_OPTIN),
    "flash_attention_kernel": KernelBudget(128, 0, H100_SMEM_OPTIN),
}


def family_of(name: str) -> Optional[str]:
    """The budget family of a kernel's (mangled or plain) name: the longest
    family name it contains, or None."""
    hits = [f for f in KERNEL_BUDGETS if f in name]
    return max(hits, key=len) if hits else None
