"""NVIDIA H100 SXM5 constants used by the roofline analysis of the dry-run
cells (one card a rank; NVIDIA's H100 Tensor Core GPU datasheet, SXM5
column, dense rates without sparsity, at the card's full 700 W).

``collective term`` divides a rank's wire bytes by ONE link's rate: a mesh
of 256 or 512 ranks spans 32 or 64 nodes of 8 cards, so at least one of
its axes crosses nodes, and a ring on it runs at the rate of the node's
network, one 400 Gb/s NDR InfiniBand NIC a card. Within a node NVLink 4
carries 450e9 B/s a direction; ``collective_s_nvlink`` is the term at that
rate, for an axis that stays inside a node.
"""
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 on the tensor cores (datasheet: 1,979 with sparsity)
PEAK_FLOPS_F32 = 67e12        # FLOP/s, float32 outside the tensor cores
HBM_BW = 3.35e12              # B/s, HBM3
LINK_BW = 50e9                # B/s, one 400 Gb/s NDR NIC a card (across nodes)
NVLINK_BW = 450e9             # B/s a direction, NVLink 4 (18 links x 25 GB/s)
CHIP_HBM_BYTES = 80 * 10**9   # 80 GB of HBM3


def peak_flops(dtype) -> float:
    """The peak rate of a compute dtype (a ``torch.dtype`` or its name):
    bf16 / fp16 on the tensor cores, anything else at the float32 rate."""
    name = str(dtype).replace("torch.", "")
    return PEAK_FLOPS_BF16 if name in ("bfloat16", "bf16", "float16", "fp16") \
        else PEAK_FLOPS_F32
