"""Config dataclasses + registry for the assigned architectures and shapes."""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Optional, Tuple


# --------------------------------------------------------------------------- #
# Model configuration
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""

    num_experts: int
    top_k: int = 2
    dense_residual: bool = False      # arctic: dense FFN residual in parallel with MoE
    capacity_factor: float = 1.25
    expert_sharding: str = "ep"       # "ep": experts over model axis; "tp": d_ff over model
    router_aux_weight: float = 0.01   # load-balancing auxiliary loss weight


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256                  # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    """One configuration fully describes a model in the zoo.

    ``family`` selects the block structure:
      dense | moe | ssm | hybrid | encdec | vlm
    """

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None            # default: d_model // n_heads
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE (t,h,w)
    sliding_window: Optional[int] = None      # h2o-danube SWA
    qkv_bias: bool = False                    # qwen2
    norm: str = "rmsnorm"                     # rmsnorm | layernorm | nonparam_ln
    act: str = "swiglu"                       # swiglu | gelu
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_shared_every: int = 0              # zamba2: shared attn block period
    encoder_layers: int = 0                   # encdec: encoder stack depth
    input_mode: str = "tokens"                # tokens | embeds (modality-frontend stub)
    param_dtype: str = "float32"              # storage dtype of parameters
    compute_dtype: str = "bfloat16"           # activation / matmul dtype
    remat: str = "dots"                       # none | dots | full
    scan_layers: bool = True                  # lax.scan over stacked layer params
    attention_impl: str = "auto"              # auto | xla | pallas
    max_target_len: Optional[int] = None      # encdec: decoder length (None -> seq_len)

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ----- analytic parameter / FLOP counts (for roofline MODEL_FLOPS) ----- #
    def param_count(self) -> int:
        """Analytic total parameter count."""
        d, dh = self.d_model, self.resolved_head_dim
        hq, hkv, ff, v = self.n_heads, self.n_kv_heads, self.d_ff, self.vocab

        def attn_params() -> int:
            p = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
            if self.qkv_bias:
                p += (hq + 2 * hkv) * dh
            return p

        def mlp_params(width: int = 0) -> int:
            f = width or ff
            n_mat = 3 if self.act == "swiglu" else 2
            return n_mat * d * f

        def norm_params() -> int:
            if self.norm == "nonparam_ln":
                return 0
            return d * (2 if self.norm == "layernorm" else 1)

        emb = v * d * (1 if self.tie_embeddings else 2)

        if self.family == "ssm":
            return self.n_layers * self._ssm_layer_params() + emb
        if self.family == "hybrid":
            n_shared = self.n_layers // max(self.hybrid_shared_every, 1)
            shared = attn_params() + mlp_params() + 2 * norm_params()
            return self.n_layers * self._ssm_layer_params() + shared + emb
        if self.family == "moe":
            assert self.moe is not None
            per_layer = attn_params() + 2 * norm_params()
            per_layer += self.moe.num_experts * mlp_params() + d * self.moe.num_experts
            if self.moe.dense_residual:
                per_layer += mlp_params()
            return self.n_layers * per_layer + emb
        if self.family == "encdec":
            enc = self.encoder_layers * (attn_params() + mlp_params() + 2 * norm_params())
            dec = self.n_layers * (2 * attn_params() + mlp_params() + 3 * norm_params())
            return enc + dec + emb
        # dense / vlm
        per_layer = attn_params() + mlp_params() + 2 * norm_params()
        return self.n_layers * per_layer + emb

    def _ssm_layer_params(self) -> int:
        assert self.ssm is not None
        d = self.d_model
        di = self.ssm.expand * d
        nh = di // self.ssm.head_dim
        n = self.ssm.state_dim
        # in_proj -> [z, x, B, C, dt], out_proj, conv, A_log, D, norm
        in_proj = d * (2 * di + 2 * n + nh)
        out_proj = di * d
        conv = self.ssm.conv_width * (di + 2 * n)
        return in_proj + out_proj + conv + 2 * nh + d

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if self.family != "moe" or self.moe is None:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        n_mat = 3 if self.act == "swiglu" else 2
        inactive = (self.moe.num_experts - self.moe.top_k) * n_mat * d * ff
        return self.param_count() - self.n_layers * inactive


# --------------------------------------------------------------------------- #
# Shapes
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

ARCH_IDS: tuple[str, ...] = (
    "arctic_480b",
    "grok_1_314b",
    "olmo_1b",
    "h2o_danube_1_8b",
    "qwen2_0_5b",
    "llama3_8b",
    "mamba2_780m",
    "seamless_m4t_large_v2",
    "qwen2_vl_7b",
    "zamba2_1_2b",
)

# Sub-quadratic long-context capability per arch (long_500k eligibility).
_SUBQUADRATIC: dict[str, bool] = {
    "arctic_480b": False,
    "grok_1_314b": False,
    "olmo_1b": False,
    "h2o_danube_1_8b": True,    # sliding-window attention: O(window) ring cache
    "qwen2_0_5b": False,
    "llama3_8b": False,
    "mamba2_780m": True,        # O(1) SSM state
    "seamless_m4t_large_v2": False,
    "qwen2_vl_7b": False,
    "zamba2_1_2b": True,        # hybrid: SSM states + few shared-attn KV blocks
}


def cell_is_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """Whether (arch, shape) is a runnable dry-run cell; returns (ok, reason)."""
    if shape == "long_500k" and not _SUBQUADRATIC[arch]:
        return False, "pure full-attention arch: 524k-token decode is O(S) KV / O(S^2) prefill; skipped per assignment"
    return True, ""


def list_archs() -> tuple[str, ...]:
    return ARCH_IDS


def _load(arch: str):
    if arch not in ARCH_IDS and arch != "dvnr":
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS + ('dvnr',)}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _load(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _load(arch).SMOKE
