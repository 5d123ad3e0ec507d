"""Model configuration: the port's own copy of the reference's
``configs/base.py`` ``ModelConfig`` (every field, default and derived
quantity), so the port imports nothing of the JAX package.

``InputShape``, ``INPUT_SHAPES`` and ``TrainConfig`` are copies too, field
for field.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

FAMILIES = ("dense", "moe", "vlm", "audio", "hybrid", "ssm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 32000

    # attention
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    sliding_window: int = 0          # >0: sliding-window attention everywhere
    attn_chunk: int = 1024           # KV-block size for chunked online-softmax attention
    attn_inner_remat: bool = True    # checkpoint the kv-block scan body
                                     # (False trades peak HBM for less traffic — §Perf H2)

    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_impl: str = "dense"          # dense (reference) | ep (shard_map expert parallel)

    # vlm (Qwen2-VL style; vision encoder stubbed per task carve-out)
    mrope: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)   # t/h/w splits of head_dim/2
    num_patches: int = 0             # stub patch embeddings prepended to the sequence

    # audio (MusicGen style; EnCodec frontend stubbed per task carve-out)
    num_codebooks: int = 0

    # hybrid (RecurrentGemma / Griffin)
    block_pattern: Tuple[str, ...] = ()   # e.g. ("rec", "rec", "attn")
    local_attn_window: int = 2048
    lru_width: int = 0

    # ssm (Mamba-2 SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 128

    # numerics
    norm_eps: float = 1e-5
    dtype: str = "float32"           # activation dtype
    param_dtype: str = "float32"
    tie_embeddings: bool = False
    remat: bool = False              # activation checkpoint each scanned layer
    remat_policy: str = "nothing"    # nothing | dots — what the layer
                                     # checkpoint may keep (§Perf H1)

    source: str = ""                 # citation for the assigned config

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family != "ssm":
            if self.num_heads <= 0:
                raise ValueError(f"{self.name}: num_heads required")
            if self.head_dim == 0:
                object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
            if self.num_kv_heads == 0:
                object.__setattr__(self, "num_kv_heads", self.num_heads)
            if self.num_heads % max(self.num_kv_heads, 1) != 0:
                raise ValueError(f"{self.name}: heads must divide evenly into kv groups")
        if self.family == "moe" and (self.num_experts <= 0 or self.experts_per_token <= 0):
            raise ValueError(f"{self.name}: moe requires num_experts/experts_per_token")
        if self.family == "hybrid" and not self.block_pattern:
            raise ValueError(f"{self.name}: hybrid requires block_pattern")
        if self.family == "ssm" and self.ssm_state <= 0:
            raise ValueError(f"{self.name}: ssm requires ssm_state")

    # ---- derived quantities used by sharding/roofline --------------------

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def layer_types(self) -> Tuple[str, ...]:
        """Per-layer block type, length == num_layers."""
        if self.family == "ssm":
            return ("ssm",) * self.num_layers
        if self.family == "hybrid":
            pattern = self.block_pattern
            reps = (self.num_layers + len(pattern) - 1) // len(pattern)
            return (pattern * reps)[: self.num_layers]
        return ("attn",) * self.num_layers

    @property
    def supports_long_decode(self) -> bool:
        """True if decode memory is sub-linear in context (→ long_500k runs)."""
        if self.family == "ssm":
            return True
        if self.family == "hybrid":
            return True  # RG-LRU state + bounded local-attention window
        return self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (for 6ND model-FLOPs in the roofline)."""
        d, v = self.d_model, self.vocab_size
        n = v * d  # embeddings
        if not self.tie_embeddings:
            n += v * d
        if self.family == "audio" and self.num_codebooks:
            # K codebook embeddings + K heads instead of one each
            n += (self.num_codebooks - 1) * 2 * v * d
        for lt in self.layer_types:
            if lt == "attn":
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qkv_bias:
                    n += self.q_dim + 2 * self.kv_dim
                n += 2 * d  # norms
                n += self._ffn_params()
            elif lt == "rec":
                w = self.lru_width or d
                n += d * w * 2 + w * d  # gate/in/out projections
                n += w * self.conv_width
                n += 2 * w + 2 * w  # RG-LRU gates (a, x) diag params + biases
                n += 2 * d
                n += self._ffn_params()
            elif lt == "ssm":
                d_in = self.ssm_expand * d
                nh = d_in // self.ssm_headdim
                conv_dim = d_in + 2 * self.ssm_ngroups * self.ssm_state
                n += d * (2 * d_in + 2 * self.ssm_ngroups * self.ssm_state + nh)
                n += conv_dim * self.conv_width
                n += nh * 2  # A_log, D
                n += d_in * d  # out proj
                n += 2 * d
        n += d  # final norm
        return n

    def _ffn_params(self) -> int:
        d = self.d_model
        if self.family == "moe" or (self.num_experts > 0):
            return self.num_experts * 3 * d * self.d_ff + d * self.num_experts
        return 3 * d * self.d_ff

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts) for 6·N_active·D."""
        if self.num_experts <= 0:
            return self.param_count()
        full = self.param_count()
        expert_p = self.num_experts * 3 * self.d_model * self.d_ff
        active_p = self.experts_per_token * 3 * self.d_model * self.d_ff
        moe_layers = sum(1 for lt in self.layer_types if lt == "attn")
        return full - moe_layers * (expert_p - active_p)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned (seq_len, global_batch, mode) tuples."""

    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimiser + compression wiring for a training run."""

    learning_rate: float = 0.1
    momentum: float = 0.0            # optimiser-level momentum (paper: 0, momentum
                                     # lives in the correction term)
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    lr_schedule: str = "constant"    # constant | cosine | step
    warmup_steps: int = 0
    total_steps: int = 1000
    grad_sync: str = "dense"         # dense | gmf_data | gmf_pod
    seed: int = 0
