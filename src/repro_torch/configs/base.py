"""Architecture config system.

Every assigned architecture is expressed as an ``ArchConfig`` — a purely
declarative description consumed by ``repro_torch.models.model.build_model``.
Configs never touch jax device state at import time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden dim
    every: int = 1               # MoE layer every `every` layers (1 = all)
    shared_expert: bool = False  # llama4-style always-on shared expert
    # None: dropless (every routed pair computed, as granite-4.0-h)
    capacity_factor: Optional[float] = 1.25
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM block, or with ``n_heads`` > 0 a Mamba-2
    (SSD) mixer of ``n_heads`` heads of ``head_dim`` channels
    (``n_heads * head_dim == d_inner``), ``n_groups`` groups of B and C,
    a scalar decay a head, scanned in chunks of ``chunk`` steps."""
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2              # d_inner = expand * d_model
    n_heads: int = 0             # 0: Mamba-1
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """Alternating mLSTM / sLSTM blocks (xLSTM)."""
    slstm_every: int = 2         # 1 sLSTM per `slstm_every` layers; rest mLSTM
    proj_factor: float = 2.0     # mLSTM up-projection factor
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Separate encoder stack for enc-dec (seamless-m4t)."""
    n_layers: int
    n_heads: int
    n_kv_heads: int
    d_ff: int


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None           # default: d_model // n_heads
    mlp_act: str = "swiglu"                  # swiglu | squared_relu | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # Attention pattern: "full" or "local_global".
    attn_pattern: str = "full"
    local_window: int = 1024
    local_global_ratio: int = 0              # e.g. 5 => 5 local : 1 global

    # Hybrid attention:ssm interleave (jamba): 1 attn per `attn_every` layers,
    # at layer `attn_offset` of each period.
    attn_every: int = 1
    attn_offset: int = 0
    # RoPE on q and k (False: no positional encoding, granite-4.0-h's
    # "nope"), and the score scale (None: 1/sqrt(head_dim)).
    use_rope: bool = True
    attn_scale: Optional[float] = None

    # Granite's multipliers: the token embeddings times
    # `embedding_multiplier`, each block's output times
    # `residual_multiplier` before its residual add, the logits divided by
    # `logits_scaling`.
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    encoder: Optional[EncoderConfig] = None

    # Modality frontend stub: None | "audio_frames" | "vit_patches".
    frontend: Optional[str] = None
    frontend_len: int = 0                    # tokens contributed by frontend

    # Sub-quadratic? (drives long_500k applicability)
    subquadratic: bool = False

    # FSDP (param/optimizer sharding over the data axis) on by default for
    # archs whose state does not fit tensor parallelism alone.
    use_fsdp: bool = False

    # Compute dtype for activations / params (master + opt state are f32
    # unless overridden by the trainer).
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, (
            f"{self.name}: n_heads {self.n_heads} not divisible by "
            f"n_kv_heads {self.n_kv_heads}")

    # ---- derived sizes ------------------------------------------------
    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def param_count(self) -> int:
        """Analytic total parameter count (embeddings included)."""
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads * hd) * 2 + d * (self.n_kv_heads * hd) * 2
        def ffn_params(dff: int) -> int:
            mult = 3 if self.mlp_act == "swiglu" else 2
            return mult * d * dff

        total = 0
        for i in range(self.n_layers):
            is_attn = ((i % self.attn_every) == self.attn_offset
                       if self.attn_every > 1 else True)
            if self.xlstm is not None:
                dm = int(self.xlstm.proj_factor * d)
                total += 2 * d * dm + dm * d + 4 * d * dm  # rough mLSTM/sLSTM
                continue
            if is_attn:
                total += attn
            elif self.ssm is not None and self.ssm.n_heads:
                s = self.ssm
                di, gn = s.expand * d, 2 * s.n_groups * s.d_state
                total += (d * (2 * di + gn + s.n_heads) + s.d_conv
                          * (di + gn) + (di + gn) + 3 * s.n_heads + di
                          + di * d)
            elif self.ssm is not None:
                di = self.ssm.expand * d
                total += 2 * d * di + di * d + di * (2 * self.ssm.d_state + 2)
            if self.moe is not None and (i % self.moe.every) == (self.moe.every - 1):
                total += self.moe.num_experts * ffn_params(self.moe.d_ff)
                total += d * self.moe.num_experts  # router
                if self.moe.shared_expert:
                    total += ffn_params(self.d_ff)
            elif self.d_ff > 0:
                total += ffn_params(self.d_ff)
            total += 2 * d  # norms
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.encoder is not None:
            e = self.encoder
            enc_attn = d * (e.n_heads * hd) * 2 + d * (e.n_kv_heads * hd) * 2
            total += e.n_layers * (enc_attn + ffn_params(e.d_ff) + 2 * d)
            # cross attention in every decoder layer
            total += self.n_layers * attn
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if (i % self.moe.every) == (self.moe.every - 1))
        mult = 3 if self.mlp_act == "swiglu" else 2
        expert_p = mult * self.d_model * self.moe.d_ff
        inactive = n_moe_layers * (self.moe.num_experts - self.moe.top_k) * expert_p
        return full - inactive


# ---------------------------------------------------------------------------
# Input shape grid (assigned): every LM arch is paired with these four shapes.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"


SHAPE_GRID: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES = {s.name: s for s in SHAPE_GRID}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch, shape) is a live cell per DESIGN.md §4."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""
