"""Model configuration — one dataclass covers all 10 assigned families.

A model is ``num_blocks`` repetitions of a *pattern* of sub-layers; each
sub-layer has a mixer (GQA attention or Mamba-1 SSM) and an MLP (dense
SwiGLU or top-k MoE).  Uniform transformers use a 1-long pattern; Jamba's
1:7 attention:mamba interleave with MoE every other layer uses an 8-long
pattern.  Block parameters are stacked over ``num_blocks``; the port walks
the stack with a Python loop.

A copy of ``repro.models.config`` (the port imports nothing of the JAX
package): the same dataclasses, fields and helpers.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

Mixer = Literal["attn", "mamba"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Mixer = "attn"
    moe: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int                 # query heads (ignored for attn-free)
    num_kv_heads: int
    head_dim: int
    d_ff: int                      # dense MLP hidden (per-expert for MoE)
    vocab_size: int
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)

    # attention flavor
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: int | None = None        # SWA window (h2o-danube)
    rope_theta: float = 10_000.0

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0
    capacity_factor: float = 1.25

    # Mamba-1 (falcon-mamba, jamba)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0               # 0 => d_model // 16
    ssm_scan_bf16: bool = False    # bf16 decay/cumprod tensors in the scan

    # modality frontends (stubs per the assignment)
    num_codebooks: int = 0         # musicgen: 4 EnCodec streams
    vision_tokens: int = 0         # llava: precomputed patch embeds

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.num_layers % len(self.pattern) != 0:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not a multiple "
                f"of pattern length {len(self.pattern)}")

    @property
    def num_blocks(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank or max(self.d_model // 16, 1)

    @property
    def has_attention(self) -> bool:
        return any(s.mixer == "attn" for s in self.pattern)

    @property
    def has_mamba(self) -> bool:
        return any(s.mixer == "mamba" for s in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid / sliding-window archs.

        Full-attention archs are quadratic in context and skip long_500k
        (documented in DESIGN.md §Arch-applicability).
        """
        return (not self.has_attention) or (self.sliding_window is not None) \
            or self.has_mamba

    def param_count(self) -> int:
        """Exact parameter count (embeddings included once if tied)."""
        d, hd = self.d_model, self.head_dim
        n = 0
        emb = self.vocab_size * d * max(self.num_codebooks, 1)
        n += emb
        if not self.tie_embeddings:
            n += emb
        for spec in self.pattern:
            ln = 0
            if spec.mixer == "attn":
                qkv = d * (self.num_heads + 2 * self.num_kv_heads) * hd
                if self.qkv_bias:
                    qkv += (self.num_heads + 2 * self.num_kv_heads) * hd
                ln += qkv + self.num_heads * hd * d
                if self.qk_norm:
                    ln += 2 * hd
            else:
                di, r, s = self.d_inner, self.dt_rank_, self.ssm_state
                ln += d * 2 * di                     # in_proj
                ln += di * self.ssm_conv + di       # conv
                ln += di * (r + 2 * s)              # x_proj
                ln += r * di + di                    # dt_proj
                ln += di * s + di                    # A_log, D
                ln += di * d                         # out_proj
            if spec.moe:
                ln += d * self.num_experts
                ln += self.num_experts * 3 * d * self.d_ff
            else:
                ln += 3 * d * self.d_ff
            ln += 2 * d                              # two RMSNorm scales
            n += ln * self.num_blocks
        n += d                                       # final norm
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k of E experts)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        moe_layers = sum(s.moe for s in self.pattern) * self.num_blocks
        expert_p = 3 * self.d_model * self.d_ff
        inactive = moe_layers * expert_p * (self.num_experts
                                            - self.num_experts_per_tok)
        return full - inactive


def uniform_pattern(moe: bool = False) -> tuple[LayerSpec, ...]:
    return (LayerSpec(mixer="attn", moe=moe),)


def jamba_pattern() -> tuple[LayerSpec, ...]:
    """Jamba period-8 block: attention at index 4 (1:7 ratio), MoE on every
    other sub-layer (odd indices)."""
    specs = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        specs.append(LayerSpec(mixer=mixer, moe=(i % 2 == 1)))
    return tuple(specs)


def mamba_pattern() -> tuple[LayerSpec, ...]:
    return (LayerSpec(mixer="mamba", moe=False),)
