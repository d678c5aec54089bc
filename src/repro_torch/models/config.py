"""Model configuration schema covering all assigned architecture families.

The PyTorch twin of ``repro.models.config``: the same frozen dataclasses and
the same ``param_counts``, with ``pdtype``/``cdtype`` returning
``torch.dtype``s.  One config drives every family: the decoder-only ones
(``models/transformer.py``), whisper's encoder-decoder
(``models/whisper.py``) and the VLM (``models/vlm.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int  # per-expert FFN hidden size
    num_shared: int = 0  # shared (always-on) experts, deepseek-style
    first_dense: int = 0  # leading layers that stay dense
    every: int = 1  # MoE every N layers (jamba: 2), else dense MLP
    capacity_factor: float = 1.25
    router: str = "softmax"  # "softmax" | "sigmoid" (deepseek-v3)
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64  # low-rank size of the data-dependent decay (Finch)
    tokenshift_lora: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # ---- attention flavor -------------------------------------------------
    attn_kind: str = "gqa"  # gqa | mla | none (ssm)
    qkv_bias: bool = False
    use_rope: bool = True  # False: absolute position embeddings (whisper)
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    logit_softcap: Optional[float] = None  # gemma2: 30.0
    sliding_window: Optional[int] = None  # gemma2: 4096 on local layers
    local_global: bool = False  # alternate local(sliding)/global layers
    mla: Optional[MLAConfig] = None

    # ---- FFN / MoE ---------------------------------------------------------
    mlp_kind: str = "swiglu"  # swiglu | geglu | gelu
    moe: Optional[MoEConfig] = None

    # ---- norm / embeddings --------------------------------------------------
    norm_kind: str = "rmsnorm"  # rmsnorm | layernorm | nonparametric
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma multiplies embeds by sqrt(d_model)

    # ---- hybrid / ssm --------------------------------------------------------
    # pattern of a repeating block, e.g. jamba: ("attn",)+("mamba",)*7
    block_pattern: Optional[Tuple[str, ...]] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # ---- encoder-decoder (whisper) -------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper: frames after conv stub
    max_target_positions: int = 448  # learned decoder position table size

    # ---- multimodal stub (vlm) -------------------------------------------------
    vision_tokens: int = 0  # prefix patch embeddings per sample
    vision_dim: int = 0  # raw patch embedding dim (projected into d_model)

    # ---- multi-token prediction (deepseek-v3) -----------------------------------
    mtp_depth: int = 0

    # ---- numerics ---------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # ---- remat ----------------------------------------------------------------
    remat_policy: str = "nothing"  # nothing | full | dots

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.attn_kind == "mla" and self.mla is None:
            object.__setattr__(self, "mla", MLAConfig())

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (roofline MODEL_FLOPS) ------------------------------
    def param_counts(self) -> Tuple[int, int]:
        """(total_params, active_params) — active excludes non-routed experts."""
        d, v = self.d_model, self.vocab_size
        embed = v * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.attn_kind == "mla":
                m = self.mla
                qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * m.q_lora_rank + m.q_lora_rank * self.num_heads * qk_dim
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * self.num_heads * (
                    m.qk_nope_head_dim + m.v_head_dim
                )
                p += self.num_heads * m.v_head_dim * d
                return p
            if self.attn_kind == "none":
                return 0
            hd = self.head_dim
            return d * hd * (self.num_heads + 2 * self.num_kv_heads) + (
                self.num_heads * hd * d
            )

        def mlp_params(dff: int) -> int:
            mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
            return mult * d * dff

        def mamba_params() -> int:
            mc = self.mamba or MambaConfig()
            d_in = mc.expand * d
            dt_rank = mc.dt_rank or -(-d // 16)
            p = d * 2 * d_in  # in_proj (x and z)
            p += d_in * mc.d_conv  # conv
            p += d_in * (dt_rank + 2 * mc.d_state)  # x -> dt,B,C
            p += dt_rank * d_in  # dt proj
            p += d_in * mc.d_state + d_in  # A, D
            p += d_in * d  # out proj
            return p

        def rwkv_params() -> int:
            rc = self.rwkv or RWKVConfig()
            p = 4 * d * d + d * d  # r,k,v,g + output
            p += 2 * d * rc.decay_lora + 6 * d * rc.tokenshift_lora * 2
            p += d  # u (bonus)
            p += d * self.d_ff + self.d_ff * d + d * d  # channel mix
            return p

        total = embed
        active = embed
        pattern = self.block_pattern or ("attn",) * 1
        for layer in range(self.num_layers):
            kind = pattern[layer % len(pattern)] if self.block_pattern else "attn"
            if kind == "attn":
                total += attn_params()
                active += attn_params()
            elif kind == "mamba":
                total += mamba_params()
                active += mamba_params()
            elif kind == "rwkv":
                total += rwkv_params()
                active += rwkv_params()
            if kind == "rwkv":
                continue  # rwkv_params already includes channel mix
            if self.moe is not None and layer >= self.moe.first_dense and (
                layer % self.moe.every == 0
            ):
                e = self.moe
                total += e.num_experts * mlp_params(e.d_expert) + d * e.num_experts
                total += e.num_shared * mlp_params(e.d_expert)
                active += (e.top_k + e.num_shared) * mlp_params(e.d_expert)
                active += d * e.num_experts
            else:
                total += mlp_params(self.d_ff)
                active += mlp_params(self.d_ff)
        if self.is_encoder_decoder:
            # decoder cross-attention blocks
            total += self.num_layers * attn_params()
            active += self.num_layers * attn_params()
            # encoder stack
            enc = self.encoder_layers * (attn_params() + mlp_params(self.d_ff))
            total += enc
            active += enc
        return int(total), int(active)
