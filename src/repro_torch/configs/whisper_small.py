"""whisper-small — Whisper small [arXiv:2212.04356; unverified].

Encoder-decoder, 12L each, d_model=768, 12H (MHA), d_ff=3072, vocab 51865.
The conv mel frontend is a STUB per the assignment: ``input_specs()``
supplies precomputed frame embeddings (1500 × d_model).  Decoder positions
are learned; the table is sized for the decode_32k dry-run cell.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from .common import ParallelismPlan

ARCH_ID = "whisper-small"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        head_dim=64,
        mlp_kind="gelu",
        norm_kind="layernorm",
        use_rope=False,
        is_encoder_decoder=True,
        encoder_layers=12,
        encoder_seq=1500,
        max_target_positions=32768,  # sized for the decode_32k dry-run cell
        tie_embeddings=True,
    )


PLAN = ParallelismPlan(
    tp=4,
    dp_cross_pod=True,
    ocs_links_per_ring_hop=1,
    notes=(
        "Enc-dec: decode = decoder self-attn + cross-attn over the cached "
        "encoder output; 12 heads limit TP to 4 (divisibility guard)."
    ),
)
