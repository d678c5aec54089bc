"""gemma2-9b — Gemma 2 9B [arXiv:2408.00118; hf].

42L, d_model=3584, 16H (GQA kv=8), head_dim=256, GeGLU d_ff=14336,
vocab 256000.  Alternating local(sliding-4096)/global attention layers,
attention-logit softcap 50, final-logit softcap 30.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from .common import ParallelismPlan

ARCH_ID = "gemma2-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=42,
        d_model=3584,
        num_heads=16,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=256000,
        head_dim=256,
        mlp_kind="geglu",
        local_global=True,
        sliding_window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
        embed_scale=True,
        tie_embeddings=True,
    )


PLAN = ParallelismPlan(
    tp=16,
    dp_cross_pod=True,
    ocs_links_per_ring_hop=4,
    notes=(
        "Local/global alternation halves attention FLOPs at 32k; long_500k "
        "still skipped — half the layers are full-attention (DESIGN.md §4)."
    ),
)
