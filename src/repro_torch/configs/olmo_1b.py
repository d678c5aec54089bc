"""olmo-1b — OLMo 1B [arXiv:2402.00838; hf].

16L, d_model=2048, 16H (MHA, kv=16), d_ff=8192, vocab 50304.
OLMo uses non-parametric LayerNorm (no scale/bias) and SwiGLU.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from .common import ParallelismPlan

ARCH_ID = "olmo-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        norm_kind="nonparametric",
        tie_embeddings=True,
    )


PLAN = ParallelismPlan(
    tp=8,
    dp_cross_pod=True,
    ocs_links_per_ring_hop=2,
    notes="Smallest dense LM; DP-dominant, used as the fast CI cell.",
)
