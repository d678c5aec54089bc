"""qwen2.5-14b — Qwen2.5-14B [hf:Qwen/Qwen2.5-14B; hf].

48L, d_model=5120, 40H (GQA kv=8), d_ff=13824, vocab 152064, QKV bias,
untied embeddings.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from .common import ParallelismPlan

ARCH_ID = "qwen2.5-14b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=13824,
        vocab_size=152064,
        head_dim=128,
        qkv_bias=True,
        tie_embeddings=False,
    )


PLAN = ParallelismPlan(
    tp=8,
    dp_cross_pod=True,
    ocs_links_per_ring_hop=4,
    notes="Standard dense GQA; TP in-pod, DP ring across pods.",
)
