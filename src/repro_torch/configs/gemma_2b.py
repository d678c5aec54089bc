"""gemma-2b — Gemma 2B [arXiv:2403.08295; hf].

18L, d_model=2048, 8H with MQA (kv=1), head_dim=256, GeGLU d_ff=16384,
vocab 256000.  Gemma scales embeddings by sqrt(d_model) and ties the LM head.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from .common import ParallelismPlan

ARCH_ID = "gemma-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,  # MQA
        d_ff=16384,
        vocab_size=256000,
        head_dim=256,
        mlp_kind="geglu",
        embed_scale=True,
        tie_embeddings=True,
    )


PLAN = ParallelismPlan(
    tp=8,
    dp_cross_pod=True,
    ocs_links_per_ring_hop=4,
    notes=(
        "MQA (kv=1): the single KV head replicates under TP; q-heads shard. "
        "256k vocab makes the embedding/LM-head the TP hot spot."
    ),
)
