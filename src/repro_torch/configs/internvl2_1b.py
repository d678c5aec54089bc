"""internvl2-1b — InternVL2-1B [arXiv:2404.16821; hf].

Backbone: Qwen2-0.5B-style LM — 24L, d_model=896, 14H (GQA kv=2),
d_ff=4864, vocab 151655, QKV bias.  The InternViT vision frontend is a STUB
per the assignment: ``input_specs()`` supplies precomputed patch embeddings
(256 tokens × 1024 dims) projected into the LM.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from .common import ParallelismPlan

ARCH_ID = "internvl2-1b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        head_dim=64,
        qkv_bias=True,  # Qwen2 backbone
        vision_tokens=256,
        vision_dim=1024,
        tie_embeddings=True,
    )


PLAN = ParallelismPlan(
    tp=2,  # tiny model: 14 heads, d_model=896 → little TP headroom
    dp_cross_pod=True,
    ocs_links_per_ring_hop=2,
    notes=(
        "Small VLM; DP-dominant. 14 q-heads do not divide the model axis — "
        "sharding degrades those dims to replicated (divisibility guard)."
    ),
)
