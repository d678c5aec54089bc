"""grok-1-314b — Grok-1 [hf:xai-org/grok-1; unverified].

64L, d_model=6144, 48H (GQA kv=8), d_ff=32768, vocab 131072,
MoE 8 experts top-2.  Grok-1 softcaps attention logits at 30.
"""
from __future__ import annotations

from ..models.config import ModelConfig, MoEConfig
from .common import ParallelismPlan

ARCH_ID = "grok-1-314b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=64,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        head_dim=128,
        moe=MoEConfig(num_experts=8, top_k=2, d_expert=32768),
        attn_softcap=30.0,
        tie_embeddings=True,
    )


PLAN = ParallelismPlan(
    tp=16,
    ep=8,  # 8 experts ≤ model-axis width; EP in-pod
    dp_cross_pod=True,
    ocs_links_per_ring_hop=8,
    notes="8-expert top-2 MoE; EP in-pod, wide d_expert makes TP dominant.",
)
