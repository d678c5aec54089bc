"""rwkv6-1.6b — RWKV-6 "Finch" 1.6B [arXiv:2404.05892; unverified].

24L, d_model=2048, attention-free (WKV linear recurrence with
data-dependent decay), channel-mix d_ff=7168, vocab 65536, head_dim=64
(32 WKV heads).
"""
from __future__ import annotations

from ..models.config import ModelConfig, RWKVConfig
from .common import ParallelismPlan

ARCH_ID = "rwkv6-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        num_layers=24,
        d_model=2048,
        num_heads=32,  # d_model / rwkv.head_dim
        num_kv_heads=32,
        d_ff=7168,
        vocab_size=65536,
        attn_kind="none",
        block_pattern=("rwkv",),
        rwkv=RWKVConfig(head_dim=64),
        norm_kind="layernorm",
        tie_embeddings=False,
    )


PLAN = ParallelismPlan(
    tp=8,
    dp_cross_pod=True,
    seq_shard_long=True,  # O(1) recurrent state → long_500k native
    ocs_links_per_ring_hop=2,
    notes=(
        "Attention-free: the paper's EP/TP-in-pod reasoning has no attention "
        "traffic to confine, but the control plane is agnostic — it only "
        "sees the DP link demand. Technique fully applicable (DESIGN.md §4)."
    ),
)
