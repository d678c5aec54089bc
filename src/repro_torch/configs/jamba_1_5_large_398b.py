"""jamba-1.5-large-398b — Jamba-1.5 Large [arXiv:2403.19887; hf].

72L, d_model=8192, 64H (GQA kv=8), d_ff=24576, vocab 65536.
Hybrid Mamba+attention at 1:7 interleave (1 attn per 8-layer block),
MoE 16 experts top-2 on every other layer.
"""
from __future__ import annotations

from ..models.config import MambaConfig, ModelConfig, MoEConfig
from .common import ParallelismPlan

ARCH_ID = "jamba-1.5-large-398b"


def _pattern():
    return ("attn",) + ("mamba",) * 7


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        num_layers=72,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=65536,
        head_dim=128,
        block_pattern=_pattern(),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576, every=2),
        tie_embeddings=True,
    )


PLAN = ParallelismPlan(
    tp=16,
    ep=16,
    dp_cross_pod=True,
    seq_shard_long=True,  # SSM state is O(1)/token → long_500k native
    ocs_links_per_ring_hop=8,
    notes=(
        "Hybrid: Mamba layers have O(1) state → long_500k runs; attention "
        "layers (1:7) keep a 500k KV cache sharded over the data axis."
    ),
)
