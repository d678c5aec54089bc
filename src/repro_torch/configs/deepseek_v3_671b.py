"""deepseek-v3-671b — DeepSeek-V3 [arXiv:2412.19437; hf].

61L, d_model=7168, 128 heads (MLA), MoE 1 shared + 256 routed top-8 with
d_expert=2048, vocab 129280, MTP depth 1.  The assignment's ``d_ff=2048`` is
the *expert* FFN width (HF ``moe_intermediate_size``); the three leading
dense layers use the HF ``intermediate_size`` 18432.

Paper mapping: the heaviest EP all-to-all of the pool — exactly the traffic
the paper sizes pods for (§3.1: "each Pod could host hundreds of GPUs, which
is large enough to accommodate the MoE Parallelism (EP) ... within a Pod").
Most representative cell for §Perf.
"""
from __future__ import annotations

from ..models.config import MLAConfig, ModelConfig, MoEConfig
from .common import ParallelismPlan

ARCH_ID = "deepseek-v3-671b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=128,
        num_kv_heads=128,
        d_ff=18432,  # dense (first-3) layers; experts use d_expert=2048
        vocab_size=129280,
        head_dim=128,
        attn_kind="mla",
        mla=MLAConfig(
            q_lora_rank=1536,
            kv_lora_rank=512,
            qk_nope_head_dim=128,
            qk_rope_head_dim=64,
            v_head_dim=128,
        ),
        moe=MoEConfig(
            num_experts=256,
            top_k=8,
            d_expert=2048,
            num_shared=1,
            first_dense=3,
            router="sigmoid",
        ),
        tie_embeddings=False,
        mtp_depth=1,
    )


PLAN = ParallelismPlan(
    tp=16,
    ep=16,  # 256 experts / 16 model-axis shards = 16 experts per device
    dp_cross_pod=True,
    ocs_links_per_ring_hop=8,  # largest model → widest DP ring links
    notes=(
        "EP all-to-all confined in-pod on the model axis; DP gradient ring "
        "across pods over the OCS core. The paper's motivating workload."
    ),
)
