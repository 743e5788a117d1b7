"""Kimi K2 — trillion-param MoE [arXiv:2501.kimi2; unverified tier].

61L d_model=7168 64H (GQA kv=8) d_ff(moe per-expert)=2048 vocab=163840,
MoE 384 experts top-8 (+1 shared), first layer dense (DeepSeek-V3-style stack).
"""
from repro_torch.configs.base import LMConfig, register

FULL = LMConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=18432,              # dense-layer FFN width (first dense layer)
    vocab=163840,
    moe_experts=384,
    moe_top_k=8,
    moe_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=1,
    mla=False,               # K2 uses GQA-style attention w/ 64 heads, kv=8
    max_seq=524288,
    rope_theta=50000.0,
)

SMOKE = LMConfig(
    name="kimi-k2-1t-a32b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    moe_experts=8,
    moe_top_k=2,
    moe_shared_experts=1,
    moe_d_ff=32,
    first_dense_layers=1,
    max_seq=128,
)

register(FULL, SMOKE)
