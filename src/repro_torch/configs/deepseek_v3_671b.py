"""DeepSeek-V3 671B [arXiv:2412.19437; hf tier].

61L d_model=7168 128H d_ff(per-expert)=2048 vocab=129280,
MLA (q_lora 1536, kv_lora 512, nope 128, rope 64, v 128),
MoE: 1 shared + 256 routed, top-8, first 3 layers dense (d_ff 18432).
"""
from repro_torch.configs.base import LMConfig, register

FULL = LMConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,          # MLA: all heads share the compressed latent
    head_dim=128,
    d_ff=18432,              # dense-layer FFN width (first 3 layers)
    vocab=129280,
    moe_experts=256,
    moe_top_k=8,
    moe_shared_experts=1,
    moe_d_ff=2048,
    first_dense_layers=3,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    max_seq=524288,
    rope_theta=10000.0,
)

SMOKE = LMConfig(
    name="deepseek-v3-671b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    moe_experts=8,
    moe_top_k=2,
    moe_shared_experts=1,
    moe_d_ff=32,
    first_dense_layers=1,
    mla=True,
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    max_seq=128,
)

register(FULL, SMOKE)
