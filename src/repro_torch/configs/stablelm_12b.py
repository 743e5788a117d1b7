"""StableLM-2 12B [hf:stabilityai/stablelm-2-12b family; hf tier].

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
"""
from repro_torch.configs.base import LMConfig, register

FULL = LMConfig(
    name="stablelm-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab=100352,
    max_seq=524288,
    rope_theta=10000.0,
)

SMOKE = LMConfig(
    name="stablelm-12b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    max_seq=128,
)

register(FULL, SMOKE)
