"""StableLM 3B [hf:stabilityai/stablelm family; unverified tier].

32L d_model=2560 32H (MHA kv=32) d_ff=6912 vocab=50304.
"""
from repro_torch.configs.base import LMConfig, register

FULL = LMConfig(
    name="stablelm-3b",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab=50304,
    max_seq=524288,
    rope_theta=10000.0,
)

SMOKE = LMConfig(
    name="stablelm-3b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=256,
    max_seq=128,
)

register(FULL, SMOKE)
