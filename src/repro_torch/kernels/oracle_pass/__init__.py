from repro_torch.kernels.oracle_pass.ops import (
    oracle_pass,
    oracle_pass_plain,
)
