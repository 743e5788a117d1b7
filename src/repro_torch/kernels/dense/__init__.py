from repro_torch.kernels.dense.ops import dense, dense_plain
