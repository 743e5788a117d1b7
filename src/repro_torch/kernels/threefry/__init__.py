from repro_torch.kernels.threefry import ops
