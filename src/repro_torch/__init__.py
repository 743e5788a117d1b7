"""PyTorch/CUDA port of the MadEye fleet system (paper §3.3-§3.4).

A second package beside the JAX reference (`repro`): the same camera-side
loop — scene advance, oracle pass, search-coupled shortlist, fused
crop->token rasterization, one ViT-detector forward, controller step —
as eager PyTorch over a [F, ...] fleet axis, with the hot kernels
(`shape_search` and `budget_walk` for the controller's search,
`cell_rasterize`, `crop_patchify`) hand-written in CUDA C++ for Hopper
(`csrc/`, built with nvcc at first use and loaded through ctypes).

    from repro_torch.fleet import FleetRunSpec, run_fleet
    result = run_fleet(FleetRunSpec(provider="detector", n_cameras=64))

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper uses its plain
PyTorch version. The package imports nothing of `repro` and no JAX:
host-side pieces it needs are kept as numpy copies under `core/`.
"""
