"""The oracle pass's spread round-off on the card: the kernel's and the
plain version's float32 variances against a float64 sum of the same
per-object terms, at the card tests' shapes.

    PYTHONPATH=src python tools/spread_error.py

For F = 1024 cameras, M = 22, 128 and 256 object slots and 1, 4 and 8
workload pairs (the seeded states of tests/test_torch_kernels_cuda.py's
test_oracle_pass_kernel_on_card), prints per case the largest |variance
- float64 variance| of the kernel and of the plain version (each variance
read as spread^2), the largest kernel - plain difference and the windows
where it passes 1e-2; then the card's `nvidia-smi` name and power limit
and one JSON line with every case.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))

from repro_torch.kernels.oracle_pass.ops import (  # noqa: E402
    oracle_pass,
    oracle_pass_plain,
)
from repro_torch.scene.scene import SceneSpec  # noqa: E402
from torch_kernel_inputs import (  # noqa: E402
    oracle_args,
    oracle_state,
    oracle_variance_f64,
    spread_errors,
)


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rows = []
    for m in (22, 128, 256):
        for p in (1, 4, 8):
            f = 1024
            people = 14 if m == 22 else 100
            spec = SceneSpec(max_people=people, max_cars=m - people,
                             miss_rate=0.12)
            st = oracle_state(f, people, m - people, f + m + p)
            args, kw = oracle_args(st, spec, p, device=dev)
            got = oracle_pass(*args, **kw)
            want = oracle_pass_plain(*args, **kw)
            var64 = oracle_variance_f64(args, kw)
            k_err, p_err, kp, over = spread_errors(got, want, var64)
            rows.append(dict(f=f, m=m, p=p, kernel_err=k_err,
                             plain_err=p_err, kernel_minus_plain=kp,
                             windows_over_1e2=over,
                             windows=int(var64.numel()),
                             var64_max=float(var64.max())))
            print(f"F={f} M={m} P={p}: |var - float64| kernel {k_err:.6e} "
                  f"plain {p_err:.6e}; |kernel - plain| {kp:.6e}, over "
                  f"1e-2 on {over} of {var64.numel()} windows")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(json.dumps({"spread_error": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
