"""How close a detector's scores come to its decision boundaries on the
anchor's windows: run_fleet(provider="detector") at full madeye-approx
width, fused and exhaustive (shortlist_k = 75, every window scored),
with the weights chip_smoke.py's anchor uses (numpy's default_rng from
--seed, threshold 0.3), and every decode's raw cell scores recorded.

    PYTHONPATH=src python tools/anchor_scores.py [--cameras 4]
        [--steps 2] [--seed 0] [--device cuda|cpu]

Prints one JSON line: the windows scored, those holding a detection
within 1e-4 of a score threshold (the anchor's gate allows 0.1%), those
within 1e-4 of the top-k cut or a class tie, quantiles of the k-th and
the top score, and the patch embedding's sum (the same weights give the
same sum under any PyTorch). The card by default; small fleets run on
the CPU (`--device cpu`) in seconds.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.fleet.api import FleetRunSpec, run_fleet  # noqa: E402
from repro_torch.models import detector  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cameras", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    cfg = get_config("madeye-approx")
    weights = detector.detector_init(np.random.default_rng(a.seed), cfg)
    raw = []
    decode = detector._decode_detections

    def recording(c, cls_logits, box_raw, obj_logits):
        raw.append(tuple(x.cpu() for x in chip_smoke.raw_scores(
            cls_logits, obj_logits)))
        return decode(c, cls_logits, box_raw, obj_logits)

    detector._decode_detections = recording
    try:
        run_fleet(FleetRunSpec(
            provider="detector", n_cameras=a.cameras, n_steps=a.steps,
            shortlist_k=75, provider_kwargs={
                "det_cfg": cfg, "det_params": weights,
                "thresh": chip_smoke.FRESH_THRESH}), device=a.device)
    finally:
        detector._decode_detections = decode
    score = torch.cat([s for s, _ in raw])
    margin = torch.cat([m for _, m in raw])
    t = chip_smoke.FRESH_THRESH
    near_t, near_other = chip_smoke.near_boundary(
        score, margin, (t, t + 0.05), cfg.max_boxes)
    ranked = score.sort(dim=-1, descending=True).values
    q = [0.0, 0.01, 0.5, 0.99, 1.0]
    print(json.dumps({
        "windows": int(score.shape[0]),
        "near_threshold": int(near_t.sum()),
        "near_cut_or_tie": int(near_other.sum()),
        "kth_score_quantiles": [float(x) for x in np.quantile(
            ranked[:, cfg.max_boxes - 1].numpy(), q)],
        "top_score_quantiles": [float(x) for x in np.quantile(
            ranked[:, 0].numpy(), q)],
        "patch_embed_sum": float(
            weights["backbone"]["vit"]["patch_embed"]["w"].sum()),
        "seed": a.seed, "cameras": a.cameras, "steps": a.steps,
        "device": a.device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
