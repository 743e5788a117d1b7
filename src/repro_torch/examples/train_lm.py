"""Train a reduced LM end to end with the full training substrate: AdamW
with its global-norm clip, fault-tolerant atomic checkpoints with
restart, the straggler watchdog.

    python -m repro_torch.examples.train_lm [--steps 200] [--device cpu]
        [--ckpt-dir DIR]

The stablelm-3b SMOKE config on synthetic token streams
(`launch.train.synthetic_batch`). Checkpoints go to a new temporary
directory, removed at the end, unless `--ckpt-dir` names one: then a run
killed midway and started again resumes from its last checkpoint.
Prints the loss on a held-out batch before and after training.
"""
import argparse
import math
import shutil
import tempfile
import time

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.devices import resolve_device
from repro_torch.launch.train import synthetic_batch, train_loop
from repro_torch.models.transformer import lm_loss
from repro_torch.scene import prng
from repro_torch.train import trainer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None,
                    help="keep checkpoints here (default: a temporary "
                         "directory, removed at the end)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config("stablelm-3b")
    shape = ShapeSpec("example", "train", seq_len=64, global_batch=8)
    held_out = synthetic_batch(cfg, shape, prng.PRNGKey(123, device=dev))

    def held_out_loss(params):
        with torch.no_grad():
            return float(lm_loss(params, cfg, held_out["tokens"],
                                 held_out["labels"]))

    # the weights train_loop starts from (torch.Generator seed 0)
    init = trainer.make_train_step(cfg).init_params(
        torch.Generator(device=dev).manual_seed(0), dev)
    init_loss = held_out_loss(init)
    del init

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_lm_ckpt_")
    print(f"training {cfg.name} ({cfg.n_layers}L d{cfg.d_model}) "
          f"for {args.steps} steps, ckpt -> {ckpt_dir}", flush=True)
    t0 = time.time()
    try:
        params, _ = train_loop(cfg, shape, steps=args.steps, lr=3e-3,
                               ckpt_dir=ckpt_dir, ckpt_every=50,
                               log_every=25, device=dev)
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"done in {time.time()-t0:.0f}s")
    print(f"held-out loss {held_out_loss(params):.3f} (at init "
          f"{init_loss:.3f}; uniform over the vocab "
          f"{math.log(cfg.vocab):.2f})")


if __name__ == "__main__":
    main()
