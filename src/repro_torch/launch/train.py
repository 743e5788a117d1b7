"""Training launcher: the fault-tolerant train loop on the CUDA card.

Restores the latest checkpoint if there is one, then runs the train
loop with heartbeats, the straggler deadline and atomic checkpoints
(train/fault.py, train/checkpoint.py: the reference's on-disk format,
so either side resumes the other's run). The data are the learnable
synthetic batches of `synthetic_batch`. `--device` picks where it runs:
`cuda` (the default; raises without a card) or `cpu`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch vit-b16 \
      --steps 6 --batch 8 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --smoke --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.devices import resolve_device
from repro_torch.scene import prng
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer
from repro_torch.train.fault import (
    HeartbeatTable,
    RestartPolicy,
    deadline_for_step,
)


def synthetic_batch(cfg, shape: ShapeSpec, key: torch.Tensor) -> dict:
    """Learnable synthetic batch matching trainer.batch_specs, on the
    key's device, drawn as the reference draws it.

    LM tokens follow t[i] = (start + 7 i) mod V with labels = the next
    token, so the loss has real signal to descend (uniform-random tokens
    would floor at ln(V)). Each entry's key is fold_in(key,
    abs(hash(name)) % 2**31), the reference's rule: string hashes are
    randomised per process, so two processes draw the same batch only
    under the same PYTHONHASHSEED."""
    specs = trainer.batch_specs(cfg, shape)
    dev = key.device
    out = {}
    for name, spec in specs.items():
        k = prng.fold_in(key, abs(hash(name)) % (2 ** 31))
        if name == "tokens":
            v = cfg.vocab
            start = prng.randint(k, spec.shape[:-1] + (1,), 0, v)
            steps = torch.arange(spec.shape[-1], device=dev)
            out[name] = ((start + 7 * steps) % v).to(spec.dtype)
        elif name == "labels" and "tokens" in specs:
            out[name] = None      # filled below from tokens
        elif spec.dtype == torch.int32:
            hi = getattr(cfg, "vocab", getattr(cfg, "n_classes", 2))
            out[name] = prng.randint(k, spec.shape, 0, hi).to(spec.dtype)
        elif spec.dtype == torch.bool:
            out[name] = torch.ones(spec.shape, dtype=torch.bool, device=dev)
        else:
            out[name] = prng.normal(k, spec.shape).to(spec.dtype) * 0.1
    if out.get("labels", 0) is None:
        out["labels"] = torch.roll(out["tokens"], -1, dims=-1)
    return out


def train_loop(cfg, shape: ShapeSpec, *, steps: int, lr: float,
               ckpt_dir: str | None, ckpt_every: int = 50,
               log_every: int = 5, device=None):
    """Train `cfg` from fresh weights (torch.Generator seed 0 on the
    device), or from the newest checkpoint in `ckpt_dir`, up to `steps`;
    checkpoint every `ckpt_every` steps and at the end. Returns (params,
    opt_state)."""
    dev = resolve_device(device)
    # the loop never reads a step's inputs again: donate them
    ts = trainer.make_train_step(cfg, lr=lr, donate=True)
    key = prng.PRNGKey(0, device=dev)
    params = ts.init_params(torch.Generator(device=dev).manual_seed(0), dev)
    opt = ts.init_opt(params)
    start = 0
    if ckpt_dir:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            (params, opt), manifest = ckpt.restore(
                ckpt_dir, last, (params, opt))
            start = manifest["step"]
            print(f"restored checkpoint step {start}")

    hb = HeartbeatTable(n_hosts=1)
    policy = RestartPolicy()
    history = []

    for step in range(start, steps):
        t0 = time.time()
        batch = synthetic_batch(cfg, shape, prng.fold_in(key, step))
        params, opt, metrics = ts.step(params, opt, batch,
                                       prng.fold_in(key, 10 ** 6 + step))
        loss = float(metrics["loss"])
        dt = time.time() - t0
        history.append(dt)
        hb.beat(0, dt)

        if step % log_every == 0:
            ddl = deadline_for_step(history[:-1])
            flag = " [STRAGGLER]" if dt > ddl and len(history) > 10 else ""
            print(f"step {step:5d} loss {loss:.4f} "
                  f"grad {float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms"
                  f"{flag}", flush=True)
        if ckpt_dir and step and step % ckpt_every == 0:
            path = ckpt.save(ckpt_dir, step, (params, opt))
            ckpt.prune_old(ckpt_dir)
            print(f"checkpointed -> {path}", flush=True)

        dead = hb.dead_hosts()
        if dead:
            action = policy.decide(len(dead), hb.n_hosts, model_parallel=1)
            print(f"dead hosts {dead} -> {action}")

    if ckpt_dir:
        ckpt.save(ckpt_dir, steps, (params, opt))
    return params, opt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "lm":
        shape = ShapeSpec("cli", "train", seq_len=args.seq,
                          global_batch=args.batch)
    else:
        shape = ShapeSpec("cli", "train", img_res=cfg.img_res,
                          global_batch=args.batch)
    train_loop(cfg, shape, steps=args.steps, lr=args.lr,
               ckpt_dir=args.ckpt_dir, device=args.device)


if __name__ == "__main__":
    main()
