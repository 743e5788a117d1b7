"""Per-(architecture x input-shape) step builders for the dry run and the
real launchers.

`build_cell(arch, shape_name, mesh)` returns a CellSpec:
  fn            — the pure step (train step / prefill / decode / forward
                  / sampler), called on tensors or DTensors
  args          — shape-only stand-ins for every input: parameters and
                  optimizer states on the meta device, the batch, tokens,
                  caches and the key as `TensorSpec`s (no memory; what
                  `jax.ShapeDtypeStruct` is to the reference)
  in_shardings / out_shardings — trees of `distributed.sharding.
                  NamedSharding` (the mesh a DeviceMesh or an
                  AbstractMesh)
  make_args     — (gen, device) -> the same args as real tensors:
                  parameters by the config's own init from `gen` (a
                  numpy Generator), inputs drawn from it inside their
                  valid ranges; what a real launcher passes to fn

Conventions per family (the reference's):
  LM     train_*   -> full train step (fwd + bwd + optimizer update)
         prefill_* -> last-token logits + filled KV cache
         decode_*  -> one-token serve step against a seq_len cache
         long_500k -> decode with a sequence-sharded (SP) cache
  vision train shapes -> train step; serve_* -> forward
  diff   train_*   -> train step; gen_* -> full sampler loop (steps fwds)

Departures from the reference: the sequence-parallel cutoff is the
`sp_threshold` argument (the reference reads REPRO_SP_THRESHOLD); the
key is the port's threefry key, two uint32 words in int64
(scene/prng.py); a decode cell decodes the cache's last position (the
port's cache length is a host int; the reference's traced length costs
the same at any value, since the masked attention reads the whole
cache).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs import get_config, get_shape
from repro_torch.configs.base import (
    DiffusionConfig,
    LMConfig,
    ShapeSpec,
    VisionConfig,
)
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import NamedSharding
from repro_torch.models import diffusion as diff
from repro_torch.models import dit as dit_mod
from repro_torch.models import kvcache as kvc
from repro_torch.models import mmdit as mmdit_mod
from repro_torch.models import moe_lm, transformer
from repro_torch.models import swin as swin_mod
from repro_torch.models import vit as vit_mod
from repro_torch.models.layout import TensorSpec
from repro_torch.models.mmdit import TXT_TOKENS
from repro_torch.scene import prng
from repro_torch.train import trainer

KEY_SDS = TensorSpec((2,), torch.int64)

# giant-MoE training uses Adafactor (factored second moment); dense fits
# AdamW comfortably
_ADAFACTOR_ARCHS = {"kimi-k2-1t-a32b", "deepseek-v3-671b"}


@dataclass
class CellSpec:
    arch: str
    shape: str
    fn: Callable
    args: tuple
    in_shardings: Any
    out_shardings: Any
    static_kwargs: dict
    make_args: Callable


def _input(spec: TensorSpec, gen, device, high: int = 2):
    """`spec` itself when gen is None; else a tensor of its shape and
    dtype on `device`: standard normals, integers in [0, high), or
    True."""
    if gen is None:
        return spec
    if spec.dtype.is_floating_point:
        a = gen.standard_normal(spec.shape).astype(np.float32)
    elif spec.dtype == torch.bool:
        a = np.ones(spec.shape, bool)
    else:
        a = gen.integers(0, high, spec.shape)
    return torch.as_tensor(a, device=device).to(spec.dtype)


def _key(gen, device):
    if gen is None:
        return KEY_SDS
    return prng.PRNGKey(int(gen.integers(2 ** 31)), device=device)


def _params(init, gen, device):
    """init(gen, device) on the meta device (shapes only) when gen is
    None."""
    return init(gen, "meta" if gen is None else device)


def _replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def _metrics_sh(mesh) -> dict:
    return {"loss": _replicated(mesh), "grad_norm": _replicated(mesh)}


# ---------------------------------------------------------------------------
# train cells (every family)
# ---------------------------------------------------------------------------

def _train_cell(cfg, shape: ShapeSpec, mesh, optimizer: str = "adamw"
                ) -> CellSpec:
    ts = trainer.make_train_step(cfg, optimizer=optimizer)
    high = getattr(cfg, "vocab", getattr(cfg, "n_classes", 2))

    def make_args(gen, device):
        params = _params(ts.init_params, gen, device)
        batch = {k: _input(s, gen, device, high)
                 for k, s in ts.batch_spec(shape).items()}
        return params, ts.init_opt(params), batch, _key(gen, device)

    args = make_args(None, None)
    p_sh = shd.param_shardings(args[0], mesh)
    o_sh = shd.opt_shardings(args[1], mesh)
    b_sh = shd.batch_shardings(args[2], mesh)
    return CellSpec(cfg.name, shape.name, ts.step, args,
                    (p_sh, o_sh, b_sh, _replicated(mesh)),
                    (p_sh, o_sh, _metrics_sh(mesh)), {}, make_args)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_init(cfg: LMConfig):
    init = moe_lm.moe_lm_init if cfg.moe_experts else transformer.lm_init
    return lambda gen, device: init(gen, cfg, device)


def _lm_cell(cfg: LMConfig, shape: ShapeSpec, mesh,
             sp_threshold: int) -> CellSpec:
    moe = bool(cfg.moe_experts)
    if shape.kind == "train":
        return _train_cell(cfg, shape, mesh, "adafactor"
                           if cfg.name in _ADAFACTOR_ARCHS else "adamw")
    init = _lm_init(cfg)
    dp = shd.spec_entry(shd.dp_axes(mesh))
    b = shape.global_batch

    if shape.kind == "prefill":
        if moe:
            fn = kvc.mla_prefill if cfg.mla else kvc.moe_gqa_prefill
        else:
            fn = kvc.gqa_prefill
        tokens = TensorSpec((b, shape.seq_len), torch.int32)

        def make_args(gen, device):
            return (_params(init, gen, device),
                    _input(tokens, gen, device, cfg.vocab))

        def step(params, tokens, _fn=fn):
            return _fn(params, cfg, tokens, max_seq=shape.seq_len,
                       last_only=True)
        args = make_args(None, None)
        p_sh = shd.param_shardings(args[0], mesh)
        t_sh = shd.batch_shardings({"t": tokens}, mesh)["t"]
        cache_sh = shd.kvcache_shardings(
            kvc.cache_specs(cfg, b, shape.seq_len), mesh)
        logits_sh = NamedSharding(mesh, (dp, None, "model"))
        return CellSpec(cfg.name, shape.name, step, args, (p_sh, t_sh),
                        (logits_sh, cache_sh), {}, make_args)

    # decode cells (decode_32k, long_500k): the cache's sequence axis is
    # sharded over `model` from sp_threshold on (sequence parallelism)
    seq_parallel = shape.seq_len >= sp_threshold
    if moe:
        step_fn = kvc.mla_decode_step if cfg.mla else kvc.moe_gqa_decode_step
    else:
        step_fn = kvc.gqa_decode_step
    cache = kvc.cache_specs(cfg, b, shape.seq_len)
    token = TensorSpec((b, 1), torch.int32)
    position = shape.seq_len - 1

    def make_args(gen, device):
        if gen is None:
            c = cache
        else:
            c = type(cache)(*(
                torch.zeros(s.shape, dtype=s.dtype, device=device)
                for s in cache))
        return (_params(init, gen, device),
                _input(token, gen, device, cfg.vocab), c)

    def step(params, tok, cache, _fn=step_fn):
        return _fn(params, cfg, tok, cache._replace(length=position))
    args = make_args(None, None)
    p_sh = shd.param_shardings(args[0], mesh)
    tok_sh = shd.batch_shardings({"t": token}, mesh)["t"]
    cache_sh = shd.kvcache_shardings(cache, mesh,
                                     sequence_parallel=seq_parallel)
    logits_sh = NamedSharding(mesh, (dp if b > 1 else None, None, "model"))
    return CellSpec(cfg.name, shape.name, step, args,
                    (p_sh, tok_sh, cache_sh), (logits_sh, cache_sh),
                    {"position": position}, make_args)


# ---------------------------------------------------------------------------
# Vision cells
# ---------------------------------------------------------------------------

def _vision_cell(cfg: VisionConfig, shape: ShapeSpec, mesh) -> CellSpec:
    if shape.kind == "train":
        # cls_384 fine-tunes at the higher resolution: the batch spec
        # carries it
        return _train_cell(cfg, shape, mesh)
    fwd = swin_mod.swin_forward if cfg.swin else vit_mod.vit_forward
    init = swin_mod.swin_init if cfg.swin else vit_mod.vit_init
    images = TensorSpec(
        (shape.global_batch, shape.img_res, shape.img_res, 3), torch.float32)

    def make_args(gen, device):
        return (_params(lambda g, d: init(g, cfg, device=d), gen, device),
                _input(images, gen, device))

    def step(params, x):
        return fwd(params, cfg, x)
    args = make_args(None, None)
    p_sh = shd.param_shardings(args[0], mesh)
    i_sh = shd.batch_shardings({"x": images}, mesh)["x"]
    dp = shd.spec_entry(shd.dp_axes(mesh))
    out_sh = NamedSharding(
        mesh, (dp if shape.global_batch > 1 else None, None))
    return CellSpec(cfg.name, shape.name, step, args, (p_sh, i_sh), out_sh,
                    {}, make_args)


# ---------------------------------------------------------------------------
# Diffusion cells
# ---------------------------------------------------------------------------

def latent_res(cfg: DiffusionConfig, shape: ShapeSpec) -> int:
    """The sampler's latent side at the shape's image resolution."""
    r = cfg.latent_res or cfg.img_res // 8
    if cfg.latent_res and shape.img_res:
        r = cfg.latent_res * shape.img_res // cfg.img_res
    elif shape.img_res:
        r = shape.img_res // 8
    return r


def _diffusion_cell(cfg: DiffusionConfig, shape: ShapeSpec,
                    mesh) -> CellSpec:
    if shape.kind == "train":
        return _train_cell(cfg, shape, mesh)

    # generation cells: the full sampler loop, `steps` backbone forwards
    b = shape.global_batch
    lat_res = latent_res(cfg, shape)
    if cfg.is_mmdit:
        init = mmdit_mod.mmdit_init
        cond = TensorSpec((b, TXT_TOKENS, cfg.cond_dim), torch.float32)

        def step(params, key, txt_emb):
            return diff.rf_sample(params, cfg, key, batch=b,
                                  n_steps=shape.steps, txt_emb=txt_emb,
                                  latent_res=lat_res)
    else:
        init = dit_mod.dit_init
        cond = TensorSpec((b,), torch.int32)

        def step(params, key, labels):
            return diff.dit_sample(params, cfg, key, batch=b,
                                   n_steps=shape.steps, y=labels,
                                   latent_res=lat_res)

    def make_args(gen, device):
        return (_params(lambda g, d: init(g, cfg, d), gen, device),
                _key(gen, device), _input(cond, gen, device, cfg.n_classes))
    args = make_args(None, None)
    p_sh = shd.param_shardings(args[0], mesh)
    dp = shd.dp_axes(mesh)
    b_axis = shd.spec_entry(dp) if b % shd.axis_size(mesh, dp) == 0 else None
    out_sh = NamedSharding(mesh, (b_axis, None, None, None))
    return CellSpec(cfg.name, shape.name, step, args,
                    (p_sh, _replicated(mesh),
                     shd.batch_shardings({"t": cond}, mesh)["t"]),
                    out_sh, {}, make_args)


# ---------------------------------------------------------------------------

def build_cell(arch: str, shape_name: str, mesh, *,
               sp_threshold: int = 262144) -> CellSpec:
    """The cell of `arch` at `shape_name` on `mesh`. `sp_threshold`: the
    decode cells' sequence length from which the KV cache's sequence
    axis is sharded over `model` (the reference's REPRO_SP_THRESHOLD,
    default 262144: long_500k only)."""
    cfg = get_config(arch)
    shape = get_shape(cfg, shape_name)
    if cfg.family == "lm":
        return _lm_cell(cfg, shape, mesh, sp_threshold)
    if cfg.family == "vision":
        return _vision_cell(cfg, shape, mesh)
    if cfg.family == "diffusion":
        return _diffusion_cell(cfg, shape, mesh)
    raise ValueError(cfg.family)
