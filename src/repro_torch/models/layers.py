"""The layers of the port's models, as plain functions on parameter
dictionaries (the JAX package's pytree layout, so one checkpoint serves
both): linear, embedding, layernorm, adaLN (modulated layernorm),
rmsnorm, the GELU and the gated (SwiGLU) MLP, the NHWC/HWIO
convolution, and the helpers for stacked layers and parameter trees.

Numerics follow the reference: layernorm uses the population variance
and eps = 1e-6 (torch's default is 1e-5); the norms compute in float32
and return x's dtype; GELU is the tanh approximation; `linear` casts
its weights to x's dtype, and on plain float32 CUDA tensors that need
no gradient, in products of at least DENSE_MIN_ROWS rows and
DENSE_MIN_MACS multiply-adds, runs as one launch of the dense kernel
(kernels/dense: split TF32, bias and GELU fused). The detector is float32; the LMs run
in their config's dtype.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch._C._functorch import is_functorch_wrapped_tensor
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils.checkpoint import checkpoint

from repro_torch.devices import resolve_device
from repro_torch.kernels.dense.ops import dense
from repro_torch.kernels.rmsnorm.ops import rmsnorm_plain
from repro_torch.models.layout import activation_sharding, local_shape
from repro_torch.train.optim import tree_leaves, tree_map

Params = dict


# ---------------------------------------------------------------------------
# initialisation (truncated normals at +-2 std, from a torch.Generator
# or a numpy Generator)
# ---------------------------------------------------------------------------

def shape_only(device=None) -> bool:
    """True where tensors carry no values: `device` is the meta device,
    or a FakeTensorMode is active."""
    if device is not None and torch.device(device).type == "meta":
        return True
    return torch._guards.detect_fake_mode() is not None


def trunc_normal(gen, shape, std: float = 0.02, device=None,
                 dtype=torch.float32) -> torch.Tensor:
    """Truncated normal draw. A torch.Generator goes through
    torch.nn.init.trunc_normal_ on the generator's device, whose draws
    differ between PyTorch versions; a numpy Generator
    (np.random.default_rng) gives the same weights under any PyTorch
    (standard normals, those past +-2 drawn again, times std). std 0
    gives zeros and draws nothing. On the meta device, or under an
    active FakeTensorMode, nothing is drawn: the result holds the shape,
    dtype and device only (the dry run's parameters, as
    `jax.eval_shape` gives the reference's)."""
    if std == 0:
        return torch.zeros(shape, device=device, dtype=dtype)
    if shape_only(device):
        return torch.empty(shape, device=device, dtype=dtype)
    if isinstance(gen, np.random.Generator):
        z = gen.standard_normal(shape)
        out = np.abs(z) > 2.0
        while out.any():
            z[out] = gen.standard_normal(int(out.sum()))
            out = np.abs(z) > 2.0
        return torch.as_tensor((z * std).astype(np.float32),
                               device=device).to(dtype)
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=gen)
    return x.to(device=device, dtype=dtype)


def lecun_normal(gen, shape, device=None,
                 dtype=torch.float32) -> torch.Tensor:
    """Truncated normal of std sqrt(1 / fan_in), fan_in = shape[0]."""
    return trunc_normal(gen, shape, std=math.sqrt(1.0 / max(1, shape[0])),
                        device=device, dtype=dtype)


def he_normal(gen, shape, fan_in: int | None = None, device=None,
              dtype=torch.float32) -> torch.Tensor:
    """Truncated normal of std sqrt(2 / fan_in), fan_in = shape[0] unless
    given."""
    fan_in = fan_in if fan_in is not None else shape[0]
    return trunc_normal(gen, shape, std=math.sqrt(2.0 / max(1, fan_in)),
                        device=device, dtype=dtype)


def linear_init(gen, d_in: int, d_out: int, *, bias: bool = True,
                std: float | None = None, device=None,
                dtype=torch.float32) -> Params:
    """{"w": [d_in, d_out], "b": [d_out]}: LeCun normal, or a truncated
    normal of `std` where given."""
    w = (trunc_normal(gen, (d_in, d_out), std=std, device=device,
                      dtype=dtype) if std is not None
         else lecun_normal(gen, (d_in, d_out), device=device, dtype=dtype))
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros(d_out, device=device, dtype=dtype)
    return p


def embedding_init(gen, vocab: int, dim: int, *, device=None,
                   dtype=torch.float32) -> Params:
    return {"table": trunc_normal(gen, (vocab, dim), std=0.02,
                                  device=device, dtype=dtype)}


def mlp_init(gen, d_model: int, d_ff: int, *, gated: bool = False,
             bias: bool = True, device=None, dtype=torch.float32) -> Params:
    """up / down (and gate, for the SwiGLU MLP) linears, drawn in the
    reference's order."""
    kw = dict(bias=bias, device=device, dtype=dtype)
    p = {"up": linear_init(gen, d_model, d_ff, **kw),
         "down": linear_init(gen, d_ff, d_model, **kw)}
    if gated:
        p["gate"] = linear_init(gen, d_model, d_ff, **kw)
    return p


def conv_init(gen, k_h: int, k_w: int, c_in: int, c_out: int, *,
              device=None, dtype=torch.float32) -> Params:
    """{"w": [k_h, k_w, c_in, c_out] (HWIO, He normal), "b": [c_out]}."""
    return {"w": he_normal(gen, (k_h, k_w, c_in, c_out),
                           fan_in=k_h * k_w * c_in, device=device,
                           dtype=dtype),
            "b": torch.zeros(c_out, device=device, dtype=dtype)}


def rmsnorm_init(dim: int, *, device=None,
                 dtype=torch.float32) -> Params:
    return {"scale": torch.ones(dim, device=device, dtype=dtype)}


def layernorm_init(dim: int, *, device=None,
                   dtype=torch.float32) -> Params:
    return {"scale": torch.ones(dim, device=device, dtype=dtype),
            "bias": torch.zeros(dim, device=device, dtype=dtype)}


@contextlib.contextmanager
def full_float32():
    """Within the block, TF32 is off for float32 matrix products and
    cuDNN convolutions (torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32), so the detector runs in full
    float32 on the card, as the model is specified; the flags are
    restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _rows_mergeable(x: torch.Tensor) -> torch.Tensor:
    """A product flattens x's leading dims into rows, and DTensor's
    products cannot take two sharded dims merged into one: on a mesh,
    the middle dims of x (neither the batch nor the features) are made
    whole first, and the batch dim too where its sharding is strided or
    uneven or the dim has size 1 (DTensor will not fold a sharded dim of
    size 1 away). Plain tensors pass unchanged."""
    if not isinstance(x, DTensor) or x.ndim <= 2:
        return x
    mesh = x.device_mesh
    ways = 1
    for size, p in zip(mesh.shape, x.placements):
        if p.is_shard(0):
            ways *= size
    uneven = x.shape[0] % ways != 0 or x.shape[0] == 1
    drop = [p.is_shard() and p.dim < x.ndim - 1 and (
        p.dim > 0 or uneven or isinstance(p, _StridedShard))
        for p in x.placements]
    if not any(drop):
        return x
    return x.redistribute(mesh, [
        Replicate() if d else p for d, p in zip(drop, x.placements)])


class _MergeableRows(torch.autograd.Function):
    """_rows_mergeable on the value and on its gradient (a product's
    backward flattens the gradient of its output into rows too)."""

    @staticmethod
    def forward(ctx, x):
        return _rows_mergeable(x)

    @staticmethod
    def backward(ctx, g):
        return _rows_mergeable(g)


def _fence(x: torch.Tensor) -> torch.Tensor:
    return _MergeableRows.apply(x) if isinstance(x, DTensor) else x


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w. On a mesh (x a DTensor of 3 or more dims) the product is
    taken on x's rows flattened, and its result's rows laid out as x's
    before they unflatten (DTensor may shard the rows of a product over
    an axis that does not divide x's batch dim), fenced both ways."""
    if not isinstance(x, DTensor) or x.ndim <= 2:
        return x @ w
    lead = x.shape[:-1]
    x2 = _fence(x).reshape(-1, x.shape[-1])
    y2 = x2 @ w
    rows = [px if px.is_shard(0) else (Replicate() if py.is_shard(0)
                                       else py)
            for px, py in zip(x2.placements, y2.placements)]
    if list(rows) != list(y2.placements):
        y2 = y2.redistribute(y2.device_mesh, rows)
    return _fence(y2.reshape(*lead, y2.shape[-1]))


# The dense kernel pays where the product is large enough. Below
# DENSE_MIN_ROWS rows its pre-pass (w read once, 2 |w| written, then read
# again for each 128-row tile) and its few output tiles cost more than
# cuBLAS's float32 product, which reads w once (an H100, stablelm-3b's
# 2560 x 2560: 4.7x slower at 4 rows, 1.4x at 256; Swin-B's 4096 x 1024
# 1.75x slower at 512; the large weights measured 1.06-1.84x faster
# from 1,024 rows). Below DENSE_MIN_MACS multiply-adds (M K N) the call is as
# short as its host dispatch, which is longer than torch's (the ViT's
# 192 x 768: 1.66x slower at 2,048 rows, 1.78x faster at 8,192).
DENSE_MIN_ROWS = 1024
DENSE_MIN_MACS = 2 ** 30


def card_kernel_operands(*ts: torch.Tensor) -> bool:
    """True where a forward-only hand-written kernel may take the
    tensors: each is a plain float32 CUDA tensor holding values (no
    DTensor, no functorch wrapper, not meta, no FakeTensorMode) and none
    needs a gradient (the kernels have no backward)."""
    if any(t.dtype != torch.float32 or t.device.type != "cuda"
           or isinstance(t, DTensor) or is_functorch_wrapped_tensor(t)
           for t in ts):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        return False
    return not shape_only()


def _dense_engages(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor | None) -> bool:
    """The product runs in the dense kernel (kernels/dense) when every
    operand is one it may take (card_kernel_operands) and x has at least
    DENSE_MIN_ROWS rows and the product DENSE_MIN_MACS multiply-adds (an
    LM's decode step, a few rows, keeps torch's product)."""
    rows = x.shape[:-1].numel()
    if rows < DENSE_MIN_ROWS or rows * w.numel() < DENSE_MIN_MACS:
        return False
    return card_kernel_operands(*((x, w) if b is None else (x, w, b)))


def linear(p: Params, x: torch.Tensor,
           act: str | None = None) -> torch.Tensor:
    """x @ w + b, then the GELU where act="gelu". Plain float32 CUDA
    tensors without gradients, in products large enough
    (_dense_engages), take one launch of the dense kernel (the product
    in split TF32 on the tensor cores, bias and GELU in its epilogue);
    everything else runs the product as torch does."""
    w = p["w"].to(x.dtype)
    b = p["b"].to(x.dtype) if "b" in p else None
    if _dense_engages(x, w, b):
        return dense(x.contiguous(), w.contiguous(), b, act=act)
    y = _matmul(x, w)
    if b is not None:
        y = y + b
    return gelu(y) if act == "gelu" else y


def embedding(p: Params, ids: torch.Tensor) -> torch.Tensor:
    return p["table"][ids]


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm_plain(x, p["scale"], eps)


def _normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) over the last dim, in float32."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.square(xf - mu).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps)


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm computed in float32 and returned in x's dtype, as the
    reference's."""
    y = _normalize(x, eps) * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def modulated_layernorm(p: Params, x: torch.Tensor, shift: torch.Tensor,
                        scale: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """adaLN (DiT, MMDiT): LayerNorm without affine, then
    (1 + scale) * x + shift, in float32, returned in x's dtype. `p` is
    unused (the reference's signature)."""
    y = _normalize(x, eps) * (1.0 + scale.float()) + shift.float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) with the sigmoid as 1 / (1 + exp(-x)), each op
    rounded in x's dtype: the reference's `jax.nn.silu` as XLA lowers
    it, so bfloat16 rounds where the reference's does (F.silu rounds
    once, which puts the LMs' bf16 logits several ulps off)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """down(act(up(x))): GELU, or SwiGLU (silu(gate(x)) * up(x)) where
    the parameters hold a gate."""
    x = batch_rows(x)
    gated = "gate" in p
    h = linear(p["up"], x, act=None if gated else "gelu")
    if gated:
        h = silu(linear(p["gate"], x)) * h
    return linear(p["down"], h)


def patch_embed(images: torch.Tensor, wflat: torch.Tensor,
                bias: torch.Tensor | None, *, patch: int) -> torch.Tensor:
    """The conv patch-embed (a patch x patch conv, stride = patch, VALID)
    as a patchify and one matrix product: images [B, H, W, C], wflat
    [patch * patch * C, D] (HWIO weights flattened), bias [D] or None ->
    tokens [B, (H/patch) * (W/patch), D], patches in row-major order.
    The one definition of the embed, shared by `vit_embed` and the plain
    crop -> token stage, so pixels and fused crops embed to equal
    tokens."""
    images = batch_rows(images)
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    tiles = images[:, :gh * patch, :gw * patch].reshape(
        b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b, gh * gw, patch * patch * c)
    tok = _matmul(tiles, wflat)
    return tok if bias is None else tok + bias


def grid_side(n: int, what: str) -> int:
    """The side of a square grid of n patches (raises if n is not a
    square)."""
    g = int(round(n ** 0.5))
    if g * g != n:
        raise ValueError(f"{what}: {n} patches do not form a square grid")
    return g


def resize_grid(grid: torch.Tensor, g_new: int) -> torch.Tensor:
    """Bilinear-resize a learned square grid of embeddings [1, g*g, D]
    to [1, g_new*g_new, D], antialiased when it shrinks, as
    jax.image.resize's "bilinear" is: the one resize behind the ViT's
    and DiT's off-grid pos_embed. On a mesh it runs per shard (each
    channel is resized alone; DTensor has no rule for the resize)."""
    if isinstance(grid, DTensor):
        return per_shard(lambda t: resize_grid(t, g_new), (grid,),
                         ((None, None, "data"),))
    g_old = grid_side(grid.shape[1], "pos_embed")
    x = grid.reshape(1, g_old, g_old, -1).permute(0, 3, 1, 2)
    x = F.interpolate(x.float(), size=(g_new, g_new), mode="bilinear",
                      align_corners=False, antialias=True).to(grid.dtype)
    return x.permute(0, 2, 3, 1).reshape(1, g_new * g_new, -1)


def _same_pad(size: int, k: int, stride: int) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p: Params, x: torch.Tensor, *, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """x [B, H, W, C] (NHWC), p["w"] [kh, kw, C, O] (HWIO) -> NHWC."""
    w = p["w"]
    kh, kw = w.shape[0], w.shape[1]
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        ph = _same_pad(x.shape[1], kh, stride)
        pw = _same_pad(x.shape[2], kw, stride)
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    elif padding != "VALID":
        raise ValueError(f"padding must be SAME or VALID, got {padding!r}")
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    y = y.permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# layouts on a mesh (DTensor); no-ops on plain tensors
# ---------------------------------------------------------------------------

def _layout(x, spec):
    """x (a DTensor) redistributed to `spec` resolved on its mesh."""
    sh = activation_sharding(x.device_mesh, tuple(x.shape), spec)
    return x.redistribute(x.device_mesh, sh.placements())


def batch_rows(x: torch.Tensor) -> torch.Tensor:
    """x laid out batch (dim 0) over the DP axes, its other dims whole,
    when x is a DTensor (constrain_spec): the residual stream's layout
    at a layer's entry, so no layer merges two sharded dims."""
    return constrain_spec(x, ("data",) + (None,) * (x.ndim - 1))


class _Constrain(torch.autograd.Function):
    """_layout on the value and on its gradient."""

    @staticmethod
    def forward(ctx, x, spec):
        ctx.spec = spec
        return _layout(x, spec)

    @staticmethod
    def backward(ctx, g):
        return (_layout(g, ctx.spec) if isinstance(g, DTensor) else g), None


def constrain_spec(x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """x laid out by `spec` (None, "data" for the DP axes, or a mesh
    axis name per dim; an axis that does not divide its dim leaves it
    whole) when x is a DTensor, and its gradient too: the redistribute
    GSPMD would insert for the reference's with_sharding_constraint.
    Plain tensors pass unchanged."""
    return _Constrain.apply(x, spec) if isinstance(x, DTensor) else x


def dp_entry(x: torch.Tensor, n: int):
    """"data" when x is a DTensor whose mesh's DP axes divide n, else
    None: a spec entry for a dim that carries n batch rows."""
    if not isinstance(x, DTensor):
        return None
    return "data" if activation_sharding(
        x.device_mesh, (n,), ("data",)).spec[0] else None


def zeros_laid_out(like: torch.Tensor, shape: tuple, spec: tuple,
                   dtype) -> torch.Tensor:
    """Zeros of `shape` on like's device; when `like` is a DTensor, a
    DTensor on its mesh laid out by `spec`, each rank allocating its
    shard only."""
    if not isinstance(like, DTensor):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    mesh = like.device_mesh
    pl = activation_sharding(mesh, shape, spec).placements()
    return DTensor.from_local(
        torch.zeros(local_shape(shape, pl, mesh), dtype=dtype,
                    device=like.to_local().device), mesh, pl,
        run_check=False)


def per_shard(fn, xs: tuple, specs: tuple):
    """fn(*xs) where fn acts on each shard alone (attention is
    independent across batch rows and heads). With a DTensor among xs,
    each is laid out by its spec (a plain tensor counts as whole on
    every rank), fn runs on the local shards, and its result carries
    the first input's layout: what GSPMD makes of such a step, where
    DTensor's products cannot follow two sharded dims merged into one.
    Plain tensors: fn(*xs)."""
    mesh = next((x.device_mesh for x in xs if isinstance(x, DTensor)),
                None)
    if mesh is None:
        return fn(*xs)
    whole = [Replicate()] * mesh.ndim
    laid = [None if x is None else _layout(
        x if isinstance(x, DTensor) else DTensor.from_local(
            x, mesh, whole, run_check=False), spec)
        for x, spec in zip(xs, specs)]
    out_pl = laid[0].placements

    def local(x):
        # an input whole over a mesh dim the result is split over feeds
        # every shard: its gradient is the sum of theirs
        return x.to_local(grad_placements=[
            Partial() if pi.is_replicate() and po.is_shard() else pi
            for pi, po in zip(x.placements, out_pl)])
    out = fn(*(None if x is None else local(x) for x in laid))
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


# ---------------------------------------------------------------------------
# stacked layers and parameter trees
# ---------------------------------------------------------------------------

def remat(enabled: bool, layer, *args):
    """layer(*args), with its activations recomputed in the backward pass
    when `enabled` (a config's `remat`) and gradients are being recorded:
    the reference's `jax.checkpoint` around each scanned layer. The
    whole layer is recomputed, whatever checkpoint policy the reference
    names (a policy changes memory, not values). Values are layer's
    own either way."""
    if enabled and torch.is_grad_enabled():
        return checkpoint(layer, *args, use_reentrant=False)
    return layer(*args)


def stack_trees(trees: list) -> Params:
    """Equal-structured trees -> one tree whose leaves are stacked on a
    new leading axis."""
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def stack_init(gen, n_layers: int, init_fn) -> Params:
    """n_layers draws of init_fn(gen), leaves stacked on axis 0 (the
    reference's scan-over-layers layout)."""
    return stack_trees([init_fn(gen) for _ in range(n_layers)])


def layer_params(stacked: Params, i: int) -> Params:
    """Layer i of a stacked tree (views, no copy)."""
    return tree_map(lambda x: x[i], stacked)


def count_params(params: Params) -> int:
    return int(sum(p.numel() for p in tree_leaves(params)))


def param_bytes(params: Params) -> int:
    return int(sum(p.numel() * p.element_size()
                   for p in tree_leaves(params)))


def params_from_numpy(tree, dtype, device=None,
                      keep_float32: tuple = ()) -> Params:
    """A reference parameter tree (nested dicts and lists of numpy or
    JAX arrays) -> the same tree of tensors on `device` (the card unless
    the caller passes "cpu"): floating leaves in `dtype`, but those under
    a key of `keep_float32` in float32, other leaves as they are. bf16
    leaves (numpy's view of them has no torch counterpart) go through
    float32, which holds every bf16 value exactly."""
    device = resolve_device(device)

    def convert(node, f32: bool):
        if isinstance(node, dict):
            return {k: convert(v, f32 or k in keep_float32)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [convert(v, f32) for v in node]
        a = np.array(node)
        if a.dtype.name == "bfloat16":
            a = a.astype(np.float32)
        t = torch.as_tensor(a, device=device)
        if t.is_floating_point():
            t = t.to(torch.float32 if f32 else dtype)
        return t

    return convert(tree, False)


def cast_floats(params: Params, dtype) -> Params:
    return tree_map(lambda p: p.to(dtype) if p.is_floating_point() else p,
                    params)
