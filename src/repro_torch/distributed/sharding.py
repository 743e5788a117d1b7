"""Per-architecture partition rules (FSDP + TP + EP + SP), the
reference's `distributed/sharding.py` on DeviceMesh / DTensor terms.

Policy (MaxText-style, adapted per family):

  * `data`-like axes (`pod`, `data`) carry batch (DP) and shard every
    large weight's reduction dim (FSDP / ZeRO-3 — optimizer states
    follow params);
  * `model` carries tensor parallelism (attention heads / FFN hidden
    dim), expert parallelism (MoE expert axis), and sequence parallelism
    for the long-context decode cells (KV-cache sequence axis);
  * norms / biases / small vectors replicate.

Rules are path + shape based, so one function covers the dense LM, the
MoE LMs (MLA and GQA), ViT / Swin, DiT / MMDiT and the detector. A dim
is sharded only when the mesh axis size divides it; otherwise it
replicates.

Each function returns a tree of `NamedSharding(mesh, spec)`: `spec`
holds the reference's `PartitionSpec` entries (None, an axis name, or a
tuple of names), and `placements()` the DTensor placements, one per
mesh dim. The mesh is a DeviceMesh or a device-free
`launch.mesh.AbstractMesh`.

Departure from the reference: it picks its rule set from the
environment (REPRO_SERVE_REPLICATED / REPRO_SERVE_TP_ONLY); here the
rule set is the `rules` argument ("train", "serve_tp", "replicated")
and no environment is read.
"""
from __future__ import annotations

import contextlib
import re

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

from repro_torch.models.layout import (  # noqa: F401 (re-exported)
    NamedSharding,
    activation_sharding,
    axis_names,
    axis_size,
    dp_axes,
    fits,
    local_shape,
    spec_entry,
)


def tree_map_with_path(fn, tree, path: tuple = ()):
    """fn(path, leaf) over nested dicts, lists, tuples and NamedTuples;
    a path is the tuple of dict keys, sequence indices and NamedTuple
    field names from the root (jax.tree_util's key path, as strings).
    None is an empty subtree, as in jax.tree_util."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree) -> list:
    """The leaves of `tree` in `tree_map_with_path`'s order."""
    out = []
    tree_map_with_path(lambda _, x: out.append(x), tree)
    return out


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

_RULES = [
    # (path regex, spec for the trailing dims)
    (r"embed.*table$", ("model", "data")),
    (r"lm_head.*w$", ("data", "model")),
    (r"(wq|wk|wv)/w$", ("data", "model")),
    (r"wq_b/w$", (None, "model")),
    (r"wkv_b/w$", (None, "model")),
    (r"(wq_a|wkv_a)/w$", ("data", None)),
    (r"wo/w$", ("model", "data")),
    (r"router/w$", ("data", None)),
    (r"w_gate$", ("model", "data", None)),       # [E, D, F] — EP + FSDP
    (r"w_up$", ("model", "data", None)),
    (r"w_down$", ("model", None, "data")),
    (r"shared/(gate|up)/w$", ("data", "model")),
    (r"shared/down/w$", ("model", "data")),
    (r"(up|gate)/w$", ("data", "model")),        # dense MLPs
    (r"down/w$", ("model", "data")),
    (r"(fc1|fc2)/w$", ("data", "model")),
    (r"ada/w$", ("data", "model")),
    (r"final_ada/w$", ("data", "model")),
    (r"(img_in|txt_in|final_proj|head|reduce)/w$", ("data", "model")),
    (r"patch_embed/w$", (None, None, None, "model")),
    (r"(cls|box|obj)/w$", (None, None, "data", None)),  # detector heads
    (r"pos_embed$", (None, None, "data")),
    (r"y_embed$", (None, "data")),
]


def _path_str(kp) -> str:
    """Key path -> 'layers/attn/wq/w' (the rule regexes read this form)."""
    return "/".join(str(k) for k in kp)


# Serving rules: inference has no optimizer states, so FSDP weight
# sharding only buys per-layer weight all-gathers. TP-only Megatron
# layout — column-parallel in, row-parallel out, one activation
# all-reduce per block — and EP-only expert placement.
_SERVE_RULES = [
    (r"embed.*table$", ("model", None)),
    (r"lm_head.*w$", (None, "model")),
    (r"(wq|wk|wv)/w$", (None, "model")),
    (r"wq_b/w$", (None, "model")),
    (r"wkv_b/w$", (None, "model")),
    (r"(wq_a|wkv_a)/w$", (None, None)),
    (r"wo/w$", ("model", None)),
    (r"router/w$", (None, None)),
    (r"w_gate$", ("model", "data", None)),   # E over TP, D over data:
    (r"w_up$", ("model", "data", None)),      # 1T of experts must spread
    (r"w_down$", ("model", None, "data")),    # across BOTH axes to fit HBM
    (r"shared/(gate|up)/w$", (None, "model")),
    (r"shared/down/w$", ("model", None)),
    (r"(up|gate)/w$", (None, "model")),
    (r"down/w$", ("model", None)),
    (r"(fc1|fc2)/w$", (None, "model")),
    (r"(img_in|txt_in|head)/w$", (None, "model")),
]

# "replicated": small-model serving replicates every weight; each DP
# slice runs whole images with no collectives (TP on an 86M-parameter
# model costs more in activation all-reduces than it saves)
RULE_SETS = {
    "train": _RULES,
    "serve_tp": _SERVE_RULES + _RULES,
    "replicated": [],
}


def _rules(rules: str) -> list:
    if rules not in RULE_SETS:
        raise ValueError(f"unknown rule set {rules!r} "
                         f"({' | '.join(RULE_SETS)})")
    return RULE_SETS[rules]


def _leaf_spec(path: str, shape: tuple, mesh, rules: str = "train"
               ) -> tuple:
    names = axis_names(mesh)
    for pat, trailing in _rules(rules):
        if re.search(pat, path):
            spec = [None] * len(shape)
            # right-align the rule onto the trailing dims (stacked layers
            # carry a leading L dim that stays unsharded)
            k = len(trailing)
            if len(shape) < k:
                break
            resolved = []
            for ax_name, dim in zip(trailing, shape[-k:]):
                if ax_name is None:
                    resolved.append(None)
                    continue
                axis = dp_axes(mesh) if ax_name == "data" else ax_name
                if ax_name == "model" and "model" not in names:
                    resolved.append(None)
                    continue
                resolved.append(spec_entry(axis) if fits(dim, mesh, axis)
                                else None)
            spec[-k:] = resolved
            return tuple(spec)
    return ()  # replicate (norms, biases, small tensors)


def param_shardings(params_tree, mesh, *, rules: str = "train"):
    """Tree of NamedShardings matching a params tree (tensors or any
    leaves with `.shape`)."""
    return tree_map_with_path(
        lambda kp, leaf: NamedSharding(
            mesh, _leaf_spec(_path_str(kp), tuple(leaf.shape), mesh,
                             rules)),
        params_tree)


def opt_shardings(opt_tree, mesh, *, rules: str = "train"):
    """Optimizer states inherit their parameter's sharding (ZeRO-3);
    scalar leaves (step, masked placeholders) replicate."""
    def leaf(kp, x):
        if len(x.shape) == 0:
            return NamedSharding(mesh, ())
        return NamedSharding(mesh, _leaf_spec(_path_str(kp),
                                              tuple(x.shape), mesh, rules))
    return tree_map_with_path(leaf, opt_tree)


# ---------------------------------------------------------------------------
# Batch / activation rules
# ---------------------------------------------------------------------------

def batch_shardings(batch_tree, mesh, *, microbatched: bool = False):
    """Inputs: leading batch dim over the DP axes (after an optional
    microbatch dim that stays unsharded)."""
    dp = dp_axes(mesh)

    def leaf(_, x):
        spec = [None] * len(x.shape)
        b_idx = 1 if microbatched else 0
        if len(x.shape) > b_idx and fits(x.shape[b_idx], mesh, dp):
            spec[b_idx] = spec_entry(dp)
        return NamedSharding(mesh, tuple(spec))
    return tree_map_with_path(leaf, batch_tree)


def kvcache_shardings(cache_tree, mesh, *, sequence_parallel: bool = False):
    """GQA cache [L, B, S, Hkv, Dh] / MLA cache [L, B, S, lora].

    decode: batch over DP (+ kv heads over model if divisible).
    sequence_parallel: the S axis over `model` (split-S softmax,
    distributed/collectives.ring_reduce_attend)."""
    dp = dp_axes(mesh)
    names = axis_names(mesh)

    def leaf(_, x):
        shape = tuple(x.shape)
        if len(shape) == 0:
            return NamedSharding(mesh, ())
        spec = [None] * len(shape)
        if len(shape) >= 3:
            if sequence_parallel and "model" in names \
                    and fits(shape[2], mesh, "model"):
                spec[2] = "model"
            if fits(shape[1], mesh, dp):
                spec[1] = spec_entry(dp)
            if (not sequence_parallel and len(shape) >= 5
                    and "model" in names
                    and fits(shape[3], mesh, "model")):
                spec[3] = "model"    # kv heads over TP when they fit
        return NamedSharding(mesh, tuple(spec))
    return tree_map_with_path(leaf, cache_tree)


def replicated(tree, mesh):
    return tree_map_with_path(lambda _, __: NamedSharding(mesh, ()), tree)


# ---------------------------------------------------------------------------
# Collectives a run issues (roofline: collective bytes per rank)
# ---------------------------------------------------------------------------

# the functional collectives DTensor's redistributions lower to, by the
# reference's HLO op names
_COLLECTIVE_KINDS = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
}


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in _pytree_leaves(out)
               if isinstance(t, torch.Tensor))


def _has_dtensor(args, kwargs) -> bool:
    return any(isinstance(t, DTensor) for t in _pytree_leaves((args,
                                                               kwargs)))


class CollectiveRecorder(TorchDispatchMode):
    """Within the block, records (kind, output bytes) of every
    collective that the local tensors of DTensors issue, in `record`.

    An op on DTensors is left to DTensor (NotImplemented), whose
    redistributions and local ops then come back through this mode on
    plain local tensors: the collectives are the functional ones
    (`_c10d_functional`) and DTensor's shard-to-shard all-to-all. On a
    CPU mesh DTensor lowers that all-to-all to an all-gather and a
    chunk; it is recorded as the one all-to-all it stands for (output
    bytes: the chunk). DTensor's sharding propagation, which runs ops
    on stand-ins of the global shapes, is not the rank's work and is
    not seen. Subclasses see every local op through `local_op` (with
    `quiet` set inside the two DTensor internals) and each tensor the
    all-to-all returns through `_hold`."""

    def __init__(self):
        super().__init__()
        self.record: list = []
        self._inner = 0
        self._depth = 0
        self._patch = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(args, kwargs):
            return NotImplemented
        return self.local_op(func, args, kwargs)

    @property
    def quiet(self) -> bool:
        return self._inner > 0

    def local_op(self, func, args, kwargs):
        out = func(*args, **kwargs)
        kind = _COLLECTIVE_KINDS.get(func.name().split(".")[0])
        if kind and not self.quiet:
            self.record.append((kind, _nbytes(out)))
        return out

    def _hold(self, t: torch.Tensor) -> None:
        """A tensor the rank now holds (LocalCosts tracks them)."""

    def __enter__(self):
        if self._depth == 0:
            with contextlib.ExitStack() as stack:
                stack.enter_context(_alltoall_as_one(self))
                stack.enter_context(_quiet_propagation(self))
                self._patch = stack.pop_all()
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._patch.close()


def _patched(owner, name: str):
    """owner.name, which the recorder wraps; a PyTorch without it would
    change what is counted (an all-to-all as an all-gather, the
    propagation's global-shape stand-ins as the rank's memory), so its
    absence is an error, not a silent pass."""
    orig = getattr(owner, name, None)
    if orig is None:
        raise RuntimeError(
            f"CollectiveRecorder: this PyTorch ({torch.__version__}) has "
            f"no {getattr(owner, '__name__', owner)}.{name}, which the "
            f"dry run's counts rely on")
    return orig


@contextlib.contextmanager
def _alltoall_as_one(rec: CollectiveRecorder):
    """Wraps DTensor's shard_dim_alltoall (looked up by name in
    `placement_types` when a Shard moves dims) so that its CPU lowering
    records one all-to-all, not the all-gather inside it."""
    from torch.distributed.tensor import placement_types as pt

    orig = _patched(pt, "shard_dim_alltoall")

    def wrapped(input, *args, **kwargs):
        rec._inner += 1
        try:
            out = orig(input, *args, **kwargs)
        finally:
            rec._inner -= 1
        rec.record.append(("all-to-all", _nbytes(out)))
        rec._hold(out)
        return out

    pt.shard_dim_alltoall = wrapped
    try:
        yield
    finally:
        pt.shard_dim_alltoall = orig


@contextlib.contextmanager
def _quiet_propagation(rec: CollectiveRecorder):
    """Marks DTensor's sharding propagation on stand-in tensors of the
    global shapes (ShardingPropagator's tensor-meta pass) as quiet."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    orig = _patched(ShardingPropagator, name)

    def wrapped(self, *args, **kwargs):
        rec._inner += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            rec._inner -= 1

    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, orig)


def collective_bytes(record) -> dict:
    """Sum the output bytes per rank of every collective in a run's
    record ((kind, bytes) pairs, `CollectiveRecorder.record`). Returns
    {kind: bytes} under the reference's kinds (all-gather, all-reduce,
    reduce-scatter, all-to-all, collective-permute), those the run
    issued. The reference parses the compiled HLO's collectives; here
    they are recorded as they are dispatched (no HLO text exists)."""
    out: dict = {}
    for kind, n in record:
        out[kind] = out.get(kind, 0) + int(n)
    return out
