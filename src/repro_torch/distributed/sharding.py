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

import re
from dataclasses import dataclass

from torch.distributed.tensor import Replicate, Shard

from repro_torch.launch.mesh import axis_names, mesh_shape


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


def dp_axes(mesh) -> tuple:
    """The data-parallel mesh axes (pod + data when multi-pod)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names) or (names[0],)


def axis_size(mesh, axis) -> int:
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= shape[a]
        return n
    return shape[axis]


def _fits(dim: int, mesh, axis) -> bool:
    return dim % axis_size(mesh, axis) == 0


def _entry(axis):
    """A spec entry as PartitionSpec keeps it: a one-axis tuple is the
    axis name."""
    return axis[0] if isinstance(axis, tuple) and len(axis) == 1 else axis


@dataclass(frozen=True)
class NamedSharding:
    """A layout on `mesh`: `spec[d]` names the mesh axes tensor dim d is
    split over (None: whole), as jax's PartitionSpec entries."""
    mesh: object
    spec: tuple

    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: Shard(d) on every mesh
        dim named by spec[d] (a tuple of axes shards dim d over each of
        them, the first axis major, as JAX orders them), Replicate()
        elsewhere."""
        names = axis_names(self.mesh)
        out = [Replicate()] * len(names)
        for d, entry in enumerate(self.spec):
            if entry is None:
                continue
            for a in entry if isinstance(entry, tuple) else (entry,):
                out[names.index(a)] = Shard(d)
        return tuple(out)


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
                resolved.append(_entry(axis) if _fits(dim, mesh, axis)
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
        if len(x.shape) > b_idx and _fits(x.shape[b_idx], mesh, dp):
            spec[b_idx] = _entry(dp)
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
                    and _fits(shape[2], mesh, "model"):
                spec[2] = "model"
            if _fits(shape[1], mesh, dp):
                spec[1] = _entry(dp)
            if (not sequence_parallel and len(shape) >= 5
                    and "model" in names
                    and _fits(shape[3], mesh, "model")):
                spec[3] = "model"    # kv heads over TP when they fit
        return NamedSharding(mesh, tuple(spec))
    return tree_map_with_path(leaf, cache_tree)


def replicated(tree, mesh):
    return tree_map_with_path(lambda _, __: NamedSharding(mesh, ()), tree)
