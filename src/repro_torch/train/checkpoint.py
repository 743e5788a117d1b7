"""Atomic checkpoints in the reference's on-disk format, so either side
restores what the other wrote.

    <ckpt_dir>/step_%08d/shard_%05d.msgpack   a msgpack map: path -> raw bytes
    <ckpt_dir>/step_%08d/manifest.json        step, paths, meta (shape and
                                              dtype string), treedef,
                                              n_processes, extra

A checkpoint is written into `step_%08d.tmp-<process>` and published by
`os.replace`, so a crash mid-save never leaves a half-written
`step_%08d`; `latest_step` sees only published directories with a
manifest.

Trees are nested dicts (leaves in sorted-key order), lists, tuples and
NamedTuples, as `jax.tree_util` walks them; a leaf's path is the string
`jax.tree_util.keystr` gives it (`[0]['layers']['attn']['wq']`,
`[1].mu['embed']['table']`), and `treedef` is the string of
`jax.tree.structure`. Leaves are written C-order as numpy writes them:
bf16 as the raw 16-bit words under the dtype string "bfloat16" (the
reference's ml_dtypes name), read back through an int16 view.

The msgpack codec here covers what the format uses, and nothing else:
maps (fixmap, map16, map32) of str keys (fixstr, str8/16/32) to bin
values (bin8/16/32), byte-equal to `msgpack.packb(payload,
use_bin_type=True)`. Anything else raises.
"""
from __future__ import annotations

import json
import os
import shutil
import struct

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.devices import resolve_device

MANIFEST = "manifest.json"

# torch dtype <-> the dtype string numpy (with ml_dtypes) prints
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64",
                torch.int32: "int32", torch.int64: "int64",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}
_NAMED_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


# ---------------------------------------------------------------------------
# trees: jax.tree_util's order, key strings and structure string
# ---------------------------------------------------------------------------

def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """[(key string, child)] of a container in jax.tree_util's order, or
    None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def tree_flatten_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] in jax.tree_util's leaf order; each path is the
    string `jax.tree_util.keystr` gives that leaf."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pl for key, child in kids
            for pl in tree_flatten_with_paths(child, prefix + key)]


def tree_paths(tree) -> list[str]:
    return [p for p, _ in tree_flatten_with_paths(tree)]


def treedef_str(tree) -> str:
    """The string of `jax.tree.structure(tree)`."""
    def rec(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {rec(node[k])}"
                                   for k in sorted(node)) + "}"
        if _is_namedtuple(node):
            return (f"CustomNode(namedtuple[{type(node).__name__}], ["
                    + ", ".join(rec(c) for c in node) + "])")
        if isinstance(node, list):
            return "[" + ", ".join(rec(c) for c in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(rec(c) for c in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        return "*"
    return f"PyTreeDef({rec(tree)})"


def _rebuild(like, leaves):
    """`like`'s structure with its leaves taken in order from the
    iterator `leaves`."""
    if isinstance(like, dict):
        new = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: new[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*[_rebuild(c, leaves) for c in like])
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(c, leaves) for c in like)
    return next(leaves)


# ---------------------------------------------------------------------------
# the msgpack subset: map of str -> bin
# ---------------------------------------------------------------------------

def _map_header(n: int) -> bytes:
    if n < 16:
        return bytes([0x80 | n])
    if n < 1 << 16:
        return b"\xde" + struct.pack(">H", n)
    return b"\xdf" + struct.pack(">I", n)


def _str_header(n: int) -> bytes:
    if n < 32:
        return bytes([0xa0 | n])
    if n < 1 << 8:
        return b"\xd9" + struct.pack(">B", n)
    if n < 1 << 16:
        return b"\xda" + struct.pack(">H", n)
    return b"\xdb" + struct.pack(">I", n)


def _bin_header(n: int) -> bytes:
    if n < 1 << 8:
        return b"\xc4" + struct.pack(">B", n)
    if n < 1 << 16:
        return b"\xc5" + struct.pack(">H", n)
    return b"\xc6" + struct.pack(">I", n)


def write_map(f, items) -> None:
    """Write (str, bytes-like) pairs as one msgpack map to the file `f`
    (`msgpack.packb(dict(items), use_bin_type=True)`), each value
    streamed as it is (no copy into one buffer)."""
    items = list(items)
    f.write(_map_header(len(items)))
    for key, value in items:
        k = key.encode("utf-8")
        v = memoryview(value).cast("B")
        f.write(_str_header(len(k)))
        f.write(k)
        f.write(_bin_header(v.nbytes))
        f.write(v)


def unpack_map(buf) -> dict:
    """msgpack bytes of one map of str -> bin -> {str: memoryview into
    buf}. Any other msgpack type raises ValueError."""
    mv = memoryview(buf).cast("B")
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(mv):
            raise ValueError("msgpack: truncated input")
        out = mv[pos:pos + n]
        pos += n
        return out

    def length(tag, small_mask, small_base, wide):
        """The length a header byte `tag` announces: in its low bits for
        the small form, else in the big-endian field `wide[tag]`."""
        if small_base is not None and tag & ~small_mask == small_base:
            return tag & small_mask
        if tag in wide:
            fmt = wide[tag]
            return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]
        return None

    n = length(take(1)[0], 0x0f, 0x80, {0xde: ">H", 0xdf: ">I"})
    if n is None:
        raise ValueError("msgpack: the top-level object is not a map")
    out = {}
    for _ in range(n):
        tag = take(1)[0]
        klen = length(tag, 0x1f, 0xa0, {0xd9: ">B", 0xda: ">H",
                                        0xdb: ">I"})
        if klen is None:
            raise ValueError(f"msgpack: map key type 0x{tag:02x} is not str")
        key = bytes(take(klen)).decode("utf-8")
        tag = take(1)[0]
        vlen = length(tag, 0, None, {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"})
        if vlen is None:
            raise ValueError(f"msgpack: value type 0x{tag:02x} is not bin")
        out[key] = take(vlen)
    if pos != len(mv):
        raise ValueError("msgpack: trailing bytes after the map")
    return out


# ---------------------------------------------------------------------------
# leaves <-> bytes
# ---------------------------------------------------------------------------

def _leaf_array(leaf) -> np.ndarray:
    """A leaf as the C-order numpy array whose bytes are written (bf16
    through an int16 view)."""
    t = torch.as_tensor(leaf).detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _leaf_dtype_name(leaf) -> str:
    dt = torch.as_tensor(leaf).dtype
    if dt not in _DTYPE_NAMES:
        raise TypeError(f"checkpoint: no dtype string for {dt}")
    return _DTYPE_NAMES[dt]


def _tensor_from(raw, dtype_name: str, shape, device) -> torch.Tensor:
    dt = _NAMED_DTYPES.get(dtype_name)
    if dt is None:
        raise TypeError(f"checkpoint: unknown dtype {dtype_name!r}")
    carrier = torch.int16 if dt == torch.bfloat16 else dt
    n = int(np.prod(shape, dtype=np.int64))
    if n == 0:
        t = torch.empty(shape, dtype=carrier)
    else:
        t = torch.frombuffer(raw, dtype=carrier, count=n).reshape(shape)
    if dt == torch.bfloat16:
        t = t.view(torch.bfloat16)
    return t.to(device=device, copy=True)


def _process_count() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


# ---------------------------------------------------------------------------
# save / latest / restore / prune
# ---------------------------------------------------------------------------

def _whole(tree):
    """`tree` with every DTensor leaf gathered to its full tensor
    (`full_tensor()`, a collective over the leaf's mesh)."""
    leaves = [x.full_tensor() if isinstance(x, DTensor) else x
              for _, x in tree_flatten_with_paths(tree)]
    return _rebuild(tree, iter(leaves))


def save(ckpt_dir: str, step: int, tree, *, process_index: int = 0,
         extra: dict | None = None) -> str:
    """Atomically write one checkpoint. Returns the final directory.

    Leaves may be DTensors: each is written whole. With a process group
    initialized, every rank of the world calls save — the gather of a
    DTensor is a collective — only rank 0 writes, and all meet at a
    barrier before it publishes the directory, and again after, so that
    no rank returns before the checkpoint exists."""
    tree = _whole(tree)
    dist = torch.distributed
    ranks = dist.is_available() and dist.is_initialized()
    writer = not ranks or dist.get_rank() == 0
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + f".tmp-{process_index}"
    if writer:
        _write(tmp, step, tree, process_index, extra)
    if ranks:
        dist.barrier()
    if writer:
        # atomic publish
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    if ranks:
        dist.barrier()
    return final


def _write(tmp: str, step: int, tree, process_index: int,
           extra: dict | None) -> None:
    """The shard and the manifest of one checkpoint, into `tmp`."""
    os.makedirs(tmp, exist_ok=True)
    flat = tree_flatten_with_paths(tree)
    paths = [p for p, _ in flat]
    meta = {}
    arrays = []
    for p, leaf in flat:
        arr = _leaf_array(leaf)
        arrays.append((p, arr))
        meta[p] = {"shape": list(arr.shape),
                   "dtype": _leaf_dtype_name(leaf)}
    shard_file = os.path.join(tmp, f"shard_{process_index:05d}.msgpack")
    with open(shard_file, "wb") as f:
        write_map(f, ((p, np.ascontiguousarray(a).reshape(-1).view(np.uint8))
                       for p, a in arrays))

    manifest = {
        "step": int(step),
        "paths": paths,
        "meta": meta,
        "treedef": treedef_str(tree),
        "n_processes": _process_count(),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and ".tmp" not in name:
            if os.path.exists(os.path.join(ckpt_dir, name, MANIFEST)):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like, *, process_index: int = 0,
            device=None):
    """Restore into the structure of `like` (a tree of tensors or
    shape specs), each leaf in the dtype and shape the manifest records.
    A leaf goes to the device of `like`'s tensor at its place; a spec's
    goes to `device` (the card unless the caller passes "cpu").
    Returns (tree, manifest)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(final, MANIFEST)) as f:
        manifest = json.load(f)
    shard_file = os.path.join(final, f"shard_{process_index:05d}.msgpack")
    buf = bytearray(os.path.getsize(shard_file))
    with open(shard_file, "rb") as f:
        f.readinto(buf)
    payload = unpack_map(buf)

    spec_device = None
    out = []
    for p, leaf in tree_flatten_with_paths(like):
        if isinstance(leaf, torch.Tensor):
            dev = leaf.device
        else:
            if spec_device is None:
                spec_device = resolve_device(device)
            dev = spec_device
        m = manifest["meta"][p]
        out.append(_tensor_from(payload[p], m["dtype"], m["shape"], dev))
    return _rebuild(like, iter(out)), manifest


def prune_old(ckpt_dir: str, keep: int = 3):
    """Keep the newest `keep` checkpoints (bounded disk on long runs)."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and ".tmp" not in n)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
