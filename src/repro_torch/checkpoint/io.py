"""Checkpoints without external deps, crash-safe, in the JAX package's
on-disk format (`src/repro/checkpoint/io.py`), so either package
restores what the other wrote.

Layout: <dir>/step_<N>/
    manifest.json              — tree structure, shapes, dtypes, step,
                                 per-leaf CRC32 + byte counts
    <escaped-leaf-path>.npy    — one file per leaf (params + optimizer)

Leaf paths are the JAX package's: the tuple (params, opt_state)
flattens with a leading slash, "/0/embed/tok" for a parameter, then the
optimizer state's fields in order, "/1/0" for the step, "/1/1/...",
"/1/2/..." and "/1/3/..." for the fp32 master, m and v.  The port's
`AdamWState` is a dataclass whose step is a Python int: it flattens to
the same paths (a dataclass as the tuple of its fields), and the step
is written as a 0-d int32 array, as the JAX package's is.  bfloat16
leaves are stored as their raw bits in uint16 with "bfloat16" in the
manifest (numpy has no bfloat16, and the port needs no `ml_dtypes`:
the bits travel through int16 views); the CRC covers the stored bytes.

Crash safety: `save` writes the whole step into ``step_<N>.tmp`` and
atomically renames it into place only after every leaf and the
manifest are on disk, so a writer killed mid-step leaves at most a
``.tmp`` directory that `latest_step` never selects.  `restore` (and
`verify`) reject a missing, truncated or corrupt leaf with
`CheckpointCorruptError`, and a leaf absent from the manifest or of
another shape than the tree restored into.

Sharded runs: with a data mesh and a placement tree shaped like the
checkpointed tree (`placements`: each leaf's shard dimension, or None),
`save` gathers every sharded leaf (a collective all ranks join) and
rank 0 alone writes the same format; `restore` has every rank read the
full leaves and keep its shard.  The ranks wait on a barrier before and
after both, so a checkpoint written at one world size restores at any
other, and in the JAX package.

`crash_after_leaves` is the fault-injection hook
(`repro_torch.resilience.faults.CheckpointCrash`): the save raises
`CheckpointCrashError` after writing that many leaf files, exactly like
a process kill mid-write.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointCrashError(RuntimeError):
    """Injected mid-write crash (fault injection only — a real crash
    simply kills the process at the same point)."""


class CheckpointCorruptError(RuntimeError):
    """A checkpoint leaf failed validation (missing file, truncated
    bytes, CRC mismatch, absent from the manifest, or another shape)."""


def _esc(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.@-]", "__", path)


def _children(tree: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a container, None for a leaf: dicts by
    sorted key, tuples and lists by index, a dataclass as the tuple of
    its fields (the JAX package's NamedTuple)."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(str(i), getattr(tree, f.name))
                for i, f in enumerate(dataclasses.fields(tree))]
    return None


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    out = {}
    for k, v in kids:
        out.update(_flatten(v, f"{prefix}/{k}"
                            if prefix or not isinstance(tree, dict) else k))
    return out


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(stored array, manifest dtype) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf, dtype=np.int32 if isinstance(leaf, int) else None)
    return arr, str(arr.dtype)


def _placed(placements: Any, mesh) -> Dict[str, Optional[int]]:
    """{leaf path: shard dimension or None} of a placement tree."""
    if mesh is None or placements is None:
        return {}
    return _flatten(placements)


def save(ckpt_dir: str, step: int, tree: Any, *,
         keep_last: int = 0,
         crash_after_leaves: Optional[int] = None,
         placements: Any = None, mesh=None) -> str:
    """Atomically write one checkpoint step; returns its directory.

    `keep_last > 0` prunes older completed steps down to the newest
    `keep_last` after the rename (retention).  `crash_after_leaves`
    injects a mid-write crash for fault testing (see module docs); on a
    mesh every rank raises at the same leaf.  With `mesh` and
    `placements` every rank calls this and rank 0 writes (module note)."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    where = _placed(placements, mesh)
    writer = mesh is None or mesh.rank == 0
    if mesh is not None:
        mesh.barrier()
    if writer:
        if os.path.isdir(tmp):        # stale debris from an earlier crash
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    flat = _flatten(tree)
    manifest = {"step": step, "leaves": {}}
    for i, (path, leaf) in enumerate(flat.items()):
        if crash_after_leaves is not None and i >= crash_after_leaves:
            err = CheckpointCrashError(
                f"injected crash writing step {step} after {i} leaves "
                f"(tmp dir {tmp} left behind)")
            err.step = step       # lets a supervisor consume the event
            raise err
        if where.get(path) is not None:
            leaf = mesh.gather(leaf, where[path], "checkpoint")
        if not writer:
            continue
        stored, dtype = _to_numpy(leaf)
        fn = _esc(path) + ".npy"
        np.save(os.path.join(tmp, fn), stored)
        manifest["leaves"][path] = {
            "file": fn, "shape": list(stored.shape), "dtype": dtype,
            "crc32": zlib.crc32(np.ascontiguousarray(stored).tobytes()),
            "nbytes": int(stored.nbytes)}
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        if keep_last > 0:
            prune(ckpt_dir, keep_last)
    if mesh is not None:
        mesh.barrier()
    return final


def prune(ckpt_dir: str, keep_last: int) -> List[int]:
    """Delete all but the newest `keep_last` completed steps (and any
    stale ``.tmp`` debris); returns the deleted step numbers."""
    steps = completed_steps(ckpt_dir)
    doomed = steps[:-keep_last] if keep_last > 0 else []
    for s in doomed:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"))
    for name in os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else []:
        if name.endswith(".tmp") and _STEP_RE.match(name[:-4]):
            shutil.rmtree(os.path.join(ckpt_dir, name))
    return doomed


def completed_steps(ckpt_dir: str) -> List[int]:
    """Sorted step numbers of *complete* checkpoints: a final-named
    directory whose manifest made it to disk."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.isfile(
                os.path.join(ckpt_dir, name, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = completed_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load_leaf(d: str, path: str, meta: Dict[str, Any]) -> np.ndarray:
    """The stored array of one leaf, validated (bfloat16 as its uint16
    bits)."""
    fp = os.path.join(d, meta["file"])
    if not os.path.isfile(fp):
        raise CheckpointCorruptError(
            f"checkpoint {d}: leaf {path!r} is missing its data file "
            f"{meta['file']}")
    try:
        arr = np.load(fp)
    except Exception as e:
        raise CheckpointCorruptError(
            f"checkpoint {d}: leaf {path!r} is unreadable "
            f"({type(e).__name__}: {e}) — the file is truncated or "
            f"corrupt") from e
    if "nbytes" in meta and int(arr.nbytes) != int(meta["nbytes"]):
        raise CheckpointCorruptError(
            f"checkpoint {d}: leaf {path!r} has {arr.nbytes} bytes, "
            f"manifest recorded {meta['nbytes']} (truncated write)")
    if "crc32" in meta:
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
        if crc != int(meta["crc32"]):
            raise CheckpointCorruptError(
                f"checkpoint {d}: leaf {path!r} failed its CRC32 check "
                f"({crc:#010x} != {int(meta['crc32']):#010x}) — the "
                f"data is corrupt; refusing to restore garbage")
    return arr


def _to_torch(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _manifest(ckpt_dir: str, step: Optional[int]) -> Tuple[str, Dict, int]:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        return d, json.load(f), step


def verify(ckpt_dir: str, step: Optional[int] = None) -> int:
    """Validate every leaf of a checkpoint (CRC + sizes) without
    restoring it; returns the number of leaves checked.  Raises
    `CheckpointCorruptError` on the first bad leaf."""
    d, manifest, _ = _manifest(ckpt_dir, step)
    for path, meta in manifest["leaves"].items():
        _load_leaf(d, path, meta)
    return len(manifest["leaves"])


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            device=None, placements: Any = None,
            mesh=None) -> Tuple[Any, int]:
    """Restore into the structure of `like` (dicts, tuples and
    dataclasses of tensors and ints); returns (tree, step).  Each tensor
    leaf lands on `device` (default: the device of the leaf it
    replaces), an int leaf comes back an int.  A corrupt or truncated
    leaf, a leaf absent from the manifest, or one of another shape
    raises `CheckpointCorruptError`.  With `mesh` and `placements` the
    leaves of `like` are the rank's shards: the stored full leaf is
    checked against the full shape and the rank keeps its part."""
    where = _placed(placements, mesh)
    if mesh is not None:
        mesh.barrier()
    d, manifest, step = _manifest(ckpt_dir, step)
    out: Dict[str, Any] = {}
    for path, leaf in _flatten(like).items():
        if path not in manifest["leaves"]:
            raise CheckpointCorruptError(
                f"checkpoint {d}: leaf {path!r} absent from the "
                f"manifest (tree structure changed?)")
        meta = manifest["leaves"][path]
        arr = _load_leaf(d, path, meta)
        want = list(leaf.shape) if isinstance(leaf, torch.Tensor) else []
        dim = where.get(path)
        if dim is not None:
            want[dim] *= mesh.world
        if list(arr.shape) != want:
            raise CheckpointCorruptError(
                f"checkpoint {d}: leaf {path!r} has shape "
                f"{tuple(arr.shape)}, the tree restored into has "
                f"{tuple(want)}")
        if isinstance(leaf, torch.Tensor):
            dev = leaf.device if device is None else device
            if dim is None:
                out[path] = _to_torch(arr, meta["dtype"], dev)
            else:
                out[path] = mesh.shard(_to_torch(arr, meta["dtype"], "cpu"),
                                       dim).to(dev)
        else:
            out[path] = type(leaf)(arr.item())
    if mesh is not None:
        mesh.barrier()
    return _unflatten(out, like), step


def _unflatten(flat: Dict[str, Any], like: Any, prefix: str = "") -> Any:
    kids = _children(like)
    if kids is None:
        return flat[prefix]
    sub = lambda k: f"{prefix}/{k}" if prefix or not isinstance(
        like, dict) else k
    if isinstance(like, dict):     # in like's own key order
        return {k: _unflatten(flat, like[k], sub(str(k))) for k in like}
    vals = [_unflatten(flat, v, sub(k)) for k, v in kids]
    if isinstance(like, (list, tuple)):
        return type(like)(vals)
    return dataclasses.replace(like, **{
        f.name: v for f, v in zip(dataclasses.fields(like), vals)})
