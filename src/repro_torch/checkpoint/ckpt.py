"""Checkpointing: the port's trees <-> npz with a structure manifest
(counterpart of `repro/checkpoint/ckpt.py`).

A tree is a nested dict, NamedTuple, tuple or list whose leaves are torch
tensors (any dtype, any device) or numpy arrays.  Leaves go to host numpy
and into one `.npz` under their '/'-joined paths; the manifest beside it
holds the structure and a sha256 digest per leaf (`_digest`, the
reference's hashing, so equal arrays give equal digests in both packages).
A dtype numpy lacks (bfloat16, the float8 types) is stored as the integer
type of its width and viewed back on load.

Integrity: writes are atomic (tmp + fsync + rename, so a kill mid-write
leaves the previous file or none), and `load_pytree` raises
`CheckpointCorruptError` on an unreadable, truncated or digest-mismatched
file; `repro_torch.grid.segments` catches it and falls back to the
previous segment boundary.  A missing checkpoint is not corruption
(FileNotFoundError propagates: resume starts from scratch), and a
structure mismatch (the caller handed the wrong `like`) stays a
ValueError.

On a world of several ranks (`grid/shard.py`) every rank saves its own
files, tagged by its replica row and client block (`p{i}-r{row}c{block}-`),
not one gathered carry from rank 0: a rank's carry holds only its
replicas and its client block, so it writes and reads its own with no
collective at a segment boundary, each file O(N / shards) client rows, and
a resume restores each block where it was; `run_grid`'s fingerprint holds
the world's size, so a rerun on another world is refused.

The reference keeps its PRNG key inside the carry (`encode_prng_keys`).
The port's draws come from a `RunDraws` source outside the carry, so
`save_carry` / `load_carry` store each source's `state()` beside it and
put the sources back on load.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
import zipfile
import zlib
from typing import Any, Callable, Sequence

import numpy as np
import torch

Tree = Any
_SEP = "/"
_RAW_INTS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint exists on disk but cannot be trusted: unreadable npz,
    missing or undecodable manifest, or a per-leaf sha256 mismatch."""


def _digest(arr: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(repr(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def _atomic_write(path: str, writer: Callable) -> None:
    """Write via tmp + fsync + rename so readers never see a torn file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _children(tree) -> list | None:
    """(key, child) pairs of an inner node, None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _structure(tree) -> str:
    kids = _children(tree)
    if kids is None:
        return "*"
    inner = ",".join(f"{k}:{_structure(v)}" for k, v in kids)
    return f"{type(tree).__name__}({inner})"


def leaves_with_paths(tree, prefix: str = "") -> list:
    """(path, leaf) pairs of a tree, paths '/'-joined, in the order
    `rebuild_like` takes the leaves back."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pl for k, v in kids for pl in leaves_with_paths(
        v, f"{prefix}{_SEP}{k}" if prefix else k)]


def _raw_dtype(dtype: torch.dtype):
    """The integer dtype a torch dtype numpy lacks is stored as, else None."""
    try:
        torch.empty((0,), dtype=dtype).numpy()
        return None
    except TypeError:
        return _RAW_INTS[torch.empty((0,), dtype=dtype).element_size()]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        raw = _raw_dtype(t.dtype)
        return (t.view(raw) if raw is not None else t).cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree: Tree) -> dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in leaves_with_paths(tree)}


def rebuild_like(like, leaves):
    """`like`'s structure over `leaves` (an iterator, in
    `leaves_with_paths` order)."""
    kids = _children(like)
    if kids is None:
        return next(leaves)
    parts = [rebuild_like(v, leaves) for _, v in kids]
    if isinstance(like, dict):
        return {k: p for (k, _), p in zip(kids, parts)}
    if hasattr(like, "_fields"):
        return type(like)(*parts)
    return type(like)(parts)


def _like_leaf(arr: np.ndarray, ref):
    if isinstance(ref, torch.Tensor):
        t = torch.from_numpy(np.array(arr))
        raw = _raw_dtype(ref.dtype)
        t = t.view(ref.dtype) if raw is not None else t.to(ref.dtype)
        return t.to(ref.device)
    return np.asarray(arr, dtype=np.asarray(ref).dtype)


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _manifest_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".manifest.json"


def save_pytree(path: str, tree: Tree) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten_with_paths(tree)
    _atomic_write(_npz_path(path), lambda f: np.savez(f, **flat))
    manifest = {"treedef": _structure(tree), "keys": sorted(flat),
                "digests": {k: _digest(v) for k, v in flat.items()}}
    _atomic_write(_manifest_path(path),
                  lambda f: f.write(json.dumps(manifest).encode()))


def _load_manifest(path: str) -> dict:
    """The manifest dict, or {} when absent (then nothing is verified)."""
    try:
        with open(_manifest_path(path)) as f:
            return json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"unreadable checkpoint manifest {_manifest_path(path)!r}: {e!r}"
        ) from e


def load_pytree(path: str, like: Tree) -> Tree:
    """Load into the structure of `like` (shapes checked; each leaf takes
    its `like` leaf's dtype and, for a tensor, its device).

    Raises FileNotFoundError when the npz is absent (missing, not corrupt),
    CheckpointCorruptError when it is unreadable or fails digest
    verification, and ValueError on a structure mismatch with `like`."""
    npz_path = _npz_path(path)
    digests = _load_manifest(path).get("digests", {})
    try:
        npz = np.load(npz_path)
        files = sorted(npz.files)
    except FileNotFoundError:
        raise
    except (OSError, ValueError, KeyError, zipfile.BadZipFile,
            zlib.error) as e:
        raise CheckpointCorruptError(
            f"unreadable checkpoint {npz_path!r}: {e!r}") from e
    pairs = leaves_with_paths(like)
    if files != sorted(k for k, _ in pairs):
        raise ValueError(
            f"checkpoint structure mismatch: {files[:5]}... vs "
            f"{sorted(k for k, _ in pairs)[:5]}...")
    new_leaves = []
    for key, ref in pairs:
        try:
            arr = npz[key]
        except (OSError, ValueError, KeyError, zipfile.BadZipFile,
                zlib.error) as e:
            raise CheckpointCorruptError(
                f"unreadable leaf {key!r} in {npz_path!r}: {e!r}") from e
        if key in digests and _digest(arr) != digests[key]:
            raise CheckpointCorruptError(
                f"digest mismatch at leaf {key!r} in {npz_path!r}")
        want = tuple(getattr(ref, "shape", np.shape(ref)))
        if arr.shape != want:
            raise ValueError(f"shape mismatch at {key}: {arr.shape} vs "
                             f"{want}")
        new_leaves.append(_like_leaf(arr, ref))
    return rebuild_like(like, iter(new_leaves))


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_carry(path: str, carry: Tree, draws: Sequence = (), *,
               telemetry=None) -> None:
    """Checkpoint a scan-segment carry with the state of each draw source
    that continues it (`RunDraws.state()`, read now).  With a telemetry
    sink, emits `checkpoint_save` (path, bytes on disk, write seconds)."""
    t0 = time.perf_counter()
    save_pytree(path, {"carry": carry, "draws": [d.state() for d in draws]})
    if telemetry is not None:
        telemetry.emit("checkpoint_save", path=_npz(path),
                       nbytes=os.path.getsize(_npz(path)),
                       seconds=time.perf_counter() - t0)


def load_carry(path: str, like: Tree, draws: Sequence = (), *,
               telemetry=None) -> Tree:
    """Inverse of `save_carry`: returns the carry and puts each source in
    `draws` back where it was when the carry was saved.  With a telemetry
    sink, emits `checkpoint_load`."""
    snap = load_pytree(path, {"carry": like,
                              "draws": [d.state() for d in draws]})
    for d, state in zip(draws, snap["draws"]):
        d.set_state(state)
    if telemetry is not None:
        telemetry.emit("checkpoint_load", path=_npz(path))
    return snap["carry"]


def save_server_state(path: str, *, params: Tree, sv, counts,
                      round_idx: int, seed: int) -> None:
    save_pytree(path, {"params": params})
    base = path[:-4] if path.endswith(".npz") else path
    meta = {"round": int(round_idx), "seed": int(seed)}
    _atomic_write(base + ".meta.npz", lambda f: np.savez(
        f, sv=_to_numpy(sv), counts=_to_numpy(counts)))
    _atomic_write(base + ".meta.json",
                  lambda f: f.write(json.dumps(meta).encode()))


def load_server_state(path: str, params_like: Tree) -> dict:
    params = load_pytree(path, {"params": params_like})["params"]
    base = path[:-4] if path.endswith(".npz") else path
    with np.load(base + ".meta.npz") as meta_arr:
        sv, counts = meta_arr["sv"], meta_arr["counts"]
    with open(base + ".meta.json") as f:
        meta = json.load(f)
    return {"params": params, "sv": sv, "counts": counts,
            "round": meta["round"], "seed": meta["seed"]}
