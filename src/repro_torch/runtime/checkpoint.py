"""Atomic step checkpoints of nested dicts / NamedTuples / lists of
tensors (the reference package's ``runtime/checkpoint.py``).

Layout:  <dir>/step_<N>/
             manifest.json            leaf keys, shapes, dtypes, step, extra
             <leafkey>.npy            one file per leaf
         <dir>/LATEST                 atomically updated pointer

Guarantees:
* step-atomic: the step directory is staged under a ``.tmp`` name and
  renamed, and LATEST is written, fsynced and renamed only after every
  leaf and the fsynced manifest have landed, so a crash mid-save never
  corrupts the restore point;
* async: ``AsyncCheckpointer.save`` copies every leaf to host memory before
  its thread starts (``.cpu()`` of a CPU tensor is the same storage, which
  the next step's update would overwrite under the writer), then writes on
  a background thread; ``keep`` newest steps are kept;
* restore checks every leaf's shape against the tree it restores into and
  refuses a checkpoint that lacks one.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _items(node):
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(tree, prefix: str = "") -> dict:
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _rebuild(tree, leaves: dict, prefix: str = ""):
    items = _items(tree)
    if items is None:
        return leaves[prefix]
    vals = [_rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k))
            for k, v in items]
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), vals))
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def _host_copy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _snapshot(tree) -> dict:
    return {k: _host_copy(v) for k, v in _flatten(tree).items()}


def save(ckpt_dir: str, step: int, tree: Any, extra: Optional[dict] = None):
    """Synchronous atomic save."""
    _write(ckpt_dir, step, _snapshot(tree), extra or {})


class AsyncCheckpointer:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        self.wait()
        flat = _snapshot(tree)
        self._thread = threading.Thread(
            target=self._save_bg, args=(step, flat, extra or {}), daemon=True)
        self._thread.start()

    def _save_bg(self, step, flat, extra):
        _write(self.dir, step, flat, extra)
        _gc(self.dir, self.keep)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def _write(ckpt_dir: str, step: int, flat: dict, extra: dict):
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra, "leaves": {}}
    for key, arr in flat.items():
        fn = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fn), arr)
        manifest["leaves"][key] = {"file": fn, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
        f.flush()
        os.fsync(f.fileno())
    os.rename(latest_tmp, os.path.join(ckpt_dir, "LATEST"))


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if re.fullmatch(r"step_\d+", d))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, tree_like: Any,
            step: Optional[int] = None) -> Tuple[Any, dict, int]:
    """Restore into the structure of ``tree_like`` (shapes validated), as
    CPU tensors.  Returns (tree, extra, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat_like = _flatten(tree_like)
    leaves = {}
    for key, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(d, meta["file"]))
        if key in flat_like and tuple(arr.shape) != tuple(flat_like[key].shape):
            raise ValueError(f"checkpoint leaf {key} shape {arr.shape} != "
                             f"expected {tuple(flat_like[key].shape)}")
        leaves[key] = torch.from_numpy(arr)
    missing = set(flat_like) - set(leaves)
    if missing:
        raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]}...")
    return _rebuild(tree_like, leaves), manifest["extra"], manifest["step"]
