"""Checkpoints with atomic commits: the port of the JAX package's
``checkpoint/ckpt.py``, with the same on-disk layout, so either package
restores the other's checkpoints bit for bit.

Layout per step:  <dir>/step_<n:08d>/
    manifest.json        step, sorted keys, tree structure, extra
    arrays.npz           leaves keyed by their ``/``-joined tree path;
                         bfloat16 stored as its uint16 bits under
                         ``<key>::bf16``

Writes go to a temporary directory that is renamed into place, so a crash
mid-save never leaves a partial checkpoint. Trees are nested dicts (and
lists) of tensors; restore loads into ``like``'s structure, each leaf on
its ``like`` leaf's device, with the checkpoint's dtype.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import threading
from typing import Any

import numpy as np
import torch

from .. import tree as T


def _host(leaf) -> np.ndarray:
    """A tensor (or array) as a numpy array; bfloat16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    flat = {}
    for key, leaf in T.leaves_with_paths(tree):
        if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
            flat[key + "::bf16"] = _host(leaf)
        else:
            flat[key] = _host(leaf)
    return flat


def _structure(tree: Any) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(v) for v in tree) + "]"
    return "*"


def save(directory: str | os.PathLike, step: int, tree: Any,
         extra: dict | None = None) -> pathlib.Path:
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = pathlib.Path(tempfile.mkdtemp(dir=directory, prefix=".tmp_"))
    try:
        flat = _flatten(tree)
        np.savez(tmp / "arrays.npz", **flat)
        manifest = {"step": step, "keys": sorted(flat),
                    "treedef": _structure(tree), "extra": extra or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return final


def latest_step(directory: str | os.PathLike) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _leaf(arr: np.ndarray, bf16: bool, like) -> torch.Tensor:
    if bf16:
        t = torch.from_numpy(arr.astype(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return t.to(dev)


def restore(directory: str | os.PathLike, like: Any,
            step: int | None = None) -> tuple[Any, int]:
    """Load into the structure of ``like``. Returns (tree, step)."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    data = np.load(directory / f"step_{step:08d}" / "arrays.npz")
    flat = {}
    for key, leaf in T.leaves_with_paths(like):
        bf16 = key + "::bf16" in data
        arr = data[key + "::bf16"] if bf16 else data[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"expected {tuple(leaf.shape)}")
        flat[key] = _leaf(arr, bf16, leaf)
    return T.tree_map(lambda _, k: flat[k], like, _paths(like)), step


def _paths(tree: Any, prefix: str = "") -> Any:
    """The tree with each leaf replaced by its path."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_paths(v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return prefix[:-1]


class CheckpointManager:
    """keep_n retention + optional async (background-thread) saves."""

    def __init__(self, directory: str | os.PathLike, keep_n: int = 3,
                 async_save: bool = True):
        self.directory = pathlib.Path(directory)
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any, extra: dict | None = None):
        self.wait()
        # snapshot off the device (a copy, so later in-place updates of
        # the tensors do not reach the writer thread)
        host_tree = T.tree_map(
            lambda t: t.detach().to("cpu", copy=True), tree)

        def work():
            save(self.directory, step, host_tree, extra)
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()

    def _gc(self):
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.directory.glob("step_*")
            if (p / "manifest.json").exists())
        for s in steps[: -self.keep_n]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)
