"""Fault-tolerant checkpoints: atomic publish, asynchronous writes, keep
the newest k, resume; the counterpart of ``repro.checkpoint.manager``.

The layout is the reference's, one directory a step::

    <root>/step_000100.tmp-<nonce>/   # written here first
    <root>/step_000100/               # renamed here, atomically, when whole
        manifest.json                 # tree, shapes, dtypes, step
        leaf_00000.npy ...

A crash mid-write leaves only a ``.tmp-*`` directory, which
``latest_step`` and ``restore_checkpoint`` ignore and ``gc_checkpoints``
removes.  ``CheckpointManager`` snapshots the tree to the host on the
caller's thread, so the train loop may overwrite its tensors at once, and
writes on a worker thread, keeping the newest ``keep`` checkpoints.

The port's checkpoints are not the reference's format, and neither
package reads the other's: the reference's manifest stores a JAX treedef,
and the port's stores its own description of the tree, the key path of
every leaf (``repro_torch.tree``) as JSON.  A leaf is a tensor, a numpy
array or a Python number; it is saved as a numpy array.  numpy has no
bfloat16, so a bfloat16 leaf is saved as its raw bits (``uint16``) with
``"bfloat16"`` in the manifest, and restored bit for bit as a bfloat16
tensor on the CPU; every other leaf comes back as a numpy array.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any

import numpy as np
import torch

from repro_torch import tree as T

_MANIFEST = "manifest.json"
_BF16 = "bfloat16"


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A copy of ``leaf`` on the host as (array to save, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), str(t.numpy().dtype)
    a = np.array(leaf)
    return a, str(a.dtype)


def _snapshot(tree: Any) -> tuple[list, list, list]:
    leaves, paths = T.flatten(tree)
    host = [_to_host(x) for x in leaves]
    return paths, [a for a, _ in host], [d for _, d in host]


def _write(root: str, step: int, paths, arrays, dtypes) -> str:
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + f".tmp-{uuid.uuid4().hex[:8]}"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "paths": paths, "n_leaves": len(arrays),
                "shapes": [list(a.shape) for a in arrays], "dtypes": dtypes}
    for i, a in enumerate(arrays):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), a)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)       # the atomic publish
    return final


def save_checkpoint(root: str, step: int, tree: Any) -> str:
    """A synchronous, atomic checkpoint of ``tree`` at ``step``; returns
    the published directory."""
    return _write(root, step, *_snapshot(tree))


def latest_step(root: str) -> int | None:
    """The newest step with a whole checkpoint under ``root``, or None."""
    if not os.path.isdir(root):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(root)
             if name.startswith("step_") and ".tmp" not in name
             and os.path.exists(os.path.join(root, name, _MANIFEST))]
    return max(steps) if steps else None


def restore_checkpoint(root: str, step: int | None = None) -> tuple[int, Any]:
    """(step, tree) of the checkpoint at ``step``, by default the newest
    whole one (``FileNotFoundError`` if there is none)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves = []
    for i, dtype in enumerate(manifest["dtypes"]):
        a = np.load(os.path.join(d, f"leaf_{i:05d}.npy"))
        leaves.append(torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                      if dtype == _BF16 else a)
    return manifest["step"], T.unflatten(manifest["paths"], leaves)


def gc_checkpoints(root: str, keep: int = 3) -> list[int]:
    """Remove the ``.tmp-*`` litter and all but the newest ``keep``
    checkpoints; returns the removed steps."""
    if not os.path.isdir(root):
        return []
    steps = []
    for name in list(os.listdir(root)):
        if ".tmp-" in name:
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)
        elif name.startswith("step_"):
            steps.append(int(name.split("_")[1]))
    removed = sorted(steps)[:-keep] if keep else []
    for s in removed:
        shutil.rmtree(os.path.join(root, f"step_{s:08d}"), ignore_errors=True)
    return removed


class CheckpointManager:
    """Asynchronous checkpoints with retention: ``save`` snapshots to the
    host and returns while a worker thread writes; the previous write is
    joined before a new one starts, and its error raised."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        self.wait()
        # the snapshot on the caller's thread: the loop may overwrite its
        # tensors as soon as this returns
        snapshot = _snapshot(tree)

        def work():
            try:
                _write(self.root, step, *snapshot)
                gc_checkpoints(self.root, self.keep)
            except Exception as e:      # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self) -> tuple[int, Any]:
        self.wait()
        return restore_checkpoint(self.root)
