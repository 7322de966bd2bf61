"""Checkpoint manager: ``.npz`` + JSON manifest, keep-N garbage
collection, asynchronous save. Counterpart of ``repro.checkpoint.manager``
with its contract and its file format, so a checkpoint written by either
package restores in the other:

  * atomic commit: writes go to ``<dir>/tmp.<step>`` and are renamed to
    ``step_<%010d>`` only when complete, so a crash mid-save never leaves
    a checkpoint that counts;
  * ``arrays.npz`` holds one array a leaf, its ``/``-joined path with
    ``/`` written as ``__``; ``manifest.json`` holds the step, ``extra``
    (the trainer's ``data_step``) and each leaf's logical dtype and
    shape; a bfloat16 leaf is stored as its uint16 bits;
  * restart: ``latest_step`` and ``restore`` resume from the newest
    complete checkpoint;
  * asynchronous: ``save_async`` copies the state to host memory before it
    returns, then writes it in a background thread. The port's trainer
    updates its state in place (the next step, a graph replay, overwrites
    the same tensors), so the copy must be done by then.

The manager writes the tree it is given, as JAX's does: a tree of dicts
whose leaves are tensors or arrays. The trainer hands it its state in
JAX's tree layout (``models.convert.state_to_jax`` at the stack's period:
stacked layers, the layout of ``repro.train.steps``' state); ``restore``
returns that layout as CPU tensors and ``models.convert.load_state_``
copies it into a trainer's state tensors in place. Elastic re-sharding
(JAX's ``shardings``) has no counterpart on one device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

Tree = Any


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        out[prefix[:-1]] = tree
    else:
        raise TypeError(f"checkpoint leaf {prefix[:-1]!r} is a "
                        f"{type(tree).__name__}: the tree holds dicts of "
                        "tensors or arrays (a trainer state goes through "
                        "models.convert.state_to_jax first)")
    return out


def _host(tree: Tree) -> Tree:
    """A copy of the tree in host memory (waits for the card's queued
    work on each leaf)."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree, copy=True)


def _unflatten(flat: Dict[str, Any]) -> Tree:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _to_file(t):
    """-> (numpy array as stored, logical dtype name)."""
    if not isinstance(t, torch.Tensor):
        arr = np.asarray(t)
        return arr, str(arr.dtype)
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_file(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype), copy=True))


class CheckpointManager:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ save ---
    def save(self, step: int, tree: Tree,
             extra: Optional[Dict] = None) -> Path:
        """Write ``tree`` (dicts of tensors or arrays) as checkpoint
        ``step``."""
        tmp = self.dir / f"tmp.{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays = {}
        meta = {"step": step, "extra": extra or {}, "leaves": {}}
        for name, leaf in _flatten(tree).items():
            arr, dtype = _to_file(leaf)
            arrays[name.replace("/", "__")] = arr
            meta["leaves"][name] = {"dtype": dtype,
                                    "shape": list(arr.shape)}
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "manifest.json").write_text(json.dumps(meta))
        final = self.dir / f"step_{step:010d}"
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def save_async(self, step: int, tree: Tree,
                   extra: Optional[Dict] = None) -> None:
        """Copy the tree to host memory now (the copies wait for the
        card's queued work), write it in the background."""
        self.wait()
        self._thread = threading.Thread(
            target=self.save, args=(step, _host(tree), extra), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # --------------------------------------------------------- restore ---
    def latest_step(self) -> Optional[int]:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.dir.glob("step_*"))
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Dict[str, Any]:
        """-> {"step", "state" (JAX's layout, CPU tensors in their logical
        dtypes), "extra"} of checkpoint ``step`` (default the newest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step:010d}"
        meta = json.loads((path / "manifest.json").read_text())
        with np.load(path / "arrays.npz") as z:
            flat = {name: _from_file(z[name.replace("/", "__")],
                                     info["dtype"])
                    for name, info in meta["leaves"].items()}
        return {"step": meta["step"], "state": _unflatten(flat),
                "extra": meta["extra"]}

    # -------------------------------------------------------------- gc ---
    def _gc(self) -> None:
        steps = sorted(self.dir.glob("step_*"))
        for p in steps[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
