"""Checkpoints of the train state: atomic, async, keep-N (the counterpart
of ``repro/checkpoint/manager.py``, in its on-disk format).

Layout: ``<dir>/step_<N>/arrays.npz`` + ``manifest.json``, written under
``<dir>/.tmp_step_<N>_<pid>`` and renamed into place, so a crash mid-write
never corrupts the latest checkpoint.  The npz keys are the tree paths
joined by ``/`` (``params/groups/0/0/mixer/wq``, ``opt/mu/...``, ``step`` as
a 0-d int32), so either package restores what the other wrote.  A bf16
tensor is stored as its raw 2-byte words (numpy dtype ``V2``, the bytes the
reference writes for an ``ml_dtypes.bfloat16`` array) and read back as
``torch.bfloat16``.  An async writer thread keeps the train loop from
waiting on the disk; ``wait()`` joins it and re-raises its failure.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

_BF16_WORDS = np.dtype("V2")


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{path: leaf}, dict keys sorted as ``jax.tree`` orders them."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16_WORDS)
        return t.numpy()
    return np.asarray(leaf, dtype=np.int32 if isinstance(leaf, int)
                      else None)


def _from_numpy(arr: np.ndarray, like):
    if isinstance(like, int):
        return int(arr)
    if not isinstance(like, torch.Tensor):
        return arr
    if arr.dtype == _BF16_WORDS:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _unflatten_into(tree_like, flat: Dict[str, np.ndarray], prefix=""):
    if isinstance(tree_like, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}/{k}" if prefix
                                   else str(k))
                for k, v in tree_like.items()}
    if isinstance(tree_like, (list, tuple)):
        return [_unflatten_into(v, flat, f"{prefix}/{i}" if prefix
                                else str(i))
                for i, v in enumerate(tree_like)]
    if prefix not in flat:
        raise KeyError(f"checkpoint missing array {prefix!r}")
    arr = flat[prefix]
    if tuple(arr.shape) != _shape(tree_like):
        raise ValueError(f"{prefix}: checkpoint shape {arr.shape} != "
                         f"{_shape(tree_like)}")
    return _from_numpy(arr, tree_like)


class CheckpointError(RuntimeError):
    """A checkpoint write failed.  For async writes the failure happened
    on the writer thread; it is re-raised from the next ``save()`` or
    ``wait()`` so a failed snapshot is never taken as durable."""


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, async_write: bool = True):
        self.dir = Path(directory)
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.dir.mkdir(parents=True, exist_ok=True)

    # -- write ------------------------------------------------------------
    def save(self, state, step: int) -> None:
        """Snapshot ``state`` (tensors copied to the host before this
        returns, so the caller may go on updating them in place) as
        ``step``."""
        self.wait()
        flat = {k: _to_numpy(v) for k, v in _flatten(state).items()}

        def write():
            tmp = self.dir / f".tmp_step_{step}_{os.getpid()}"
            tmp.mkdir(parents=True, exist_ok=True)
            np.savez(tmp / "arrays.npz", **flat)
            (tmp / "manifest.json").write_text(json.dumps({
                "step": step, "time": time.time(),
                "num_arrays": len(flat),
                "bytes": int(sum(a.nbytes for a in flat.values())),
            }))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)           # atomic publish
            self._gc()

        if self.async_write:
            def guarded():     # capture, don't swallow: wait() re-raises
                try:
                    write()
                except BaseException as e:
                    self._error = e

            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self) -> None:
        """Join any in-flight async write; re-raise its failure (once)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise CheckpointError(
                f"async checkpoint write under {self.dir} failed: "
                f"{err!r}") from err

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # -- read -------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, state_like, step: Optional[int] = None):
        """Restore into the structure of ``state_like`` (the latest step
        unless ``step`` names one): ``(state, step)``, the tensors on the
        CPU.  A missing array raises ``KeyError``, a mis-shaped one
        ``ValueError``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        with np.load(self.dir / f"step_{step}" / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten_into(state_like, flat), step
