"""Cross-job step sharing: one process-wide step table (the counterpart of
``repro/engine/stepcache.py``).

Every ``SPBEngine(shared_cache=True)`` takes its step functions from
:data:`GLOBAL`, keyed on everything that determines what a step runs:

    (digest of aot.step_ident + the engine kind, depth tag,
     device fingerprint[, submesh fingerprint])

``step_ident`` drops the knobs that never reach a step (checkpoint and
log cadence, and the seed when compression is off), so two tenants that
differ only by data seed share every entry.  A step function of the port
is a plain closure over the configs (``dist/steps.py``): it holds no
session state, so sharing it is safe.  What cannot be shared is a CUDA
graph: it binds one engine's state buffers, so graphs stay per engine
(``engine/graphs.py``).

Two engines, one entry:

>>> from repro_torch.config import SPBConfig, TrainConfig
>>> from repro_torch.configs import reduced_config
>>> from repro_torch.engine import SPBEngine, stepcache
>>> stepcache.GLOBAL.clear()
>>> cfg = reduced_config("yi-6b")
>>> spb = SPBConfig(mode="temporal", k=2)
>>> a = SPBEngine(cfg, TrainConfig(seed=0), spb, device="cpu")
>>> b = SPBEngine(cfg, TrainConfig(seed=1), spb, device="cpu")
>>> a.step_fn(2) is b.step_fn(2)
True

The persistent half (``--compilation-cache-dir``): in the reference it is
jax's on-disk XLA cache; in the port it is the directory of kernel
libraries that ``nvcc`` builds (``kernels/_build.py``), which a second
process loads instead of compiling.
"""
from __future__ import annotations

import threading
from pathlib import Path
from typing import Any, Callable, Dict

from repro_torch.device import device_fingerprint  # noqa: F401 (the key's)
from repro_torch.kernels import _build


class StepCache:
    """A thread-safe ``key -> step function`` table with hit/miss stats.

    ``get_or_build`` runs ``builder`` outside the lock; a concurrent
    duplicate build resolves to whichever entry landed first, counted as
    a hit for the loser.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Any, Callable] = {}
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key: Any, builder: Callable[[], Callable]):
        with self._lock:
            fn = self._entries.get(key)
            if fn is not None:
                self.hits += 1
                return fn
        built = builder()
        with self._lock:
            fn = self._entries.setdefault(key, built)
            if fn is built:
                self.misses += 1
            else:
                self.hits += 1
            return fn

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "entries": len(self._entries)}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = 0
            self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


#: The process-wide table every ``SPBEngine(shared_cache=True)`` consults.
GLOBAL = StepCache()


# -- the persistent half: the kernel libraries (cross-process) --------------

def enable_persistent_compilation_cache(cache_dir) -> int:
    """Build and load the kernel libraries in ``cache_dir`` (created if
    needed) instead of ``build/repro_torch/``; a library already there is
    loaded, not compiled.  Returns the number of libraries already
    present, for :func:`persistent_cache_report`."""
    path = Path(cache_dir)
    path.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = path
    return _cache_entries(path)


def _cache_entries(path: Path) -> int:
    try:
        return sum(1 for p in Path(path).glob("lib*.so") if p.is_file())
    except OSError:
        return 0


def persistent_cache_report(cache_dir, entries_before: int) -> str:
    """The one-line hit/miss log for ``--compilation-cache-dir``."""
    now = _cache_entries(Path(cache_dir))
    new = max(0, now - entries_before)
    verdict = ("miss" if new else
               "hit — all compiles served from cache")
    return (f"[cc] persistent compilation cache {cache_dir}: "
            f"{new} new entries ({verdict}), {now} total")
