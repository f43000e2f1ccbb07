"""Step-table persistence (the counterpart of ``repro/engine/aot.py``).

The reference serializes its compiled XLA executables, so a fresh
process runs the table without tracing or compiling.  A CUDA graph cannot
leave its process, so the port persists what a fresh process needs to
capture the same graphs without compiling anything:

    <cache>/<key>/manifest.json          compat metadata, the entry index
                                         and the kernel libraries
    <cache>/<key>/step_<tag>.json        one entry: its static-input
                                         signature and the kernel launches
                                         one replay makes
    <cache>/<key>/lib<name>-<digest>.so  a copy of every kernel library an
                                         entry launches

``load_aot`` (``engine/engine.py``, ``serve/engine.py``) loads those
libraries (no ``nvcc``) and captures the graphs in-process; a capture
whose launches differ from the entry's is refused.  ``<key>`` is a digest
of everything a step depends on: the model, optimizer and SPB configs
(less the knobs :func:`step_ident` drops), the batch's shapes and the env
(torch and CUDA versions, the device's name and compute capability, the
device count).  A manifest of another env raises :class:`AOTCompatError`;
a damaged manifest or entry, or a missing or stale library, reads as a
miss.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.engine.graphs import COUNTER_LIBS
from repro_torch.kernels import _build

DEFAULT_CACHE = (Path(__file__).resolve().parents[3] / "results"
                 / "aot_cache_torch")

_FMT_VERSION = 1
_ENV_KEYS = ("torch_version", "cuda_version", "device_name", "capability",
             "device_count")


class AOTCompatError(RuntimeError):
    """A stored step table is incompatible with this process."""


class AOTCorruptError(AOTCompatError):
    """A stored step table is damaged on disk (unparseable manifest or
    entry, a library that does not load or was built from other sources).
    A subclass of :class:`AOTCompatError`, so callers treating the cache as
    best-effort need one except clause; ``load_aot`` treats it as a miss."""


def _depth_tag(key: Any) -> str:
    return "full" if key is None else str(key)


def _untag_depth(tag: str) -> Any:
    if tag == "full":
        return None
    try:
        return int(tag)
    except ValueError:
        return tag                      # 'mb', 'decode', 'prefill_16'


def _shape_sig(tree: Any, prefix: str = "") -> list:
    """JSON-able ``[path, shape, dtype]`` rows of a (nested) dict of
    tensors, arrays or anything with ``shape`` and ``dtype``."""
    if isinstance(tree, dict):
        return [row for k in sorted(tree, key=str)
                for row in _shape_sig(tree[k], f"{prefix}{k}/")]
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        dtype = str(tree.dtype).replace("torch.", "")
        return [[prefix.rstrip("/"), [int(s) for s in tree.shape], dtype]]
    if isinstance(tree, (list, tuple)):
        return [row for i, v in enumerate(tree)
                for row in _shape_sig(v, f"{prefix}{i}/")]
    return [[prefix.rstrip("/"), None, type(tree).__name__]]


def _env_sig(device) -> Dict[str, Any]:
    dev = torch.device(device)
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        name = torch.cuda.get_device_name(index)
        cap = list(torch.cuda.get_device_capability(index))
    else:
        name, cap = dev.type, None
    return {"torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "device_name": name, "capability": cap,
            "device_count": (torch.cuda.device_count()
                             if torch.cuda.is_available() else 0)}


def step_ident(cfg, tcfg, spb, *, zero1: bool = False,
               donate: bool = False, remat: str = "none") -> Dict[str, Any]:
    """The config component shared by every step-identity key (the step
    table on disk, the process-wide step cache): the model, train and SPB
    configs with the fields that never reach a step scrubbed out.
    Checkpoint and logging knobs don't invalidate caches, and without
    gradient compression the data seed doesn't either, so same-config
    jobs that differ only by seed share one step.  ``zero1`` and
    ``donate`` keep the reference's key layout (the port has one device
    and updates in place).  ``remat``, the layer-recompute policy a step
    closes over, is the port's own: the reference's is a context variable
    its key does not read, so a table captured under one policy would
    replay under another."""
    train = dataclasses.asdict(tcfg) if tcfg is not None else {}
    for k in ("checkpoint_every", "checkpoint_dir", "keep_checkpoints",
              "log_every"):
        train.pop(k, None)
    if train.get("compression") == "none":
        # the seed reaches a step only through the compressors' generator
        train.pop("seed", None)
    return {
        "model": dataclasses.asdict(cfg),
        "train": train,
        "spb": dataclasses.asdict(spb) if spb is not None else {},
        "zero1": zero1,
        "donate": donate,
        "remat": remat,
    }


def cache_key(cfg, tcfg, spb, device, batch_shapes, *, zero1: bool = False,
              donate: bool = False, remat: str = "none", extra=None) -> str:
    """Digest identifying one step table: ``fmt``, :func:`step_ident`, the
    batch's shape signature and the env signature.  ``tcfg``/``spb`` may be
    None for tables with no training or SPB leg (the serve engine)."""
    ident = {
        "fmt": _FMT_VERSION,
        **step_ident(cfg, tcfg, spb, zero1=zero1, donate=donate,
                     remat=remat),
        "batch": _shape_sig(batch_shapes),
        "env": _env_sig(device),
    }
    if extra:
        ident["extra"] = extra
    blob = json.dumps(ident, sort_keys=True, default=str).encode()
    return f"{cfg.name}__{hashlib.sha256(blob).hexdigest()[:16]}"


def export_table(entries: Dict[Any, Dict[str, Any]], path, *, device,
                 meta: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``{key: record}`` under ``path``, where a record holds the
    entry's ``inputs`` signature, its ``launches`` a replay and the kernel
    ``libs`` it launches; each library is copied beside the entries.

    Additive: entries accumulate across exports into one directory as long
    as the manifest there was written by the same env; a manifest of
    another env is overwritten whole."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    env = {**(meta or {}), **_env_sig(device)}
    index: Dict[str, str] = {}
    libs: Dict[str, str] = {}
    mf_path = path / "manifest.json"
    if mf_path.exists():
        try:
            old = json.loads(mf_path.read_text())
            same_env = all(old.get("env", {}).get(k) == env[k]
                           for k in _ENV_KEYS)
            if old.get("fmt") == _FMT_VERSION and same_env:
                index = dict(old.get("entries", {}))
                libs = dict(old.get("libs", {}))
        except (json.JSONDecodeError, OSError, AttributeError):
            pass
    for key, record in entries.items():
        tag = _depth_tag(key)
        fname = f"step_{tag}.json"
        (path / fname).write_text(json.dumps(record, indent=1))
        index[tag] = fname
        for name in record.get("libs", ()):
            src, dst = _build.loaded_file(name), path / _build.lib_path(
                name).name
            if not dst.exists() or not dst.samefile(src):
                shutil.copyfile(src, dst)
            libs[name] = dst.name
    manifest = {"fmt": _FMT_VERSION, "env": env, "entries": index,
                "libs": libs}
    mf_path.write_text(json.dumps(manifest, indent=2))
    return path


def table_exists(path) -> bool:
    return (Path(path) / "manifest.json").exists()


def import_table(path, *, expect_device=None) -> Dict[Any, Dict[str, Any]]:
    """Read a stored step table: ``{key: record}``; its kernel libraries
    are loaded from the table's directory (no ``nvcc``).

    Raises :class:`AOTCompatError` when the manifest's env differs from
    this process's on ``expect_device`` (default: the manifest's own kind
    of device), :class:`AOTCorruptError` for a damaged manifest, entry or
    library, and ``FileNotFoundError`` for a missing entry or library."""
    path = Path(path)
    mf_path = path / "manifest.json"
    if not mf_path.exists():
        raise FileNotFoundError(f"no step table at {path}")
    try:
        manifest = json.loads(mf_path.read_text())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise AOTCorruptError(f"unparseable manifest {mf_path}: {e}") from e
    if not isinstance(manifest, dict):
        raise AOTCorruptError(f"manifest {mf_path} is not an object")
    if manifest.get("fmt") != _FMT_VERSION:
        raise AOTCompatError(
            f"step-table format {manifest.get('fmt')} != {_FMT_VERSION}")
    env = manifest.get("env", {})
    if expect_device is None:
        expect_device = "cuda" if env.get("capability") else "cpu"
    live = _env_sig(expect_device)
    for k in _ENV_KEYS:
        if env.get(k) != live[k]:
            raise AOTCompatError(
                f"stored for {k}={env.get(k)!r}, this process has "
                f"{live[k]!r}")
    table: Dict[Any, Dict[str, Any]] = {}
    for tag, fname in manifest.get("entries", {}).items():
        entry = path / fname
        if not entry.exists():
            # the manifest promises an entry that is gone: a miss for the
            # whole table (callers capture anew), not a crash
            raise FileNotFoundError(f"step-table entry {entry} missing")
        try:
            record = json.loads(entry.read_text())
            if not isinstance(record, dict) or not isinstance(
                    record.get("launches"), dict):
                raise ValueError("not a step-table record")
        except (ValueError, UnicodeDecodeError) as e:
            raise AOTCorruptError(f"corrupt entry {entry}: {e}") from e
        table[_untag_depth(tag)] = record
    _load_libs(path, manifest.get("libs", {}))
    return table


def _load_libs(path: Path, libs: Dict[str, str]) -> None:
    """Load each stored kernel library in place of building it.  A library
    built from other sources than this checkout's is stale: a miss."""
    for name, fname in libs.items():
        if fname != _build.lib_path(name).name:
            raise AOTCorruptError(
                f"library {fname} was built from other sources than "
                f"{_build.lib_path(name).name}")
        lib = path / fname
        if not lib.exists():
            raise FileNotFoundError(f"step-table library {lib} missing")
        if name in _build._LIBS:
            continue                    # this process has it already
        try:
            _build.load_library(name, lib)
        except OSError as e:
            raise AOTCorruptError(f"library {lib} does not load: {e}") from e


def read_manifest(path) -> Dict[str, Any]:
    return json.loads((Path(path) / "manifest.json").read_text())


def entry_libs(launches: Dict[str, int]) -> list:
    """The kernel libraries behind the counters an entry launched."""
    return sorted({COUNTER_LIBS[n] for n, c in launches.items() if c})


def check_launches(what: str, got: Dict[str, int],
                   want: Dict[str, int]) -> None:
    """Refuse a capture whose launches a replay differ from its stored
    entry's."""
    got = {n: c for n, c in got.items() if c}
    want = {n: c for n, c in want.items() if c}
    if got != want:
        raise AOTCompatError(f"{what}: the capture launches {got}, the "
                             f"stored entry {want}")

