"""Build the CUDA sources in ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` into
``build/repro_torch/lib<name>-<digest>.so`` at the repository root (a
git-ignored directory), where ``<digest>`` hashes the source, the shared
headers and the flags: a changed source rebuilds, an unchanged one loads.
The sources have a plain C interface (pointers, ints, the stream) and
return ``cudaGetLastError()``; :func:`check` turns a non-zero code into a
:class:`KernelError`, with the message of the ``kernel_error_string``
entry that every source gets from ``csrc/kernel_common.cuh``.  Builds happen at first use,
never at import, and only from the sources in this package.  The
compiler's output (``-Xptxas -v``: each kernel's registers, spills and
static shared memory) is kept beside the library, :func:`build_log`.

The meta device: while a dry run counts a step on a host with no card
(``launch/dryrun.py``, a sink in :data:`META_SINKS`), a wrapper given
meta tensors runs its own checks and allocates its outputs as on the
card, then reports the launch to :func:`meta_launch` in place of making
it.  Nothing is computed and nothing runs in the kernel's place; with no
sink a meta tensor is refused as any other device (:func:`kernel_device`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("flash_fwd", "flash_delta", "flash_dq", "flash_dkv", "ssd_fwd",
           "ssd_bwd", "rglru")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LIB_FILES: Dict[str, Path] = {}        # the file each loaded library came from

# who hears of a launch on the meta device, innermost last: a callable of
# (kernel name, its work function's arguments, (flops, bytes))
META_SINKS: List[Callable[[str, dict, Tuple[float, float]], None]] = []


class KernelError(RuntimeError):
    """A kernel failed to build, load or launch.  A subclass of
    ``RuntimeError``, so every ``except RuntimeError`` still catches it; a
    loop that retries failed steps re-raises it instead, since a kernel
    fault is not transient."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and Path(cand).is_file():
            return cand
    raise KernelError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                      "cannot be built")


def lib_path(name: str) -> Path:
    """The library ``csrc/<name>.cu`` builds into."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile every named source whose library is missing, all ``nvcc``
    processes at once; returns the seconds spent.  Raises with the
    compiler's output if any build fails."""
    t0 = time.perf_counter()
    todo = [(n, lib_path(n)) for n in names if not lib_path(n).is_file()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            out.with_suffix(".log").write_bytes(log)
    if failures:
        raise KernelError("nvcc failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def build_variants(sources: Dict[str, str], out_dir: Path
                   ) -> Dict[str, Tuple[ctypes.CDLL, str]]:
    """Compile each ``{name: CUDA source text}`` with this module's flags
    (headers from ``csrc/``) into ``out_dir/lib<name>.so``, all ``nvcc``
    processes at once, and load it: ``{name: (library, nvcc output)}``.
    For the analysis scripts that time variants of a kernel; raises with
    the compiler's output if any build fails."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o",
             str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise KernelError(f"nvcc failed for {name}:\n{log}")
        built[name] = (ctypes.CDLL(str(out_dir / f"lib{name}.so")), log)
    return built


def build_log(name: str) -> str:
    """What ``nvcc`` printed when it built ``csrc/<name>.cu``."""
    log = lib_path(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.is_file() else ""


def nvcc_tool(tool: str) -> str:
    """A program of the CUDA toolkit beside ``nvcc`` (e.g. cuobjdump)."""
    return str(Path(_nvcc()).parent / tool)


def load_library(lib_name: str, path: Path) -> ctypes.CDLL:
    """Load the library of ``csrc/<lib_name>.cu`` from ``path`` (a build,
    or a stored step table's copy) as the one this process launches."""
    lib = ctypes.CDLL(str(path))
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    _LIBS[lib_name] = lib
    _LIB_FILES[lib_name] = Path(path)
    return lib


def loaded_file(lib_name: str) -> Path:
    """The file this process loaded ``lib<lib_name>`` from (its build
    when it has not been loaded yet)."""
    return _LIB_FILES.get(lib_name, lib_path(lib_name))


def function(lib_name: str, fn_name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``fn_name`` of ``lib<lib_name>``, building and loading
    the library on first use."""
    lib = _LIBS.get(lib_name)
    if lib is None:
        build([lib_name])
        lib = load_library(lib_name, lib_path(lib_name))
    fn = getattr(lib, fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(lib_name: str, code: int) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if code != 0:
        msg = _LIBS[lib_name].kernel_error_string(code).decode()
        raise KernelError(f"{lib_name}: CUDA error {code} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on ``t``'s device, the last
    argument of every C entry."""
    return torch.cuda.current_stream(t.device).cuda_stream


def kernel_device(t: torch.Tensor, what: str) -> str:
    """The type of ``t``'s device where a ``what`` kernel takes it:
    ``cuda``, or ``meta`` while a sink counts launches; raises for any
    other."""
    kind = t.device.type
    if kind == "cuda" or (kind == "meta" and META_SINKS):
        return kind
    raise ValueError(f"no {what} kernel for device {t.device}")


def meta_launch(name: str, work: Callable[..., Tuple[float, float]],
                **shape) -> None:
    """A wrapper's launch of kernel ``name`` on meta tensors: hands the
    innermost of :data:`META_SINKS` the kernel's ``work(**shape)``."""
    if META_SINKS:
        META_SINKS[-1](name, shape, work(**shape))
