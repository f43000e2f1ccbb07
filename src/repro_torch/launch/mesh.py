"""The data-parallel group: whatever ranks the job has, one data axis
(the counterpart of ``repro/launch/mesh.py``'s ``make_host_mesh``, whose
role is "the data axis is whatever devices you have").

:func:`init_data_group` makes this process's rank of the group, a
``dist/group.DataGroup`` (a group of one needs no process group):

* under ``torchrun`` it reads ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``
  (``init_method="env://"``);
* ranks that :func:`spawn` started on this machine meet in a ``file://``
  store in a temporary directory.

Rank r takes ``cuda:{local_rank % device_count}``.  The backend is
``nccl`` only when every rank of the machine has a card of its own; ranks
that share a card, and ranks on the CPU, take ``gloo`` (NCCL refuses two
ranks on one device, while gloo moves CUDA tensors through the host).  The
choice is printed once, by rank 0, and an error never changes it: a failed
collective raises.  ``init_process_group`` gets a timeout, so a dead peer
raises instead of hanging.

The sharding rules see the group as the reference's host mesh, axes
``("data", "model")`` of sizes ``(n, 1)`` (``dist/sharding.mesh_for``),
over which ``SPBEngine`` shards its optimizer state (ZeRO-1).  A rank that
fails ends the group (:func:`spawn` ends the others, as torchrun does), so
a group restarts only as a whole, from its last checkpoint
(``launch/train.py``).

The pipeline's grid (the counterpart of the reference's
``make_pipeline_mesh``): :func:`make_pipeline_mesh` gives its axes,
``("stage", "data")`` of ``(S, D)``, or ``("stage", "data", "model")`` of
``(S, D, T)`` with a tensor-parallel axis, and :func:`init_pipe_group`
makes this process's rank of it, a ``dist/group.PipeGroup`` (rank ``(s *
D + d) * T + t``), from torchrun's environment or from :func:`spawn`'s
store (``spawn(..., grid=(S, D, T))``, T 1 without tensor parallelism).
A pipeline always takes ``gloo``: its activations move by point-to-point
messages through the host, which NCCL would not take from host tensors,
and its ranks share a card.

The ``(data, model)`` grid of expert parallelism (the counterpart of the
reference's ``jax.make_mesh((D, T), ("data", "model"))`` that
``SPBEngine(mesh=)`` takes): :func:`init_grid_group` makes this process's
rank of it, a ``dist/group.GridGroup`` (rank ``d * T + t``), from
torchrun's environment or from :func:`spawn`'s store (``spawn(...,
grid=(D, T))``); its ``data`` group holds the D
ranks of one model index, its ``model`` group the T ranks of one data
index.  The backend is picked as for a data group.
:func:`make_mesh_from_config` and :func:`parallel_config_for` carry a
``config.ParallelConfig`` to a ``dist/sharding.Mesh`` and back.

The submeshes of spatial co-location (the counterpart of the reference's
``split_devices``, ``make_submeshes`` and ``assert_disjoint``):
:func:`make_submeshes` cuts a device's units into disjoint
:class:`Submesh` values, one a machine slot of ``cluster/live.py``'s spatial
mode.  On a card a unit is the driver's smallest partition of its SMs
(``device.card_units``: 8 SMs on an H100, 15 units and 12 SMs left over)
and a submesh holds a ``device.CardShare``, a green context over its SMs
with a stream of its own; memory stays the card's one pool.  On the CPU a
unit is a virtual slot of the one ``cpu`` device.  ``model_parallel > 1``
raises: one job over several shares in one process is not done.

The host mesh (the counterpart of the reference's ``make_host_mesh``):
:func:`make_host_mesh` gives ``("data", "model")`` of ``(n, 1)`` over this
process's devices, the visible cards or the one CPU.  A process is one
rank, so a mesh of several devices is a grid of ranks
(``serve/engine.ServeEngine(group=)`` takes the group, whose mesh is
``dist/sharding.mesh_for(group)``).

The production meshes (the counterpart of the reference's
``make_production_mesh``): :func:`make_production_mesh` gives the pod,
``("data", "model")`` of ``(16, 16)``, or with ``multi_pod`` ``("pod",
"data", "model")`` of ``(2, 16, 16)``, whose ``pod`` axis is an outer
data-parallel axis (:func:`parallel_config_for` gives ``dp_axes=("pod",
"data")``).  They are axes and sizes only: the dry run counts one rank of
them on the meta device (``launch/dryrun.py --pod``, ``--multi-pod``),
and a grid of ranks serves a mesh with a ``pod`` axis when its data group
holds pod x data ranks (``dist/steps.shard_decode_step``).
"""
from __future__ import annotations

import dataclasses
import datetime
import importlib
import itertools
import math
import os
import pickle
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import ParallelConfig
from repro_torch.device import (CardShare, card_units, device_fingerprint,
                                resolve_device)
from repro_torch.dist import sharding
from repro_torch.dist.group import (DEFAULT_TIMEOUT_S, DataGroup,
                                   GridGroup, ModelGroup, PipeGroup)

def pick_backend(device: torch.device, local_world: int) -> str:
    """``nccl`` when every rank of the machine (``local_world`` of them)
    has a card of its own, ``gloo`` otherwise (ranks that share a card;
    the CPU)."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def _rank_env(size: Optional[int], rank: Optional[int], device, store_dir,
              flag: str):
    """(size, rank, local rank, init method, device) of this process:
    torchrun's environment when it set one (``size``, if given, must
    agree), else ``size`` ranks meeting in a ``file://`` store under
    ``store_dir``.  Rank r takes ``cuda:{local_rank % device_count}``."""
    base = resolve_device(device)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        env_size = int(os.environ["WORLD_SIZE"])
        if size is not None and size != env_size:
            raise ValueError(f"{flag} {size} disagrees with "
                             f"torchrun's WORLD_SIZE={env_size}")
        size, rank = env_size, int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        init_method = "env://"
    else:
        size = 1 if size is None else size
        rank = 0 if rank is None else rank
        local_rank = rank
        init_method = None if store_dir is None else \
            f"file://{Path(store_dir).resolve()}/store"
    if base.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = base
    return size, rank, local_rank, init_method, dev


def init_data_group(size: Optional[int] = None, *, rank: Optional[int] = None,
                    device=None, store_dir=None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> DataGroup:
    """This process's rank of the data group.

    Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) the group comes
    from the environment and ``size``, if given, must agree with it.
    Otherwise ``size`` ranks meet in a ``file://`` store under
    ``store_dir`` (:func:`spawn` passes its temporary directory), this one
    as ``rank``.  ``device``: ``cuda`` (default; raises without a card) or
    ``cpu``."""
    size, rank, local_rank, init_method, dev = _rank_env(
        size, rank, device, store_dir, "--data-parallel")
    group = DataGroup(rank=rank, size=size, local_rank=local_rank,
                      device=dev, timeout_s=timeout_s)
    if size == 1:
        return group
    if init_method is None:
        raise ValueError("a group of several ranks outside torchrun needs "
                         "the store directory its ranks meet in")
    # the ranks on this machine: torchrun's, else every rank (a spawn)
    group.backend = pick_backend(
        dev, int(os.environ.get("LOCAL_WORLD_SIZE", size)))
    dist.init_process_group(group.backend, init_method=init_method,
                            rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    group.pg = dist.group.WORLD
    if rank == 0:
        cards = f" over {torch.cuda.device_count()} card(s)" \
            if dev.type == "cuda" else ""
        print(f"[mesh] data group of {size} ranks{cards}: "
              f"backend={group.backend} device={dev.type}", flush=True)
    return group


def make_host_mesh(device=None) -> sharding.Mesh:
    """Whatever fits this process's devices, one data axis: ``("data",
    "model")`` of ``(n, 1)``, n the visible cards on a card (``device``:
    ``cuda``, the default, raises without one) or 1 on the CPU."""
    dev = resolve_device(device)
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    return sharding.Mesh((n, 1), ("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> sharding.Mesh:
    """The production mesh: one pod, ``("data", "model")`` of ``(16,
    16)`` = 256 devices, or two pods, ``("pod", "data", "model")`` of
    ``(2, 16, 16)`` = 512, the ``pod`` axis an outer data-parallel axis
    whose collectives cross between pods.  A function that touches no
    device: the axes and sizes only."""
    if multi_pod:
        return sharding.Mesh((2, 16, 16), ("pod", "data", "model"))
    return sharding.Mesh((16, 16), ("data", "model"))


def make_mesh_from_config(pcfg: ParallelConfig) -> sharding.Mesh:
    """The mesh a ``ParallelConfig`` names (axes and sizes)."""
    return sharding.Mesh(pcfg.mesh_shape, pcfg.mesh_axes)


def parallel_config_for(mesh: sharding.Mesh) -> ParallelConfig:
    """A mesh's axis roles: ``pod`` and ``data`` shard the batch,
    ``model`` the weights, ``stage`` (if any) pipelines the stack."""
    axes = tuple(mesh.axis_names)
    return ParallelConfig(
        mesh_shape=tuple(mesh.shape[a] for a in axes), mesh_axes=axes,
        dp_axes=tuple(a for a in axes if a in ("pod", "data")),
        tp_axis="model", pp_axis="stage" if "stage" in axes else None)


# -- spatial submeshes: disjoint shares of one device ----------------------

def split_devices(sizes: Sequence[int],
                  devices: Optional[Sequence] = None) -> List[list]:
    """Partition ``devices`` (default: the units of the default device,
    :func:`device_units`) into disjoint contiguous groups of the given
    sizes.  Pure bookkeeping over any sequence — the submesh invariants
    are testable with plain ints:

    >>> split_devices([1, 3], devices=list(range(4)))
    [[0], [1, 2, 3]]
    >>> split_devices([2, 2], devices=list(range(3)))
    Traceback (most recent call last):
        ...
    ValueError: submesh sizes [2, 2] need 4 devices, have 3
    """
    if devices is None:
        devices = device_units()
    sizes = list(sizes)
    if not sizes or any(s < 1 for s in sizes):
        raise ValueError(f"submesh sizes must be >= 1, got {sizes}")
    need = sum(sizes)
    if need > len(devices):
        raise ValueError(f"submesh sizes {sizes} need {need} devices, "
                         f"have {len(devices)}")
    groups, at = [], 0
    for s in sizes:
        groups.append(list(devices[at:at + s]))
        at += s
    return groups


def device_units(device=None, need: int = 1) -> List[int]:
    """The units a device's submeshes are cut from: on a card the
    driver's smallest SM partitions (``device.card_units``), on the CPU
    ``need`` virtual slots of the one ``cpu`` device (the counterpart of
    the reference's ``--xla_force_host_platform_device_count`` devices,
    which are virtual too)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return list(range(card_units(dev).count))
    return list(range(need))


@dataclasses.dataclass(frozen=True, eq=False)
class Submesh:
    """One machine slot of the spatial cluster: ``units`` of ``device``,
    disjoint from every other submesh's.  On a card the units are SM
    partitions and ``share`` the :class:`~repro_torch.device.CardShare`
    (a green context over their ``sms`` SMs and its stream) that every
    step placed here runs on; on the CPU they are virtual slots and
    ``sms`` and ``share`` are None."""
    index: int
    device: torch.device
    units: Tuple[int, ...]
    sms: Optional[int] = None
    share: Optional[CardShare] = None

    def fingerprint(self) -> Tuple:
        """Hashable identity of the placement (the counterpart of the
        reference's ``mesh_fingerprint``): the device, the sorted units
        and the SMs.  A submesh rebuilt over the same units fingerprints
        equal; disjoint submeshes never collide."""
        return ("submesh", device_fingerprint(self.device),
                tuple(sorted(self.units)), self.sms)


def make_submeshes(sizes: Optional[Sequence[int]] = None, *,
                   count: Optional[int] = None, device=None,
                   model_parallel: int = 1) -> List[Submesh]:
    """Disjoint submeshes for spatial multi-job co-location: each machine
    slot of the cluster runtime maps to one submesh, so co-located jobs
    run concurrent train steps on separate shares of the device (on a
    card: separate SMs, each share with a stream of its own).

    Pass explicit per-submesh ``sizes`` (in units), or ``count`` to split
    the units as evenly as possible (earlier submeshes take the
    remainder).  Each size must divide by ``model_parallel``; above 1 it
    raises ``NotImplementedError``: a ``(data, model)`` submesh would
    spread one job over several shares in one process, which the port
    does not do (a job spans ranks through its data group instead)."""
    if (sizes is None) == (count is None):
        raise ValueError("pass exactly one of sizes= or count=")
    dev = resolve_device(device)
    units = device_units(dev, count if sizes is None else sum(sizes))
    if sizes is None:
        if count < 1 or count > len(units):
            raise ValueError(f"count={count} submeshes from "
                             f"{len(units)} devices")
        base, extra = divmod(len(units), count)
        sizes = [base + (1 if i < extra else 0) for i in range(count)]
    for s in sizes:
        if s % model_parallel:
            raise ValueError(f"submesh size {s} not divisible by "
                             f"model_parallel={model_parallel}")
    if model_parallel > 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: a (data, model) submesh "
            f"spreads one job over several shares of the device in one "
            f"process, which the port does not do; a job spans ranks "
            f"through its data group (launch/mesh.init_grid_group)")
    subs = []
    for i, group in enumerate(split_devices(sizes, devices=units)):
        if dev.type == "cuda":
            share = CardShare(dev, group)
            subs.append(Submesh(i, share.device, tuple(group), share.sms,
                                share))
        else:
            subs.append(Submesh(i, dev, tuple(group)))
    assert_disjoint(subs)
    return subs


def assert_disjoint(submeshes) -> None:
    """The spatial invariant: no unit of a device belongs to two
    submeshes."""
    seen: dict = {}
    for i, sub in enumerate(submeshes):
        dev = device_fingerprint(sub.device)
        for u in sub.units:
            if (dev, u) in seen:
                raise ValueError(f"unit {u} of {sub.device} appears in "
                                 f"submesh {seen[dev, u]} and {i}")
            seen[dev, u] = i


def _join_grid(what: str, shape, rank: int, init_method: Optional[str],
               backend: str, timeout_s: float) -> List[Any]:
    """Join the world of a row-major grid of ``shape`` as ``rank`` and
    return, for each axis, the process group of the ranks that differ from
    this one along that axis only: None where the axis has one rank, the
    world where it has them all.  Every rank makes every group, in one
    order (``new_group`` is collective)."""
    if init_method is None:
        raise ValueError(f"{what} of several ranks outside torchrun needs "
                         f"the store directory its ranks meet in")
    n = math.prod(shape)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=n, timeout=timeout)
    strides = [math.prod(shape[a + 1:]) for a in range(len(shape))]
    coord = [rank // st % m for st, m in zip(strides, shape)]
    mine: List[Any] = []
    for a, size in enumerate(shape):
        mine.append(None if size == 1 else dist.group.WORLD)
        if size in (1, n):
            continue
        others = [range(1) if b == a else range(m)
                  for b, m in enumerate(shape)]
        for at in itertools.product(*others):
            first = sum(c * st for c, st in zip(at, strides))
            pg = dist.new_group(ranks=[first + i * strides[a]
                                       for i in range(size)],
                                backend=backend, timeout=timeout)
            if all(c == coord[b] for b, c in enumerate(at) if b != a):
                mine[a] = pg
    return mine


def init_grid_group(data_parallel: int, model_parallel: int, *,
                    rank: Optional[int] = None, device=None, store_dir=None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> GridGroup:
    """This process's rank of a ``(data, model)`` grid of
    ``data_parallel`` x ``model_parallel`` ranks (``dist/group.
    GridGroup``; rank ``d * T + t``), from torchrun's environment (whose
    ``WORLD_SIZE`` must be their product) or from the store under
    ``store_dir``.  The backend as :func:`init_data_group` picks it."""
    D, T = data_parallel, model_parallel
    if D < 1 or T < 1:
        raise ValueError(f"grid of {D} x {T}: every factor must be >= 1")
    n, rank, local_rank, init_method, dev = _rank_env(
        D * T, rank, device, store_dir, "the grid's data x model ranks =")
    d, t = rank // T, rank % T
    group = GridGroup(rank=rank, size=n, local_rank=local_rank, device=dev,
                      timeout_s=timeout_s,
                      data=DataGroup(rank=d, size=D, local_rank=local_rank,
                                     device=dev, timeout_s=timeout_s,
                                     root=t),
                      model=ModelGroup(rank=t, size=T))
    if n == 1:
        return group
    backend = pick_backend(dev, int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    group.backend = group.data.backend = backend
    group.data.pg, group.model.pg = _join_grid(
        "a grid", (D, T), rank, init_method, backend, timeout_s)
    group.pg = dist.group.WORLD
    if rank == 0:
        cards = f" over {torch.cuda.device_count()} card(s)" \
            if dev.type == "cuda" else ""
        print(f"[mesh] grid of {D} data x {T} model ranks{cards}: "
              f"backend={backend} device={dev.type}", flush=True)
    return group


def make_pipeline_mesh(num_stages: int, *, data_parallel: int = 1,
                       model_parallel: int = 1) -> sharding.Mesh:
    """The pipeline's axes, ``("stage", "data")`` of ``(num_stages,
    data_parallel)``, or ``("stage", "data", "model")`` when
    ``model_parallel > 1``: microbatches stream along ``stage`` while each
    microbatch's rows split over ``data``, each stage's optimizer state
    ZeRO-1-shards over ``data`` (``dist/sharding.pipeline_state_pspec``),
    and ``model`` carries the column/row roles of the stages' weights."""
    if data_parallel < 1 or model_parallel < 1 or num_stages < 1:
        raise ValueError(f"pipeline mesh of {num_stages} stages x "
                         f"{data_parallel} x {model_parallel}: every factor "
                         f"must be >= 1")
    if model_parallel > 1:
        return sharding.Mesh((num_stages, data_parallel, model_parallel),
                             ("stage", "data", "model"))
    return sharding.Mesh((num_stages, data_parallel), ("stage", "data"))


def init_pipe_group(num_stages: int, data_parallel: int = 1,
                    model_parallel: int = 1, *, rank: Optional[int] = None,
                    device=None, store_dir=None,
                    timeout_s: float = DEFAULT_TIMEOUT_S) -> PipeGroup:
    """This process's rank of a pipeline of ``num_stages`` stages x
    ``data_parallel`` data ranks x ``model_parallel`` model ranks
    (``dist/group.PipeGroup``), from torchrun's environment (whose
    ``WORLD_SIZE`` must be their product) or from the store under
    ``store_dir``; the backend is ``gloo``."""
    S, D, T = num_stages, data_parallel, model_parallel
    n, rank, local_rank, init_method, dev = _rank_env(
        S * D * T, rank, device, store_dir, "--pipeline-stages x "
        "--pipeline-data-parallel x --tensor-parallel =")
    s, d, t = rank // (D * T), rank // T % D, rank % T
    at = lambda ss, dd, tt: (ss * D + dd) * T + tt     # noqa: E731
    group = PipeGroup(stage=s, num_stages=S, rank=rank, size=n,
                      local_rank=local_rank, device=dev, timeout_s=timeout_s,
                      data=DataGroup(rank=d, size=D, local_rank=local_rank,
                                     device=dev, timeout_s=timeout_s,
                                     root=at(s, 0, t)),
                      model=ModelGroup(rank=t, size=T))
    if n == 1:
        return group
    group.backend = group.data.backend = "gloo"
    group.pipe_pg, group.data.pg, group.model.pg = _join_grid(
        "a pipeline", (S, D, T), rank, init_method, "gloo", timeout_s)
    group.pg = dist.group.WORLD
    if rank == 0:
        cards = f" over {torch.cuda.device_count()} card(s)" \
            if dev.type == "cuda" else ""
        model = f" x {T} model ranks" if T > 1 else ""
        print(f"[mesh] pipeline of {S} stages x {D} data ranks{model}"
              f"{cards}: backend=gloo device={dev.type}", flush=True)
    return group


def _resolve_target(target: str) -> Callable:
    """The function named ``"module:function"``."""
    module, _, name = target.partition(":")
    if not name:
        raise ValueError(f"target {target!r} is not 'module:function'")
    return getattr(importlib.import_module(module), name)


def _rank_main(target: str, rank: int, n: int, device, tmp: str,
               threads: Optional[int], args, kwargs, grid=None) -> None:
    """One spawned rank: join the group (a ``(data, model)`` grid's when
    ``grid`` is ``(D, T)``, a pipeline's when it is ``(S, D, T)``), run
    ``target(group, *args, **kwargs)``, leave its result (or its
    traceback) in ``tmp``."""
    if threads:
        torch.set_num_threads(threads)
    try:
        if grid is None:
            group = init_data_group(n, rank=rank, device=device,
                                    store_dir=tmp)
        elif len(grid) == 2:
            group = init_grid_group(*grid, rank=rank, device=device,
                                    store_dir=tmp)
        else:
            group = init_pipe_group(*grid, rank=rank, device=device,
                                    store_dir=tmp)
        try:
            out = _resolve_target(target)(group, *args, **kwargs)
        finally:
            group.close()
        with open(Path(tmp) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        (Path(tmp) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def spawn(target: str, n: int, *args, device=None,
          timeout_s: float = 1800.0, threads: Optional[int] = None,
          grid=None, **kwargs) -> List[Any]:
    """Run ``target(group, *args, **kwargs)`` on ``n`` ranks of a data
    group on this machine, each a fresh process (start method ``spawn``:
    never a fork of a process that may hold a CUDA context), and return
    each rank's result, rank 0 first.  ``target`` names a function as
    ``"module:function"``; the arguments and results are pickled.

    A rank that fails ends the others and raises ``RuntimeError`` with its
    traceback; ranks still running after ``timeout_s`` are ended and
    ``TimeoutError`` is raised.  ``threads``: each rank's intra-op threads
    (default: the CPU's cores shared out on the CPU, torch's default on
    the card).  ``grid=(D, T)`` makes the ranks a ``(data, model)``
    grid's (:func:`init_grid_group`), ``grid=(S, D, T)`` a pipeline's
    (:func:`init_pipe_group`), instead of a data group's; ``n`` must be
    the grid's product."""
    if grid is not None and (len(grid) not in (2, 3)
                             or math.prod(grid) != n):
        raise ValueError(f"a grid {grid} is not (D, T) or (S, D, T) of "
                         f"{n} ranks")
    if threads is None and resolve_device(device).type == "cpu":
        threads = max(1, (os.cpu_count() or 1) // n)
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="data_group_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(target, r, n, device, tmp, threads, args,
                                   kwargs, grid))
                 for r in range(n)]
        for p in procs:
            p.start()
        try:
            _wait(procs, tmp, time.monotonic() + timeout_s, timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(n):
            with open(Path(tmp) / f"rank{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results


def _wait(procs, tmp: str, deadline: float, timeout_s: float) -> None:
    """Until every rank has exited 0; raise at the first that did not."""
    while True:
        codes = [p.exitcode for p in procs]
        for r, code in enumerate(codes):
            if code not in (None, 0):
                err = Path(tmp) / f"rank{r}.err"
                detail = err.read_text() if err.exists() else \
                    f"exit code {code}"
                raise RuntimeError(f"rank {r} of {len(procs)} failed:\n"
                                   f"{detail}")
        if all(code == 0 for code in codes):
            return
        if time.monotonic() > deadline:
            running = [r for r, c in enumerate(codes) if c is None]
            raise TimeoutError(f"ranks {running} still running after "
                               f"{timeout_s:.0f} s")
        time.sleep(0.05)
