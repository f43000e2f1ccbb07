"""The data-parallel group, the ``(data, model)`` grid of expert
parallelism and the pipeline's ``(stage, data, model)`` grid at run time:
one rank's view of each and its collectives (what the steps and the
engine use; ``launch/mesh.py`` makes the groups and spawns their ranks).
:class:`GridGroup` is the ``(data, model)`` grid's, :class:`PipeGroup`
the pipeline's, and :class:`ModelGroup` the ``model`` axis of either
(below).

A :class:`DataGroup` holds its rank, the group's size, its local rank, its
device, the backend, the ``ProcessGroup``, and the subgroups of the last
``c`` ranks that spatial SPB's re-reduce uses
(``core/spb.subgroup_allreduce``), keyed by ``c``.  A group of one needs
no process group: every collective is then the identity.  A failed
collective raises.

Its collectives: the all-reduce of the gradients and metrics, a
pipeline's ZeRO-2 reduce-scatter of a stage gradient onto a rank's slice,
the all-gather that rebuilds each parameter from the ranks' ZeRO-1 slices
(``optim/optimizers.apply_updates`` updates a rank's slice only), the
gather of a sharded optimizer leaf to rank 0 for a checkpoint, an int's
broadcast and a barrier.  Each runs on the tensors where they lie: gloo
takes CUDA tensors for every one of them (staging them through the host
itself), as NCCL does.  On the meta device nothing moves: a dry run's
``analysis/cost.CostMode`` counts the collective from :data:`META_SINKS`
instead, and nothing else is done.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import time
from typing import Any, Callable, Dict, List, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0

# who counts a collective on meta tensors: (kind, group size, payload bytes,
# site); ``analysis/cost.CostMode`` pushes its own while it counts
META_SINKS: List[Callable[[str, int, float, str], None]] = []


def _counted_on_meta(kind: str, n: int, t: torch.Tensor,
                     payload: float) -> bool:
    """True when ``t`` is a meta tensor: the collective is reported to the
    innermost sink, if one counts, and not run."""
    if not t.is_meta:
        return False
    if META_SINKS:
        META_SINKS[-1](kind, n, payload, f"{t.dtype} {tuple(t.shape)}")
    return True


def _moved_gather(pg, t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """Every rank's ``t`` joined along ``dim`` in rank order (one
    ``all_gather_into_tensor`` on dim 0 of a contiguous copy)."""
    src = t.movedim(dim, 0).contiguous()
    buf = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(buf, src, group=pg)
    return buf.movedim(0, dim)


def _moved_scatter(pg, t: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum of every rank's ``t`` (one
    ``reduce_scatter_tensor`` on dim 0 of a contiguous copy)."""
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n,) + tuple(src.shape[1:]),
                      dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, src, group=pg)
    return out.movedim(0, dim)


@dataclasses.dataclass
class DataGroup:
    """One rank's view of the data-parallel group."""
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    pg: Any = None                  # the ProcessGroup; None at size 1
    timeout_s: float = DEFAULT_TIMEOUT_S
    # contributor count c -> the ProcessGroup of the last c ranks (or
    # ``GroupMember.NON_GROUP_MEMBER`` on the others)
    subgroups: Dict[int, Any] = dataclasses.field(default_factory=dict)
    # host seconds spent inside this rank's collectives
    reduce_s: float = 0.0
    # the global rank of this group's rank 0 (a pipeline stage's data
    # group is a subgroup of the world)
    root: int = 0

    def make_subgroups(self, counts) -> None:
        """Create the subgroups of the last ``c`` ranks for each ``c`` of
        ``counts`` with 1 < c < size that has none yet, in increasing
        order.  ``new_group`` is collective, so every rank calls this with
        the same counts at the same point (when a step is built)."""
        for c in sorted(set(counts)):
            if 1 < c < self.size and c not in self.subgroups:
                self.subgroups[c] = dist.new_group(
                    ranks=list(range(self.size - c, self.size)),
                    backend=self.backend,
                    timeout=datetime.timedelta(seconds=self.timeout_s))

    def all_reduce(self, t: torch.Tensor,
                   contributors: Optional[int] = None) -> torch.Tensor:
        """Sum ``t`` in place over the group, or over its last
        ``contributors`` ranks (their subgroup, made by
        :meth:`make_subgroups`); the identity for a rank outside that
        subgroup and for a group or subgroup of one.  Returns ``t``."""
        c = self.size if contributors is None else min(contributors,
                                                       self.size)
        if c <= 1 or self.rank < self.size - c:
            return t
        if _counted_on_meta("all-reduce", c, t, t.numel() * t.element_size()):
            return t
        pg = self.pg if c == self.size else self.subgroups[c]
        t0 = time.perf_counter()
        dist.all_reduce(t, group=pg)
        self.reduce_s += time.perf_counter() - t0
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Fill ``t`` in place from every rank's slice along ``dim``: rank
        r holds ``t.narrow(dim, r s, s)`` with ``s = t.shape[dim] / n``
        (:func:`dist.sharding.shard_slices`), written before the call; the
        other ranks' slices arrive.  ``t`` must be contiguous.  A slice on
        dim 0 is gathered into ``t`` itself; on another dim into a
        temporary of ``t``'s size, then copied into place.  Returns
        ``t``."""
        n = self.size
        if n == 1:
            return t
        s = t.shape[dim] // n
        if _counted_on_meta("all-gather", n, t, t.numel() * t.element_size()):
            return t
        mine = t.narrow(dim, self.rank * s, s).clone(
            memory_format=torch.contiguous_format)
        t0 = time.perf_counter()
        if dim == 0:
            dist.all_gather_into_tensor(t, mine, group=self.pg)
        else:
            buf = torch.empty((n * mine.shape[0],) + tuple(mine.shape[1:]),
                              dtype=t.dtype, device=t.device)
            dist.all_gather_into_tensor(buf, mine, group=self.pg)
            t.unflatten(dim, (n, s)).copy_(
                buf.view((n,) + tuple(mine.shape)).movedim(0, dim))
        self.reduce_s += time.perf_counter() - t0
        return t

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` (:func:`dist.sharding.
        shard_slices`'s) of the sum of every rank's ``t``, a new contiguous
        tensor: ZeRO-2's gradient reduce (gloo's ``reduce_scatter_tensor``
        on a copy with ``dim`` first)."""
        n = self.size
        if n == 1:
            return t
        if _counted_on_meta("reduce-scatter", n, t,
                            t.numel() * t.element_size()):
            return t.narrow(dim, 0, t.shape[dim] // n).contiguous()
        t0 = time.perf_counter()
        out = _moved_scatter(self.pg, t, dim, n).contiguous()
        self.reduce_s += time.perf_counter() - t0
        return out

    def gather(self, t: torch.Tensor, dim: int = 0
               ) -> Optional[torch.Tensor]:
        """Every rank's slice ``t`` (all of one shape), joined along
        ``dim`` in rank order on rank 0: the whole tensor there, on
        ``t``'s device; None on the other ranks.  A checkpoint's
        gather."""
        if self.size == 1:
            return t
        out = [torch.empty_like(t, memory_format=torch.contiguous_format)
               for _ in range(self.size)] if self.rank == 0 else None
        if _counted_on_meta("gather", self.size, t,
                            self.size * t.numel() * t.element_size()):
            return torch.cat(out, dim) if out is not None else None
        t0 = time.perf_counter()
        dist.gather(t.contiguous(), out, dst=self.root, group=self.pg)
        self.reduce_s += time.perf_counter() - t0
        return torch.cat(out, dim) if out is not None else None

    def barrier(self) -> None:
        """Wait until every rank of the group has reached this call."""
        if self.size == 1:
            return
        t0 = time.perf_counter()
        dist.barrier(group=self.pg)
        self.reduce_s += time.perf_counter() - t0

    def shard(self, batch: Dict[str, torch.Tensor], chunks: int = 1
              ) -> Dict[str, torch.Tensor]:
        """This rank's rows of a global batch: rows ``[r B/n, (r+1) B/n)``.
        A step that splits its batch into ``chunks`` microbatches (the
        temporal-mb cycle) takes this rank's n-th of each chunk instead,
        so that its j-th microbatch is its share of the global batch's
        j-th, as when one process splits the global batch."""
        if self.size == 1:
            return batch
        rows = next(iter(batch.values())).shape[0]
        if rows % (self.size * chunks):
            raise ValueError(
                f"a global batch of {rows} rows does not split over "
                f"{self.size} ranks" + (f" x {chunks} microbatches"
                                        if chunks > 1 else ""))
        c = rows // chunks
        part = c // self.size
        lo = self.rank * part
        return {k: torch.cat([t[j * c + lo:j * c + lo + part]
                              for j in range(chunks)])
                for k, t in batch.items()}

    def broadcast_int(self, value: Optional[int]) -> Optional[int]:
        """Rank 0's ``value`` (an int or None) on every rank."""
        if self.size == 1:
            return value
        dev = self.device if self.backend == "nccl" else "cpu"
        t = torch.tensor([-1 if value is None else value], dtype=torch.int64,
                         device=dev)
        dist.broadcast(t, src=self.root, group=self.pg)
        got = int(t.item())
        return None if got < 0 else got

    def close(self) -> None:
        """Tear down the process group (a no-op at size 1)."""
        if self.pg is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.pg = None
        self.subgroups.clear()


@dataclasses.dataclass
class ModelGroup:
    """One rank's view of a ``model`` axis: the T ranks of one ``(stage,
    data)`` index of a pipeline, over which a stage's attention and FFN
    weights are column/row-sharded, or of one data index of a ``(data,
    model)`` grid, over which a MoE layer's experts are sharded
    (``models/layers.py``'s collective pairs and ``models/moe.py``'s
    exchange run on it).  A group of one needs no process group: every
    collective is then the identity.

    Each collective is out of place (an autograd Function's forward and
    backward call it) and runs on the tensors where they lie: gloo takes
    CUDA tensors for all four, staging them through the host itself.  A
    reduce-scatter is gloo's own ``reduce_scatter_tensor``, an all-to-all
    its ``all_to_all_single`` (probed once on an H100 under torch 2.11:
    two ranks sharing the card exchanged CUDA chunks exactly, so no host
    buffer is staged by hand, unlike a pipeline's sends; nothing switches
    transport at run time, and a failed exchange raises).  ``reduce_s``
    counts the host seconds inside them, and ``seconds``, ``calls`` and
    ``bytes`` the host seconds, the calls and the payload bytes (the
    input's; an all-gather's output) by kind: ``all-reduce``,
    ``all-gather``, ``reduce-scatter`` and ``all-to-all``.  On the meta
    device nothing moves: a dry run's ``analysis/cost.CostMode`` counts the
    collective from :data:`META_SINKS`."""
    rank: int = 0
    size: int = 1
    pg: Any = None                  # the ProcessGroup; None at size 1
    reduce_s: float = 0.0
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    def _count(self, kind: str, nbytes: int, t0: float) -> None:
        """One call of ``kind`` that began at host time ``t0``."""
        dt = time.perf_counter() - t0
        self.reduce_s += dt
        self.seconds[kind] = self.seconds.get(kind, 0.0) + dt
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.bytes[kind] = self.bytes.get(kind, 0) + nbytes

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (a new tensor)."""
        if self.size == 1:
            return t
        nbytes = t.numel() * t.element_size()
        out = t.clone(memory_format=torch.contiguous_format)
        if _counted_on_meta("all-reduce", self.size, t, nbytes):
            return out
        t0 = time.perf_counter()
        dist.all_reduce(out, group=self.pg)
        self._count("all-reduce", nbytes, t0)
        return out

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` joined along ``dim`` in rank order."""
        if self.size == 1:
            return t
        n = self.size
        nbytes = n * t.numel() * t.element_size()
        if _counted_on_meta("all-gather", n, t, nbytes):
            shape = list(t.shape)
            shape[dim] *= n
            return t.new_empty(shape)
        t0 = time.perf_counter()
        out = _moved_gather(self.pg, t, dim, n)
        self._count("all-gather", nbytes, t0)
        return out

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice along ``dim`` (``t.shape[dim] / n`` long, at
        ``rank``) of the sum of every rank's ``t``."""
        if self.size == 1:
            return t
        n = self.size
        nbytes = t.numel() * t.element_size()
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"over {n} ranks")
        if _counted_on_meta("reduce-scatter", n, t, nbytes):
            return t.narrow(dim, 0, t.shape[dim] // n).clone()
        t0 = time.perf_counter()
        out = _moved_scatter(self.pg, t, dim, n)
        self._count("reduce-scatter", nbytes, t0)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """The exchange of equal chunks along dim 0: chunk j of ``t`` goes
        to rank j, and chunk j of the result (a new tensor) came from
        rank j.  Its own adjoint."""
        if self.size == 1:
            return t
        n = self.size
        if t.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(t.shape)} does not split "
                             f"over {n} ranks")
        nbytes = t.numel() * t.element_size()
        if _counted_on_meta("all-to-all", n, t, nbytes):
            return torch.empty_like(t)
        src = t.contiguous()
        out = torch.empty_like(src)
        t0 = time.perf_counter()
        dist.all_to_all_single(out, src, group=self.pg)
        self._count("all-to-all", nbytes, t0)
        return out


@dataclasses.dataclass
class SeqGroup(ModelGroup):
    """One rank's view of the ranks a dense decode cache's sequence
    shards over (the serving grid's ``kv_seq`` axes,
    ``dist/sharding.seq_axes``): ``rank`` is this rank's share of the
    sequence, numbered row-major over the axes as the override lists them
    (``dist/sharding.grid_share``'s blocks), and ``size`` the number of
    shares.  Its :meth:`all_gather` joins the ranks' partial attentions
    (``models/layers.seq_combine``) in the process group's order, the same
    on every rank, and is counted by kind as a :class:`ModelGroup`'s (on
    the meta device through :data:`META_SINKS`)."""


@dataclasses.dataclass
class _Grid:
    """What a ``(data, model)`` grid and a pipeline's ``(stage, data,
    model)`` grid share: ``data`` is the :class:`DataGroup` of this rank's
    data axis, ``model`` the :class:`ModelGroup` of its model axis, ``pg``
    the world."""
    data: DataGroup = dataclasses.field(default_factory=DataGroup)
    model: ModelGroup = dataclasses.field(default_factory=ModelGroup)
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    backend: Optional[str] = None
    pg: Any = None                  # the world; None at size 1
    timeout_s: float = DEFAULT_TIMEOUT_S

    @property
    def data_index(self) -> int:
        return self.data.rank

    @property
    def model_index(self) -> int:
        return self.model.rank

    def shard(self, batch: Dict[str, torch.Tensor], chunks: int = 1
              ) -> Dict[str, torch.Tensor]:
        """This data index's rows of a global batch that splits into
        ``chunks`` microbatches (``DataGroup.shard``): the same on every
        rank of the other axes."""
        return self.data.shard(batch, chunks)

    def broadcast_int(self, value: Optional[int]) -> Optional[int]:
        """Rank 0's ``value`` (an int or None) on every rank."""
        if self.size == 1:
            return value
        dev = self.device if self.backend == "nccl" else "cpu"
        t = torch.tensor([-1 if value is None else value], dtype=torch.int64,
                         device=dev)
        dist.broadcast(t, src=0, group=self.pg)
        got = int(t.item())
        return None if got < 0 else got

    def barrier(self) -> None:
        """Wait until every rank has reached this call."""
        if self.size == 1:
            return
        dist.barrier(group=self.pg)

    def close(self) -> None:
        """Tear down the process groups (a no-op at size 1)."""
        if self.pg is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.pg = self.data.pg = self.model.pg = None


@dataclasses.dataclass
class GridGroup(_Grid):
    """One rank's view of a ``(data, model)`` grid of D x T ranks: rank
    ``d * T + t``, row-major as the reference's ``jax.make_mesh((D, T),
    ("data", "model"))`` lays out its devices.  ``data`` is the
    :class:`DataGroup` of the D ranks of this model index (its ``rank`` is
    the data index d, its ``root`` the global rank of ``(0, t)``), ``model``
    the :class:`ModelGroup` of the T ranks of this data index, and ``pg``
    the world.

    The T ranks of a data index hold the same rows of the batch and the
    same parameters, except a MoE layer's experts, of which rank t holds
    ``[t E / T, (t + 1) E / T)``: everything outside the MoE layers runs
    replicated over ``model`` (``models/moe.moe_fwd_ep`` exchanges the
    tokens).  A grid of one rank needs no process group."""

    # (mesh axes, kv_seq axes) -> this rank's SeqGroup (seq_group)
    seq_groups: Dict[Any, "SeqGroup"] = dataclasses.field(
        default_factory=dict)

    def seq_group(self, mesh, axes) -> SeqGroup:
        """This rank's :class:`SeqGroup` over the ``axes`` of ``mesh`` (a
        ``dist/sharding.Mesh`` whose DP axes hold ``data.size`` ranks and
        whose ``model`` axis ``model.size``, laid out row-major as the
        grid's ranks are): the ranks that agree on every other axis.  The
        world, the model group or the data group where the members are
        theirs; else a process group of its own, made the first time:
        ``new_group`` is collective, so every rank calls this with the
        same arguments at the same point (when its decode step is built)."""
        from repro_torch.dist.sharding import mesh_coords
        key = (tuple(mesh.axis_names), tuple(mesh.shape.values()),
               tuple(axes))
        if key in self.seq_groups:
            return self.seq_groups[key]
        at = mesh_coords(mesh, self.rank)
        index = 0
        for a in axes:
            index = index * mesh.shape[a] + at[a]
        n = math.prod(mesh.shape[a] for a in axes)
        others = [a for a in mesh.axis_names if a not in axes]
        members: Dict[tuple, List[int]] = {}
        for r in range(self.size):
            c = mesh_coords(mesh, r)
            members.setdefault(tuple(c[a] for a in others), []).append(r)
        mine = members[tuple(at[a] for a in others)]
        T = self.model.size
        d, t = divmod(self.rank, T)
        pg = None
        if n > 1:
            if mine == list(range(self.size)):
                pg = self.pg
            elif mine == [d * T + j for j in range(T)]:
                pg = self.model.pg
            elif mine == [i * T + t for i in range(self.data.size)]:
                pg = self.data.pg
            else:
                for ranks in (members[k] for k in sorted(members)):
                    made = dist.new_group(
                        ranks=ranks, backend=self.backend,
                        timeout=datetime.timedelta(seconds=self.timeout_s))
                    if ranks == mine:
                        pg = made
        group = SeqGroup(rank=index, size=n, pg=pg)
        self.seq_groups[key] = group
        return group

    def close(self) -> None:
        super().close()
        self.seq_groups.clear()


# tags of a pipeline's point-to-point messages: activations go right,
# cotangents left, whole tensors (the tied table, a checkpoint's leaves)
# either way
TAG_ACT, TAG_COT, TAG_TENSOR = 1, 2, 3


@dataclasses.dataclass
class PipeGroup(_Grid):
    """One rank's view of a pipeline's ``(stage, data, model)`` grid: rank
    ``(stage * D + d) * T + t``, row-major as the reference's
    ``jax.make_mesh((S, D, T), ("stage", "data", "model"))`` lays out its
    devices.  ``data`` is the :class:`DataGroup` of the D ranks of this
    ``(stage, t)`` (the ``data`` axis), ``model`` the :class:`ModelGroup`
    of the T ranks of this ``(stage, d)`` (the ``model`` axis), and
    ``pipe_pg`` the process group of the S ranks of this ``(d, t)`` (the
    ``stage`` axis; the world when D and T are 1).

    Activations and cotangents move between neighbouring stages of one
    ``(d, t)`` index by point-to-point messages (:meth:`exchange`), so
    each model index runs its own stage-to-stage messages.  Gloo's
    send and receive work on host tensors only, so a CUDA payload is
    copied to the host before it is sent and to the card after it
    arrives, explicitly.  Each tick's sends and receives are posted
    together and then waited on, so two neighbours that send to each other
    at one tick do not wait on each other.  A failed message raises;
    nothing retries it.

    ``p2p_s`` counts the host seconds inside the messages, ``reduce_s``
    the host seconds inside the collectives over the stage axis (the data
    axis's are ``data.reduce_s``), ``p2p_by_tag`` the bytes this rank
    sent, by kind (:data:`TAG_ACT`, :data:`TAG_COT`, :data:`TAG_TENSOR`),
    and ``busy_s`` the host seconds of the schedule's items on this rank
    (``dist/pipeline/runtime.run_schedule``).  On the meta device nothing
    moves: a dry run's ``analysis/cost.CostMode`` counts each send from
    :data:`META_SINKS` (kind ``send``), and a receive gives an empty meta
    tensor."""
    stage: int = 0
    num_stages: int = 1
    pipe_pg: Any = None             # this (d, t) index's stages
    p2p_s: float = 0.0
    p2p_by_tag: Dict[int, int] = dataclasses.field(default_factory=dict)
    reduce_s: float = 0.0
    busy_s: float = 0.0

    def rank_at(self, stage: int, data: int, model: int) -> int:
        """The global rank of grid index ``(stage, data, model)``."""
        return (stage * self.data.size + data) * self.model.size + model

    def peer(self, stage: int) -> int:
        """The global rank of ``stage`` at this rank's ``(d, t)`` index."""
        if not 0 <= stage < self.num_stages:
            raise ValueError(f"no stage {stage} in a pipeline of "
                             f"{self.num_stages}")
        return self.rank_at(stage, self.data.rank, self.model.rank)

    def exchange(self, sends=(), recvs=(), *, on_host: bool = False
                 ) -> List[torch.Tensor]:
        """Post every send ``(tensor, to_stage, tag)`` and every receive
        ``(shape, dtype, from_stage, tag)`` of one tick together, wait on
        all of them, and return the received tensors on this rank's
        device (on the host with ``on_host``), in the order of
        ``recvs``.  The stages are this ``(d, t)``'s."""
        return self._post([(t, self.peer(s), g) for t, s, g in sends],
                          [(sh, dt, self.peer(s), g)
                           for sh, dt, s, g in recvs], on_host)

    def _post(self, sends, recvs, on_host: bool) -> List[torch.Tensor]:
        """:meth:`exchange` with global ranks for stages."""
        sends, recvs = list(sends), list(recvs)
        if not sends and not recvs:
            return []
        if any(t.is_meta for t, _r, _g in sends) or \
                self.device.type == "meta":
            for t, _rank, _tag in sends:
                _counted_on_meta("send", 2, t, t.numel() * t.element_size())
            return [torch.empty(shape, dtype=dtype, device="meta")
                    for shape, dtype, _r, _g in recvs]
        t0 = time.perf_counter()
        works, held, got = [], [], []
        for t, rank, tag in sends:
            host = t.detach().to("cpu").contiguous()
            held.append(host)
            self.p2p_by_tag[tag] = self.p2p_by_tag.get(tag, 0) + \
                host.numel() * host.element_size()
            works.append(dist.isend(host, rank, tag=tag))
        for shape, dtype, rank, tag in recvs:
            host = torch.empty(tuple(shape), dtype=dtype)
            got.append(host)
            works.append(dist.irecv(host, rank, tag=tag))
        for w in works:
            w.wait()
        out = got if on_host else [h.to(self.device) for h in got]
        self.p2p_s += time.perf_counter() - t0
        return out

    def send(self, t: torch.Tensor, stage: int, tag: int = TAG_TENSOR
             ) -> None:
        """Send one tensor to ``stage`` (at this ``(d, t)``) and wait."""
        self.exchange(sends=[(t, stage, tag)])

    def recv(self, shape, dtype, stage: int, tag: int = TAG_TENSOR, *,
             on_host: bool = False) -> torch.Tensor:
        """Receive one tensor from ``stage`` (at this ``(d, t)``)."""
        return self.exchange(recvs=[(shape, dtype, stage, tag)],
                             on_host=on_host)[0]

    def send_to_rank(self, t: torch.Tensor, rank: int,
                     tag: int = TAG_TENSOR) -> None:
        """Send one tensor to global ``rank`` and wait (a checkpoint's
        gather of the model shards)."""
        self._post([(t, rank, tag)], [], False)

    def recv_from_rank(self, shape, dtype, rank: int, tag: int = TAG_TENSOR,
                       *, on_host: bool = False) -> torch.Tensor:
        """Receive one tensor from global ``rank``."""
        return self._post([], [(shape, dtype, rank, tag)], on_host)[0]

    def pipe_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` in place over the stages of this ``(d, t)``."""
        if self.num_stages == 1:
            return t
        if _counted_on_meta("all-reduce", self.num_stages, t,
                            t.numel() * t.element_size()):
            return t
        t0 = time.perf_counter()
        dist.all_reduce(t, group=self.pipe_pg)
        self.reduce_s += time.perf_counter() - t0
        return t

    def barrier(self) -> None:
        t0 = time.perf_counter()
        super().barrier()
        self.reduce_s += time.perf_counter() - t0

    def close(self) -> None:
        super().close()
        self.pipe_pg = None
