"""The data-parallel group at run time: one rank's view of it and its
collectives (what the steps and the engine use; ``launch/mesh.py`` makes
the group and spawns its ranks).

A :class:`DataGroup` holds its rank, the group's size, its local rank, its
device, the backend, the ``ProcessGroup``, and the subgroups of the last
``c`` ranks that spatial SPB's re-reduce uses
(``core/spb.subgroup_allreduce``), keyed by ``c``.  A group of one needs
no process group: every collective is then the identity.  A failed
collective raises.

Its collectives: the all-reduce of the gradients and metrics, the
all-gather that rebuilds each parameter from the ranks' ZeRO-1 slices
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
        dist.gather(t.contiguous(), out, dst=0, group=self.pg)
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
        dist.broadcast(t, src=0, group=self.pg)
        got = int(t.item())
        return None if got < 0 else got

    def close(self) -> None:
        """Tear down the process group (a no-op at size 1)."""
        if self.pg is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.pg = None
        self.subgroups.clear()
