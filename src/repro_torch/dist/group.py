"""The data-parallel group at run time: one rank's view of it and its
collectives (what the steps and the engine use; ``launch/mesh.py`` makes
the group and spawns its ranks).

A :class:`DataGroup` holds its rank, the group's size, its local rank, its
device, the backend, the ``ProcessGroup``, and the subgroups of the last
``c`` ranks that spatial SPB's re-reduce uses
(``core/spb.subgroup_allreduce``), keyed by ``c``.  A group of one needs
no process group: every collective is then the identity.  A failed
collective raises.
"""
from __future__ import annotations

import dataclasses
import datetime
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


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
        pg = self.pg if c == self.size else self.subgroups[c]
        t0 = time.perf_counter()
        dist.all_reduce(t, group=pg)
        self.reduce_s += time.perf_counter() - t0
        return t

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
