"""FCFS admission with a token-budget watermark, preempt-free
(``repro/serve/scheduler.py``, pure Python).

The scheduler decides *when* a queued request joins the running batch;
the :class:`~repro_torch.serve.kvcache.BlockAllocator` decides whether its
pages physically fit.  Admission is conservative: a request is admitted
only if (a) a slot is free, (b) its full page span (prompt + max_new
tokens) is allocatable right now, and (c) the session's committed tokens
would stay under ``watermark * capacity_tokens``.  Because every
admitted request has its whole span reserved up front, a running request
can never be starved of pages mid-decode -- the price is admission
throughput, not correctness.

FCFS is strict: if the head of the queue does not fit, nothing behind it
is admitted either (no head-of-line bypass), which keeps per-request
latency ordering predictable under load.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Deque, List, Optional, Sequence, Tuple

from repro_torch.serve.kvcache import BlockAllocator, PageGeometry

_rid_counter = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request moving through the serving session."""
    prompt: Sequence[int]
    max_new: int
    temperature: float = 0.0
    rid: int = dataclasses.field(default_factory=lambda: next(_rid_counter))

    # -- filled in by the scheduler / engine -------------------------------
    slot: Optional[int] = None
    pages: Optional[List[int]] = None
    arrived_step: int = -1
    admitted_step: int = -1
    finished_step: int = -1
    output: List[int] = dataclasses.field(default_factory=list)

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + self.max_new

    @property
    def done(self) -> bool:
        return self.finished_step >= 0


class Scheduler:
    """FCFS queue + token-budget watermark over one page pool."""

    def __init__(self, geom: PageGeometry, *, watermark: float = 1.0):
        if not 0.0 < watermark <= 1.0:
            raise ValueError(f"watermark must be in (0, 1], got {watermark}")
        self.geom = geom
        self.watermark = watermark
        self.allocator = BlockAllocator(geom)
        self.queue: Deque[Request] = deque()
        self.committed_tokens = 0
        self.admitted = 0

    @property
    def budget_tokens(self) -> int:
        return int(self.watermark * self.geom.capacity_tokens)

    def submit(self, req: Request, *, step: int = 0) -> None:
        if req.total_tokens > self.geom.max_context:
            raise ValueError(
                f"request {req.rid}: {req.total_tokens} tokens exceeds "
                f"slot capacity {self.geom.max_context}")
        req.arrived_step = step
        self.queue.append(req)

    def admit(self, free_slots: Sequence[int], *,
              step: int = 0) -> List[Tuple[Request, int, List[int]]]:
        """Admit queue-head requests into ``free_slots`` (strict FCFS).

        Returns [(request, slot, pages), ...]; each returned request has
        its full page span reserved and ``slot``/``pages`` filled in.
        """
        placed: List[Tuple[Request, int, List[int]]] = []
        slots = list(free_slots)
        while self.queue and slots:
            req = self.queue[0]
            if self.committed_tokens + req.total_tokens > self.budget_tokens:
                break
            pages = self.allocator.alloc(self.geom.pages_for(req.total_tokens))
            if pages is None:
                break
            self.queue.popleft()
            req.slot = slots.pop(0)
            req.pages = pages
            req.admitted_step = step
            self.committed_tokens += req.total_tokens
            self.admitted += 1
            placed.append((req, req.slot, pages))
        return placed

    def retire(self, req: Request, *, step: int = 0) -> None:
        """Return a finished request's pages and budget to the pool."""
        if req.pages is None:
            raise ValueError(f"request {req.rid} was never admitted")
        self.allocator.free(req.pages)
        self.committed_tokens -= req.total_tokens
        req.finished_step = step
        req.pages = None

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Scheduler(queued={len(self.queue)}, "
                f"committed={self.committed_tokens}/{self.budget_tokens}, "
                f"free_pages={self.allocator.free_pages})")
