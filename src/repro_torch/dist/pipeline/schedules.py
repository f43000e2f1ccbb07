"""Pipeline schedules as explicit per-tick work tables (a copy of
``repro/dist/pipeline/schedules.py``, which is plain Python).

A pipeline run *is* a :class:`Schedule`: for every tick and every stage,
at most one :class:`WorkItem` -- forward or backward of one microbatch.
Everything the paper cares about is decided here, in plain Python:

* **GPipe** (:func:`gpipe`) -- all forwards fill/drain, then all
  backwards in reverse microbatch order; peak activation stash is the
  full microbatch count.
* **1F1B** (:func:`one_f_one_b`) -- PipeDream-flush/Megatron-style: each
  stage warms up with ``S-1-s`` forwards, then alternates one-forward /
  one-backward; same bubble as GPipe, bounded in-flight activations.
* **SPB truncation** (:func:`spb_truncate`, or ``bwd_stages`` on the
  builders) -- the paper's structured partial backprop mapped onto the
  pipeline axis: stages below the truncation point simply *have no
  backward items*.

Because the table is data, analyses read it directly
(``analysis/roofline.py``'s pipeline terms):
:func:`bubble_fraction_of` measures idle slots per tick (the quantity
the old closed form ``(S-1)/(M+S-1)`` only approximated for GPipe), and
:func:`max_in_flight` gives the activation-stash watermark that
separates 1F1B from GPipe.  ``runtime.run_schedule`` interprets a table
on each stage's rank of a ``dist/group.PipeGroup``, and ``stage`` cuts the
model into the stages' slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

FWD = "fwd"
BWD = "bwd"


@dataclass(frozen=True)
class WorkItem:
    """One unit of pipeline work: ``kind`` pass of ``microbatch`` at
    ``stage``."""
    stage: int
    microbatch: int
    kind: str                     # FWD | BWD


@dataclass(frozen=True)
class Schedule:
    """An explicit per-tick pipeline work table.

    ``ticks[t][s]`` is the :class:`WorkItem` stage ``s`` executes at tick
    ``t`` (or None = idle).  ``bwd_stages`` counts the *suffix* stages
    that run backward (SPB truncation point = ``num_stages -
    bwd_stages``); ``num_stages`` means full backprop.
    """
    name: str
    num_stages: int
    num_microbatches: int
    bwd_stages: int
    ticks: Tuple[Tuple[Optional[WorkItem], ...], ...]

    @property
    def num_ticks(self) -> int:
        return len(self.ticks)

    @property
    def first_bwd_stage(self) -> int:
        """Stages below this index are frozen (forward-only)."""
        return self.num_stages - self.bwd_stages

    def items(self):
        for t, row in enumerate(self.ticks):
            for it in row:
                if it is not None:
                    yield t, it

    def stage_has_bwd(self, stage: int) -> bool:
        return stage >= self.first_bwd_stage


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def gpipe_forward(num_stages: int, num_microbatches: int) -> Schedule:
    """Forward-only fill/drain (the schedule behind ``pipeline_apply``)."""
    s_, m_ = num_stages, num_microbatches
    ticks = []
    for t in range(m_ + s_ - 1):
        row = []
        for s in range(s_):
            m = t - s
            row.append(WorkItem(s, m, FWD) if 0 <= m < m_ else None)
        ticks.append(tuple(row))
    return validate(Schedule("gpipe-fwd", s_, m_, 0, tuple(ticks)))


def gpipe(num_stages: int, num_microbatches: int, *,
          bwd_stages: Optional[int] = None) -> Schedule:
    """Classic GPipe: full forward fill/drain, then backward fill/drain
    in reverse microbatch order."""
    s_, m_ = num_stages, num_microbatches
    b_ = s_ if bwd_stages is None else bwd_stages
    _check_bwd_stages(s_, b_)
    fwd_ticks = m_ + s_ - 1
    ticks: Dict[int, Dict[int, WorkItem]] = {}
    for m in range(m_):
        for s in range(s_):
            ticks.setdefault(m + s, {})[s] = WorkItem(s, m, FWD)
    for m in range(m_):
        for s in range(s_ - b_, s_):
            t = fwd_ticks + (m_ - 1 - m) + (s_ - 1 - s)
            ticks.setdefault(t, {})[s] = WorkItem(s, m, BWD)
    return validate(_from_dict("gpipe", s_, m_, b_, ticks))


def one_f_one_b(num_stages: int, num_microbatches: int, *,
                bwd_stages: Optional[int] = None) -> Schedule:
    """1F1B (PipeDream-flush): greedy per-stage policy — warm up with
    ``min(S-1-s, M)`` forwards, then prefer backward whenever one is
    ready.  With ``bwd_stages < S`` the frozen prefix never waits on
    cotangents, so its forwards pack back-to-back (the SPB win shows up
    directly as a shorter table) — but each frozen stage caps its lead
    over its right neighbor at one microbatch, so the first live stage
    never buffers more than its 1F1B in-flight cap (the stash watermark
    stays at ``bwd_stages``, it does not creep back toward M).

    >>> sched = one_f_one_b(2, 4)
    >>> (sched.num_stages, sched.num_microbatches, sched.bwd_stages)
    (2, 4, 2)
    >>> max_in_flight(sched)              # bounded stash, not M=4
    2
    >>> max_in_flight(one_f_one_b(4, 8, bwd_stages=1))
    1
    """
    s_, m_ = num_stages, num_microbatches
    b_ = s_ if bwd_stages is None else bwd_stages
    _check_bwd_stages(s_, b_)
    first_bwd = s_ - b_
    fwd_done: Dict[Tuple[int, int], int] = {}     # (m, s) -> tick
    bwd_done: Dict[Tuple[int, int], int] = {}
    next_fwd = [0] * s_
    next_bwd = [0 if s >= first_bwd else m_ for s in range(s_)]
    warmup = [min(s_ - 1 - s, m_) for s in range(s_)]
    issued_fwd = [0] * s_
    ticks = []
    while any(next_fwd[s] < m_ for s in range(s_)) or \
            any(next_bwd[s] < m_ for s in range(s_)):
        t = len(ticks)
        row: list = [None] * s_
        for s in range(s_):
            def fwd_ready():
                m = next_fwd[s]
                if m >= m_ or (s > 0 and fwd_done.get((m, s - 1), t) >= t):
                    return False
                if s >= first_bwd:
                    # canonical 1F1B in-flight cap: beyond warmup, each
                    # forward must be paid for by a completed backward
                    return issued_fwd[s] < warmup[s] + next_bwd[s] + 1
                if b_ > 0:
                    # frozen stage: at most one microbatch ahead of the
                    # right neighbor's forward issue — backpressure that
                    # keeps the first live stage's arrival queue at its
                    # in-flight cap (free-running would pile ~M stashed
                    # activations there, forfeiting the 1F1B watermark)
                    return issued_fwd[s] < next_fwd[s + 1] + 1
                return True

            def bwd_ready():
                m = next_bwd[s]
                if m >= m_:
                    return False
                if s == s_ - 1:
                    return fwd_done.get((m, s), t) < t
                return bwd_done.get((m, s + 1), t) < t

            if issued_fwd[s] < warmup[s] and fwd_ready():
                kind = FWD
            elif bwd_ready():
                kind = BWD
            elif fwd_ready():
                kind = FWD
            else:
                continue
            if kind == FWD:
                m = next_fwd[s]
                row[s] = WorkItem(s, m, FWD)
                fwd_done[(m, s)] = t
                next_fwd[s] += 1
                issued_fwd[s] += 1
            else:
                m = next_bwd[s]
                row[s] = WorkItem(s, m, BWD)
                bwd_done[(m, s)] = t
                next_bwd[s] += 1
        if not any(row):
            raise RuntimeError(
                f"1F1B builder stalled at tick {t} (S={s_}, M={m_}, "
                f"bwd_stages={b_})")
        ticks.append(tuple(row))
    return validate(Schedule("1f1b", s_, m_, b_, tuple(ticks)))


BUILDERS = {"gpipe": gpipe, "1f1b": one_f_one_b}


def build(kind: str, num_stages: int, num_microbatches: int, *,
          bwd_stages: Optional[int] = None) -> Schedule:
    """Builder registry: 'gpipe' | '1f1b' (+ optional SPB truncation).

    >>> sched = build("1f1b", 2, 4)
    >>> sched.name, sched.num_ticks
    ('1f1b', 10)
    >>> trunc = build("1f1b", 4, 8, bwd_stages=2)
    >>> trunc.first_bwd_stage          # stages 0-1 are frozen
    2
    >>> build("magic", 2, 4)
    Traceback (most recent call last):
        ...
    ValueError: unknown pipeline schedule 'magic'; known: ['1f1b', 'gpipe']
    """
    if kind not in BUILDERS:
        raise ValueError(f"unknown pipeline schedule {kind!r}; "
                         f"known: {sorted(BUILDERS)}")
    return BUILDERS[kind](num_stages, num_microbatches,
                          bwd_stages=bwd_stages)


def spb_truncate(sched: Schedule, bwd_stages: int) -> Schedule:
    """Drop backward items for stages below the truncation point and
    compact now-empty ticks.  ``one_f_one_b(..., bwd_stages=)`` packs
    tighter (frozen stages stop waiting for cotangent turns); this
    generic form keeps the base schedule's forward timing."""
    _check_bwd_stages(sched.num_stages, bwd_stages)
    first_bwd = sched.num_stages - bwd_stages
    ticks = []
    for row in sched.ticks:
        new_row = tuple(
            None if (it is not None and it.kind == BWD
                     and it.stage < first_bwd) else it
            for it in row)
        if any(it is not None for it in new_row):
            ticks.append(new_row)
    return validate(Schedule(f"{sched.name}-spb{bwd_stages}",
                             sched.num_stages, sched.num_microbatches,
                             bwd_stages, tuple(ticks)))


def _from_dict(name, s_, m_, b_, ticks: Dict[int, Dict[int, WorkItem]]
               ) -> Schedule:
    out = []
    for t in range(max(ticks) + 1):
        row = ticks.get(t, {})
        out.append(tuple(row.get(s) for s in range(s_)))
    return Schedule(name, s_, m_, b_, tuple(out))


def _check_bwd_stages(num_stages: int, bwd_stages: int) -> None:
    if not 0 <= bwd_stages <= num_stages:
        raise ValueError(f"bwd_stages={bwd_stages} out of range for "
                         f"{num_stages} stages")


# ---------------------------------------------------------------------------
# Invariants
# ---------------------------------------------------------------------------

def validate(sched: Schedule) -> Schedule:
    """Check the table invariants the runtime relies on.

    * one item per stage per tick, ``item.stage`` matching its column;
    * every (microbatch, stage) has exactly one forward; forwards flow
      left-to-right with at least one tick between neighbor stages (the
      ``ppermute`` transfer);
    * backward items exist exactly for the suffix ``bwd_stages`` stages,
      once per microbatch, flowing right-to-left with a one-tick gap;
    * at a given stage, a microbatch's backward comes strictly after its
      forward.
    """
    s_, m_ = sched.num_stages, sched.num_microbatches
    fwd: Dict[Tuple[int, int], int] = {}
    bwd: Dict[Tuple[int, int], int] = {}
    for t, row in enumerate(sched.ticks):
        if len(row) != s_:
            raise ValueError(f"tick {t}: {len(row)} slots != {s_} stages")
        for s, it in enumerate(row):
            if it is None:
                continue
            if it.stage != s:
                raise ValueError(f"tick {t}: item {it} in column {s}")
            if not 0 <= it.microbatch < m_:
                raise ValueError(f"tick {t}: bad microbatch in {it}")
            key = (it.microbatch, s)
            book = fwd if it.kind == FWD else bwd
            if key in book:
                raise ValueError(f"duplicate {it.kind} for mb "
                                 f"{it.microbatch} at stage {s}")
            book[key] = t
    for m in range(m_):
        for s in range(s_):
            if (m, s) not in fwd:
                raise ValueError(f"missing fwd of mb {m} at stage {s}")
            if s > 0 and fwd[(m, s)] <= fwd[(m, s - 1)]:
                raise ValueError(
                    f"fwd of mb {m}: stage {s} at tick {fwd[(m, s)]} not "
                    f"after stage {s - 1} at {fwd[(m, s - 1)]}")
    first_bwd = sched.first_bwd_stage
    for (m, s), t in bwd.items():
        if s < first_bwd:
            raise ValueError(f"bwd of mb {m} at frozen stage {s}")
        if t <= fwd[(m, s)]:
            raise ValueError(f"bwd of mb {m} at stage {s} (tick {t}) not "
                             f"after its fwd (tick {fwd[(m, s)]})")
        if s < s_ - 1 and ((m, s + 1) not in bwd
                           or t <= bwd[(m, s + 1)]):
            raise ValueError(f"bwd of mb {m} at stage {s} not after "
                             f"stage {s + 1}")
    for s in range(first_bwd, s_):
        missing = [m for m in range(m_) if (m, s) not in bwd]
        if missing:
            raise ValueError(f"live stage {s} missing bwd for mbs {missing}")
    return sched


def render(sched: Schedule) -> str:
    """ASCII view of the per-tick work table (``F``/``B`` = forward /
    backward of that microbatch, ``.`` = idle slot):

    >>> print(render(one_f_one_b(2, 4)))
    tick     0  1  2  3  4  5  6  7  8  9
    stage 0 F0 F1  . B0 F2 B1 F3 B2  . B3
    stage 1  . F0 B0 F1 B1 F2 B2 F3 B3  .
    """
    w = max(3, len(str(sched.num_microbatches - 1)) + 2)
    lines = ["tick   " + "".join(f"{t:>{w}}" for t in range(sched.num_ticks))]
    for s in range(sched.num_stages):
        cells = []
        for row in sched.ticks:
            it = row[s]
            cells.append("." if it is None else
                         f"{'F' if it.kind == FWD else 'B'}{it.microbatch}")
        lines.append(f"stage {s}" + "".join(f"{c:>{w}}" for c in cells))
    return "\n".join(line.rstrip() for line in lines)


# ---------------------------------------------------------------------------
# Table-derived analyses
# ---------------------------------------------------------------------------

def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Closed-form idle fraction of a GPipe phase, (S-1)/(M+S-1).

    Kept for the pre-refactor callers; :func:`bubble_fraction_of`
    measures any schedule (1F1B, truncated, weighted costs) directly
    from its table.
    """
    s, m = num_stages, num_microbatches
    return (s - 1) / (m + s - 1)


def bubble_fraction_of(sched: Schedule, bwd_cost: float = 2.0) -> float:
    """Idle fraction of the device-time rectangle, measured on the table.

    Each tick's duration is its most expensive concurrent item (forward
    = 1, backward = ``bwd_cost``); a stage's busy time is the sum of its
    own items' costs.  For a forward-only GPipe table with uniform costs
    this reduces exactly to the closed form ``(S-1)/(M+S-1)``.
    """
    cost = {FWD: 1.0, BWD: bwd_cost}
    wall = 0.0
    busy = 0.0
    for row in sched.ticks:
        tick_costs = [cost[it.kind] for it in row if it is not None]
        wall += max(tick_costs) if tick_costs else 0.0
        busy += sum(tick_costs)
    if wall == 0.0:
        return 0.0
    return 1.0 - busy / (sched.num_stages * wall)


def max_in_flight(sched: Schedule) -> int:
    """Peak number of activations stashed *awaiting a backward* at any
    stage — the memory watermark that separates 1F1B (≤ S) from GPipe
    (= M).  Frozen stages hold nothing: their forward consumes its input
    in the same tick and no backward will ever read it, so SPB
    truncation shrinks this watermark along with the compute.

    >>> max_in_flight(one_f_one_b(4, 8)), max_in_flight(gpipe(4, 8))
    (4, 8)
    """
    peak = 0
    live = [0] * sched.num_stages
    for _, it in sched.items():
        if it.stage < sched.first_bwd_stage:
            continue
        if it.kind == FWD:
            live[it.stage] += 1
            peak = max(peak, live[it.stage])
        else:
            live[it.stage] -= 1
    return peak


# ---------------------------------------------------------------------------
# Stash planning: watermark-sized ring slots for the runtime's buffers
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StashPlan:
    """Static slot assignment for the runtime's activation / cotangent
    stashes, derived purely from the table.

    ``act_slot[(stage, microbatch)]`` is the ring slot holding that
    microbatch's *input activation* from its arrival (one tick after the
    left neighbor's forward) to its last read (the backward, or the
    forward on a frozen stage); ``cot_slot`` likewise holds the *output
    cotangent* from arrival/seeding to the backward that consumes it.
    Entries are absent when no buffering is needed: stage 0 reads ``xs``
    directly, and a value consumed in its arrival tick flows straight
    from the ``ppermute`` receive.

    ``act_slots`` / ``cot_slots`` are the buffer sizes — the schedule's
    true memory watermark.  For the shipped 1F1B tables ``act_slots ==``
    :func:`max_in_flight` (never M); GPipe needs all M of both.
    """
    act_slots: int
    cot_slots: int
    act_slot: Dict[Tuple[int, int], int]
    cot_slot: Dict[Tuple[int, int], int]


def _assign_slots(intervals) -> Tuple[int, Dict[Tuple[int, int], int]]:
    """Greedy interval coloring, per stage: ``intervals`` is a list of
    ``(stage, microbatch, start_tick, end_tick)`` lifetimes; a slot frees
    strictly after its end tick (arrival writes happen before the same
    tick's reads, so same-tick reuse would clobber)."""
    by_stage: Dict[int, list] = {}
    for s, m, a, b in intervals:
        by_stage.setdefault(s, []).append((a, b, m))
    peak = 0
    assignment: Dict[Tuple[int, int], int] = {}
    for s, items in by_stage.items():
        items.sort()
        slot_end: list = []                 # slot index -> busy-until tick
        for a, b, m in items:
            for i, e in enumerate(slot_end):
                if e < a:
                    slot_end[i] = b
                    assignment[(s, m)] = i
                    break
            else:
                assignment[(s, m)] = len(slot_end)
                slot_end.append(b)
        peak = max(peak, len(slot_end))
    return peak, assignment


def stash_plan(sched: Schedule) -> StashPlan:
    """Compute the watermark-sized stash layout for ``sched``.

    The runtime allocates exactly ``act_slots`` / ``cot_slots`` buffer
    entries (instead of one per microbatch) and indexes them with the
    compile-time-constant slots planned here — this is what realizes
    1F1B's bounded-memory advantage the table already encodes.

    >>> plan = stash_plan(one_f_one_b(4, 8))
    >>> plan.act_slots == max_in_flight(one_f_one_b(4, 8)) == 4
    True
    >>> plan.cot_slots                # 1F1B consumes cotangents on arrival
    1
    >>> gp = stash_plan(gpipe(4, 8))
    >>> (gp.act_slots, gp.cot_slots)  # GPipe stashes every microbatch
    (8, 8)
    """
    s_, m_ = sched.num_stages, sched.num_microbatches
    fwd: Dict[Tuple[int, int], int] = {}
    bwd: Dict[Tuple[int, int], int] = {}
    for t, it in sched.items():
        (fwd if it.kind == FWD else bwd)[(it.microbatch, it.stage)] = t
    act, cot = [], []
    for m in range(m_):
        for s in range(s_):
            if s > 0:                       # stage 0 reads xs directly
                arrive = fwd[(m, s - 1)] + 1
                if sched.stage_has_bwd(s):
                    act.append((s, m, arrive, bwd[(m, s)]))
                elif fwd[(m, s)] > arrive:  # frozen + consumed later
                    act.append((s, m, arrive, fwd[(m, s)]))
            if sched.stage_has_bwd(s):
                # cotangent: seeded during the forward at the last stage,
                # received one tick after the right neighbor's backward
                # elsewhere; consumed by this stage's backward
                c_start = (fwd[(m, s)] if s == s_ - 1
                           else bwd[(m, s + 1)] + 1)
                if s == s_ - 1 or bwd[(m, s)] > c_start:
                    cot.append((s, m, c_start, bwd[(m, s)]))
    act_n, act_map = _assign_slots(act)
    cot_n, cot_map = _assign_slots(cot)
    return StashPlan(act_n, cot_n, act_map, cot_map)
