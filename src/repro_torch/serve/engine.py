"""ServeEngine: continuous batching over one persistent decode step
(``repro/serve/engine.py``).

Keep every decode step full by admitting and retiring requests
mid-flight instead of padding a static batch to its slowest member.  The
engine owns params + a fixed-capacity paged KV cache
(:mod:`repro_torch.serve.kvcache`) and runs a slot-based batch:

* **one decode step, one shape** -- the batch dimension is the fixed
  ``num_slots``; per-slot position, sampling params, an active mask and
  the output buffer live in preallocated device tensors that the step
  functions update in place.
* **prefill-into-free-slots** -- prompts are right-padded to a small set
  of bucket lengths; a device-side ``prompt_len`` masks pad K/V to the
  trash page, so one code path serves every prompt up to the bucket.
* **one host-to-device transfer per admission** -- the packed int32
  ``desc`` vector (prompt, pages, length, slot, max_new, temperature
  bits), copied from pinned memory without a sync.
* **no host sync in** :meth:`ServeEngine.step` -- the token pick runs on
  the device (argmax, or a draw from the engine's ``torch.Generator``),
  finished slots deactivate themselves on the device (EOS / max-new),
  and the host reads device state only in :meth:`poll`.

The port runs the step functions eagerly: there is no ``jit``, so the
reference's AOT step table (``compile_table``, ``export_aot``,
``load_aot``) waits for the step cache (ROADMAP.md Queue 1 B item 9), and
a device mesh for the multi-GPU slice (item 11).

Determinism: greedy slots (temperature 0) consume no randomness, so
their outputs are the same token for token whether a request runs solo
or shares the batch -- co-residents only ever contribute exactly-zero
attention mass (see the kvcache docstring).  Sampled slots draw from the
engine's generator, so their streams depend on step placement; only
greedy outputs are placement-invariant (and only they match the
reference's, whose JAX key a torch generator cannot reproduce).
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve import kvcache
from repro_torch.serve.kvcache import TRASH_PAGE, PageGeometry
from repro_torch.serve.scheduler import Request, Scheduler

State = Dict[str, Any]
Tensor = torch.Tensor


def default_buckets(geom: PageGeometry) -> Tuple[int, ...]:
    """Prefill bucket lengths: powers of four up to the slot context."""
    bs = tuple(b for b in (16, 64, 256, 1024) if b <= geom.max_context)
    return bs or (geom.max_context,)


def draw(probs: Tensor, generator: torch.Generator) -> Tensor:
    """One token a row from ``probs`` (N, V): ``torch.multinomial(probs, 1,
    generator=generator)[:, 0]``'s own draw (an exponential race: argmax
    of probs / E with E ~ Exp(1) from the generator), without its
    host-side check of the probabilities, which would sync the card."""
    race = torch.empty_like(probs).exponential_(1, generator=generator)
    return (probs / race).argmax(dim=-1)


def _pick(logits: Tensor, temp: Tensor,
          generator: Optional[torch.Generator]) -> Tensor:
    """The next token of each row, on the device: argmax, or where
    ``temp`` > 0 a draw from softmax(logits / temp) when a ``generator``
    is given (the host passes one only when some slot samples)."""
    greedy = logits.argmax(dim=-1)
    if generator is None:
        return greedy
    probs = torch.softmax(logits.float() / temp.clamp_min(1e-6)[:, None],
                          dim=-1)
    return torch.where(temp > 0, draw(probs, generator), greedy)


def _make_decode_fn(cfg: ModelConfig, *, eos_id: int, out_cap: int
                    ) -> Callable[..., None]:
    V = cfg.vocab_size

    def step(params, state: State,
             generator: Optional[torch.Generator]) -> None:
        logits, _ = lm.serve_decode(
            params, state["groups"], state["tokens"], cfg,
            pos=state["pos"], page_table=state["page_table"],
            active=state["active"])
        active = state["active"]
        tok = torch.where(active, _pick(logits[..., :V], state["temp"],
                                        generator), 0)
        # an active slot writes at out_len (< max_new <= out_cap); a
        # finished one writes its own entry back
        col = state["out_len"].clamp(max=out_cap - 1)[:, None]
        state["out"].scatter_(1, col, torch.where(
            active[:, None], tok[:, None], state["out"].gather(1, col)))
        state["out_len"] += active
        state["pos"] += active
        state["tokens"].copy_(tok[:, None])
        state["active"].copy_(active & (tok != eos_id)
                              & (state["out_len"] < state["max_new"]))

    return step


def _make_admit_fn(cfg: ModelConfig, *, eos_id: int, bucket: int,
                   pages_per_slot: int) -> Callable[..., None]:
    V = cfg.vocab_size
    P = pages_per_slot

    def admit(params, state: State, desc: Tensor,
              generator: Optional[torch.Generator]) -> None:
        """Prefill one request into a slot; every other slot's state is
        untouched.  ``desc`` is one packed int32 device vector -- one
        host-to-device transfer per admission:

            [prompt(bucket) | pages(Pmax) | prompt_len | slot | max_new
             | temp_bits(f32 bitcast)]

        Every field is read as a slice on the device (a 0-dim index would
        be read on the host)."""
        d = desc.long()
        prompt = d[None, :bucket]
        page_row = d[bucket:bucket + P]
        prompt_len, slot, max_new = (d[bucket + P + i:bucket + P + i + 1]
                                     for i in range(3))
        temp = desc[bucket + P + 3:bucket + P + 4].view(torch.float32)
        state["page_table"].index_copy_(0, slot, page_row[None])
        logits, _ = lm.serve_prefill(params, prompt, cfg, state["groups"],
                                     page_row=page_row, prompt_len=prompt_len)
        tok = _pick(logits[:, :V], temp, generator)               # (1,)
        state["tokens"].index_copy_(0, slot, tok[:, None])
        state["pos"].index_copy_(0, slot, prompt_len)
        state["active"].index_copy_(0, slot, (tok != eos_id) & (max_new > 1))
        state["max_new"].index_copy_(0, slot, max_new)
        state["temp"].index_copy_(0, slot, temp)
        state["out"].index_fill_(0, slot, 0)
        state["out"][:, 0].index_copy_(0, slot, tok)
        state["out_len"].index_fill_(0, slot, 1)

    return admit


class ServeEngine:
    """A serving session: params + paged cache + scheduler + step functions.

    >>> from repro_torch.configs import reduced_config
    >>> from repro_torch.serve import ServeEngine, default_geometry
    >>> eng = ServeEngine(reduced_config("yi-6b"), device="cpu",
    ...                   geom=default_geometry(num_slots=2, page_size=8,
    ...                                         max_context=48))
    >>> req = eng.submit([3, 1, 4, 1, 5], max_new=4)
    >>> done = eng.drain()
    >>> [len(r.output) for r in done]
    [4]

    ``device``: ``cuda`` unless the caller asks for another; ``params``
    must lie on it (default: :func:`lm.init_lm` from ``seed`` there).
    """

    def __init__(self, cfg: ModelConfig, *, geom: Optional[PageGeometry]
                 = None, mesh=None, params=None, seed: int = 0,
                 eos_id: int = -1, max_new_cap: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 watermark: float = 1.0, chunk: int = 1, device=None):
        reason = kvcache.supports(cfg)
        if reason:
            raise NotImplementedError(f"serve: {cfg.name}: {reason}")
        if mesh is not None:
            raise NotImplementedError(
                "ServeEngine(mesh=...): the port serves on one device; "
                "sharded serving comes with the multi-GPU slice (ROADMAP.md "
                "Queue 1 B item 11)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.geom = geom or kvcache.default_geometry()
        self.eos_id = eos_id
        self.max_new_cap = max_new_cap or self.geom.max_context
        self.buckets = tuple(sorted(buckets)) if buckets else \
            default_buckets(self.geom)
        if self.buckets[-1] > self.geom.max_context:
            raise ValueError(f"bucket {self.buckets[-1]} exceeds slot "
                             f"context {self.geom.max_context}")
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.chunk = chunk
        self.scheduler = Scheduler(self.geom, watermark=watermark)

        N, Pmax = self.geom.num_slots, self.geom.pages_per_slot
        dev = self.device
        if params is None:
            params = lm.init_lm(torch.Generator(device=dev).manual_seed(seed),
                                cfg, dev)
        self.params = params
        zeros = lambda *shape, dtype=torch.int64: torch.zeros(
            shape, dtype=dtype, device=dev)
        self.state: State = {
            "groups": kvcache.init_paged_cache(cfg, self.geom, dev),
            "page_table": torch.full((N, Pmax), TRASH_PAGE, dtype=torch.int64,
                                     device=dev),
            "pos": zeros(N),
            "active": zeros(N, dtype=torch.bool),
            "tokens": zeros(N, 1),
            "max_new": zeros(N),
            "temp": zeros(N, dtype=torch.float32),
            "out": zeros(N, self.max_new_cap),
            "out_len": zeros(N),
        }
        # the sampled slots' draws; greedy slots never touch it
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)

        self._steps: Dict[str, Callable] = {
            "decode": _make_decode_fn(cfg, eos_id=eos_id,
                                      out_cap=self.max_new_cap)}
        for b in self.buckets:
            self._steps[f"prefill_{b}"] = _make_admit_fn(
                cfg, eos_id=eos_id, bucket=b, pages_per_slot=Pmax)

        # host-side bookkeeping
        self._live: Dict[int, Request] = {}       # slot -> in-flight req
        self._slot_uses = [0] * N
        self.clock = 0                            # engine steps (incl. idle)
        self.decode_steps = 0

    # -- request lifecycle -------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new: int, *,
               temperature: float = 0.0) -> Request:
        """Queue a request; it joins the batch at the next free slot."""
        if not 1 <= max_new <= self.max_new_cap:
            raise ValueError(f"max_new must be in [1, {self.max_new_cap}]")
        if len(prompt) > self.buckets[-1]:
            raise ValueError(f"prompt of {len(prompt)} tokens exceeds the "
                             f"largest prefill bucket {self.buckets[-1]}")
        req = Request(prompt=list(prompt), max_new=max_new,
                      temperature=temperature)
        self.scheduler.submit(req, step=self.clock)
        return req

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"no bucket holds a {n}-token prompt")

    def _to_device(self, desc: np.ndarray) -> Tensor:
        """One host-to-device copy, from pinned memory without a sync."""
        t = torch.from_numpy(desc)
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _admit_ready(self) -> int:
        free = sorted(set(range(self.geom.num_slots)) - set(self._live))
        placed = self.scheduler.admit(free, step=self.clock)
        for req, slot, pages in placed:
            bucket = self._bucket_for(len(req.prompt))
            Pmax = self.geom.pages_per_slot
            desc = np.zeros((bucket + Pmax + 4,), np.int32)
            desc[:len(req.prompt)] = req.prompt
            desc[bucket:bucket + len(pages)] = pages
            desc[bucket + Pmax:] = [
                len(req.prompt), slot, req.max_new,
                np.float32(req.temperature).view(np.int32)]
            self.step_fn(f"prefill_{bucket}")(
                self.params, self.state, self._to_device(desc),
                self.generator if req.temperature > 0 else None)
            self._live[slot] = req
            self._slot_uses[slot] += 1
        return len(placed)

    def step(self, n: int = 1) -> None:
        """Advance the session ``n`` engine steps: admit whatever fits,
        then run the decode step (skipped while the batch is empty).  One
        engine step is ``chunk`` decode steps.  No host sync happens
        here."""
        for _ in range(n):
            self._admit_ready()
            if self._live:
                sampled = any(r.temperature > 0 for r in self._live.values())
                fn = self.step_fn("decode")
                for _ in range(self.chunk):
                    fn(self.params, self.state,
                       self.generator if sampled else None)
                self.decode_steps += self.chunk
            self.clock += 1

    def poll(self) -> List[Request]:
        """Sync point: harvest finished requests (their slots free up and
        their pages return to the pool).  This is the only place the host
        reads device state."""
        if not self._live:
            return []
        active = self.state["active"].cpu().numpy()
        fin = [r for r in self._live.values() if not active[r.slot]]
        if not fin:
            return []
        out = self.state["out"].cpu().numpy()
        out_len = self.state["out_len"].cpu().numpy()
        done = []
        for req in fin:
            req.output = out[req.slot, :out_len[req.slot]].tolist()
            self.scheduler.retire(req, step=self.clock)
            del self._live[req.slot]
            done.append(req)
        return done

    def drain(self, *, poll_every: int = 4,
              max_steps: int = 100_000) -> List[Request]:
        """Run until queue + batch are empty; returns finished requests in
        completion order."""
        done: List[Request] = []
        steps = 0
        while self._live or self.scheduler.queue:
            self.step(1)
            steps += 1
            if steps % poll_every == 0 or self.scheduler.queue:
                done.extend(self.poll())
            if steps > max_steps:
                raise RuntimeError(f"drain exceeded {max_steps} steps "
                                   f"({len(self._live)} live, "
                                   f"{len(self.scheduler.queue)} queued)")
        done.extend(self.poll())
        return done

    # -- observability -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        alc = self.scheduler.allocator
        return {"clock": self.clock, "decode_steps": self.decode_steps,
                "admitted": self.scheduler.admitted,
                "live": len(self._live),
                "queued": len(self.scheduler.queue),
                "slots_reused": sum(1 for u in self._slot_uses if u > 1),
                "slot_uses": list(self._slot_uses),
                "free_pages": alc.free_pages,
                "page_allocs": alc.allocs, "page_frees": alc.frees}

    def page_table(self) -> np.ndarray:
        """Host copy of the (num_slots, pages_per_slot) block table."""
        return self.state["page_table"].cpu().numpy()

    # -- step table --------------------------------------------------------

    def step_fn(self, key: str) -> Callable:
        """The step function ``decode`` or ``prefill_<bucket>``."""
        if key not in self._steps:
            raise KeyError(f"serve step table has no entry {key!r}; "
                           f"available: {sorted(self._steps)}")
        return self._steps[key]

    def _no_aot(self, what: str):
        raise NotImplementedError(
            f"ServeEngine.{what}: the port runs its step functions eagerly; "
            f"a serialized step table waits for the step cache (ROADMAP.md "
            f"Queue 1 B item 9)")

    def compile_table(self) -> Dict[str, Any]:
        self._no_aot("compile_table")

    def aot_cache_path(self, cache_root=None) -> Path:
        self._no_aot("aot_cache_path")

    def export_aot(self, path) -> Path:
        self._no_aot("export_aot")

    def load_aot(self, path) -> bool:
        self._no_aot("load_aot")
