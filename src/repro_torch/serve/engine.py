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

The port runs the step functions eagerly unless the caller asks for the
step table: ``compile_table()`` captures each entry as CUDA graphs
(``engine/graphs.py``) -- ``decode`` and one ``prefill_<bucket>`` a
bucket, each twice: greedy, and sampled with the engine's generator
registered with the graph -- so one host call replays the step's few
thousand launches.  The prefill's packed ``desc`` is then a static buffer
of its bucket's size that :meth:`ServeEngine._to_device` fills without a
sync.  ``export_aot`` / ``load_aot`` store and restore the table
(``engine/aot.py``).  On the CPU the table holds the eager functions.

Sharded serving (``group=``, a ``dist/group.GridGroup`` of D x T ranks, one
process each; ``mesh=`` names the same grid, ``dist/sharding.mesh_for``):
each rank keeps its share of the params (``dist/sharding.
serve_params_pspec``: an attn/local layer's heads and a dense FFN's columns
over ``model``, a MoE layer's experts there too, MLA, the table and the head
whole) and a paged pool of its ``Hkv / T`` KV heads, and runs the same
step functions with the model group (``lm.serve_prefill`` / ``serve_decode``
``tp=``), whose all-reduces join the row-parallel products.  Every model
rank then holds bit-identical logits, and every rank draws from a generator
of the same seed, so the T ranks pick the same tokens; the D data indices
serve the same slots (nothing of the serving state shards over ``data``, as
in the reference).  Under such a group each step syncs inside gloo: a
collective of a CUDA tensor stages through the host, so "no host sync in
``step()``" holds for the one-device engine only, and no step table is
built (``compile_table``, ``export_aot`` and ``load_aot`` raise).

Determinism: greedy slots (temperature 0) consume no randomness, so
their outputs are the same token for token whether a request runs solo
or shares the batch -- co-residents only ever contribute exactly-zero
attention mass (see the kvcache docstring).  Sampled slots draw from the
engine's generator, so their streams depend on step placement; only
greedy outputs are placement-invariant (and only they match the
reference's, whose JAX key a torch generator cannot reproduce).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.engine import aot, graphs
from repro_torch.models import lm
from repro_torch.serve import kvcache
from repro_torch.serve.kvcache import TRASH_PAGE, PageGeometry
from repro_torch.serve.scheduler import Request, Scheduler
from repro_torch.tree import tree_leaves, tree_map

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


def _make_decode_fn(cfg: ModelConfig, *, eos_id: int, out_cap: int,
                    tp=None) -> Callable[..., None]:
    V = cfg.vocab_size

    def step(params, state: State,
             generator: Optional[torch.Generator]) -> None:
        logits, _ = lm.serve_decode(
            params, state["groups"], state["tokens"], cfg,
            pos=state["pos"], page_table=state["page_table"],
            active=state["active"], tp=tp)
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
                   pages_per_slot: int, tp=None) -> Callable[..., None]:
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
                                     page_row=page_row, prompt_len=prompt_len,
                                     tp=tp)
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


def _serving_mesh(mesh, group) -> sharding.Mesh:
    """The engine's mesh: ``group``'s (``mesh``, if given, must equal it),
    else ``mesh`` of one device, else the one-device mesh."""
    if mesh is not None and not isinstance(mesh, sharding.Mesh):
        raise TypeError(f"ServeEngine(mesh=): a dist/sharding.Mesh, not "
                        f"{type(mesh).__name__}")
    if group is not None:
        want = sharding.mesh_for(group)
        if mesh is not None and mesh != want:
            raise ValueError(f"ServeEngine(mesh={mesh}) under a group whose "
                             f"mesh is {want}")
        return want
    if mesh is not None and mesh.size > 1:
        raise ValueError(
            f"ServeEngine(mesh={mesh}): a process serves as one rank; a "
            f"mesh of {mesh.size} devices is a grid of ranks, so pass this "
            f"rank's group= (launch/mesh.init_grid_group)")
    return mesh if mesh is not None else sharding.Mesh((1, 1),
                                                       ("data", "model"))


class _GraphedServeStep:
    """One step-table key as two CUDA graphs, greedy and sampled, bound to
    the engine's params and state; called as the eager step is.  The
    warm-up admits a one-token request with ``max_new`` 1 into slot 0 whose
    pages are all the trash page (prefill), or decodes an idle batch, and
    the small per-slot state is restored after the capture, so capturing
    changes nothing a request can see."""

    def __init__(self, engine: "ServeEngine", key: str):
        fn, dev = engine._raw[key], engine.device
        self.params, self.state = engine.params, engine.state
        self.desc = None
        if key.startswith("prefill_"):
            bucket = int(key.split("_")[1])
            P = engine.geom.pages_per_slot
            desc = np.zeros((bucket + P + 4,), np.int32)
            desc[bucket:bucket + P] = TRASH_PAGE
            desc[bucket + P:bucket + P + 3] = (1, 0, 1)
            self.desc = torch.from_numpy(desc).to(dev)
        small = {k: v.clone() for k, v in self.state.items()
                 if k != "groups"}
        warm_gen = torch.Generator(device=dev).manual_seed(0)
        self.graphs = {}
        for sampled in (False, True):
            def call(gen, sampled=sampled):
                args = (() if self.desc is None else (self.desc,))
                fn(self.params, self.state, *args, gen if sampled else None)
            self.graphs[sampled] = graphs.capture(
                lambda: call(engine.generator), device=dev,
                pool=engine._graph_pool(), warmup=lambda: call(warm_gen),
                generators=(engine.generator,) if sampled else ())
            for k, v in small.items():
                self.state[k].copy_(v)
        self.launches = self.graphs[False].launches

    def __call__(self, params, state, *args) -> None:
        if params is not self.params or state is not self.state:
            raise RuntimeError("a graphed serve step runs on the params and "
                               "state it was captured on")
        *desc, generator = args
        if desc and desc[0] is not self.desc:
            self.desc.copy_(desc[0])
        self.graphs[generator is not None].replay()


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

    ``group``: this process's rank of a serving grid (a
    ``dist/group.GridGroup``; its device is the engine's).  ``params``
    are then the whole model's, of which the rank keeps its share, or are
    drawn from ``seed`` leaf by leaf, each leaf's share kept as it is
    drawn (``lm.init_lm(keep=)``), so no rank holds the whole model.
    ``mesh``: a ``dist/sharding.Mesh``; with a group it must be
    ``sharding.mesh_for(group)``, without one a mesh of one device (a
    process is one rank).
    """

    def __init__(self, cfg: ModelConfig, *, geom: Optional[PageGeometry]
                 = None, mesh=None, params=None, seed: int = 0,
                 eos_id: int = -1, max_new_cap: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 watermark: float = 1.0, chunk: int = 1, device=None,
                 group=None):
        reason = kvcache.supports(cfg)
        if reason:
            raise NotImplementedError(f"serve: {cfg.name}: {reason}")
        self.mesh = _serving_mesh(mesh, group)
        self.group = group
        model = getattr(group, "model", None)
        t, T = (model.rank, model.size) if model is not None else (0, 1)
        kvcache.check_model_parallel(cfg, T)
        # the model group the row-parallel joins all-reduce over
        self.tp = model if T > 1 else None
        self.cfg = cfg
        if group is not None:
            if device is not None and \
                    torch.device(device).type != group.device.type:
                raise ValueError(f"ServeEngine(device={device!r}) under a "
                                 f"group on {group.device}")
            self.device = group.device
        else:
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
        shapes = lm.param_shapes(cfg)
        self.params_specs = sharding.serve_params_pspec(shapes, cfg,
                                                        self.mesh)
        if params is None:
            params = lm.init_lm(torch.Generator(device=dev).manual_seed(seed),
                                cfg, dev, keep=None if T == 1 else
                                sharding.share_keeper(self.params_specs,
                                                      shapes, self.mesh,
                                                      {"model": t}))
        elif T > 1:
            params = sharding.grid_share(params, self.params_specs,
                                         self.mesh, {"model": t})
            params = tree_map(lambda p: p.clone(), params)
        self.params = params
        zeros = lambda *shape, dtype=torch.int64: torch.zeros(
            shape, dtype=dtype, device=dev)
        self.state: State = {
            "groups": kvcache.init_paged_cache(cfg, self.geom, dev, T),
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

        self._raw: Dict[str, Callable] = {
            "decode": _make_decode_fn(cfg, eos_id=eos_id,
                                      out_cap=self.max_new_cap, tp=self.tp)}
        for b in self.buckets:
            self._raw[f"prefill_{b}"] = _make_admit_fn(
                cfg, eos_id=eos_id, bucket=b, pages_per_slot=Pmax,
                tp=self.tp)
        self._steps: Dict[str, Callable] = dict(self._raw)
        self._compiled: Dict[str, Callable] = {}
        self._pool = None
        self._frozen = False

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

    def _to_device(self, desc: np.ndarray, key: str) -> Tensor:
        """One host-to-device copy, from pinned memory without a sync --
        into the static buffer of ``key``'s graphs when it has them."""
        t = torch.from_numpy(desc)
        if self.device.type != "cuda":
            return t.to(self.device)
        static = getattr(self._steps[key], "desc", None)
        if static is None:
            return t.pin_memory().to(self.device, non_blocking=True)
        return static.copy_(t.pin_memory(), non_blocking=True)

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
            key = f"prefill_{bucket}"
            self.step_fn(key)(
                self.params, self.state, self._to_device(desc, key),
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

    def held_bytes(self) -> Dict[str, int]:
        """The bytes this rank holds: its params and its paged pool."""
        count = lambda tree: sum(t.numel() * t.element_size()
                                 for t in tree_leaves(tree))
        return {"params": count(self.params),
                "pool": count(self.state["groups"])}

    # -- step table --------------------------------------------------------

    def step_fn(self, key: str) -> Callable:
        """The step function ``decode`` or ``prefill_<bucket>``."""
        if key not in self._steps:
            table = "AOT serve table" if self._frozen else "serve step table"
            raise KeyError(f"{table} has no entry {key!r}; "
                           f"available: {sorted(self._steps)}")
        return self._steps[key]

    def _graph_pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def _capture(self, key: str) -> Callable:
        if self.device.type != "cuda":
            return self._raw[key]
        return _GraphedServeStep(self, key)

    def _refuse_group(self, what: str) -> None:
        if self.group is not None and self.group.size > 1:
            raise NotImplementedError(
                f"{what} under a serving grid of {self.mesh.shape['data']} "
                f"x {self.mesh.shape['model']} ranks: their collectives go "
                f"through the host (gloo), which a CUDA graph cannot "
                f"capture; serve the grid's steps eagerly")

    def compile_table(self) -> Dict[str, Any]:
        """Build the step table: on a CUDA device, CUDA graphs of decode
        and of every prefill bucket (greedy and sampled each), which
        replace the eager entries; on the CPU the eager functions.  The
        capture warms each step up on the idle slots, so no request may be
        in flight.  Raises under a group of several ranks."""
        self._refuse_group("compile_table")
        if self._live:
            raise RuntimeError("compile_table: requests are in flight; "
                               "build the table on an idle engine")
        for key in self._raw:
            if key not in self._compiled:
                self._compiled[key] = self._steps[key] = self._capture(key)
        return dict(self._compiled)

    def aot_cache_path(self, cache_root=None) -> Path:
        root = Path(cache_root) if cache_root else aot.DEFAULT_CACHE
        extra = {"mode": "serve", "geom": dataclasses.asdict(self.geom),
                 "buckets": list(self.buckets), "eos_id": self.eos_id,
                 "out_cap": self.max_new_cap, "chunk": self.chunk}
        return root / aot.cache_key(self.cfg, None, None, self.device,
                                    self.state, extra=extra)

    def export_aot(self, path) -> Path:
        self._refuse_group("export_aot")
        if not self._compiled:
            self.compile_table()
        records = {}
        for key, entry in self._compiled.items():
            launches = getattr(entry, "launches", {})
            desc = getattr(entry, "desc", None)
            records[key] = {"inputs": aot._shape_sig({"desc": desc}),
                            "launches": launches,
                            "libs": aot.entry_libs(launches)}
        return aot.export_table(records, Path(path), device=self.device,
                                meta={"arch": self.cfg.name, "mode": "serve"})

    def load_aot(self, path) -> bool:
        """Restore a stored serve table (its kernel libraries load without
        ``nvcc``; on a CUDA device every entry is captured, its launches
        checked against the stored ones).  False on a miss or a damaged
        table, ``AOTCompatError`` for a table of another env.  Raises under
        a group of several ranks."""
        self._refuse_group("load_aot")
        if not aot.table_exists(path):
            return False
        try:
            table = aot.import_table(path, expect_device=self.device)
        except (aot.AOTCorruptError, FileNotFoundError):
            return False
        if self._live:
            raise RuntimeError("load_aot: requests are in flight")
        steps = {}
        for key, record in table.items():
            if key not in self._raw:
                raise aot.AOTCompatError(f"the stored serve table has an "
                                         f"entry {key!r} this engine lacks")
            entry = self._capture(key)
            aot.check_launches(key, getattr(entry, "launches", {}),
                                  record["launches"])
            steps[key] = self._compiled[key] = entry
        self._steps = steps
        self._frozen = True
        return True
