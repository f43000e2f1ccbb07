"""The port's serving subsystem, mirroring tests/test_serve.py: greedy
outputs are the same token for token whether a request runs alone or
joins a batch mid-flight (slot isolation: co-residents contribute exactly
zero attention mass), paged decode equals the dense prefill/decode path,
pages return to the free list, FCFS + watermark admission, the chunked
decode step; and the port's ``ServeEngine`` gives the reference's greedy
outputs token for token on bridged weights.  The AOT methods store and
restore the step table (on the CPU the eager functions; the round trip
and the key are in tests/test_torch_aot.py); a mesh that is not a
``dist/sharding.Mesh``, or one of several devices without the rank's
group, raises."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import lm as jlm
from repro.serve import ServeEngine as JServeEngine
from repro.serve import default_geometry as j_geometry
from repro.serve import kvcache as jkv
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.dist import sharding
from repro_torch.models import lm
from repro_torch.serve import (BlockAllocator, PageGeometry, Request,
                               Scheduler, ServeEngine, TRASH_PAGE,
                               cache_bytes, default_geometry, engine,
                               supports)

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

PROMPT_A = [3, 1, 4, 1, 5, 9, 2, 6]
PROMPT_B = [2, 7, 1, 8, 2, 8]
SERVE_ARCHS = ["yi-6b", "gemma3-4b", "deepseek-v2-lite-16b"]


def _geom(slots=2):
    return default_geometry(num_slots=slots, page_size=8, max_context=48)


def _engine(cfg, **kw):
    return ServeEngine(cfg, device="cpu", **kw)


def _bridged(arch, seed=0):
    """The reference's init_lm weights, as numpy and as the port's."""
    params = jax.tree.map(np.asarray,
                          jlm.init_lm(jax.random.key(seed), j_reduced(arch)))
    return params, bridge.params_from_numpy(params, reduced_config(arch))


@pytest.fixture(scope="module")
def yi():
    cfg = reduced_config("yi-6b")
    return cfg, lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")


# ---------------------------------------------------------------------------
# scheduler / allocator units (host-side)
# ---------------------------------------------------------------------------

def test_allocator_invariants():
    geom = PageGeometry(num_slots=2, page_size=8, pages_per_slot=4,
                        num_pages=9)
    alc = BlockAllocator(geom)
    assert alc.free_pages == 8
    a = alc.alloc(3)
    assert a == [1, 2, 3]                   # lowest-id-first, never page 0
    assert TRASH_PAGE not in a
    assert alc.alloc(6) is None             # pool can't satisfy -> None
    alc.free(a)
    assert alc.free_pages == 8
    assert alc.alloc(3) == [1, 2, 3]        # freed pages recycle low-first
    with pytest.raises(ValueError, match="double free"):
        alc.free([4, 4])
    with pytest.raises(ValueError, match="trash"):
        alc.free([TRASH_PAGE])


def test_geometry_validation():
    with pytest.raises(ValueError):
        PageGeometry(num_slots=0, page_size=8, pages_per_slot=4, num_pages=9)
    with pytest.raises(ValueError):
        PageGeometry(num_slots=1, page_size=8, pages_per_slot=1, num_pages=1)
    geom = _geom()
    assert geom.max_context == 48
    assert geom.capacity_tokens == (geom.num_pages - 1) * geom.page_size
    jg = j_geometry(num_slots=2, page_size=8, max_context=48)
    assert (geom.num_slots, geom.page_size, geom.pages_per_slot,
            geom.num_pages) == (jg.num_slots, jg.page_size,
                                jg.pages_per_slot, jg.num_pages)


def test_scheduler_fcfs_no_bypass():
    """If the queue head doesn't fit, nothing behind it jumps ahead."""
    geom = PageGeometry(num_slots=2, page_size=8, pages_per_slot=4,
                        num_pages=5)                    # pool: 4 pages
    sch = Scheduler(geom)
    big = Request(prompt=[1] * 8, max_new=24)           # 4 pages
    small = Request(prompt=[1] * 4, max_new=4)          # 1 page
    tiny = Request(prompt=[1] * 2, max_new=2)           # 1 page
    sch.submit(big)
    sch.submit(small)
    placed = sch.admit([0, 1])
    assert [r.rid for r, _, _ in placed] == [big.rid]   # big takes the pool
    sch.submit(tiny)
    assert sch.admit([1]) == []                         # small blocks tiny
    sch.retire(big)
    placed = sch.admit([0, 1])
    assert [r.rid for r, _, _ in placed] == [small.rid, tiny.rid]
    assert sch.allocator.allocs == sch.allocator.frees + 2


def test_scheduler_watermark_budget():
    geom = PageGeometry(num_slots=4, page_size=8, pages_per_slot=4,
                        num_pages=17)                   # capacity 128 tokens
    sch = Scheduler(geom, watermark=0.5)                # budget 64 tokens
    reqs = [Request(prompt=[1] * 8, max_new=24) for _ in range(3)]  # 32 each
    for r in reqs:
        sch.submit(r)
    placed = sch.admit([0, 1, 2, 3])
    assert len(placed) == 2                             # third exceeds budget
    assert sch.committed_tokens == 64
    sch.retire(placed[0][0])
    assert len(sch.admit([0])) == 1                     # budget freed -> admits
    with pytest.raises(ValueError, match="watermark"):
        Scheduler(geom, watermark=0.0)


def test_scheduler_rejects_oversized():
    sch = Scheduler(_geom())
    with pytest.raises(ValueError, match="exceeds slot capacity"):
        sch.submit(Request(prompt=[1] * 40, max_new=48))


@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-4b",
                                  "deepseek-v2-lite-16b", "minicpm3-4b"])
def test_paged_cache_layout_and_bytes_equal_the_reference(arch):
    from repro_torch.serve import paged_cache_shapes
    geom = default_geometry(num_slots=4, page_size=16, max_context=128)
    jgeom = j_geometry(num_slots=4, page_size=16, max_context=128)
    want = jkv.paged_cache_shapes(j_reduced(arch), jgeom)
    got = paged_cache_shapes(reduced_config(arch), geom)
    assert [w.shape for w in jax.tree.leaves(want)] == \
        [tuple(t.shape) for t in jax.tree.leaves(got)]
    assert cache_bytes(reduced_config(arch), geom) == \
        jkv.cache_bytes(j_reduced(arch), jgeom)


# ---------------------------------------------------------------------------
# engine: the continuous-batching contract
# ---------------------------------------------------------------------------

def _staggered(eng):
    ra = eng.submit(PROMPT_A, max_new=6)
    eng.step(2)                             # A mid-decode ...
    rb = eng.submit(PROMPT_B, max_new=6)    # ... when B joins
    done = eng.drain()
    assert {r.rid for r in done} == {ra.rid, rb.rid}
    return ra.output, rb.output


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_staggered_matches_solo_and_the_reference(arch):
    """The acceptance property: request B joining while A is mid-decode
    changes neither output by a single token (greedy).  Covers dense GQA,
    local+global windows and MLA absorbed decode.  And the reference's
    engine, on the same weights and trace, emits the same tokens."""
    params, tp = _bridged(arch)
    eng = _engine(reduced_config(arch), geom=_geom(), params=tp)
    solo = {}
    for prompt in (PROMPT_A, PROMPT_B):
        eng.submit(prompt, max_new=6)
        (done,) = eng.drain()
        solo[tuple(prompt)] = done.output
    out_a, out_b = _staggered(eng)
    assert out_a == solo[tuple(PROMPT_A)]
    assert out_b == solo[tuple(PROMPT_B)]
    assert len(out_a) == len(out_b) == 6

    ref = JServeEngine(j_reduced(arch), geom=j_geometry(
        num_slots=2, page_size=8, max_context=48), params=params)
    assert _staggered(ref) == (out_a, out_b)


def test_paged_decode_matches_dense(yi):
    """ServeEngine's paged greedy continuation == the dense
    prefill/decode_step path on the same params."""
    cfg, params = yi
    max_new = 8
    eng = _engine(cfg, geom=_geom(), params=params)
    req = eng.submit(PROMPT_A, max_new=max_new)
    eng.drain()

    V = cfg.vocab_size
    cache = lm.init_cache(cfg, 1, len(PROMPT_A) + max_new)
    logits, cache = lm.prefill(params, {"tokens": torch.tensor([PROMPT_A])},
                               cfg, cache)
    ref = [int(logits[0, 0, :V].argmax())]
    for _ in range(max_new - 1):
        logits, cache = lm.decode_step(params, cache,
                                       torch.tensor([[ref[-1]]]), cfg)
        ref.append(int(logits[0, 0, :V].argmax()))
    assert req.output == ref


def test_slot_reuse_and_freelist(yi):
    """More requests than slots: slots recycle, every page comes home."""
    cfg, params = yi
    eng = _engine(cfg, geom=_geom(slots=2), params=params)
    reqs = [eng.submit(PROMPT_A, max_new=3 + i) for i in range(5)]
    done = eng.drain()
    assert len(done) == 5
    assert [len(r.output) for r in reqs] == [3, 4, 5, 6, 7]
    st = eng.stats()
    assert st["slots_reused"] == 2          # both slots served >1 request
    assert st["page_allocs"] == st["page_frees"] > 0
    assert st["free_pages"] == eng.geom.num_pages - 1
    # stale table rows are fine: inactive slots write to the trash page
    assert not bool(eng.state["active"].any())
    assert eng.page_table().shape == (2, eng.geom.pages_per_slot)


def test_pool_exhaustion_queues_then_completes(yi):
    """An oversubscribed pool queues the overflow request; it admits when
    pages free up and still finishes correctly."""
    cfg, params = yi
    geom = PageGeometry(num_slots=2, page_size=8, pages_per_slot=4,
                        num_pages=5)        # 4 usable pages, slots want 8
    eng = _engine(cfg, geom=geom, params=params)
    r1 = eng.submit(PROMPT_A, max_new=8)    # 16 tok = 2 pages
    r2 = eng.submit(PROMPT_B, max_new=10)   # 16 tok = 2 pages
    r3 = eng.submit(PROMPT_A, max_new=8)    # must wait for pages
    eng.step(1)
    assert len(eng._live) == 2 and len(eng.scheduler.queue) == 1
    done = eng.drain()
    assert {r.rid for r in done} == {r1.rid, r2.rid, r3.rid}
    assert r3.admitted_step > r2.admitted_step
    assert r1.output == r3.output           # same prompt, same greedy path
    assert eng.stats()["free_pages"] == 4


def test_chunked_decode_equivalence(yi):
    """chunk=3 (three decode steps per engine step) produces the same
    tokens as the single-step engine, in fewer engine steps."""
    cfg, params = yi
    outs, clocks = [], []
    for chunk in (1, 3):
        eng = _engine(cfg, geom=_geom(), params=params, chunk=chunk)
        eng.submit(PROMPT_A, max_new=7)
        eng.submit(PROMPT_B, max_new=5)
        done = eng.drain()
        outs.append(sorted((tuple(r.prompt), tuple(r.output)) for r in done))
        clocks.append(eng.clock)
    assert outs[0] == outs[1]
    assert clocks[1] < clocks[0]


def test_eos_deactivates_the_slot_on_the_device(yi):
    """A slot whose greedy token is ``eos_id`` stops there: the output ends
    with it and is shorter than max_new."""
    cfg, params = yi
    full = _engine(cfg, geom=_geom(), params=params)
    full.submit(PROMPT_A, max_new=8)
    (ref,) = full.drain()
    eos = ref.output[2]
    cut = ref.output[:ref.output.index(eos) + 1]
    eng = _engine(cfg, geom=_geom(), params=params, eos_id=eos)
    eng.submit(PROMPT_A, max_new=8)
    (done,) = eng.drain()
    assert done.output == cut and len(cut) < 8


def test_sampled_slots_draw_from_the_generator(yi):
    """temperature > 0: the draw is torch.multinomial's one-sample draw from
    the engine's generator; a sampled co-resident leaves a greedy request's
    output unchanged."""
    probs = torch.softmax(torch.randn(5, 300), dim=-1)
    g1, g2 = (torch.Generator().manual_seed(7) for _ in "12")
    assert torch.equal(engine.draw(probs, g1),
                       torch.multinomial(probs, 1, generator=g2)[:, 0])
    cfg, params = yi
    eng = _engine(cfg, geom=_geom(), params=params)
    eng.submit(PROMPT_A, max_new=6)
    (greedy,) = eng.drain()
    a = eng.submit(PROMPT_A, max_new=6)
    b = eng.submit(PROMPT_B, max_new=6, temperature=1.0)
    eng.drain()
    assert a.output == greedy.output
    assert len(b.output) == 6 and all(0 <= t < cfg.vocab_size
                                      for t in b.output)


def test_submit_validation(yi):
    cfg, params = yi
    eng = _engine(cfg, geom=_geom(), params=params)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(PROMPT_A, max_new=0)
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(list(range(100)), max_new=2)
    with pytest.raises(KeyError, match="serve step table"):
        eng.step_fn("prefill_999")


def test_unsupported_arch_raises():
    assert supports(reduced_config("mamba2-2.7b")) is not None
    with pytest.raises(NotImplementedError, match="paged decode"):
        _engine(reduced_config("mamba2-2.7b"), geom=_geom())


def test_aot_methods_work_and_mesh_raises(yi, tmp_path):
    """The four AOT methods run (on the CPU the table is the eager
    functions, and the loaded one answers as they do); a mesh that is not
    a ``dist/sharding.Mesh`` raises ``TypeError``, and one of several
    devices without a ``group=`` raises ``ValueError`` naming it (a
    process serves as one rank; sharded serving is
    tests/test_torch_sharded_serve.py's)."""
    cfg, params = yi
    eng = _engine(cfg, geom=_geom(), params=params)
    assert set(eng.compile_table()) == {"decode", "prefill_16"}
    path = eng.aot_cache_path(tmp_path)
    assert path.parent == tmp_path and path.name.startswith(cfg.name)
    assert eng.export_aot(path) == path
    other = _engine(cfg, geom=_geom(), params=params)
    assert other.load_aot(path) and other._frozen
    assert not other.load_aot(tmp_path / "absent")
    with pytest.raises(TypeError, match="sharding.Mesh"):
        _engine(cfg, geom=_geom(), params=params, mesh=object())
    with pytest.raises(ValueError, match="group="):
        _engine(cfg, geom=_geom(), params=params,
                mesh=sharding.Mesh((1, 2), ("data", "model")))
