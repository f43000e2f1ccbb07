"""The port's step table on disk and in CUDA graphs (``engine/aot.py``,
``engine/graphs.py``), mirroring tests/test_engine.py's and
tests/test_serve.py's AOT tests: the round trip in one process and in a
fresh one, a frozen table resolving deeper, additive exports, an env
mismatch refused, corruption read as a miss and built anew, the serve
table and its key.  On the CPU a table holds the eager step functions, so
a frozen table's losses equal eager's exactly.

The tests marked ``cuda`` hold the graphed steps against eager ones on
the card (skipped here).  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_aot.py``.
This file imports no JAX, so it runs there.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import make_batch, reduced_config
from repro_torch.core import spb as spb_lib
from repro_torch.engine import aot, graphs
from repro_torch.engine.engine import SPBEngine
from repro_torch.engine.fused import FusedEngine, stack_batches
from repro_torch.kernels import _build
from repro_torch.models import lm
from repro_torch.optim import optimizers
from repro_torch.serve import ServeEngine, default_geometry
from repro_torch.tree import tree_leaves

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]


def _setup(k=4, **tkw):
    cfg = reduced_config("yi-6b")
    return cfg, TrainConfig(num_steps=8, **tkw), SPBConfig(mode="temporal",
                                                           k=k)


def _engine(cfg, tcfg, spb, device="cpu", **kw):
    return SPBEngine(cfg, tcfg, spb, device=device, **kw)


def _batch(cfg, seed=0, device="cpu"):
    return make_batch(cfg, 2, 32, seed=seed, device=device)


def _xent(eng, seed=0, step=0):
    return float(eng.train_step(_batch(eng.cfg, seed), step)["xent"])


# ---------------------------------------------------------------------------
# the training table (tests/test_engine.py's AOT tests)
# ---------------------------------------------------------------------------

def test_aot_roundtrip_same_process(tmp_path):
    """Store -> load in a second engine: identical first-step metrics."""
    cfg, tcfg, spb = _setup()
    src = _engine(cfg, tcfg, spb)
    specs = src.batch_specs_like(_batch(cfg))
    src.compile_table(specs)
    path = src.export_aot(tmp_path / "table", specs)
    src.init_state(0)
    want = _xent(src)

    dst = _engine(cfg, tcfg, spb)
    assert dst.load_aot(path)
    dst.init_state(0)
    assert _xent(dst) == want
    assert dst.last_depth == src.last_depth
    assert sorted(map(str, dst.depth_keys())) == sorted(
        map(str, src.depth_keys()))


def test_aot_frozen_table_resolves_deeper(tmp_path):
    """A loaded table missing a depth resolves to the nearest deeper
    entry with a warning; with no deeper entry it fails loudly."""
    cfg, tcfg, spb = _setup()
    deepest = max(spb_lib.snapped_depths(cfg, spb))
    src = _engine(cfg, tcfg, spb)
    specs = src.batch_specs_like(_batch(cfg))
    src.compile_table(specs, depths=[deepest])
    path = src.export_aot(tmp_path / "partial")

    dst = _engine(cfg, tcfg, spb)
    assert dst.load_aot(path)
    with pytest.warns(UserWarning, match="substituting deeper"):
        assert dst.resolve_depth(1) == deepest
    with pytest.raises(KeyError):
        dst.step_fn("mb")

    src2 = _engine(cfg, tcfg, spb)
    src2.compile_table(specs, depths=[1])
    path2 = src2.export_aot(tmp_path / "shallow")
    dst2 = _engine(cfg, tcfg, spb)
    assert dst2.load_aot(path2)
    with pytest.raises(KeyError, match="deeper"):
        dst2.resolve_depth(2)


def test_aot_export_is_additive(tmp_path):
    """Exports into one directory accumulate entries."""
    cfg, tcfg, spb = _setup()
    rec = {"inputs": [], "launches": {}, "libs": []}
    aot.export_table({1: rec}, tmp_path / "acc", device="cpu")
    aot.export_table({2: rec}, tmp_path / "acc", device="cpu")
    assert set(aot.import_table(tmp_path / "acc")) == {1, 2}
    eng = _engine(cfg, tcfg, spb)
    specs = eng.batch_specs_like(_batch(cfg))
    eng.compile_table(specs, depths=[3])
    eng.export_aot(tmp_path / "acc")
    assert set(aot.import_table(tmp_path / "acc")) == {1, 2, 3}


def test_aot_import_rejects_env_mismatch(tmp_path):
    """A table stored by another env (torch, CUDA, the device's name or
    capability, the device count) is refused, not run; an intact table of
    this env loads."""
    cfg, tcfg, spb = _setup()
    src = _engine(cfg, tcfg, spb)
    path = src.export_aot(tmp_path / "table",
                          src.batch_specs_like(_batch(cfg)))
    good = (path / "manifest.json").read_text()
    assert aot.import_table(path, expect_device="cpu")
    for key, value in (("device_name", "NVIDIA H100 80GB HBM3"),
                       ("torch_version", "0.0"), ("device_count", 8)):
        manifest = json.loads(good)
        manifest["env"][key] = value
        (path / "manifest.json").write_text(json.dumps(manifest))
        with pytest.raises(aot.AOTCompatError, match=key):
            aot.import_table(path, expect_device="cpu")
        with pytest.raises(aot.AOTCompatError):
            _engine(cfg, tcfg, spb).load_aot(path)
    (path / "manifest.json").write_text(good)
    assert _engine(cfg, tcfg, spb).load_aot(path)


def test_aot_corruption_is_a_cache_miss(tmp_path):
    """Damaged entries degrade to a cold cache, never a crash: typed
    errors from ``import_table``, False from ``load_aot``; a missing or
    stale kernel library reads the same way."""
    cfg, tcfg, spb = _setup(k=2)
    src = _engine(cfg, tcfg, spb)
    src.compile_table(src.batch_specs_like(_batch(cfg)), depths=[2])
    path = Path(src.export_aot(tmp_path / "table"))
    good_manifest = (path / "manifest.json").read_text()
    good_entry = (path / "step_2.json").read_text()
    miss = lambda: not _engine(cfg, tcfg, spb).load_aot(path)

    (path / "manifest.json").write_text("{ not json")
    with pytest.raises(aot.AOTCorruptError):
        aot.import_table(path)
    assert miss()
    (path / "manifest.json").write_text("[1, 2]")
    with pytest.raises(aot.AOTCorruptError):
        aot.import_table(path)
    (path / "manifest.json").write_text(good_manifest)

    (path / "step_2.json").write_text(good_entry[:16])
    with pytest.raises(aot.AOTCorruptError):
        aot.import_table(path)
    assert miss()
    (path / "step_2.json").unlink()
    with pytest.raises(FileNotFoundError):
        aot.import_table(path)
    assert miss()
    (path / "step_2.json").write_text(good_entry)

    manifest = json.loads(good_manifest)
    stale = f"libflash_fwd-{'0' * 16}.so"
    (path / stale).write_bytes(b"\x7fELF")
    manifest["libs"] = {"flash_fwd": stale}
    (path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(aot.AOTCorruptError, match="other sources"):
        aot.import_table(path)
    assert miss()
    manifest["libs"] = {"flash_fwd": _build.lib_path("flash_fwd").name}
    (path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(FileNotFoundError, match="library"):
        aot.import_table(path)
    assert miss()
    (path / _build.lib_path("flash_fwd").name).write_bytes(b"garbage")
    with pytest.raises(aot.AOTCorruptError, match="does not load"):
        aot.import_table(path)
    assert miss()

    assert issubclass(aot.AOTCorruptError, aot.AOTCompatError)
    (path / "manifest.json").write_text(good_manifest)
    assert aot.import_table(path)


def test_engine_builds_anew_after_corrupt_cache(tmp_path):
    """An engine pointed at a corrupt table reports a miss, then trains
    eagerly to the exporter's first-step metrics."""
    cfg, tcfg, spb = _setup(k=2)
    src = _engine(cfg, tcfg, spb)
    src.compile_table(src.batch_specs_like(_batch(cfg)), depths=[2])
    path = Path(src.export_aot(tmp_path / "table"))
    src.init_state(0)
    want = _xent(src)
    (path / "manifest.json").write_text("\x00garbage")
    dst = _engine(cfg, tcfg, spb)
    assert not dst.load_aot(path)
    dst.init_state(0)
    assert _xent(dst) == want


def test_aot_roundtrip_fresh_process(tmp_path):
    """A second process loads the table (nothing to build: the CPU table
    holds no library) and trains to the exporter's first-step xent."""
    cfg, tcfg, spb = _setup()
    src = _engine(cfg, tcfg, spb)
    specs = src.batch_specs_like(_batch(cfg))
    path = src.export_aot(tmp_path / "table", specs)
    src.init_state(0)
    want = _xent(src)
    code = (
        "import json, sys\n"
        "from repro_torch.config import SPBConfig, TrainConfig\n"
        "from repro_torch.configs import make_batch, reduced_config\n"
        "from repro_torch.engine.engine import SPBEngine\n"
        "cfg = reduced_config('yi-6b')\n"
        "eng = SPBEngine(cfg, TrainConfig(num_steps=8),\n"
        "                SPBConfig(mode='temporal', k=4), device='cpu')\n"
        "loaded = eng.load_aot(sys.argv[1])\n"
        "eng.init_state(0)\n"
        "m = eng.train_step(make_batch(cfg, 2, 32, seed=0, device='cpu'), 0)\n"
        "print(json.dumps({'loaded': loaded, 'xent': float(m['xent'])}))\n")
    res = subprocess.run(
        [sys.executable, "-c", code, str(path)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300, check=True)
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"loaded": True, "xent": want}


@pytest.mark.parametrize("mode,k", [("temporal", 4), ("temporal-mb", 2)])
def test_frozen_table_losses_equal_eager(tmp_path, mode, k):
    """On the CPU a loaded table runs the eager step functions: every
    step's loss, grad norm and lr, and every parameter, equal an eager
    engine's exactly over a depth cycle."""
    cfg = reduced_config("yi-6b")
    tcfg, spb = TrainConfig(num_steps=6), SPBConfig(mode=mode, k=k)
    batch_rows = 4 if mode == "temporal-mb" else 2
    batches = [make_batch(cfg, batch_rows, 32, seed=s, device="cpu")
               for s in range(6)]
    eager = _engine(cfg, tcfg, spb)
    path = eager.export_aot(tmp_path / "t", eager.batch_specs_like(
        batches[0]))
    frozen = _engine(cfg, tcfg, spb)
    assert frozen.load_aot(path) and frozen._frozen
    runs = []
    for eng in (eager, frozen):
        eng.init_state(0)
        runs.append([{k: v.clone() for k, v in eng.train_step(b, s).items()}
                     for s, b in enumerate(batches)])
    for a, b in zip(*runs):
        for key in ("loss", "grad_norm", "lr"):
            assert torch.equal(a[key], b[key])
    for a, b in zip(tree_leaves(eager.state["params"]),
                    tree_leaves(frozen.state["params"])):
        assert torch.equal(a, b)


def test_compile_table_refuses_compression():
    cfg, tcfg, spb = _setup(compression="topk")
    eng = _engine(cfg, tcfg, spb)
    with pytest.raises(NotImplementedError, match="cannot capture"):
        eng.compile_table(eng.batch_specs_like(_batch(cfg)))


def test_memory_analysis_and_specs():
    """``memory_analysis`` of a CPU entry is zeros (no pool) and needs a
    compiled entry; batch specs survive the stored signature."""
    cfg, tcfg, spb = _setup()
    eng = _engine(cfg, tcfg, spb)
    specs = eng.batch_specs_like(_batch(cfg))
    with pytest.raises(KeyError):
        eng.memory_analysis(2)
    eng.compile_table(specs, depths=[2])
    assert eng.memory_analysis(2) == {"pool_bytes": 0,
                                      "pool_total_bytes": 0,
                                      "peak_bytes": 0}
    from repro_torch.engine.engine import specs_from_signature
    assert specs_from_signature(aot._shape_sig(specs)) == specs


def test_schedule_values_are_the_host_scalars():
    """A graphed step's schedule is the learning rate and AdamW's inverse
    bias corrections of the step, as f32; on the CPU ``apply_updates``
    with it agrees with the host-scalar path to f32 rounding."""
    tcfg = TrainConfig(num_steps=20)
    for step in (0, 3, 9, 19):
        lr, i1, i2 = optimizers.schedule_values(tcfg, step)
        assert lr == np.float32(optimizers.lr_at(tcfg, step))
        assert i1 == np.float32(1.0 / (1 - tcfg.beta1 ** (step + 1.0)))
        assert i2 == np.float32(1.0 / (1 - tcfg.beta2 ** (step + 1.0)))
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(64, 32, generator=gen)}
    grads = {"w": torch.randn(64, 32, generator=gen)}
    outs = []
    for sched in (None, torch.from_numpy(optimizers.schedule_values(tcfg, 4))):
        p = {"w": params["w"].clone()}
        opt = optimizers.init_opt_state(p, tcfg)
        _, _, m = optimizers.apply_updates(p, grads, opt, 4, tcfg,
                                           sched=sched)
        outs.append((p["w"], m["lr"]))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-6, atol=1e-7)
    assert torch.equal(outs[0][1], outs[1][1])


def test_fused_engine_table_on_the_cpu(tmp_path):
    """``FusedEngine``'s table: its own step-cache keys, and a loaded
    table's fused steps equal eager ones."""
    cfg, tcfg, spb = _setup(k=2)
    batches = [stack_batches([_batch(cfg, 2 * s + j) for j in range(2)])
               for s in range(3)]
    eager = FusedEngine(cfg, tcfg, spb, num_jobs=2, device="cpu")
    assert eager.step_cache_key(2)[-1] == ("fused", 2)
    path = eager.export_aot(tmp_path / "f", eager.batch_specs_like(
        batches[0]))
    frozen = FusedEngine(cfg, tcfg, spb, num_jobs=2, device="cpu")
    assert frozen.load_aot(path)
    losses = []
    for eng in (eager, frozen):
        eng.init_states([0, 1])
        losses.append([eng.train_step(b, s)["loss"]
                       for s, b in enumerate(batches)])
    for a, b in zip(*losses):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the serve table (tests/test_serve.py's AOT tests)
# ---------------------------------------------------------------------------

def _geom(slots=2, page=8):
    return default_geometry(num_slots=slots, page_size=page, max_context=48)


@pytest.fixture(scope="module")
def yi():
    cfg = reduced_config("yi-6b")
    return cfg, lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")


def test_serve_aot_round_trip(yi, tmp_path):
    """Store the serve table, load it into a fresh engine: identical
    outputs, and the frozen table refuses unknown entries."""
    cfg, params = yi
    eng = ServeEngine(cfg, geom=_geom(), params=params, device="cpu")
    path = eng.aot_cache_path(tmp_path)
    eng.export_aot(path)
    req = eng.submit(PROMPT, max_new=6)
    eng.drain()

    eng2 = ServeEngine(cfg, geom=_geom(), params=params, device="cpu")
    assert eng2.load_aot(path)
    assert eng2._frozen
    req2 = eng2.submit(PROMPT, max_new=6)
    eng2.drain()
    assert req2.output == req.output
    with pytest.raises(KeyError, match="AOT serve table"):
        eng2.step_fn("prefill_999")


def test_serve_aot_cache_key_varies_with_geometry(yi, tmp_path):
    """The key owns the geometry, the buckets, eos_id, max_new_cap and
    chunk: each change maps to another directory."""
    cfg, params = yi
    base = dict(geom=_geom(), params=params, device="cpu")
    path = ServeEngine(cfg, **base).aot_cache_path(tmp_path)
    assert ServeEngine(cfg, **base).aot_cache_path(tmp_path) == path
    for change in (dict(geom=_geom(slots=3)), dict(geom=_geom(page=16)),
                   dict(buckets=(16, 32)), dict(eos_id=2),
                   dict(max_new_cap=20), dict(chunk=2)):
        other = ServeEngine(cfg, **{**base, **change})
        assert other.aot_cache_path(tmp_path) != path, change


def test_serve_compile_table_needs_an_idle_engine(yi):
    cfg, params = yi
    eng = ServeEngine(cfg, geom=_geom(), params=params, device="cpu")
    eng.submit(PROMPT, max_new=4)
    eng.step(1)
    with pytest.raises(RuntimeError, match="in flight"):
        eng.compile_table()
    eng.drain()
    assert set(eng.compile_table()) == {"decode", "prefill_16"}


def test_graph_capture_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        graphs.capture(lambda: None, device="cpu", pool=None)


def test_entry_libs_follow_the_counters():
    assert aot.entry_libs({"flash_fwd": 8, "flash_dq": 0,
                           "ssd_fwd_res": 2, "rglru_bwd": 1}) == [
        "flash_fwd", "rglru", "ssd_fwd"]
    assert set(graphs.COUNTER_LIBS.values()) == set(_build.SOURCES)
    assert set(graphs.launch_counters()) == set(graphs.COUNTER_LIBS)


# ---------------------------------------------------------------------------
# on the card: graphed steps against eager ones
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_decode_matches_eager(cuda):
    """yi-6b-reduced on the kernels: a staggered greedy trace through the
    graphed table equals the eager engine's token for token, with the same
    launches; sampled requests run through the sampled graphs."""
    import dataclasses
    cfg = dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)
    params = lm.init_lm(torch.Generator(device=cuda).manual_seed(0), cfg,
                        cuda)
    prompts = [PROMPT, PROMPT[:3], PROMPT[2:] * 2]
    outs, counts = [], []
    for graphed in (False, True):
        eng = ServeEngine(cfg, geom=_geom(slots=2), params=params,
                          device=cuda)
        if graphed:
            eng.compile_table()
        before = graphs.launch_counts()
        reqs = []
        for i, p in enumerate(prompts):
            reqs.append(eng.submit(p, max_new=6))
            eng.step(2)
        eng.drain()
        outs.append([r.output for r in reqs])
        counts.append({n: c - before[n]
                       for n, c in graphs.launch_counts().items()})
        eng.submit(PROMPT, max_new=5, temperature=0.8)
        (sampled,) = eng.drain()
        assert len(sampled.output) == 5
    assert outs[0] == outs[1]
    assert counts[0] == counts[1] and counts[0]["flash_fwd"] > 0


def _train(eng, batches):
    return [{k: v.detach().cpu() for k, v in eng.train_step(b, s).items()}
            for s, b in enumerate(batches)]


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer,mode", [("adamw", "temporal"),
                                            ("sgdm", "temporal"),
                                            ("adamw", "temporal-mb")])
def test_graphed_train_steps_match_eager(cuda, optimizer, mode):
    """yi-6b-reduced on the kernels, temporal k=2 (or the k=2 cycle as
    microbatches of one step), 6 steps of warm-up whose learning rate
    changes every step: the graphed table's losses, grad norms, lrs and
    parameters equal eager ones bit for bit (a baked learning rate or
    bias correction would differ from step 1 on), and each replay counts
    an eager step's launches."""
    import dataclasses
    cfg = dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)
    tcfg = TrainConfig(num_steps=6, optimizer=optimizer)
    spb = SPBConfig(mode=mode, k=2)
    rows = 4 if mode == "temporal-mb" else 2
    batches = [make_batch(cfg, rows, 64, seed=s, device=cuda)
               for s in range(6)]
    runs = {}
    for graphed in (False, True):
        eng = SPBEngine(cfg, tcfg, spb, device=cuda)
        eng.init_state(0)
        if graphed:
            eng.compile_table(eng.batch_specs_like(batches[0]))
        before = graphs.launch_counts()
        runs[graphed] = (_train(eng, batches),
                         [t.detach().cpu()
                          for t in tree_leaves(eng.state["params"])],
                         {n: c - before[n]
                          for n, c in graphs.launch_counts().items()})
    (em, ep, el), (gm, gp, gl) = runs[False], runs[True]
    assert len({float(m["lr"]) for m in em}) == 6
    for a, b in zip(em, gm):
        for key in ("loss", "grad_norm", "lr"):
            assert torch.equal(a[key], b[key]), key
    assert all(torch.equal(a, b) for a, b in zip(ep, gp))
    assert el == gl


@pytest.mark.cuda
def test_graphed_table_binds_its_state(cuda, tmp_path):
    """Once captured, a new state is copied into the captured buffers
    (``init_state``, ``attach_state``), a foreign state is refused, and a
    stored table loads and replays the exporter's first step."""
    import dataclasses
    cfg = dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)
    tcfg, spb = TrainConfig(num_steps=4), SPBConfig(mode="temporal", k=2)
    batch = make_batch(cfg, 2, 64, seed=0, device=cuda)
    eng = SPBEngine(cfg, tcfg, spb, device=cuda)
    eng.init_state(0)
    eng.compile_table(eng.batch_specs_like(batch))
    bound = eng.state
    first = float(eng.train_step(batch, 0)["loss"])
    assert eng.init_state(0) is bound
    assert float(eng.train_step(batch, 0)["loss"]) == first
    with pytest.raises(RuntimeError, match="captured on"):
        eng.step_fn(eng.last_depth)(dict(bound), batch)
    path = eng.export_aot(tmp_path / "t")
    other = SPBEngine(cfg, tcfg, spb, device=cuda)
    other.init_state(0)
    assert other.load_aot(path)
    assert float(other.train_step(batch, 0)["loss"]) == first
    stats = other.memory_analysis(other.last_depth)
    assert stats["pool_total_bytes"] > 0 and stats["peak_bytes"] > 0


@pytest.mark.cuda
def test_failed_capture_raises_and_keeps_eager(cuda):
    """A step that reads a device value on the host cannot be captured:
    ``compile_table`` raises, installs nothing, and the eager entry still
    trains."""
    cfg, tcfg, spb = _setup(k=2)
    eng = SPBEngine(cfg, tcfg, spb, device=cuda, shared_cache=False)
    eng.init_state(0)
    eager = eng.step_fn(2)

    def syncing(state, batch, **kw):
        out = eager(state, batch, **kw)
        float(out[1]["loss"])
        return out

    eng._eager_step = lambda key: syncing
    batch = _batch(cfg)
    with pytest.raises(RuntimeError):
        eng.compile_table(eng.batch_specs_like(batch), depths=[2])
    assert not eng._compiled and eng.step_fn(2) is eager
    assert np.isfinite(float(eng.train_step(batch, 0, depth=2)["loss"]))


@pytest.mark.cuda
def test_graphed_fused_steps_match_eager(cuda):
    """``FusedEngine``'s vmapped step captures too: two yi-6b-reduced
    tenants, 4 steps, losses equal the eager fused engine's."""
    import dataclasses
    cfg = dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)
    tcfg, spb = TrainConfig(num_steps=4), SPBConfig(mode="temporal", k=2)
    batches = [stack_batches([make_batch(cfg, 2, 64, seed=2 * s + j,
                                         device=cuda) for j in range(2)])
               for s in range(4)]
    losses = []
    for graphed in (False, True):
        eng = FusedEngine(cfg, tcfg, spb, num_jobs=2, device=cuda)
        eng.init_states([0, 1])
        if graphed:
            eng.compile_table(eng.batch_specs_like(batches[0]))
        losses.append([m["loss"] for m in _train(eng, batches)])
    for a, b in zip(*losses):
        assert torch.equal(a, b)
