"""The slice end to end on the CPU: the port's SPBEngine against the JAX
SPBEngine on yi-6b-reduced (f32, kernels on, temporal SPB k=4, batch
2 x 64) from bridged weights and the same Pipeline batches, 4 steps over
depths 4, 1, 3, 2.  Metrics agree step by step to rtol 1e-4: the same f32
arithmetic, summed in another order, compounded over four AdamW updates.
The same for mamba2-reduced (the SSD kernels' plain versions) and for
recurrentgemma-reduced (the RG-LRU kernels' plain versions and flash at a
window of 32 over 64 positions) and for qwen3-moe-reduced (MoE layers).  Also the port's train entry point, its
steps on compressed gradients, spatial SPB's one-step table on a group of
one (its ranks are ``tests/test_torch_spatial.py``'s), and its refusal to
run on a missing card."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import SPBConfig as JSPB, TrainConfig as JTrain
from repro.configs import reduced_config as j_reduced
from repro.core import compress as j_compress
from repro.data.pipeline import Pipeline as JPipeline
from repro.engine import SPBEngine as JEngine
from repro_torch import bridge
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.core import compress
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist import steps as steps_lib
from repro_torch.engine.engine import SPBEngine
from repro_torch.launch import train as train_mod
from repro_torch.tree import tree_leaves

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

STEPS = 4


@pytest.fixture(scope="module")
def jax_run():
    cfg = dataclasses.replace(j_reduced("yi-6b"), use_pallas=True)
    eng = JEngine(cfg, JTrain(num_steps=STEPS), JSPB(mode="temporal", k=4))
    eng.init_state(jax.random.key(0))
    params = jax.tree.map(np.asarray, eng.state["params"])
    pipe = JPipeline(cfg, 2, 64, seed=0)
    history = []
    for s in range(STEPS):
        m = eng.train_step(pipe.get_batch(s), s)
        history.append((eng.last_depth, {k: float(v) for k, v in m.items()}))
    return params, history


def test_spb_engine_tracks_jax_step_by_step(jax_run):
    params, want = jax_run
    cfg = dataclasses.replace(t_reduced("yi-6b"), use_pallas=True)
    tcfg = TrainConfig(num_steps=STEPS)
    eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal", k=4), device="cpu")
    eng.attach_state(steps_lib.state_from_params(
        bridge.params_from_numpy(params, cfg), tcfg))
    pipe = Pipeline(cfg, 2, 64, seed=0)
    depths = []
    for s, (jdepth, jm) in enumerate(want):
        m = eng.train_step(pipe.get_batch(s), s)
        depths.append(eng.last_depth)
        assert eng.last_depth == jdepth
        assert set(m) == set(jm)
        for key in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), jm[key], rtol=1e-4,
                                       err_msg=f"step {s} {key}")
    assert depths == [4, 1, 3, 2]
    assert eng.step_count == STEPS


def test_pipeline_batches_equal_jax(jax_run):
    jcfg, tcfg = j_reduced("yi-6b"), t_reduced("yi-6b")
    for s in range(2):
        want = JPipeline(jcfg, 2, 16, seed=3).get_batch(s)
        got = Pipeline(tcfg, 2, 16, seed=3).get_batch(s)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_train_driver_runs_on_cpu(capsys):
    history = train_mod.train(
        ["--steps", "2", "--batch", "2", "--seq", "64", "--spb-mode",
         "temporal", "--use-pallas", "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(history) == 2 and all(np.isfinite(history))
    assert "[train] step=    0 depth=   4 loss=" in out
    assert "[train] step=    1 depth=   1 loss=" in out


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.train(["--steps", "1", "--batch", "2", "--seq", "64"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SPBEngine(t_reduced("yi-6b"), TrainConfig())


@pytest.fixture(scope="module")
def jax_mamba2_run():
    cfg = dataclasses.replace(j_reduced("mamba2-2.7b"), use_pallas=True)
    eng = JEngine(cfg, JTrain(num_steps=STEPS), JSPB(mode="temporal", k=4))
    eng.init_state(jax.random.key(0))
    params = jax.tree.map(np.asarray, eng.state["params"])
    pipe = JPipeline(cfg, 2, 64, seed=0)
    history = []
    for s in range(STEPS):
        m = eng.train_step(pipe.get_batch(s), s)
        history.append((eng.last_depth, {k: float(v) for k, v in m.items()}))
    return params, history


def test_mamba2_spb_engine_tracks_jax_step_by_step(jax_mamba2_run):
    """mamba2-reduced (f32, SSD kernels on: their plain versions here),
    temporal SPB k=4, batch 2 x 64: the same metrics as the JAX engine at
    every step, at the yi-6b run's rtol of 1e-4."""
    params, want = jax_mamba2_run
    cfg = dataclasses.replace(t_reduced("mamba2-2.7b"), use_pallas=True)
    tcfg = TrainConfig(num_steps=STEPS)
    eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal", k=4), device="cpu")
    eng.attach_state(steps_lib.state_from_params(
        bridge.params_from_numpy(params, cfg), tcfg))
    pipe = Pipeline(cfg, 2, 64, seed=0)
    depths = []
    for s, (jdepth, jm) in enumerate(want):
        m = eng.train_step(pipe.get_batch(s), s)
        depths.append(eng.last_depth)
        assert eng.last_depth == jdepth
        for key in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), jm[key], rtol=1e-4,
                                       err_msg=f"step {s} {key}")
    assert depths == [4, 1, 3, 2]


def test_mamba2_train_entry_point_runs_on_cpu(capsys):
    history = train_mod.train(
        ["--arch", "mamba2-2.7b", "--reduced", "--steps", "2", "--batch", "2",
         "--seq", "40", "--spb-mode", "temporal", "--use-pallas", "--device",
         "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(history) == 2 and all(np.isfinite(history))
    assert "[train] step=    1 depth=   1 loss=" in out


@pytest.fixture(scope="module")
def jax_recurrentgemma_run():
    cfg = dataclasses.replace(j_reduced("recurrentgemma-2b"), use_pallas=True)
    eng = JEngine(cfg, JTrain(num_steps=STEPS), JSPB(mode="temporal", k=4))
    eng.init_state(jax.random.key(0))
    params = jax.tree.map(np.asarray, eng.state["params"])
    pipe = JPipeline(cfg, 2, 64, seed=0)
    history = []
    for s in range(STEPS):
        m = eng.train_step(pipe.get_batch(s), s)
        history.append((eng.last_depth, {k: float(v) for k, v in m.items()}))
    return params, history


def test_recurrentgemma_spb_engine_tracks_jax_step_by_step(
        jax_recurrentgemma_run):
    """recurrentgemma-reduced (f32, kernels on), temporal SPB k=4 snapped
    to whole (rglru, rglru, local) units, batch 2 x 64: the JAX engine's
    metrics at every step, at rtol 1e-4."""
    params, want = jax_recurrentgemma_run
    cfg = dataclasses.replace(t_reduced("recurrentgemma-2b"), use_pallas=True)
    tcfg = TrainConfig(num_steps=STEPS)
    eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal", k=4), device="cpu")
    eng.attach_state(steps_lib.state_from_params(
        bridge.params_from_numpy(params, cfg), tcfg))
    pipe = Pipeline(cfg, 2, 64, seed=0)
    depths = []
    for s, (jdepth, jm) in enumerate(want):
        m = eng.train_step(pipe.get_batch(s), s)
        depths.append(eng.last_depth)
        assert eng.last_depth == jdepth
        for key in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), jm[key], rtol=1e-4,
                                       err_msg=f"step {s} {key}")
    assert depths == [6, 3, 6, 3]


def test_recurrentgemma_train_entry_point_runs_on_cpu(capsys):
    history = train_mod.train(
        ["--arch", "recurrentgemma-2b", "--reduced", "--steps", "2",
         "--batch", "2", "--seq", "40", "--spb-mode", "temporal",
         "--use-pallas", "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(history) == 2 and all(np.isfinite(history))
    assert "[train] step=    1 depth=   3 loss=" in out


@pytest.fixture(scope="module")
def jax_qwen3_run():
    cfg = dataclasses.replace(j_reduced("qwen3-moe-235b-a22b"),
                              use_pallas=True)
    eng = JEngine(cfg, JTrain(num_steps=STEPS), JSPB(mode="temporal", k=4))
    eng.init_state(jax.random.key(0))
    params = jax.tree.map(np.asarray, eng.state["params"])
    pipe = JPipeline(cfg, 2, 64, seed=0)
    history = []
    for s in range(STEPS):
        m = eng.train_step(pipe.get_batch(s), s)
        history.append((eng.last_depth, {k: float(v) for k, v in m.items()}))
    return params, history


def test_qwen3_moe_spb_engine_tracks_jax_step_by_step(jax_qwen3_run):
    """qwen3-moe-reduced (f32, every FFN an MoE layer with an f32 router),
    temporal SPB k=4, batch 2 x 64: the same metrics as the JAX engine at
    every step, the MoE aux among them, at the yi-6b run's rtol of 1e-4."""
    params, want = jax_qwen3_run
    cfg = dataclasses.replace(t_reduced("qwen3-moe-235b-a22b"),
                              use_pallas=True)
    tcfg = TrainConfig(num_steps=STEPS)
    eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal", k=4), device="cpu")
    eng.attach_state(steps_lib.state_from_params(
        bridge.params_from_numpy(params, cfg), tcfg))
    pipe = Pipeline(cfg, 2, 64, seed=0)
    for s, (jdepth, jm) in enumerate(want):
        m = eng.train_step(pipe.get_batch(s), s)
        assert eng.last_depth == jdepth
        for key in ("loss", "xent", "moe_aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), jm[key], rtol=1e-4,
                                       err_msg=f"step {s} {key}")
        assert jm["moe_aux"] > 0


def test_qwen3_moe_train_entry_point_runs_on_cpu(capsys):
    """qwen3-moe-reduced through the driver: every FFN an MoE layer, the
    depth cycle 4, 1, 3, 2, and the aux loss in every step's loss."""
    history = train_mod.train(
        ["--arch", "qwen3-moe-235b-a22b", "--reduced", "--steps", "4",
         "--batch", "2", "--seq", "32", "--spb-mode", "temporal",
         "--use-pallas", "--device", "cpu", "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(history) == 4 and all(np.isfinite(history))
    lines = [ln for ln in out.splitlines() if ln.startswith("[train] step=")]
    assert [int(ln.split("depth=")[1].split()[0]) for ln in lines] == \
        [4, 1, 3, 2]
    for ln in lines:      # loss = xent + 0.01 * aux, the aux of all 4 layers
        loss = float(ln.split("loss=")[1].split()[0])
        xent = float(ln.split("xent=")[1].split()[0])
        assert loss - xent > 0.02


@pytest.mark.parametrize("compression", ["topk", "randk", "lowrank"])
def test_gradient_compression_builds_and_trains(compression, monkeypatch):
    """A config that asks for a compressor builds its steps (by
    make_train_step, and so by the engine's step table) and trains on
    compressed gradients: what the optimizer receives is, leaf by leaf,
    the reference's topk of the raw gradient bit for bit; for randk, at
    most k = int(0.1 * size) entries, each the raw entry times 1 / 0.1
    (exactly k where the raw gradient has no zero); for lowrank, a matrix
    of rank at most int(0.1 * 32) = 3, with vectors passed unchanged."""
    cfg = t_reduced("yi-6b")
    tcfg = TrainConfig(num_steps=2, compression=compression)
    steps_lib.make_train_step(cfg, tcfg, depth=2)
    seen = []
    real = compress.compress_tree

    def spy(grads, method, ratio, gen):
        out = real(grads, method, ratio, gen)
        seen.append((tree_leaves(grads), tree_leaves(out)))
        return out

    monkeypatch.setattr(steps_lib.compress, "compress_tree", spy)
    eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal", k=4), device="cpu")
    eng.init_state(0)
    pipe = Pipeline(cfg, 2, 32, seed=0)
    losses = [float(eng.train_step(pipe.get_batch(s), s)["loss"])
              for s in range(2)]
    assert np.isfinite(losses).all() and len(seen) == 2
    for raw, out in seen:
        for g, c in zip(raw, out):
            if g is None:
                assert c is None
                continue
            g, c = g.detach(), c.detach()
            assert c.shape == g.shape and c.dtype == g.dtype
            if compression == "topk":
                want = j_compress.topk_apply(g.numpy(), 0.1)
                np.testing.assert_array_equal(c.numpy(), np.asarray(want))
            elif compression == "randk":
                k, kept = max(1, int(g.numel() * 0.1)), c != 0
                assert int(kept.sum()) <= k
                assert torch.equal(c[kept], g[kept] * (1.0 / 0.1))
                if bool((g != 0).all()):
                    assert int(kept.sum()) == k
            elif g.dim() < 2:
                assert torch.equal(c, g)
            else:
                m = c.reshape(c.shape[0], -1)
                assert int(torch.linalg.matrix_rank(m)) <= 3


def test_spatial_builds_one_step_for_the_ranks_depth():
    """spatial SPB's table is one step, whose depth is the rank's level:
    on a group of one (no process group) the engine trains with it, its
    metrics the reference's (a zero ``moe_aux``), and ``launch/train.py`` runs
    it."""
    cfg = t_reduced("yi-6b")
    built = steps_lib.build_spb_train_steps(cfg, TrainConfig(),
                                            SPBConfig(mode="spatial"))
    assert list(built) == [None]
    eng = SPBEngine(cfg, TrainConfig(num_steps=2),
                    SPBConfig(mode="spatial", k=2), device="cpu")
    assert eng.depth_keys() == [None] and eng.group.size == 1
    eng.init_state(0)
    m = eng.train_step(Pipeline(cfg, 2, 32, seed=0).get_batch(0), 0)
    assert eng.last_depth is None and float(m["moe_aux"]) == 0.0
    assert np.isfinite(float(m["loss"]))
    history = train_mod.train(["--steps", "1", "--batch", "2", "--seq",
                               "32", "--spb-mode", "spatial", "--device",
                               "cpu"])
    assert len(history) == 1 and np.isfinite(history).all()


def test_without_compression_the_engine_still_trains():
    cfg = t_reduced("yi-6b")
    tcfg = TrainConfig(num_steps=2, compression="none")
    eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal", k=4), device="cpu")
    eng.init_state(0)
    pipe = Pipeline(cfg, 2, 32, seed=0)
    losses = [float(eng.train_step(pipe.get_batch(s), s)["loss"])
              for s in range(2)]
    assert np.isfinite(losses).all() and eng.step_count == 2
