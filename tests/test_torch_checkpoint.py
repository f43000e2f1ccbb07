"""The port's checkpoint manager and the driver's restart loop: the mirrors
of ``tests/test_checkpoint.py`` (round trip, async keep-N, a given step,
shape mismatch, manifest, write failures re-raised), a bf16 round trip
that keeps every bit, checkpoints carried across packages both ways, the
driver's resume against straight training and against the reference's
driver, and a kernel fault that the driver does not retry."""
import dataclasses
import json
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.config import SPBConfig as JSPB, TrainConfig as JTrain
from repro.configs import reduced_config as j_reduced
from repro.data.pipeline import Pipeline as JPipeline
from repro.dist import steps as j_steps
from repro.engine import SPBEngine as JEngine
from repro.launch import train as j_train
from repro_torch import bridge
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.checkpoint.manager import CheckpointError, CheckpointManager
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist import steps as steps_lib
from repro_torch.engine.engine import SPBEngine
from repro_torch.kernels import _build
from repro_torch.launch import train as train_mod
from repro_torch.tree import tree_leaves

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)


def _state(arch="yi-6b", dtype=None, seed=0):
    cfg = reduced_config(arch)
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return steps_lib.init_train_state(torch.Generator().manual_seed(seed),
                                      cfg, TrainConfig(), "cpu")


@pytest.fixture()
def state():
    return _state()


def _trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x.detach(), y)
        else:
            assert x == y


def test_roundtrip(tmp_path, state):
    mgr = CheckpointManager(tmp_path, keep=3, async_write=False)
    state["step"] = 10
    mgr.save(state, 10)
    restored, step = mgr.restore(state)
    assert step == 10 and restored["step"] == 10
    _trees_equal(state, restored)


def test_async_and_keep_n(tmp_path, state):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=True)
    for s in (1, 2, 3, 4):
        mgr.save(state, s)
    mgr.wait()
    assert mgr.steps() == [3, 4]
    assert not list(Path(tmp_path).glob(".tmp_*"))      # no tmp litter


def test_save_copies_before_the_caller_goes_on(tmp_path, state):
    """The snapshot is the state as ``save`` saw it, though the caller
    updates the tensors in place while the writer thread runs."""
    mgr = CheckpointManager(tmp_path, async_write=True)
    want = [t.detach().clone() for t in tree_leaves(state["params"])]
    mgr.save(state, 1)
    with torch.no_grad():
        for t in tree_leaves(state["params"]):
            t.add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore(state)
    for w, r in zip(want, tree_leaves(restored["params"])):
        assert torch.equal(w, r)


def test_restore_specific_step(tmp_path, state):
    mgr = CheckpointManager(tmp_path, keep=5, async_write=False)
    mgr.save(state, 1)
    mgr.save(dict(state, step=42), 42)
    r1, s1 = mgr.restore(state, step=1)
    r2, s2 = mgr.restore(state)
    assert (s1, s2) == (1, 42) and (r1["step"], r2["step"]) == (0, 42)


def test_shape_mismatch_raises(tmp_path, state):
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(state, 1)
    with pytest.raises((ValueError, KeyError)):
        mgr.restore(_state("mamba2-2.7b"))
    wider = _state()
    wider["params"]["final_norm"] = torch.zeros(65)
    with pytest.raises(ValueError, match="final_norm"):
        mgr.restore(wider)
    extra = dict(state, more=torch.zeros(2))
    with pytest.raises(KeyError, match="more"):
        mgr.restore(extra)


def test_manifest_contents(tmp_path, state):
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(state, 7)
    man = json.loads((Path(tmp_path) / "step_7" / "manifest.json").read_text())
    assert man["step"] == 7 and man["num_arrays"] > 10 and man["bytes"] > 0


def _boom(*_a, **_k):
    raise OSError("disk full")


def test_async_write_failure_raises_on_wait(tmp_path, state, monkeypatch):
    """A failure on the writer thread is re-raised once by wait(); the
    failed snapshot is never published, and the manager stays usable."""
    mgr = CheckpointManager(tmp_path, async_write=True)
    mgr.save(state, 1)
    mgr.wait()
    monkeypatch.setattr(manager_mod.np, "savez", _boom)
    mgr.save(state, 2)
    with pytest.raises(CheckpointError, match="disk full"):
        mgr.wait()
    mgr.wait()                          # raised once, then cleared
    monkeypatch.undo()
    mgr.save(state, 3)
    mgr.wait()
    assert mgr.steps() == [1, 3]        # step 2 never became durable


def test_async_write_failure_raises_on_next_save(tmp_path, state,
                                                 monkeypatch):
    mgr = CheckpointManager(tmp_path, async_write=True)
    monkeypatch.setattr(manager_mod.np, "savez", _boom)
    mgr.save(state, 1)
    mgr._thread.join()                  # let it fail before un-patching
    monkeypatch.undo()
    with pytest.raises(CheckpointError, match="disk full"):
        mgr.save(state, 2)
    mgr.save(state, 3)                  # error consumed; manager usable
    mgr.wait()
    assert mgr.steps() == [3]


def test_bf16_state_roundtrip_keeps_every_bit(tmp_path):
    """bf16 params (and their f32 master copies) come back bit for bit and
    as bf16; on disk a bf16 leaf is raw 2-byte words, as the reference
    writes an ml_dtypes bfloat16 array."""
    state = _state(dtype="bfloat16")
    leaves = tree_leaves(state["params"])
    assert any(t.dtype == torch.bfloat16 for t in leaves)
    with torch.no_grad():
        leaves[0].view(-1)[:4] = torch.tensor(
            [float("nan"), float("-inf"), -0.0, 1e-40], dtype=torch.bfloat16)
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(state, 3)
    restored, _ = mgr.restore(state)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype
            bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
            assert torch.equal(a.detach().view(bits), b.view(bits))
    with np.load(tmp_path / "step_3" / "arrays.npz") as z:
        assert z["params/embed/tok"].dtype == np.dtype("V2")
        assert z["opt/master/embed/tok"].dtype == np.float32


# -- across packages ------------------------------------------------------

def _jax_engine():
    cfg = j_reduced("yi-6b")
    eng = JEngine(cfg, JTrain(num_steps=6), JSPB(mode="temporal", k=4))
    eng.init_state(jax.random.key(0))
    return eng


def test_a_reference_checkpoint_restores_into_the_port(tmp_path):
    """The reference's manager writes a yi-6b-reduced f32 engine after 4
    temporal steps; the port restores it, and its next 2 steps match the
    reference's next 2 at 1e-5 relative."""
    jeng = _jax_engine()
    jpipe = JPipeline(jeng.cfg, 2, 64, seed=0)
    for s in range(4):
        jeng.train_step(jpipe.get_batch(s), s)
    jmgr = JManager(tmp_path, async_write=False)
    jmgr.save(jax.device_get(jeng.state), 4)
    want = [{k: float(v) for k, v in jeng.train_step(
        jpipe.get_batch(s), s).items()} for s in (4, 5)]

    cfg = reduced_config("yi-6b")
    eng = SPBEngine(cfg, TrainConfig(num_steps=6),
                    SPBConfig(mode="temporal", k=4), device="cpu")
    eng.init_state(1)                   # thrown away by the restore
    state, step = CheckpointManager(tmp_path).restore(eng.state)
    assert step == 4 and state["step"] == 4
    eng.attach_state(state)
    pipe = Pipeline(cfg, 2, 64, seed=0)
    for s, jm in zip((4, 5), want):
        m = eng.train_step(pipe.get_batch(s), s)
        assert eng.last_depth == jeng.policy.depth_for_step(s)
        for key in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), jm[key], rtol=1e-5,
                                       err_msg=f"step {s} {key}")


def test_a_port_checkpoint_restores_into_the_reference(tmp_path):
    """The port writes its state; the reference's manager restores it into
    the reference's state: the same keys and the same arrays."""
    state = _state()
    state["step"] = 9
    CheckpointManager(tmp_path, async_write=False).save(state, 9)
    jlike = j_steps.init_train_state(jax.random.key(0), j_reduced("yi-6b"),
                                     JTrain())
    restored, step = JManager(tmp_path).restore(jlike)
    assert step == 9 and int(restored["step"]) == 9
    assert jax.tree.structure(restored) == jax.tree.structure(jlike)
    ours = manager_mod._flatten(state)
    theirs = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path): leaf
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  restored)[0]}
    with np.load(tmp_path / "step_9" / "arrays.npz") as z:
        assert set(z.files) == set(theirs) == set(ours)
    for key, leaf in theirs.items():
        want = ours[key]
        want = want.detach().numpy() if isinstance(want, torch.Tensor) \
            else np.int32(want)
        assert np.asarray(leaf).dtype == want.dtype, key
        np.testing.assert_array_equal(np.asarray(leaf), want, err_msg=key)


# -- the driver -----------------------------------------------------------

DRIVER = ["--arch", "yi-6b", "--steps", "8", "--batch", "2", "--seq", "32",
          "--checkpoint-every", "4", "--log-every", "100"]


def _reference_weights(monkeypatch):
    """Make the port's engines start from the reference's initial weights
    for the same seed (the bridge: the two packages' initializers draw
    different numbers)."""
    def init_state(self, seed):
        params = j_steps.init_train_state(jax.random.key(seed),
                                          j_reduced(DRIVER[1]),
                                          JTrain())["params"]
        return self.attach_state(steps_lib.state_from_params(
            bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                     self.cfg), self.tcfg))

    monkeypatch.setattr(SPBEngine, "init_state", init_state)


def test_driver_resume_matches_straight_training_and_the_reference(
        tmp_path, capsys, monkeypatch):
    """8 steps straight against a failure injected at step 5 (restored
    from the step-4 checkpoint): the same last xent; and from the
    reference's initial weights, the reference's driver's xent at every
    step, to 1e-5."""
    _reference_weights(monkeypatch)
    straight = train_mod.train(DRIVER + ["--device", "cpu",
                                         "--checkpoint-dir",
                                         str(tmp_path / "a")])
    failed = train_mod.train(DRIVER + ["--device", "cpu", "--checkpoint-dir",
                                       str(tmp_path / "b"), "--fail-at", "5"])
    out = capsys.readouterr().out
    assert out.count("[train] FAILURE") == 1
    assert "[train] FAILURE: injected failure; restart 1" in out
    assert "[train] resumed from step 4" in out
    assert len(straight) == 8 and len(failed) == 5 + 4
    np.testing.assert_allclose(straight[-1], failed[-1], rtol=1e-5)
    want = j_train.train(DRIVER + ["--checkpoint-dir", str(tmp_path / "j")])
    np.testing.assert_allclose(straight, want, rtol=1e-5)
    np.testing.assert_allclose(failed[-1], want[-1], rtol=1e-5)


def test_driver_resume_waits_for_the_write_in_flight(tmp_path, capsys,
                                                     monkeypatch):
    """A failure right after a checkpoint is taken: the restore waits for
    that async write (slowed here) and resumes from it, not from step 0."""
    savez = np.savez

    def slow_savez(*args, **kwargs):
        time.sleep(0.5)
        savez(*args, **kwargs)

    monkeypatch.setattr(manager_mod.np, "savez", slow_savez)
    failed = train_mod.train(DRIVER + ["--device", "cpu", "--checkpoint-dir",
                                       str(tmp_path), "--fail-at", "5"])
    assert "[train] resumed from step 4" in capsys.readouterr().out
    assert len(failed) == 5 + 4


def test_driver_without_a_checkpoint_dir_raises_at_once(capsys):
    with pytest.raises(RuntimeError, match="injected failure"):
        train_mod.train(DRIVER + ["--device", "cpu", "--fail-at", "1"])
    assert "FAILURE" not in capsys.readouterr().out


@pytest.mark.parametrize("fault", [
    _build.KernelError("flash_dq: CUDA error 700 (an illegal memory "
                       "access was encountered)"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
], ids=["kernel", "cuda", "oom"])
def test_driver_does_not_retry_a_kernel_fault(tmp_path, capsys, monkeypatch,
                                              fault):
    """A kernel or CUDA fault in a step is raised at once, with no restart
    and no FAILURE line, though a checkpoint to restore exists."""
    real = SPBEngine.train_step

    def step(self, batch, step=None, **kw):
        if step == 5:
            raise fault
        return real(self, batch, step, **kw)

    monkeypatch.setattr(SPBEngine, "train_step", step)
    with pytest.raises(type(fault)) as info:
        train_mod.train(DRIVER + ["--device", "cpu", "--checkpoint-dir",
                                  str(tmp_path)])
    assert info.value is fault
    assert "FAILURE" not in capsys.readouterr().out
    assert CheckpointManager(tmp_path).latest_step() == 4


def test_the_loaders_error_path_raises_kernel_error(monkeypatch):
    """``_build.check`` turns a non-zero CUDA code into a KernelError (a
    RuntimeError) with the library's own message; no card is needed to
    format it."""
    class Lib:
        def kernel_error_string(self, code):
            return f"error {code} from the fake library".encode()

    monkeypatch.setitem(_build._LIBS, "fake", Lib())
    _build.check("fake", 0)
    with pytest.raises(_build.KernelError,
                       match="fake: CUDA error 700 .error 700 from the fake"):
        _build.check("fake", 700)
    assert issubclass(_build.KernelError, RuntimeError)
