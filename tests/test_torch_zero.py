"""ZeRO-1 over a data group on the CPU (``SPBEngine(zero1=True)``,
``optim/optimizers.apply_updates(shards=)``, ``DataGroup.all_gather`` /
``gather``, ``dist/sharding.py``) and checkpoints and restart under a group
(``launch/train.py --data-parallel N --checkpoint-dir ... --fail-at``).

Ranks are spawned processes over gloo (``launch/mesh.spawn``, a join
timeout on every spawn); their targets are this module's ``_rank`` and
``_restore``, so the module imports the reference (JAX) only inside the
tests that call it.  Every run starts from the port's seeded weights and
batches (yi-6b-reduced, the kernels' plain versions); the reference gets
the same weights and batches as numpy arrays, in a subprocess started when
the module starts, while the ranks run.

* In every SPB mode (``off``, ``temporal``, ``temporal-mb``, ``spatial``
  with and without the re-reduce) over 2 ranks, ZeRO-1's parameters and
  gathered optimizer state are bit-identical to the replicated group's,
  and every rank's parameters to rank 0's; a bf16 run does the same with
  the f32 masters.
* ZeRO-1's temporal steps over 2 ranks equal the reference's
  ``SPBEngine`` on 2 virtual devices (its default ``zero1``) within 1e-5:
  parameters and both moments.
* A rank's optimizer leaves have the shapes its ``state_specs`` imply, and
  its state's bytes are ``sharded_state_bytes``; ``CostMode`` counts one
  all-gather a sharded leaf, the parameters' bytes as payload.
* The driver under 2 ranks with checkpoints and ``--fail-at`` reproduces
  the uninterrupted run's xent bit for bit; its checkpoint holds the whole
  state and restores into one process and into a group of 4.
* The dry run counts one rank of a group (``count_cell(data_parallel=)``):
  its state bytes both ways, its all-gathers, its predicted peak.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import cost
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist import sharding
from repro_torch.dist.group import DataGroup
from repro_torch.engine.engine import SPBEngine
from repro_torch.launch import mesh, train
from repro_torch.tree import tree_leaves, tree_map

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
B, S, STEPS = 4, 32, 2
JOIN_S = 150.0
# name: (mode, k, subgroup_reduce, dtype)
RUNS = {"off": ("off", 4, False, "float32"),
        "temporal": ("temporal", 4, False, "float32"),
        "temporal-mb": ("temporal-mb", 2, False, "float32"),
        "spatial": ("spatial", 2, False, "float32"),
        "spatial-sub": ("spatial", 2, True, "float32"),
        "temporal-bf16": ("temporal", 4, False, "bfloat16")}
TRAIN = ["--steps", "4", "--batch", str(B), "--seq", str(S), "--device",
         "cpu", "--use-pallas", "--log-every", "100", "--spb-mode",
         "temporal", "--spb-k", "4", "--data-parallel", "2",
         "--checkpoint-every", "2"]


def _cfg(dtype="float32"):
    return dataclasses.replace(reduced_config("yi-6b"), use_pallas=True,
                               dtype=dtype)


def _numpy(tree):
    return tree_map(lambda t: t.detach().float().numpy(), tree)


def _rank(group):
    """One rank: every run of :data:`RUNS` with ZeRO-1 off, then on, from
    the seeded weights on this rank's rows of each seeded global batch,
    each step under ``CostMode``.  Returns, a run: the rank's parameters,
    its optimizer leaves' shapes and bytes, each step's counted
    collectives, and on rank 0 the gathered state (None elsewhere)."""
    out = {}
    for name, (mode, k, sub, dtype) in RUNS.items():
        cfg = _cfg(dtype)
        for zero1 in (False, True):
            eng = SPBEngine(cfg, TrainConfig(num_steps=STEPS),
                            SPBConfig(mode=mode, k=k, subgroup_reduce=sub),
                            group=group, zero1=zero1)
            eng.init_state(0)
            pipe = Pipeline(cfg, B, S, seed=0)
            chunks = k if mode == "temporal-mb" else 1
            colls, xent = [], []
            for s in range(STEPS):
                with cost.CostMode() as counted:
                    m = eng.train_step(group.shard(pipe.get_batch(s), chunks),
                                       s)
                colls.append(counted.summary.collectives())
                xent.append(float(m["xent"]))
            whole = eng.gathered_state()
            out[name, zero1] = {
                "params": _numpy(eng.state["params"]), "xent": xent,
                "opt_shapes": tree_map(lambda t: tuple(t.shape),
                                       eng.state["opt"]),
                "opt_bytes": sum(t.numel() * t.element_size()
                                 for t in tree_leaves(eng.state["opt"])),
                "collectives": colls,
                "whole": None if whole is None else {
                    "params": _numpy(whole["params"]),
                    "opt": _numpy(whole["opt"])}}
    return out


def _restore(group, directory):
    """One rank of a group restoring a checkpoint: every rank reads the
    whole state and keeps its slice; returns rank 0's gathered state and
    each rank's optimizer shapes."""
    eng = SPBEngine(_cfg(), TrainConfig(num_steps=4),
                    SPBConfig(mode="temporal", k=4), group=group)
    state, _ = CheckpointManager(directory).restore(eng.state_shapes)
    eng.attach_state(state)
    whole = eng.gathered_state()
    return {"opt_shapes": tree_map(lambda t: tuple(t.shape),
                                   eng.state["opt"]),
            "whole": None if whole is None else {
                "params": _numpy(whole["params"]),
                "opt": _numpy(whole["opt"]), "step": whole["step"]}}


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax, jax.numpy as jnp, numpy as np
    from repro.config import SPBConfig, TrainConfig
    from repro.configs import reduced_config
    from repro.dist import steps as jsteps
    from repro.engine import SPBEngine

    inp = np.load(sys.argv[1])
    cfg = reduced_config("yi-6b")

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(2, 1),
                             ("data", "model"))
    tcfg = TrainConfig(num_steps=%(steps)d)
    eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal", k=4), mesh=mesh)
    assert eng.zero1
    state = jsteps.init_train_state(jax.random.key(0), cfg, tcfg)
    state["params"] = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(inp["params/" + key(p)]), state["params"])
    eng.attach_state(state)
    for s in range(%(steps)d):
        eng.train_step({"tokens": inp["tokens%%d" %% s],
                        "labels": inp["labels%%d" %% s]}, s)
    out = {}
    for tree in ("params", "opt"):
        for p, v in jax.tree_util.tree_leaves_with_path(eng.state[tree]):
            out[tree + "/" + key(p)] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}" if prefix
                                    else k).items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _init_and_batches():
    eng = SPBEngine(_cfg(), TrainConfig(num_steps=STEPS), SPBConfig(),
                    device="cpu")
    eng.init_state(0)
    pipe = Pipeline(_cfg(), B, S, seed=0)
    return (_flat(_numpy(eng.state["params"])),
            [{k: v.numpy() for k, v in pipe.get_batch(s).items()}
             for s in range(STEPS)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts, when the module starts: the reference's subprocess, the
    spawned runs of :func:`_rank`, and the driver's runs with and without
    ``--fail-at`` (then the restore into 4 ranks); a dict of futures."""
    tmp = tmp_path_factory.mktemp("zero")
    params, batches = _init_and_batches()
    arrays = {"params/" + k: v for k, v in params.items()}
    for s, b in enumerate(batches):
        arrays.update({f"{k}{s}": v for k, v in b.items()})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE % {"steps": STEPS},
         str(tmp / "in.npz"), str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def reference():
        _, err = ref.communicate(timeout=300)
        assert ref.returncode == 0, err[-3000:]
        return dict(np.load(tmp / "ref.npz"))

    def failed():
        history = train.train(TRAIN + ["--checkpoint-dir",
                                        str(tmp / "failed"), "--fail-at",
                                        "3"])
        return history, mesh.spawn(f"{__name__}:_restore", 4,
                                   str(tmp / "failed"), device="cpu",
                                   threads=1, timeout_s=JOIN_S)

    with ThreadPoolExecutor(4) as pool:
        yield {"ranks": pool.submit(mesh.spawn, f"{__name__}:_rank", 2,
                                    device="cpu", threads=1,
                                    timeout_s=JOIN_S),
               "straight": pool.submit(train.train, TRAIN + [
                   "--checkpoint-dir", str(tmp / "straight")]),
               "failed": pool.submit(failed),
               "reference": pool.submit(reference),
               "dir": tmp / "failed"}
    if ref.poll() is None:
        ref.kill()
        ref.communicate()


@pytest.mark.parametrize("name", RUNS)
def test_zero1_is_bit_identical_to_the_replicated_group(name, runs):
    """The run's parameters and gathered optimizer state under ZeRO-1
    equal the replicated group's bit for bit, and each rank's parameters
    rank 0's; the two runs' losses are the same numbers."""
    ranks = runs["ranks"].result()
    zero, repl = ranks[0][name, True], ranks[0][name, False]
    assert zero["xent"] == repl["xent"]
    want, got = _flat(repl["whole"]), _flat(zero["whole"])
    assert set(got) == set(want)
    if RUNS[name][3] == "bfloat16":
        assert any(k.startswith("opt/master") for k in got)
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
    for r, out in enumerate(ranks[1:], 1):
        for z in (False, True):
            other = _flat(out[name, z]["params"])
            for k, v in _flat(ranks[0][name, z]["params"]).items():
                assert np.array_equal(other[k], v), (r, z, k)
        assert out[name, True]["whole"] is None


def test_zero1_equals_the_reference(runs):
    """ZeRO-1's temporal steps over 2 ranks against the reference's
    ``SPBEngine`` on 2 virtual devices (ZeRO-1, its default): parameters
    and both AdamW moments within 1e-5."""
    want = runs["reference"].result()
    got = _flat(runs["ranks"].result()[0]["temporal", True]["whole"])
    assert set(got) == set(want)
    assert {k.split("/")[1] for k in want if k.startswith("opt/")} == \
        {"mu", "nu"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_a_ranks_state_is_its_specs_slice(runs):
    """Each rank's optimizer leaves have the shapes ``state_specs``
    implies over the (2, 1) mesh, and the rank's state (parameters,
    optimizer, step) takes ``sharded_state_bytes``; the replicated run's
    takes the whole state's."""
    cfg = _cfg()
    eng = SPBEngine(cfg, TrainConfig(), SPBConfig(), group=DataGroup(size=2))
    shapes, m = eng.state_shapes, sharding.mesh_for(DataGroup(size=2))
    is_p = lambda x: isinstance(x, sharding.P)      # noqa: E731

    def implied(spec, leaf):
        return tuple(d // 2 if i < len(spec) and spec[i] == "data" else d
                     for i, d in enumerate(leaf.shape))

    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(shapes["params"]))
    for zero1 in (True, False):
        specs = sharding.state_pspec(shapes, m, zero1=zero1)
        want = {k: tree_map(implied, specs["opt"][k], shapes["opt"][k],
                            is_leaf=is_p) for k in shapes["opt"]}
        total = sharding.sharded_state_bytes(shapes, specs, m)
        for out in runs["ranks"].result():
            run = out["temporal", zero1]
            assert run["opt_shapes"] == want
            assert param_bytes + run["opt_bytes"] + 4 == total


def test_cost_mode_counts_the_all_gathers(runs):
    """Every ZeRO-1 step counts one all-gather a sharded leaf (all 11 of
    yi-6b-reduced's at n 2), the parameters' bytes as payload and half of
    it on the wire (the ring model); a replicated step counts none."""
    init, _ = _init_and_batches()
    params = sum(v.nbytes for v in init.values())
    for out in runs["ranks"].result():
        for name in ("off", "temporal", "spatial"):
            for c in out[name, True]["collectives"]:
                assert c["all-gather"] == {"count": 11.0,
                                           "payload_bytes": params,
                                           "wire_bytes": params / 2}
            for c in out[name, False]["collectives"]:
                assert "all-gather" not in c


def test_restart_under_a_group_reproduces_the_straight_run(runs):
    """``--data-parallel 2 --checkpoint-every 2 --fail-at 3``: one failure,
    a restore from step 2, and the uninterrupted run's xent bit for bit
    (the failed attempt's steps 0-2 and the resumed 2-3)."""
    straight = runs["straight"].result()
    failed, _ = runs["failed"].result()
    assert len(straight) == 4 and len(failed) == 3 + 2
    assert failed[:3] == straight[:3]
    assert failed[3:] == straight[2:]


def test_a_groups_checkpoint_restores_into_one_process_and_four(runs):
    """The group's last checkpoint (step 4) holds the whole state; it
    restores into one process, where the state is the file's, and into 4
    ranks, which each keep their slice and gather back to the file."""
    _, four = runs["failed"].result()
    mgr = CheckpointManager(runs["dir"])
    assert mgr.latest_step() == 4
    one = SPBEngine(_cfg(), TrainConfig(), SPBConfig(mode="temporal", k=4),
                    device="cpu")
    state, step = mgr.restore(one.state_shapes)
    one.attach_state(state)
    want = _flat({"params": _numpy(state["params"]),
                  "opt": _numpy(state["opt"])})
    got = _flat({"params": _numpy(one.state["params"]),
                 "opt": _numpy(one.state["opt"])})
    assert step == 4 and one.state["step"] == 4
    for k, v in want.items():
        assert np.array_equal(got[k], v), k
        assert v.shape == got[k].shape
    assert four[0]["whole"]["step"] == 4
    back = _flat({k: four[0]["whole"][k] for k in ("params", "opt")})
    assert set(back) == set(want)
    for k, v in want.items():
        assert np.array_equal(back[k], v), k
    wq = [r["opt_shapes"]["mu"]["groups"][0][0]["mixer"]["wq"] for r in four]
    assert wq == [(4, 16, 64)] * 4      # d_model 64 over 4 ranks
    assert torch.equal(torch.as_tensor(state["opt"]["mu"]["embed"]["tok"]),
                       one.state["opt"]["mu"]["embed"]["tok"])


def test_the_dry_run_counts_one_rank_of_a_group(tmp_path):
    """``count_cell(data_parallel=2)`` on the meta device: the rank's state
    bytes both ways are ``sharded_state_bytes``'s, ZeRO-1 counts one
    all-gather a sharded leaf (its payload the parameters' bytes) beside
    the replicated count's all-reduces, and its predicted peak is the
    lower; ``--no-zero1`` runs (it raised while the dry run counted one
    card only)."""
    from repro_torch.launch import dryrun

    recs = {z: dryrun.count_cell("yi-6b", "train_4k", cut="reduced",
                                 depth=2, batch=4, seq_len=32,
                                 data_parallel=2, zero1=z)
            for z in (True, False)}
    cfg = reduced_config("yi-6b")
    eng = SPBEngine(cfg, TrainConfig(), SPBConfig(), group=DataGroup(size=2))
    m = eng.mesh
    want = {("zero1" if z else "replicated"): sharding.sharded_state_bytes(
        eng.state_shapes, sharding.state_pspec(eng.state_shapes, m, zero1=z),
        m) for z in (True, False)}
    params = sum(t.numel() * t.element_size()
                 for t in tree_leaves(eng.state_shapes["params"]))
    for z, rec in recs.items():
        assert rec["state_bytes"] == want and rec["data_parallel"] == 2
        breakdown = rec["collective_breakdown"]
        assert breakdown.get("all-gather") == (params / 2 if z else None)
        assert breakdown["all-reduce"] > 0
    assert recs[True]["predicted_peak_bytes"] < \
        recs[False]["predicted_peak_bytes"]
    assert dryrun.main(["--arch", "yi-6b", "--reduced", "--shape",
                        "train_4k", "--batch", "4", "--seq", "32", "--depth",
                        "2", "--data-parallel", "2", "--no-zero1", "--out",
                        str(tmp_path)]) == 0
