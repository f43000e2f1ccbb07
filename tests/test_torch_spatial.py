"""The data-parallel group and spatial SPB on the CPU (``launch/mesh.py``,
``core/spb.spatial_grads``/``subgroup_allreduce``/``spb_estimator``,
``dist/steps.make_spatial_step``, ``launch/train.py --data-parallel``,
``analysis/cost.CostMode``'s collectives).

Ranks are spawned processes that meet over gloo in a ``file://`` store
(``launch/mesh.spawn``, one intra-op thread each, a join timeout on every
spawn); their target is this module's :func:`_rank`, which trains an
``SPBEngine`` on the rank's rows of each global batch, counts each step's
all-reduces under ``CostMode`` and hands back its metrics and final
parameters.  A spawned rank imports this module for its target, so the
reference (JAX) is imported only inside the tests that call it.  Every
run starts from the port's seeded weights (``SPBEngine.init_state(0)`` on
the CPU, which every rank draws alike) and the port's seeded ``Pipeline``
batches; the reference gets the same weights and batches as numpy arrays.

* A world of one, in-process, against the reference's spatial step on one
  CPU device (``make_host_mesh``): 2 steps, f32, 1e-5.
* Four ranks at k 4 and at k 2 (n / k = 2, ``subgroup_reduce`` off and
  on), and ``launch/train.py``'s two ranks at k 2, against the reference's
  ``SPBEngine`` spatial step on 4 (or 2) of 4 virtual CPU devices, run
  once in a subprocess started when the module starts: 2 steps, f32,
  1e-5; ``subgroup_reduce`` on equal to off within 1e-6; every rank's
  parameters bit-identical.
* ``off``, ``temporal`` (every depth of the k 4 cycle) and
  ``temporal-mb`` over 2 ranks equal the reference's ``SPBEngine`` on 2
  virtual devices within 1e-5 and the port's single process on the
  global batch within 1e-6, and the counted all-reduce payload of each
  temporal step is exactly the bytes of the leaves and rows its depth
  leaves live, plus the averaged metrics.
* ``spb_estimator`` against the reference's; the ring model's wire bytes
  against the reference's HLO count at group sizes 1, 2 and 4, and
  ``CostMode``'s count of a real all-reduce at each.
* The refusal of the step table under a group (checkpoint, resume and
  ``--fail-at`` are accepted), a batch that does not split.
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
import torch.distributed as dist

from repro_torch.analysis import cost
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.core import spb as spb_lib
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist.group import DataGroup
from repro_torch.engine.engine import SPBEngine
from repro_torch.launch import mesh, train
from repro_torch.tree import tree_map

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
B, S, STEPS = 4, 32, 2
CYCLE_STEPS = 4         # temporal's whole k 4 cycle
JOIN_S = 120.0          # each spawn's join timeout


def _argv(*extra, steps=STEPS):
    return ["--steps", str(steps), "--batch", str(B), "--seq", str(S),
            "--device", "cpu", "--use-pallas", "--log-every", "100",
            *extra]


def _rank(group, mode, k, sub=False, steps=STEPS):
    """One rank's run (the spawned ranks' target; on a group of one, the
    single process): yi-6b-reduced with the kernels' plain versions, from
    the seeded weights, on this rank's rows of each seeded global batch
    (the temporal-mb cycle's share of each microbatch), every step under
    ``CostMode``.  Returns the per-step xent, the last step's metrics, each
    step's counted all-reduces and the final parameters."""
    cfg = dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)
    eng = SPBEngine(cfg, TrainConfig(num_steps=steps),
                    SPBConfig(mode=mode, k=k, subgroup_reduce=sub),
                    group=group)
    eng.init_state(0)
    pipe = Pipeline(cfg, B, S, seed=0)
    chunks = k if mode == "temporal-mb" else 1
    out = {"history": [], "collectives": []}
    for s in range(steps):
        with cost.CostMode() as counted:
            m = eng.train_step(group.shard(pipe.get_batch(s), chunks), s)
        out["history"].append(float(m["xent"]))
        out["collectives"].append(
            counted.summary.collectives().get("all-reduce"))
    out["metrics"] = {key: float(v) for key, v in m.items()}
    out["params"] = tree_map(lambda t: t.detach().numpy(),
                             eng.state["params"])
    return out


def _spawn(n, *run):
    return mesh.spawn(f"{__name__}:_rank", n, *run, device="cpu",
                      threads=1, timeout_s=JOIN_S)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _path(path):
    return "/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                          for k in path)


def _inputs(steps=STEPS):
    """The port's seeded initial params (flat, by path) and the global
    batches every run draws."""
    eng = SPBEngine(reduced_config("yi-6b"), TrainConfig(num_steps=steps),
                    SPBConfig(), device="cpu")
    eng.init_state(0)
    pipe = Pipeline(reduced_config("yi-6b"), B, S, seed=0)
    batches = [{k: v.numpy() for k, v in pipe.get_batch(s).items()}
               for s in range(steps)]
    return _numpy(eng.state["params"]), batches


def _numpy(params):
    """A port param tree as numpy arrays, flat by path."""
    return _flat(tree_map(lambda t: t.detach().numpy(), params))


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.config import SPBConfig, TrainConfig
    from repro.configs import reduced_config
    from repro.dist import steps as jsteps
    from repro.engine import SPBEngine

    inp = np.load(sys.argv[1])
    cfg = reduced_config("yi-6b")

    def key(path):
        return "/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in path)

    out = {}
    for name, n, mode, k, sub, steps in %(runs)r:
        mesh = jax.sharding.Mesh(
            np.array(jax.devices()[:n]).reshape(n, 1), ("data", "model"))
        tcfg = TrainConfig(num_steps=steps)
        eng = SPBEngine(cfg, tcfg, SPBConfig(mode=mode, k=k,
                                             subgroup_reduce=sub), mesh=mesh)
        state = jsteps.init_train_state(jax.random.key(0), cfg, tcfg)
        state["params"] = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.asarray(inp["p" + key(p)]), state["params"])
        eng.attach_state(state)
        for s in range(steps):
            m = eng.train_step({"tokens": inp["tokens%%d" %% s],
                                "labels": inp["labels%%d" %% s]}, s)
            for kk, v in m.items():
                out["%%s/m%%d/%%s" %% (name, s, kk)] = np.asarray(v)
        for p, v in jax.tree_util.tree_leaves_with_path(eng.state["params"]):
            out[name + "/p" + key(p)] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")
# the other modes over 2 ranks: (mode, k, steps); temporal the whole k 4
# cycle, temporal-mb at k 2, so that 4 rows split over 2 ranks x 2
# microbatches
DP_MODES = {"off": (4, STEPS), "temporal": (4, CYCLE_STEPS),
            "temporal-mb": (2, STEPS)}
# the reference's runs: (name, ranks, mode, k, subgroup_reduce, steps);
# the port's spawned runs are the first three and the DP_MODES ones
RUNS = (("n4k4", 4, "spatial", 4, False, STEPS),
        ("n4k2", 4, "spatial", 2, False, STEPS),
        ("n4k2sub", 4, "spatial", 2, True, STEPS),
        ("n2k2", 2, "spatial", 2, False, STEPS),
        *((mode, 2, mode, k, False, steps)
          for mode, (k, steps) in DP_MODES.items()))


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """Starts the reference's runs on virtual CPU devices when the module
    starts, in two subprocesses (the spatial runs and the other modes'),
    while the port's ranks run; the returned callable takes a run's name,
    waits for the subprocess that holds it and gives its outputs."""
    tmp = tmp_path_factory.mktemp("spatial_ref")
    params, batches = _inputs(CYCLE_STEPS)
    arrays = {"p" + k: v for k, v in params.items()}
    for s, b in enumerate(batches):
        arrays.update({f"{k}{s}": v for k, v in b.items()})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    parts = [[r for r in RUNS if r[2] == "spatial"],
             [r for r in RUNS if r[2] != "spatial"]]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE % {"runs": tuple(runs)},
         str(tmp / "in.npz"), str(tmp / f"out{i}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, runs in enumerate(parts)]
    done = [None] * len(parts)

    def result(name):
        i = next(i for i, runs in enumerate(parts)
                 if name in {r[0] for r in runs})
        if done[i] is None:
            _, err = procs[i].communicate(timeout=300)
            assert procs[i].returncode == 0, err[-3000:]
            done[i] = dict(np.load(tmp / f"out{i}.npz"))
        return done[i]

    yield result
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module", autouse=True)
def port_runs():
    """Starts every spawned run of the module when it starts, a few at a
    time: {name: a future of each rank's output}."""
    with ThreadPoolExecutor(3) as pool:
        yield {name: pool.submit(_spawn, n, mode, k, sub, steps)
               for name, n, mode, k, sub, steps in RUNS
               if name != "n2k2"}


def _ref_run(ref, name):
    """(per-step metrics, final params by path) of one reference run."""
    steps = len({k.split("/")[1] for k in ref
                 if k.startswith(f"{name}/m")})
    metrics = [{k.split("/")[-1]: float(v) for k, v in ref.items()
                if k.startswith(f"{name}/m{s}/")} for s in range(steps)]
    params = {k[len(name) + 2:]: v for k, v in ref.items()
              if k.startswith(f"{name}/p/")}
    return metrics, params


def _same_replicas(ranks):
    """Every rank's final parameters bit-identical to rank 0's."""
    want = _flat(ranks[0]["params"])
    for r, out in enumerate(ranks[1:], 1):
        got = _flat(out["params"])
        assert set(got) == set(want)
        for k in want:
            assert np.array_equal(got[k], want[k]), f"rank {r} {k}"


def _hold(got_metrics, got_params, want_metrics, want_params, tol):
    for key in ("loss", "xent", "grad_norm"):
        np.testing.assert_allclose(got_metrics[key], want_metrics[key],
                                   rtol=tol, atol=tol, err_msg=key)
    got = _flat(got_params)
    assert set(got) == set(want_params)
    for k, v in want_params.items():
        np.testing.assert_allclose(got[k], v, rtol=tol, atol=tol,
                                   err_msg=k)


# -- a world of one (runs while the reference's subprocess does) ---------

def test_world_of_one_equals_the_reference():
    """Spatial SPB on a group of one (no process group) against the
    reference's spatial step on the one CPU device."""
    import jax
    import jax.numpy as jnp
    from repro.config import SPBConfig as JSPB, TrainConfig as JTrain
    from repro.configs import reduced_config as j_reduced
    from repro.dist import steps as j_steps
    from repro.engine import SPBEngine as JEngine
    from repro.launch.mesh import make_host_mesh

    params, batches = _inputs()
    cfg, tcfg = reduced_config("yi-6b"), TrainConfig(num_steps=STEPS)
    eng = SPBEngine(cfg, tcfg, SPBConfig(mode="spatial", k=4),
                    device="cpu")
    eng.init_state(0)
    jcfg = j_reduced("yi-6b")
    jeng = JEngine(jcfg, JTrain(num_steps=STEPS),
                   JSPB(mode="spatial", k=4), mesh=make_host_mesh())
    state = j_steps.init_train_state(jax.random.key(0), jcfg,
                                     JTrain(num_steps=STEPS))
    state["params"] = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(params[_path(p)]), state["params"])
    jeng.attach_state(state)
    for s, b in enumerate(batches):
        got = eng.train_step(b, s)
        want = jeng.train_step(b, s)
        for key in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-5, atol=1e-5)
    want_p = {_path(p): np.asarray(v) for p, v in
              jax.tree_util.tree_leaves_with_path(jeng.state["params"])}
    got_p = _numpy(eng.state["params"])
    for k, v in want_p.items():
        np.testing.assert_allclose(got_p[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


# -- the other modes over a group ---------------------------------------------

def _live_bytes(params, depth):
    """Bytes of the leaves and rows a step at suffix ``depth`` leaves
    live on yi-6b-reduced (one uniform group of 4 layers)."""
    total = 0
    for k, v in params.items():
        total += v[v.shape[0] - depth:].nbytes if k.startswith("/groups/") \
            else v.nbytes
    return total


@pytest.mark.parametrize("mode", DP_MODES)
def test_data_parallel_equals_the_reference(mode, port_runs, reference):
    """The mode over 2 ranks, each on its half of every global batch,
    equals the reference's ``SPBEngine`` over 2 virtual devices (GSPMD's
    data parallelism) within 1e-5, step by step."""
    ranks = port_runs[mode].result()
    _same_replicas(ranks)
    want_m, want_p = _ref_run(reference(mode), mode)
    np.testing.assert_allclose(ranks[0]["history"],
                               [m["xent"] for m in want_m], rtol=1e-5,
                               atol=1e-5)
    _hold(ranks[0]["metrics"], ranks[0]["params"], want_m[-1], want_p, 1e-5)


@pytest.mark.parametrize("mode", DP_MODES)
def test_data_parallel_equals_one_process(mode, port_runs):
    """The mode over 2 ranks equals the port's one process on the global
    batch within 1e-6; temporal runs the whole k 4 cycle (depths 4, 1, 3,
    2) and each step's counted all-reduce payload is exactly its live
    bytes plus the three averaged f32 metrics."""
    k, steps = DP_MODES[mode]
    ranks = port_runs[mode].result()
    _same_replicas(ranks)
    one = _rank(DataGroup(), mode, k, steps=steps)
    want_p = _flat(one["params"])
    np.testing.assert_allclose(ranks[0]["history"], one["history"],
                               rtol=1e-6, atol=1e-6)
    _hold(ranks[0]["metrics"], ranks[0]["params"], one["metrics"], want_p,
          1e-6)
    if mode == "temporal":
        init, _ = _inputs()
        for r in ranks:
            for depth, c in zip((4, 1, 3, 2), r["collectives"]):
                assert c["payload_bytes"] == _live_bytes(init, depth) + 12
                assert c["wire_bytes"] == c["payload_bytes"]   # n = 2
                assert c["count"] == 12     # 11 leaves and the metrics


# -- the estimator and the wire model ---------------------------------------

@pytest.mark.parametrize("k,L", [(2, 4), (2, 5), (4, 4), (4, 5)])
def test_spb_estimator_equals_the_reference(k, L):
    import jax.numpy as jnp
    from repro.core import spb as j_spb

    x = np.random.default_rng(k * 10 + L).standard_normal(
        (k, L, 3, 2)).astype(np.float32)
    got = spb_lib.spb_estimator(torch.from_numpy(x), k).numpy()
    want = np.asarray(j_spb.spb_estimator(jnp.asarray(x), k))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _reference_wire(n: int, elems: int) -> float:
    """The reference's HLO count of one f32 all-reduce over ``n``."""
    from repro.analysis import hlo as j_hlo

    text = textwrap.dedent(f"""\
        HloModule m

        %add (a: f32[], b: f32[]) -> f32[] {{
          %a = f32[] parameter(0)
          %b = f32[] parameter(1)
          ROOT %c = f32[] add(f32[] %a, f32[] %b)
        }}

        ENTRY %main (p: f32[{elems}]) -> f32[{elems}] {{
          %p = f32[{elems}]{{0}} parameter(0)
          ROOT %ar = f32[{elems}]{{0}} all-reduce(f32[{elems}]{{0}} %p), replica_groups={{{{{','.join(map(str, range(n)))}}}}}, to_apply=%add
        }}
        """)
    s = j_hlo.analyze(text, num_partitions=n)
    assert s.collective_payload["all-reduce"] == 4 * elems
    return s.collective_bytes


@pytest.mark.parametrize("n", [1, 2, 4])
def test_ring_model_equals_the_reference(n):
    assert cost.wire_bytes("all-reduce", n, 4 * 1000) == \
        _reference_wire(n, 1000)


def test_cost_mode_counts_an_all_reduce(tmp_path):
    """A real all-reduce over a group of one, counted: its payload, and
    the ring model's wire bytes (0 at n = 1; the spawned runs above count
    n = 2 and the spatial ranks n = 4)."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        t = torch.ones(1000)
        with cost.CostMode() as mode:
            dist.all_reduce(t)
    finally:
        dist.destroy_process_group()
    c = mode.summary.collectives()["all-reduce"]
    assert c == {"count": 1.0, "payload_bytes": 4000.0,
                 "wire_bytes": _reference_wire(1, 1000)}


# -- refusals -------------------------------------------------------------

@pytest.mark.parametrize("flags,refused", [
    pytest.param(["--checkpoint-dir", "ckpt"], False, id="flags0-item 11"),
    pytest.param(["--resume"], False, id="flags1-item 11"),
    pytest.param(["--fail-at", "1"], False, id="flags2-item 11"),
    pytest.param(["--aot-cache", "tbl"], True, id="flags3-item 11"),
])
def test_group_refusals(flags, refused):
    """A group takes checkpoints, ``--resume`` and ``--fail-at`` (their
    runs: ``tests/test_torch_zero.py``); the step table stays refused,
    naming ROADMAP item 11."""
    args = train.parse_args(_argv("--data-parallel", "2", *flags))
    if refused:
        with pytest.raises(NotImplementedError, match="item 11"):
            train.train(_argv("--data-parallel", "2", *flags))
    else:
        train._check_group_args(args, 2)


def test_a_batch_that_does_not_split_is_refused():
    with pytest.raises(ValueError, match="does not split"):
        train.train(["--batch", "3", "--data-parallel", "2", "--device",
                     "cpu"])
    with pytest.raises(ValueError, match="microbatches"):
        train.train(["--batch", "4", "--data-parallel", "2", "--spb-mode",
                     "temporal-mb", "--spb-k", "4", "--device", "cpu"])


def test_the_step_table_is_refused_under_a_group():
    cfg = reduced_config("yi-6b")
    group = DataGroup(rank=0, size=2)        # no collective is made
    eng = SPBEngine(cfg, TrainConfig(), SPBConfig(mode="temporal"),
                    group=group)
    eng.init_state(0)
    with pytest.raises(NotImplementedError, match="CUDA graph"):
        eng.compile_table({})
    with pytest.raises(NotImplementedError, match="CUDA graph"):
        eng.load_aot("nowhere")


def test_the_group_keys_the_step_cache():
    cfg, tcfg = reduced_config("yi-6b"), TrainConfig()
    one = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal"), device="cpu")
    two = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal"),
                    group=DataGroup(rank=1, size=2))
    assert two.step_cache_key(2) == one.step_cache_key(2) + (("group", 2),)
    spatial = [SPBEngine(cfg, tcfg, SPBConfig(mode="spatial", k=2),
                         group=DataGroup(rank=r, size=4))
               for r in (0, 1, 2)]
    keys = [e.step_cache_key(None)[-1] for e in spatial]
    assert keys == [("group", 4, 0), ("group", 4, 1), ("group", 4, 0)]
    assert [e.depth_key_for_step(0) for e in spatial] == [None] * 3


# -- spatial against the reference ------------------------------------------

@pytest.mark.parametrize("name", [r[0] for r in RUNS[:3]])
def test_spatial_ranks_equal_the_reference(name, port_runs, reference):
    ranks = port_runs[name].result()
    _same_replicas(ranks)
    want_m, want_p = _ref_run(reference(name), name)
    np.testing.assert_allclose(ranks[0]["history"],
                               [m["xent"] for m in want_m], rtol=1e-5,
                               atol=1e-5)
    _hold(ranks[0]["metrics"], ranks[0]["params"], want_m[-1], want_p, 1e-5)


def test_subgroup_rereduce_preserves_the_values(port_runs):
    """The re-reduce after the full sum changes no value beyond f32
    rounding (its contributors' t / c summed back)."""
    off, on = (_flat(port_runs[n].result()[0]["params"])
               for n in ("n4k2", "n4k2sub"))
    for k in off:
        np.testing.assert_allclose(on[k], off[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_train_entry_runs_spatial_over_two_ranks(reference):
    """``launch/train.py --spb-mode spatial --data-parallel 2`` trains, and
    its last loss is the reference's two-device spatial step's."""
    history = train.train(_argv("--spb-mode", "spatial", "--spb-k", "2",
                                "--data-parallel", "2"))
    want_m, _ = _ref_run(reference("n2k2"), "n2k2")
    assert len(history) == STEPS
    np.testing.assert_allclose(history, [m["xent"] for m in want_m],
                               rtol=1e-5, atol=1e-5)


def test_spatial_ranks_count_the_ring_model_at_four(port_runs):
    """Four ranks at k 4 count, each step, every leaf and the two
    metrics once over the group of 4: wire = 1.5 x payload, as the
    reference's HLO count gives for that payload."""
    init, _ = _inputs()
    payload = sum(v.nbytes for v in init.values()) + 8
    for r in port_runs["n4k4"].result():
        assert len(r["collectives"]) == STEPS
        for c in r["collectives"]:
            assert c["payload_bytes"] == payload and c["count"] == 12
            assert c["wire_bytes"] == _reference_wire(4, payload // 4)
