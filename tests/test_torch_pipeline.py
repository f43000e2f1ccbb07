"""Pipeline parallelism on the CPU (``dist/pipeline/stage.py``,
``runtime.py``, ``dist/group.PipeGroup``, ``launch/mesh.init_pipe_group``,
``dist/steps.make_pipeline_train_step``, ``SPBEngine(parallelism=
"pipeline")``, ``launch/train.py --parallelism pipeline``).

Each stage is a spawned rank (``launch/mesh.spawn(..., grid=(S, D, 1))``,
one intra-op thread each); the ranks' target is this module's
:func:`_rank`, and the module imports JAX only inside the tests that call
it, so a spawned rank does not load it.  Every run is started when the
module starts, a few at a time, beside three subprocesses that run the
reference on 4 virtual CPU devices.

* The stage maps, their rendering, the stack/unstack round trip, every
  stage fn's output and aux, the head loss, the inlet's embedding, the
  stage checks (with their texts) and ``stage_param_specs`` on a (stage 2,
  model 2) mesh equal the reference's for reduced yi-6b (one group),
  recurrentgemma-2b (two groups, zero rows) and qwen3-moe.
* The reference's toy stage ``tanh(x @ w)`` with a mean-squared loss:
  1F1B and GPipe at (S, M) in {(2, 2), (2, 8), (4, 4)} and on the
  (stage 2, data 2) grid at M 4 give the loss within 1e-6 and the stage
  gradients within 1e-5 (atol 1e-6) of the port's
  ``sequential_reference`` under autograd and of the reference's
  ``pipeline_train_grads``; every truncated table gives exactly zero on
  its frozen stages and unchanged live stages; ``stash_slots`` is the
  table's ``stash_plan``, its activations ``max_in_flight`` and, for
  1F1B at M > S, fewer than M; ``pipeline_apply`` equals the oracle's
  forward.
* ``SPBEngine(parallelism="pipeline")`` over 2 stage ranks, 1F1B at M 2,
  temporal k 4 (depths 4, 2, 4, 2 on yi-6b and qwen3-moe, 6, 3, 6, 3 on
  recurrentgemma: two steps at each stage-snapped depth; qwen3 carries
  the MoE aux): every step's metrics and the final parameters equal the
  reference's pipeline ``SPBEngine`` on 2 virtual devices within 1e-5
  and the port's one process on the whole batch within 1e-5, f32.
* A checkpoint written under the (2, 2) grid restores into one process
  and into a data group of 2, and one written by one process restores
  into the grid; the continued losses equal the uninterrupted run's.
* The refused modes and flags (the tensor-parallel knobs' refusals among
  them) raise with their texts; ``launch/train.py``
  runs a pipeline and restarts it from a checkpoint after an injected
  failure; a send on the meta device is counted by
  ``analysis/cost.CostMode``.
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

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist import steps as steps_lib
from repro_torch.dist.group import DataGroup, PipeGroup
from repro_torch.dist.pipeline import runtime, schedules
from repro_torch.dist.pipeline import stage as pp_stage
from repro_torch.engine.engine import SPBEngine
from repro_torch.launch import mesh, train
from repro_torch.models import lm
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JOIN_S = 180.0
ARCHS = ("yi-6b", "recurrentgemma-2b", "qwen3-moe-235b-a22b")
# (arch, steps) of the engine runs: two steps at each stage-snapped depth
LM_RUNS = (("yi-6b", 4), ("recurrentgemma-2b", 4),
           ("qwen3-moe-235b-a22b", 2))
# the k 4 cycle's depths, snapped to the 2 stages' boundaries
DEPTHS = {"yi-6b": (4, 2, 4, 2), "recurrentgemma-2b": (6, 3, 6, 3),
          "qwen3-moe-235b-a22b": (4, 2)}
B, SEQ, M = 4, 32, 2
# the toy cases: (S, M, D) of the runtime's grid, the reference's cases
TOY = ((2, 2, 1), (2, 8, 1), (4, 4, 1), (2, 4, 2))
TOY_D, TOY_MB = 16, 4


def _toy_inputs(S, M_, D):
    """The toy's weights ``(S, 16, 16)``, microbatches and targets
    ``(M, 4, 16)``, from a seeded numpy generator."""
    rng = np.random.default_rng(100 * S + M_ + D)
    params = (rng.standard_normal((S, TOY_D, TOY_D)) /
              np.sqrt(TOY_D)).astype(np.float32)
    xs = rng.standard_normal((M_, TOY_MB, TOY_D)).astype(np.float32)
    ts = rng.standard_normal((M_, TOY_MB, TOY_D)).astype(np.float32)
    return params, xs, ts


def _toy_stage(w, x):
    return torch.tanh(x @ w)


def _toy_loss(hp, y, t):
    return torch.mean((y - t) ** 2)


def _toy_rank(group, M_):
    """Every table of the toy at M_ microbatches on this rank's stage:
    {(kind, bwd_stages): (loss, stage grads or None, stash_slots)}."""
    S, D = group.num_stages, group.data.size
    params, xs, ts = _toy_inputs(S, M_, D)
    rows = TOY_MB // D
    lo = group.data_index * rows
    xs, ts = (torch.from_numpy(a[:, lo:lo + rows]) for a in (xs, ts))
    out = {}
    for kind in ("1f1b", "gpipe"):
        for b in range(S, 0, -1):
            res = runtime.pipeline_train_grads(
                schedules.build(kind, S, M_, bwd_stages=b), _toy_stage,
                torch.from_numpy(params[group.stage]), xs, ts, _toy_loss,
                group=group)
            g = res["stage_grads"]
            out[(kind, b)] = (float(res["loss"]),
                              None if g is None else g.numpy(),
                              res["stash_slots"])
    outs = runtime.pipeline_apply(
        _toy_stage, torch.from_numpy(params[group.stage]), xs, group=group)
    out["apply"] = None if outs is None else outs.numpy()
    return out


def _cfg(arch):
    return dataclasses.replace(reduced_config(arch), use_pallas=True)


def _engine(arch, group=None, steps=4, **kw):
    cfg, tcfg = _cfg(arch), TrainConfig(num_steps=steps, microbatches=M)
    spb = SPBConfig(mode="temporal", k=4, pipeline_stages=2)
    if group is None or isinstance(group, DataGroup):
        return SPBEngine(cfg, tcfg, spb, group=group,
                         device=None if group else "cpu", **kw)
    return SPBEngine(cfg, tcfg, spb, group=group, parallelism="pipeline",
                     **kw)


def _train(eng, group, steps, start=0):
    """Each step's metrics (floats) and depth."""
    pipe = Pipeline(eng.cfg, B, SEQ, seed=0)
    out = []
    for s in range(start, start + steps):
        batch = pipe.get_batch(s)
        if group is not None:
            batch = group.shard(batch, M if eng.pipeline_stages else 1)
        m = eng.train_step(batch, s)
        out.append({**{k: float(v) for k, v in m.items()},
                    "depth": eng.last_depth})
    return out


def _numpy(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


def _lm_rank(group):
    """The engine runs (``LM_RUNS``) on this rank: per arch its metrics
    and, on rank 0, the gathered final parameters."""
    out = {}
    for arch, steps in LM_RUNS:
        eng = _engine(arch, group, steps)
        eng.init_state(0)
        hist = _train(eng, group, steps)
        whole = eng.gathered_state()
        out[arch] = (hist, None if whole is None else _numpy(whole["params"]))
    return out


def _ckpt_rank(group, where, one_dir):
    """On the (2, 2) grid: 3 steps, a checkpoint at 3 in ``where``, 2 more
    steps; then the one-process checkpoint in ``one_dir`` restored and 2
    steps from it."""
    eng = _engine("yi-6b", group, 5)
    eng.init_state(0)
    _train(eng, group, 3)
    whole = eng.gathered_state()
    if group.rank == 0:
        CheckpointManager(where, async_write=False).save(whole, 3)
    group.barrier()
    cont = [m["xent"] for m in _train(eng, group, 2, start=3)]
    state, _ = CheckpointManager(one_dir).restore(eng.state_shapes, 3)
    eng.attach_state(state)
    from_one = [m["xent"] for m in _train(eng, group, 2, start=3)]
    return cont, from_one


def _data_rank(group, where):
    """A data group of 2 restoring the grid's checkpoint: 2 steps."""
    eng = _engine("yi-6b", group, 5)
    state, _ = CheckpointManager(where).restore(eng.state_shapes, 3)
    eng.attach_state(state)
    return [m["xent"] for m in _train(eng, group, 2, start=3)]


def _rank(group, what, *args):
    """The spawned ranks' target."""
    return {"toy": _toy_rank, "lm": _lm_rank, "ckpt": _ckpt_rank,
            "data": _data_rank}[what](group, *args)


def _spawn(n, what, *args, grid=None):
    return mesh.spawn(f"{__name__}:_rank", n, what, *args, device="cpu",
                      threads=1, timeout_s=JOIN_S, grid=grid)


# -- the reference, in a subprocess on 4 virtual devices ------------------

_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.config import SPBConfig, TrainConfig
    from repro.configs import reduced_config
    from repro.dist import steps as jsteps
    from repro.dist.pipeline import pipeline_train_grads, schedules
    from repro.engine import SPBEngine
    from repro.optim import optimizers

    inp = np.load(sys.argv[1])
    out = {}
    auto = (jax.sharding.AxisType.Auto,) * 2

    def stage_fn(w, x):
        return jnp.tanh(x @ w)

    def loss_fn(hp, y, t):
        return jnp.mean((y - t) ** 2)

    for S, M, D in %(toy)r:
        name = "toy_%%d_%%d_%%d" %% (S, M, D)
        mesh = jax.make_mesh((S, D), ("stage", "data"), axis_types=auto,
                             devices=jax.devices()[:S * D])
        args = [jnp.asarray(inp[name + "/" + k]) for k in ("p", "x", "t")]
        for kind in ("1f1b", "gpipe"):
            sched = schedules.build(kind, S, M)
            with jax.sharding.set_mesh(mesh):
                res = jax.jit(lambda p, x, t: pipeline_train_grads(
                    sched, stage_fn, p, x, t, loss_fn))(*args)
            out[name + "/" + kind + "/loss"] = np.asarray(res["loss"])
            out[name + "/" + kind + "/grads"] = np.asarray(res["stage_grads"])

    def key(path):
        return "/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in path)

    mesh = jax.make_mesh((2, 1), ("stage", "data"), axis_types=auto,
                         devices=jax.devices()[:2])
    for arch, steps in %(lm)r:
        cfg = reduced_config(arch)
        tcfg = TrainConfig(num_steps=steps, microbatches=%(m)d)
        eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal", k=4),
                        mesh=mesh, parallelism="pipeline")
        # the port's weights on the reference's layout (its eager init
        # would draw numbers that are thrown away)
        params = jax.tree_util.tree_map_with_path(
            lambda p, x: jnp.asarray(inp[arch + "/p" + key(p)]),
            jsteps.train_state_shapes(cfg, tcfg)["params"])
        eng.attach_state({"params": params,
                          "opt": optimizers.init_opt_state(params, tcfg),
                          "step": jnp.zeros((), jnp.int32)})
        for s in range(steps):
            m = eng.train_step({"tokens": inp[arch + "/tokens%%d" %% s],
                                "labels": inp[arch + "/labels%%d" %% s]}, s)
            for kk, v in m.items():
                out["%%s/m%%d/%%s" %% (arch, s, kk)] = np.asarray(v)
        for p, v in jax.tree_util.tree_leaves_with_path(eng.state["params"]):
            out[arch + "/p" + key(p)] = np.asarray(v)
    np.savez(sys.argv[2], **out)
""")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _lm_inputs(arch, steps):
    """The port's seeded initial params (flat, by path) and batches."""
    eng = _engine(arch, steps=steps)
    eng.init_state(0)
    pipe = Pipeline(eng.cfg, B, SEQ, seed=0)
    batches = [{k: v.numpy() for k, v in pipe.get_batch(s).items()}
               for s in range(steps)]
    return _flat(_numpy(eng.state["params"])), batches


@pytest.fixture(scope="module", autouse=True)
def reference(tmp_path_factory):
    """Starts the reference's runs when the module starts, in three
    subprocesses (the toy and yi-6b, recurrentgemma, qwen3-moe); the
    returned callable waits for them and gives their outputs."""
    tmp = tmp_path_factory.mktemp("pipeline_ref")
    arrays = {}
    for S, M_, D in TOY:
        for k, v in zip(("p", "x", "t"), _toy_inputs(S, M_, D)):
            arrays[f"toy_{S}_{M_}_{D}/{k}"] = v
    for arch, steps in LM_RUNS:
        params, batches = _lm_inputs(arch, steps)
        arrays.update({f"{arch}/p{k}": v for k, v in params.items()})
        for s, b in enumerate(batches):
            arrays.update({f"{arch}/{k}{s}": v for k, v in b.items()})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    parts = ((TOY, LM_RUNS[:1]), ((), LM_RUNS[1:2]), ((), LM_RUNS[2:]))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE % {"toy": toy, "lm": lm, "m": M},
         str(tmp / "in.npz"), str(tmp / f"out{i}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (toy, lm) in enumerate(parts)]
    done = {}

    def result():
        if not done:
            for i, proc in enumerate(procs):
                _, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-3000:]
                done.update(np.load(tmp / f"out{i}.npz"))
        return done

    yield result
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def one_ckpt(tmp_path_factory):
    """One process's yi-6b run: a checkpoint at step 3 and the 2 steps
    after it."""
    where = tmp_path_factory.mktemp("one_ckpt")
    eng = _engine("yi-6b", steps=5)
    eng.init_state(0)
    _train(eng, None, 3)
    CheckpointManager(where, async_write=False).save(eng.gathered_state(), 3)
    return where, [m["xent"] for m in _train(eng, None, 2, start=3)]


@pytest.fixture(scope="module", autouse=True)
def runs(reference, one_ckpt, tmp_path_factory):
    """Every spawned run of the module, started together, a few at a
    time (the reference's subprocess is already running)."""
    pipe_ckpt = tmp_path_factory.mktemp("pipe_ckpt")
    with ThreadPoolExecutor(3) as pool:
        out = {(S, M_, D): pool.submit(_spawn, S * D, "toy", M_,
                                       grid=(S, D, 1))
               for S, M_, D in ((2, 2, 1), (4, 4, 1), (2, 4, 2))}
        out[(2, 8, 1)] = pool.submit(_spawn, 2, "toy", 8, grid=(2, 1, 1))
        out["lm"] = pool.submit(_spawn, 2, "lm", grid=(2, 1, 1))
        ckpt = pool.submit(_spawn, 4, "ckpt", str(pipe_ckpt),
                           str(one_ckpt[0]), grid=(2, 2, 1))
        out["ckpt"] = ckpt
        out["data"] = pool.submit(
            lambda: (ckpt.result(), _spawn(2, "data", str(pipe_ckpt)))[1])
        out["pipe_ckpt"] = pipe_ckpt
        yield out


# -- stage maps --------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_stage_maps_equal_the_references(arch):
    from repro.configs import reduced_config as j_reduced
    from repro.dist.pipeline import stage as j_stage

    jcfg, cfg = j_reduced(arch), reduced_config(arch)
    for n in (1, 2):
        want, got = j_stage.build_stage_map(jcfg, n), \
            pp_stage.build_stage_map(cfg, n)
        assert (got.segments, got.caps, got.trivial, got.uniform) == \
            (want.segments, want.caps, want.trivial, want.uniform)
        assert pp_stage.render_stage_map(cfg, n) == \
            j_stage.render_stage_map(jcfg, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_stack_and_unstack_equal_the_references(arch):
    import jax
    from repro.configs import reduced_config as j_reduced
    from repro.dist.pipeline import stage as j_stage

    # a pure relayout: the port's seeded weights, as numpy for the
    # reference (whose eager init would take seconds an arch)
    jcfg, cfg = j_reduced(arch), reduced_config(arch)
    tp = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    params = jax.tree.map(np.asarray, _numpy(tp))
    want = j_stage.stack_stage_params(params["groups"], jcfg, 2)
    got = pp_stage.stack_stage_params(tp["groups"], cfg, 2)
    want = {"/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(want)}
    got = _flat(_numpy(got))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    got = pp_stage.stack_stage_params(tp["groups"], cfg, 2)
    back = pp_stage.unstack_stage_grads(got, cfg, 2)
    for a, b in zip(tree_leaves(back), tree_leaves(tp["groups"])):
        assert torch.equal(a, b)
    # each stage's rows, and the whole tree back from them
    smap = pp_stage.build_stage_map(cfg, 2)
    parts = [pp_stage.local_tree(tp, cfg, smap, s) for s in range(2)]
    whole = pp_stage.assemble(parts, cfg, smap)
    for a, b in zip(tree_leaves(whole), tree_leaves(tp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_fns_and_the_head_equal_the_references(arch):
    """Every stage fn of a 2-stage map (``make_stage_fns``; and
    ``make_stage_fn`` on a one-group map), the head loss and the inlet's
    embedding against the reference's on the same weights and input."""
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config as j_reduced
    from repro.dist.pipeline import stage as j_stage
    from repro.models import layers as j_layers

    jcfg, cfg = j_reduced(arch), reduced_config(arch)
    tp = lm.init_lm(torch.Generator().manual_seed(0), cfg, "cpu")
    stacked = pp_stage.stack_stage_params(tp["groups"], cfg, 2)
    jstacked = jax.tree.map(jnp.asarray, _numpy(stacked))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 16))
    fns = pp_stage.make_stage_fns(cfg, 2)
    jfns = j_stage.make_stage_fns(jcfg, 2)
    for s in range(2):
        w = tree_map(lambda t, s=s: t[s], stacked)
        got_y, got_aux = fns[s](w, torch.from_numpy(x))
        want_y, want_aux = jfns[s](jax.tree.map(lambda t, s=s: t[s],
                                                jstacked), jnp.asarray(x))
        np.testing.assert_allclose(got_y.detach().numpy(), want_y,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(got_aux), float(want_aux),
                                   rtol=1e-5, atol=1e-6)
        if pp_stage.build_stage_map(cfg, 2).trivial:
            one = pp_stage.make_stage_fn(cfg)(w, torch.from_numpy(x))
            assert torch.equal(one, got_y)
    head = _numpy(pp_stage.head_params_of(tp))
    got = pp_stage.make_head_loss(cfg)(
        pp_stage.head_params_of(tp), torch.from_numpy(x),
        torch.from_numpy(labels))
    want = j_stage.make_head_loss(jcfg)(jax.tree.map(jnp.asarray, head),
                                        jnp.asarray(x), jnp.asarray(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 16))
    np.testing.assert_allclose(
        pp_stage.embed_tokens(tp["embed"], torch.from_numpy(tokens),
                              cfg).detach().numpy(),
        j_layers.embed(jax.tree.map(jnp.asarray, head["embed"]),
                       jnp.asarray(tokens), jcfg), rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_stage_checks_and_specs_equal_the_references(arch):
    """``layers_per_stage``, ``check_pipeline_compatible`` and
    ``check_tensor_parallel_compatible`` raise where the reference's do,
    with its texts, and ``stage_param_specs`` equals the reference's on a
    (stage 2, model 2) mesh, leaf by leaf."""
    from jax.sharding import AbstractMesh
    from repro.configs import reduced_config as j_reduced
    from repro.dist.pipeline import stage as j_stage
    from repro_torch.dist import sharding

    jcfg, cfg = j_reduced(arch), reduced_config(arch)

    def outcome(fn, *args):
        try:
            return fn(*args)
        except ValueError as e:
            return str(e)

    for n in (1, 2, 3, 4, 99):
        for f in ("layers_per_stage", "check_pipeline_compatible"):
            assert outcome(getattr(pp_stage, f), cfg, n) == \
                outcome(getattr(j_stage, f), jcfg, n), (f, n)
    for mp in (1, 2, 3):
        assert outcome(pp_stage.check_tensor_parallel_compatible, cfg, mp) \
            == outcome(j_stage.check_tensor_parallel_compatible, jcfg, mp)
    stacked = pp_stage.stack_stage_params(lm.param_shapes(cfg)["groups"],
                                          cfg, 2)
    got = pp_stage.stage_param_specs(
        stacked, sharding.Mesh((2, 2), ("stage", "model")))
    want = j_stage.stage_param_specs(
        tree_map(lambda t: np.zeros(t.shape, np.float32), stacked),
        AbstractMesh((2, 2), ("stage", "model")))
    by_path = {}
    tree_map_with_path(lambda path, spec: by_path.setdefault(
        "/" + "/".join(path), tuple(spec)), got,
        is_leaf=lambda x: isinstance(x, sharding.P))
    assert by_path == {k: tuple(v) for k, v in _flat_specs(want).items()}


def _flat_specs(tree):
    import jax
    return {"/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path): spec
            for path, spec in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: type(x).__name__ == "PartitionSpec")}


# -- the toy stage over spawned ranks ----------------------------------------

def _oracle(S, M_, D):
    """The loss and the stage gradients of the sequential oracle."""
    params, xs, ts = _toy_inputs(S, M_, D)
    p = torch.from_numpy(params).requires_grad_(True)
    ys = runtime.sequential_reference(_toy_stage, p, torch.from_numpy(xs))
    loss = torch.stack([_toy_loss({}, y, t) for y, t in
                        zip(ys, torch.from_numpy(ts))]).mean()
    loss.backward()
    return float(loss.detach()), p.grad.numpy()


@pytest.mark.parametrize("case", TOY, ids=lambda c: "S%d_M%d_D%d" % c)
def test_toy_gradients_equal_the_oracle_and_the_reference(case, runs,
                                                          reference):
    """Every table at full depth against the oracle and the reference;
    every truncation: frozen stages exactly zero, live ones unchanged;
    the stashes the table's watermark."""
    S, M_, D = case
    ranks = runs[case].result()
    want_l, want_g = _oracle(S, M_, D)
    # the forward alone (GPipe's forward table) on the last stage's ranks
    params, xs, _ = _toy_inputs(S, M_, D)
    with torch.no_grad():
        ys = runtime.sequential_reference(
            _toy_stage, torch.from_numpy(params), torch.from_numpy(xs))
    for r, out in enumerate(ranks):
        if r // D < S - 1:
            assert out["apply"] is None
            continue
        rows = TOY_MB // D
        lo = (r % D) * rows
        np.testing.assert_allclose(out["apply"], ys[:, lo:lo + rows].numpy(),
                                   rtol=1e-6, atol=1e-6)
    ref = reference()
    name = "toy_%d_%d_%d" % case
    for kind in ("1f1b", "gpipe"):
        for b in range(S, 0, -1):
            sched = schedules.build(kind, S, M_, bwd_stages=b)
            plan = schedules.stash_plan(sched)
            for r, out in enumerate(ranks):
                s = r // D
                loss, g, slots = out[(kind, b)]
                np.testing.assert_allclose(loss, want_l, rtol=1e-6)
                assert slots == (plan.act_slots, plan.cot_slots)
                assert slots[0] == schedules.max_in_flight(sched)
                if kind == "1f1b":
                    assert slots[0] <= min(S, M_)
                if s < S - b:
                    assert g is None
                    continue
                np.testing.assert_allclose(g, want_g[s], rtol=1e-5,
                                           atol=1e-6)
                if b == S:
                    np.testing.assert_allclose(
                        loss, float(ref[f"{name}/{kind}/loss"]), rtol=1e-6)
                    np.testing.assert_allclose(
                        g, ref[f"{name}/{kind}/grads"][s], rtol=1e-5,
                        atol=1e-6)


def test_one_f_one_b_stashes_fewer_than_m():
    """The tables the runs above interpret, at M > S: 1F1B's activation
    stash is its watermark and fewer than M slots; GPipe's is M."""
    for S, M_ in ((2, 8), (2, 4), (4, 8)):
        for b in range(1, S + 1):
            sched = schedules.one_f_one_b(S, M_, bwd_stages=b)
            act = schedules.stash_plan(sched).act_slots
            assert act == schedules.max_in_flight(sched) < M_
        gp = schedules.gpipe(S, M_)
        assert schedules.stash_plan(gp).act_slots == M_


# -- the engine over 2 stage ranks ------------------------------------------

@pytest.mark.parametrize("arch", [a for a, _ in LM_RUNS])
def test_pipeline_engine_equals_the_reference_and_one_process(arch, runs,
                                                              reference):
    steps = dict(LM_RUNS)[arch]
    ranks = runs["lm"].result()
    hist, params = ranks[0][arch]
    # every rank reports the same metrics
    assert ranks[1][arch][0] == hist
    assert ranks[1][arch][1] is None
    depths = [m["depth"] for m in hist]
    assert depths == list(DEPTHS[arch])
    ref = reference()
    one = _engine(arch, steps=steps)
    one.init_state(0)
    one_hist = _train(one, None, steps)
    assert [m["depth"] for m in one_hist] == depths
    keys = ("loss", "xent", "moe_aux", "grad_norm", "lr")
    for s, m in enumerate(hist):
        for k in keys:
            np.testing.assert_allclose(
                m[k], float(ref[f"{arch}/m{s}/{k}"]), rtol=1e-5, atol=1e-5,
                err_msg=f"step {s} {k}")
            np.testing.assert_allclose(m[k], one_hist[s][k], rtol=1e-5,
                                       atol=1e-5, err_msg=f"step {s} {k}")
    if arch.startswith("qwen3"):
        assert all(m["moe_aux"] > 0 for m in hist)
    got = _flat(params)
    mine = _flat(_numpy(one.state["params"]))
    for k, v in got.items():
        np.testing.assert_allclose(v, ref[f"{arch}/p{k}"], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(v, mine[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


# -- checkpoints -------------------------------------------------------------

def test_a_pipelines_checkpoint_restores_into_one_process_and_a_group(
        runs, one_ckpt):
    where, one_cont = one_ckpt
    cont, from_one = runs["ckpt"].result()[0]
    np.testing.assert_allclose(cont, one_cont, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(from_one, one_cont, rtol=1e-5, atol=1e-5)
    eng = _engine("yi-6b", steps=5)
    state, step = CheckpointManager(runs["pipe_ckpt"]).restore(
        eng.state_shapes, 3)
    assert step == 3
    eng.attach_state(state)
    got = [m["xent"] for m in _train(eng, None, 2, start=3)]
    np.testing.assert_allclose(got, cont, rtol=1e-5, atol=1e-5)
    data = runs["data"].result()
    np.testing.assert_allclose(data[0], cont, rtol=1e-5, atol=1e-5)
    assert data[0] == data[1]


# -- refusals and the train entry point --------------------------------------

# what the pipeline's tensor-parallel knobs still refuse, with the
# reference's texts: (arch, knobs, the text, the model axis's size)
KNOB_REFUSALS = [
    ("yi-6b", dict(sequence_parallel=True),
     "sequence_parallel requires tensor_parallel > 1", 1),
    ("yi-6b", dict(tensor_parallel=3), "num_heads=4 not divisible", 3),
    ("qwen3-moe-235b-a22b", dict(tensor_parallel=2),
     "MoE FFNs shard over the expert axis", 2),
    ("recurrentgemma-2b", dict(tensor_parallel=2),
     "have no tensor-parallel path", 2),
]


@pytest.mark.parametrize("case", KNOB_REFUSALS)
def test_item_11_knobs_raise(case):
    """The knobs run under a pipeline (``tests/test_torch_tensor_parallel
    .py``); what they refuse raises from the engine and the step with the
    reference's texts, and outside a pipeline session each raises."""
    from repro_torch.dist.group import ModelGroup

    arch, kw, text, t = case
    with pytest.raises(ValueError, match=text):
        _engine(arch, PipeGroup(data=DataGroup(), model=ModelGroup(size=t)),
                **kw)
    with pytest.raises(ValueError, match=text):
        steps_lib.make_pipeline_train_step(
            _cfg(arch), TrainConfig(), SPBConfig(), num_stages=1, **kw)
    with pytest.raises(ValueError, match="pipeline-session knobs"):
        _engine(arch, **kw)


@pytest.mark.parametrize("flags,text", [
    (["--tensor-parallel", "3"], "num_heads=4 not divisible"),
    (["--sequence-parallel"], "sequence_parallel requires tensor_parallel"),
    (["--parallelism", "spmd", "--zero2"], "pipeline-session knobs"),
    (["--arch", "qwen3-moe-235b-a22b", "--reduced", "--tensor-parallel",
      "2"], "MoE FFNs shard over the expert axis")])
def test_item_11_flags_raise(flags, text):
    """``launch/train.py``'s refusals, before any rank starts, with the
    reference's texts."""
    argv = ["--device", "cpu", "--steps", "1", "--parallelism", "pipeline",
            *flags]
    with pytest.raises(ValueError, match=text):
        train.train(argv)


@pytest.mark.parametrize("mode", ["spatial", "temporal-mb"])
def test_spatial_and_temporal_mb_raise_under_a_pipeline(mode):
    with pytest.raises(ValueError, match="not supported under pipeline"):
        steps_lib.build_pipeline_train_steps(
            _cfg("yi-6b"), TrainConfig(), SPBConfig(mode=mode),
            num_stages=1)
    with pytest.raises(ValueError, match="not supported under pipeline"):
        SPBEngine(_cfg("yi-6b"), TrainConfig(), SPBConfig(mode=mode),
                  device="cpu", parallelism="pipeline")


def test_the_step_table_and_compression_are_refused():
    """The step table is refused under a pipeline; compression runs there
    (``tests/test_torch_tensor_parallel.py`` holds it against one
    process), and a compressed step builds under ZeRO-2 too."""
    eng = SPBEngine(_cfg("yi-6b"), TrainConfig(), SPBConfig(), device="cpu",
                    parallelism="pipeline")
    for call in (lambda: eng.compile_table({}), lambda: eng.load_aot("x")):
        with pytest.raises(NotImplementedError, match="under a pipeline"):
            call()
    assert callable(steps_lib.make_pipeline_train_step(
        _cfg("yi-6b"), TrainConfig(compression="topk"), SPBConfig(),
        num_stages=1))
    zero2 = SPBEngine(_cfg("yi-6b"), TrainConfig(compression="topk"),
                      SPBConfig(), parallelism="pipeline", zero2=True,
                      group=PipeGroup(data=DataGroup(size=2), size=2))
    assert zero2.zero2 and zero2.shards is not None
    assert all(callable(zero2.step_fn(k)) for k in zero2.depth_keys())
    with pytest.raises(ValueError, match="not pipeline-partitionable"):
        pp_stage.check_pipeline_compatible(
            reduced_config("seamless-m4t-medium"), 2)


def test_train_entry_runs_a_pipeline(tmp_path):
    """``--parallelism pipeline`` over 2 stage ranks with a failure
    injected at step 3: the first attempt's 3 steps, then steps 2 and 3
    from the step-2 checkpoint, each the one-process xent."""
    argv = ["--parallelism", "pipeline", "--pipeline-stages", "2",
            "--microbatches", "2", "--spb-mode", "temporal", "--device",
            "cpu", "--steps", "4", "--batch", str(B), "--seq", str(SEQ),
            "--use-pallas", "--log-every", "100", "--checkpoint-dir",
            str(tmp_path), "--checkpoint-every", "2", "--fail-at", "3"]
    got = train.train(argv)
    one = _engine("yi-6b", steps=4)
    one.init_state(0)
    want = [m["xent"] for m in _train(one, None, 4)]
    np.testing.assert_allclose(got, want[:3] + want[2:], rtol=1e-5,
                               atol=1e-5)


def test_a_send_on_meta_is_counted():
    """On the meta device a send moves nothing and ``CostMode`` counts it
    (its payload on the wire), a receive gives an empty meta tensor."""
    from repro_torch.analysis import cost
    from repro_torch.dist.group import TAG_ACT, TAG_COT

    group = PipeGroup(stage=0, num_stages=2, size=2,
                      device=torch.device("meta"))
    t = torch.empty(2, 32, 64, device="meta")
    with cost.CostMode() as counted:
        got = group.exchange([(t, 1, TAG_ACT)],
                             [((2, 32, 64), torch.float32, 1, TAG_COT)])
    assert got[0].is_meta and tuple(got[0].shape) == (2, 32, 64)
    c = counted.summary.collectives()["send"]
    assert c == {"count": 1.0, "payload_bytes": 16384.0,
                 "wire_bytes": 16384.0}
    assert not group.p2p_by_tag
