"""Tensor parallelism inside the pipeline's stages on the CPU
(``models/layers.py``'s collective pairs, ``dist/group.ModelGroup``, the
``(stage, data, model)`` grid of ``launch/mesh.init_pipe_group``,
``dist/pipeline/stage.py``'s model shards, ZeRO-2 in
``dist/pipeline/runtime.py``, ``dist/steps.make_pipeline_train_step``
with ``tensor_parallel``, ``sequence_parallel``, ``zero2`` and
compression, ``SPBEngine(parallelism="pipeline")`` and
``launch/train.py``).

The ranks are spawned (``launch/mesh.spawn(..., grid=(S, D, T))``, one
intra-op thread each); their target is this module's :func:`_rank`, and
the module imports JAX only inside the tests, so a spawned rank does not
load it.  Every run starts when the module starts, beside three
subprocesses that run the reference on 2, 4 and 8 virtual CPU devices.
Reduced yi-6b, f32, the kernels on (their plain versions here).

* The six collective Functions' outputs and input gradients on each of 2
  model ranks equal the reference's ``custom_vjp``s under ``shard_map`` at
  1e-5, as does a one-stage ``make_stage_fn`` over the model axis
  (output, input and weight gradients), sequence parallelism off and on,
  under every recompute policy.
* On ``(2, 1, 2)``: 1F1B and GPipe, sequence parallelism off and on, give
  the loss within 1e-6 and the stage and head gradients within 1e-5 of the
  port's ``sequential_reference`` and of the reference's
  ``pipeline_train_grads``; ``bwd_stages`` 1 gives no gradient (zero) on
  the frozen stage.  The model group's calls and bytes a step equal
  ``analysis/roofline.pipeline_tp_calls``.
* ``SPBEngine`` on ``(2, 2, 2)`` with ``sequence_parallel`` and ``zero2``,
  temporal k 4: every step's metrics and the final parameters within 1e-5
  of the reference's pipeline ``SPBEngine`` on 8 virtual devices and of
  the port's one process; ZeRO-2's parameters within 1e-6 of ZeRO-1's on
  the same grid (the gradient norm sums the data shards' squares in
  another order).
* A checkpoint written under ``(2, 1, 2)`` restores into one process, and
  one written by one process restores into ``(2, 1, 2)``.
* Compression under a pipeline: ``topk``, ``randk`` and ``lowrank`` over 2
  stage ranks, 1F1B and GPipe, ``topk`` on ``(2, 1, 2)``, and all three
  under ZeRO-2 on ``(2, 2, 1)`` and ``(2, 2, 2)``, each within 1e-5 of the
  one-process compressed step, at full and truncated depth.
* ``launch/train.py --parallelism pipeline --tensor-parallel 2`` with and
  without ``--sequence-parallel`` and with ``--pipeline-data-parallel 2
  --zero2``, and ``--pipeline-data-parallel 2 --zero2 --compression
  topk``: one process's xent, and the checkpoint restores into one
  process.
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

from repro_torch.analysis import roofline
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist.pipeline import runtime, schedules
from repro_torch.dist.pipeline import stage as pp_stage
from repro_torch.engine.engine import SPBEngine
from repro_torch.launch import mesh, train
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JOIN_S = 420.0
ARCH = "yi-6b"
B, SEQ, M, STEPS = 4, 32, 2, 4
# the k 4 cycle's depths, snapped to the 2 stages' boundaries
DEPTHS = (4, 2, 4, 2)
FNS = {"tp_psum": lambda x, g: L.tp_psum(x, g),
       "tp_enter": lambda x, g: L.tp_enter(x, g),
       "sp_all_gather": lambda x, g: L.sp_all_gather(x, g, 1),
       "sp_reduce_scatter": lambda x, g: L.sp_reduce_scatter(x, g, 1),
       "sp_slice": lambda x, g: L.sp_slice(x, g, 1),
       "sp_unslice": lambda x, g: L.sp_unslice(x, g, 1)}
# each Function's output length on the sequence dim, from 8
FN_SEQ = {"tp_psum": 8, "tp_enter": 8, "sp_all_gather": 16,
          "sp_reduce_scatter": 4, "sp_slice": 4, "sp_unslice": 16}
# the schedules held against the reference: (kind, bwd_stages)
TABLES = (("1f1b", 2), ("gpipe", 2), ("1f1b", 1))
COMPRESSIONS = ("topk", "randk", "lowrank")
# the grids compression runs on under ZeRO-2
ZERO2_GRIDS = ((2, 2, 1), (2, 2, 2))


def _cfg():
    return dataclasses.replace(reduced_config(ARCH), use_pallas=True)


def _params():
    return lm.init_lm(torch.Generator().manual_seed(0), _cfg(), "cpu")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: None if tree is None else np.asarray(
        tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _inputs():
    """Every array the port's ranks and the reference read, from seeded
    numpy generators and the port's seeded init."""
    rng = np.random.default_rng(0)
    cfg = _cfg()
    arr = {"p" + k: v for k, v in _flat(_params()).items()}
    arr["fn/x"] = rng.standard_normal((2, 2, 8, 6)).astype(np.float32)
    for name, s in FN_SEQ.items():
        arr[f"fn/{name}/g"] = rng.standard_normal((2, 2, s, 6)).astype(
            np.float32)
    arr["stage/x"] = rng.standard_normal((2, SEQ, cfg.d_model)).astype(
        np.float32)
    # the cotangent a mean over the stage's 2 x 32 positions would give
    arr["stage/g"] = (rng.standard_normal((2, SEQ, cfg.d_model))
                      / (2 * SEQ)).astype(np.float32)
    arr["xs"] = (rng.standard_normal((M, 2, SEQ, cfg.d_model)) * 0.5).astype(
        np.float32)
    arr["labels"] = rng.integers(0, cfg.vocab_size, (M, 2, SEQ))
    pipe = Pipeline(cfg, B, SEQ, seed=0)
    for s in range(STEPS):
        b = pipe.get_batch(s)
        arr[f"tokens{s}"] = b["tokens"].numpy()
        arr[f"labels{s}"] = b["labels"].numpy()
    arr["steps"] = np.array(STEPS)
    return arr


def _engine(group=None, steps=STEPS, **kw):
    cfg, tcfg = _cfg(), TrainConfig(num_steps=steps, microbatches=M,
                                    **kw.pop("tcfg", {}))
    spb = SPBConfig(mode="temporal", k=4, pipeline_stages=2)
    if group is None:
        return SPBEngine(cfg, tcfg, spb, device="cpu", **kw)
    return SPBEngine(cfg, tcfg, spb, group=group, parallelism="pipeline",
                     **kw)


def _train(eng, group, steps, start=0):
    """Each step's metrics (floats) and depth."""
    pipe = Pipeline(eng.cfg, B, SEQ, seed=0)
    out = []
    for s in range(start, start + steps):
        batch = pipe.get_batch(s)
        if group is not None:
            batch = group.shard(batch, M)
        m = eng.train_step(batch, s)
        out.append({**{k: float(v) for k, v in m.items()},
                    "depth": eng.last_depth})
    return out


def _model_sharded(tree):
    return tree_map_with_path(lambda path, t: pp_stage.model_shard_dim(
        path, t.shape) is not None, tree)


# -- the spawned ranks ---------------------------------------------------------

def _fns_rank(group, path):
    """On (1, 1, 2): each Function's output and input gradient, and the
    one-stage fn's output, input and weight gradients under each policy
    (the norm scales' summed over the model group under sequence
    parallelism, as the runtime sums them)."""
    inp = np.load(path)
    t, tp = group.model_index, group.model
    out = {}
    for name, fn in FNS.items():
        x = torch.from_numpy(inp["fn/x"][t]).requires_grad_(True)
        y = fn(x, tp)
        y.backward(torch.from_numpy(inp[f"fn/{name}/g"][t]))
        out[f"fn/{name}"] = (y.detach().numpy(), x.grad.numpy())
    cfg = _cfg()
    smap = pp_stage.build_stage_map(cfg, 1)
    w0 = pp_stage.local_groups(_params()["groups"], smap, 0,
                               model=(t, 2))[0]
    sharded = tree_leaves(_model_sharded(w0))
    for sp in (False, True):
        for remat in lm.REMAT_POLICIES:
            w = tree_map(lambda a: a.detach().clone().requires_grad_(True),
                         w0)
            x = torch.from_numpy(inp["stage/x"]).requires_grad_(True)
            fn = pp_stage.make_stage_fn(cfg, tp_group=tp,
                                        sequence_parallel=sp, remat=remat)
            y = fn(w, x)
            y.backward(torch.from_numpy(inp["stage/g"]))
            dw = [a.grad if sh or not sp else tp.all_reduce(a.grad)
                  for a, sh in zip(tree_leaves(w), sharded)]
            it = iter(dw)
            out[f"stage/{sp}/{remat}"] = (
                y.detach().numpy(), x.grad.numpy(),
                _flat(tree_map(lambda _: next(it), w0)))
    return out


def _grads_rank(group, path):
    """On (2, 1, 2): every table of ``TABLES``, sequence parallelism off
    and on: the loss, this rank's stage gradients, the head's (last
    stage), and the model group's calls and bytes of each run."""
    inp = np.load(path)
    cfg = _cfg()
    s, t = group.stage, group.model_index
    smap = pp_stage.build_stage_map(cfg, 2)
    params = _params()
    w = pp_stage.local_groups(params["groups"], smap, s, model=(t, 2))[0]
    hp = pp_stage.head_params_of(params) if s == 1 else None
    xs = torch.from_numpy(inp["xs"]) if s == 0 else None
    labels = torch.from_numpy(inp["labels"])
    head_loss = pp_stage.make_head_loss(cfg)
    out = {}
    for sp in (False, True):
        fn = pp_stage.make_stage_fn(cfg, tp_group=group.model,
                                    sequence_parallel=sp)
        for kind, b in TABLES:
            calls0 = dict(group.model.calls)
            bytes0 = dict(group.model.bytes)
            res = runtime.pipeline_train_grads(
                schedules.build(kind, 2, M, bwd_stages=b), fn, w, xs,
                labels, head_loss, group=group, head_params=hp,
                act_shape=((2, SEQ, cfg.d_model), torch.float32),
                sequence_parallel=sp, model_sharded=_model_sharded(w))
            g = res["stage_grads"]
            out[(sp, kind, b)] = {
                "loss": float(res["loss"]),
                "dw": None if tree_leaves(g)[0] is None else _flat(g),
                "head": None if res["head_grads"] is None
                else _flat(res["head_grads"]),
                "calls": {k: (group.model.calls[k] - calls0.get(k, 0),
                              group.model.bytes[k] - bytes0.get(k, 0))
                          for k in group.model.calls
                          if group.model.calls[k] - calls0.get(k, 0)}}
    return out


def _engine_rank(group, zero2_runs):
    """On (2, 2, 2): the engine with sequence parallelism, ZeRO-2 and
    ZeRO-1 (``zero2_runs``), each run's metrics and, on rank 0, the
    gathered final parameters."""
    out = {}
    for zero2 in zero2_runs:
        eng = _engine(group, tensor_parallel=2, sequence_parallel=True,
                      zero2=zero2)
        eng.init_state(0)
        hist = _train(eng, group, STEPS)
        whole = eng.gathered_state()
        out[zero2] = (hist, None if whole is None else _flat(whole["params"]))
    return out


def _ckpt_rank(group, where, one_dir):
    """On (2, 1, 2): 3 steps, a checkpoint at 3 in ``where``, 2 more
    steps; then the one-process checkpoint in ``one_dir`` restored and 2
    steps from it."""
    eng = _engine(group, steps=5)
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


def _compressed_tcfg(method, zero2=False):
    """A compressed run's train-config fields.  ``lowrank`` under ZeRO-2
    trains with SGD momentum: its projection fills a frozen stage's zero
    rows with rounding noise (~1e-9), which AdamW's first update, lr g /
    (|g| + eps), turns into moves of a tenth of lr that differ with the
    data ranks' order of sums; SGD's update is linear in the gradient."""
    out = {"compression": method}
    if zero2 and method == "lowrank":
        out["optimizer"] = "sgdm"
    return out


def _compress_rank(group, methods, schedule, zero2=False):
    """Each method's run (2 steps: depths 4 and 2) of a pipeline engine on
    this grid (under ZeRO-2 with ``zero2``); metrics and, on rank 0, the
    gathered parameters."""
    out = {}
    for method in methods:
        eng = _engine(group, steps=2, pipeline_schedule=schedule,
                      tcfg=_compressed_tcfg(method, zero2), zero2=zero2)
        eng.init_state(0)
        hist = _train(eng, group, 2)
        whole = eng.gathered_state()
        out[method] = (hist, None if whole is None
                       else _flat(whole["params"]))
    return out


def _rank(group, what, *args):
    """The spawned ranks' target."""
    return {"fns": _fns_rank, "grads": _grads_rank, "engine": _engine_rank,
            "ckpt": _ckpt_rank, "compress": _compress_rank}[what](
                group, *args)


def _spawn(grid, what, *args):
    return mesh.spawn(f"{__name__}:_rank", int(np.prod(grid)), what, *args,
                      device="cpu", threads=1, timeout_s=JOIN_S, grid=grid)


# -- the reference, in subprocesses on 2, 4 and 8 virtual devices -----------

_REFERENCE = textwrap.dedent("""
    import os, sys
    part = sys.argv[1]
    n_dev = {"fns": 2, "grads": 4, "engine": 8}[part]
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=%%d" %% n_dev)
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.config import SPBConfig, TrainConfig
    from repro.configs import reduced_config
    from repro.dist import steps as jsteps
    from repro.dist.pipeline import pipeline_train_grads, schedules
    from repro.dist.pipeline import stage as st
    from repro.models import layers as L
    from repro.optim import optimizers

    inp = np.load(sys.argv[2])
    out = {}
    auto = lambda n: (jax.sharding.AxisType.Auto,) * n
    cfg = reduced_config("yi-6b")

    def key(path):
        return "/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in path)

    shapes = jsteps.train_state_shapes(cfg, TrainConfig())["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, x: jnp.asarray(inp["p" + key(p)]), shapes)

    if part == "fns":
        mesh = jax.make_mesh((2,), ("model",), axis_types=auto(1))
        fns = {"tp_psum": lambda x: L.tp_psum(x, "model"),
               "tp_enter": lambda x: L.tp_enter(x, "model"),
               "sp_all_gather": lambda x: L.sp_all_gather(x, "model", 1),
               "sp_reduce_scatter":
                   lambda x: L.sp_reduce_scatter(x, "model", 1),
               "sp_slice": lambda x: L.sp_slice(x, "model", 1),
               "sp_unslice": lambda x: L.sp_unslice(x, "model", 1)}
        for name, fn in fns.items():
            def body(x, g, fn=fn):
                y, vjp = jax.vjp(fn, x[0])
                (dx,) = vjp(g[0])
                return y[None], dx[None]
            y, dx = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=(P("model"), P("model")),
                out_specs=(P("model"), P("model")), check_vma=False))(
                jnp.asarray(inp["fn/x"]),
                jnp.asarray(inp["fn/" + name + "/g"]))
            out["fn/" + name + "/y"] = np.asarray(y)
            out["fn/" + name + "/dx"] = np.asarray(dx)
        mesh = jax.make_mesh((1, 1, 2), ("stage", "data", "model"),
                             axis_types=auto(3))
        stacked = st.stack_stage_params(params["groups"], cfg, 1)
        pspecs = st.stage_param_specs(stacked, mesh=mesh)
        sharded = jax.tree.map(lambda s: "model" in s, pspecs,
                               is_leaf=lambda x: isinstance(x, P))
        for sp in (False, True):
            fn = st.make_stage_fn(cfg, tp_axis="model", sequence_parallel=sp)

            def body(w, x, g, fn=fn, sp=sp):
                y, vjp = jax.vjp(fn, jax.tree.map(lambda t: t[0], w), x)
                dw, dx = vjp(g)
                # the runtime's sum of the norms' partial gradients
                dw = jax.tree.map(
                    lambda t, s: t if s or not sp
                    else jax.lax.psum(t, "model"), dw, sharded)
                return y, jax.tree.map(lambda t: t[None], dw), dx
            y, dw, dx = jax.jit(jax.shard_map(
                body, mesh=mesh, in_specs=(pspecs, P(), P()),
                out_specs=(P(), pspecs, P()), check_vma=False))(
                stacked, jnp.asarray(inp["stage/x"]),
                jnp.asarray(inp["stage/g"]))
            tag = "stage/%%s" %% sp
            out[tag + "/y"] = np.asarray(y)
            out[tag + "/dx"] = np.asarray(dx)
            for p, v in jax.tree_util.tree_leaves_with_path(dw):
                out[tag + "/dw" + key(p)] = np.asarray(v)[0]

    if part == "grads":
        stacked = st.stack_stage_params(params["groups"], cfg, 2)
        hp = st.head_params_of(params)
        head_loss = st.make_head_loss(cfg)
        xs, labels = jnp.asarray(inp["xs"]), jnp.asarray(inp["labels"])
        mesh = jax.make_mesh((2, 1, 2), ("stage", "data", "model"),
                             axis_types=auto(3))
        pspecs = st.stage_param_specs(stacked, mesh=mesh)
        for sp in (False, True):
            fn = st.make_stage_fn(cfg, tp_axis="model", sequence_parallel=sp)
            for kind, b in %(tables)r:
                sched = schedules.build(kind, 2, xs.shape[0], bwd_stages=b)
                with jax.sharding.set_mesh(mesh):
                    res = jax.jit(lambda p, x, t, h: pipeline_train_grads(
                        sched, fn, p, x, t, head_loss, head_params=h,
                        param_specs=pspecs, tensor_axis="model",
                        sequence_parallel=sp))(stacked, xs, labels, hp)
                tag = "%%s/%%s/%%d" %% (sp, kind, b)
                out[tag + "/loss"] = np.asarray(res["loss"])
                for p, v in jax.tree_util.tree_leaves_with_path(
                        res["stage_grads"]):
                    out[tag + "/dw" + key(p)] = np.asarray(v)
                for p, v in jax.tree_util.tree_leaves_with_path(
                        res["head_grads"]):
                    out[tag + "/head" + key(p)] = np.asarray(v)

    if part == "engine":
        from repro.engine import SPBEngine
        from repro.launch.mesh import make_pipeline_mesh
        steps = int(inp["steps"])
        tcfg = TrainConfig(num_steps=steps, microbatches=%(m)d)
        eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal", k=4),
                        mesh=make_pipeline_mesh(2, data_parallel=2,
                                                model_parallel=2),
                        parallelism="pipeline", sequence_parallel=True,
                        zero2=True)
        eng.attach_state({"params": params,
                          "opt": optimizers.init_opt_state(params, tcfg),
                          "step": jnp.zeros((), jnp.int32)})
        for s in range(steps):
            m = eng.train_step({"tokens": inp["tokens%%d" %% s],
                                "labels": inp["labels%%d" %% s]}, s)
            for kk, v in m.items():
                out["m%%d/%%s" %% (s, kk)] = np.asarray(v)
        for p, v in jax.tree_util.tree_leaves_with_path(eng.state["params"]):
            out["p" + key(p)] = np.asarray(v)
    np.savez(sys.argv[3], **out)
""") % {"tables": TABLES, "m": M}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    where = tmp_path_factory.mktemp("tp_inputs") / "in.npz"
    np.savez(where, **_inputs())
    return where


@pytest.fixture(scope="module", autouse=True)
def reference(inputs):
    """Starts the reference's three parts when the module starts; the
    returned callable waits for them and gives their outputs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    tmp = inputs.parent
    parts = ("fns", "grads", "engine")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, part, str(inputs),
         str(tmp / f"ref_{part}.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in parts]
    done = {}

    def result():
        if not done:
            for part, proc in zip(parts, procs):
                _, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-3000:]
                done.update(np.load(tmp / f"ref_{part}.npz"))
        return done

    yield result
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


@pytest.fixture(scope="module")
def one_ckpt(tmp_path_factory):
    """One process's run: a checkpoint at step 3 and the 2 steps after."""
    where = tmp_path_factory.mktemp("tp_one_ckpt")
    eng = _engine(steps=5)
    eng.init_state(0)
    _train(eng, None, 3)
    CheckpointManager(where, async_write=False).save(eng.gathered_state(), 3)
    return where, [m["xent"] for m in _train(eng, None, 2, start=3)]


@pytest.fixture(scope="module", autouse=True)
def runs(reference, inputs, one_ckpt, tmp_path_factory):
    """Every spawned run of the module, started together, a few at a
    time (the reference's subprocesses are already running)."""
    pipe_ckpt = tmp_path_factory.mktemp("tp_pipe_ckpt")
    with ThreadPoolExecutor(3) as pool:
        out = {"engine": pool.submit(_spawn, (2, 2, 2), "engine",
                                     (True, False)),
               "grads": pool.submit(_spawn, (2, 1, 2), "grads",
                                    str(inputs)),
               "fns": pool.submit(_spawn, (1, 1, 2), "fns", str(inputs)),
               "ckpt": pool.submit(_spawn, (2, 1, 2), "ckpt",
                                   str(pipe_ckpt), str(one_ckpt[0])),
               "compress_tp": pool.submit(_spawn, (2, 1, 2), "compress",
                                          ("topk",), "1f1b")}
        for kind in ("1f1b", "gpipe"):
            out[f"compress_{kind}"] = pool.submit(
                _spawn, (2, 1, 1), "compress", COMPRESSIONS, kind)
        for grid in ZERO2_GRIDS:
            out["compress_zero2_%d%d%d" % grid] = pool.submit(
                _spawn, grid, "compress", COMPRESSIONS, "1f1b", True)
        out["pipe_ckpt"] = pipe_ckpt
        yield out


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


# -- the collective Functions and the stage fns --------------------------------

@pytest.mark.parametrize("name", list(FNS))
def test_collective_functions_equal_the_references(name, runs, reference):
    """Each rank's output and input gradient against the reference's
    ``custom_vjp`` under ``shard_map`` on 2 devices, at 1e-5."""
    ranks = runs["fns"].result()
    ref = reference()
    for t, out in enumerate(ranks):
        y, dx = out[f"fn/{name}"]
        _close(y, ref[f"fn/{name}/y"][t], msg=f"{name} y rank {t}")
        _close(dx, ref[f"fn/{name}/dx"][t], msg=f"{name} dx rank {t}")


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "tp_sp"])
def test_stage_fn_over_the_model_axis_equals_the_references(sp, runs,
                                                             reference):
    """``make_stage_fn(tp_group=)`` on 2 model ranks: the output, the input
    gradient and each rank's shard of the weight gradients against the
    reference's ``make_stage_fn(tp_axis="model")``, at 1e-5, under every
    recompute policy (which change no number)."""
    ranks = runs["fns"].result()
    ref = reference()
    for t, out in enumerate(ranks):
        y0, dx0, dw0 = out[f"stage/{sp}/none"]
        _close(y0, ref[f"stage/{sp}/y"])
        _close(dx0, ref[f"stage/{sp}/dx"])
        for k, v in dw0.items():
            want = torch.from_numpy(ref[f"stage/{sp}/dw{k}"])
            want = pp_stage.model_shard(want, tuple(k.strip("/").split("/")),
                                        (t, 2)).numpy()
            _close(v, want, msg=k)
        for remat in lm.REMAT_POLICIES[1:]:
            y, dx, dw = out[f"stage/{sp}/{remat}"]
            assert np.array_equal(y, y0) and np.array_equal(dx, dx0)
            assert all(np.array_equal(dw[k], dw0[k]) for k in dw0)


# -- the (2, 1, 2) grid's gradients -------------------------------------------

def _oracle():
    """The port's ``sequential_reference`` over the whole weights (no
    tensor parallelism): the loss and the gradients of the stage-stacked
    weights and of the head."""
    inp = {k: v for k, v in _inputs().items() if k in ("xs", "labels")}
    cfg = _cfg()
    params = _params()
    stacked = tree_map(lambda t: t.detach().requires_grad_(True),
                       pp_stage.stack_stage_params(params["groups"], cfg, 2))
    hp = tree_map(lambda t: t.detach().requires_grad_(True),
                  pp_stage.head_params_of(params))
    head_loss = pp_stage.make_head_loss(cfg)
    ys = runtime.sequential_reference(pp_stage.make_stage_fn(cfg), stacked,
                                      torch.from_numpy(inp["xs"]))
    labels = torch.from_numpy(inp["labels"])
    loss = torch.stack([head_loss(hp, ys[m], labels[m])
                        for m in range(M)]).mean()
    loss.backward()
    return (float(loss.detach()),
            _flat(tree_map(lambda t: t.grad, stacked)),
            _flat(tree_map(lambda t: t.grad, hp)))


@pytest.mark.parametrize("table", TABLES, ids=lambda t: "%s_b%d" % t)
@pytest.mark.parametrize("sp", [False, True], ids=["tp", "tp_sp"])
def test_tp_pipeline_grads_equal_the_oracle_and_the_reference(
        sp, table, runs, reference):
    """The reference's ``_TP_GRAD_SCRIPT`` case on (stage 2, data 1, model
    2): the loss within 1e-6 and each rank's shard of the stage gradients
    and the head's within 1e-5 of the oracle (live stages) and of the
    reference's ``pipeline_train_grads``; a frozen stage has none."""
    kind, b = table
    ranks = runs["grads"].result()
    ref = reference()
    want_l, want_w, want_h = _oracle()
    tag = f"{sp}/{kind}/{b}"
    for r, out in enumerate(ranks):
        s, t = divmod(r, 2)
        got = out[(sp, kind, b)]
        np.testing.assert_allclose(got["loss"], want_l, rtol=1e-6)
        np.testing.assert_allclose(got["loss"], float(ref[tag + "/loss"]),
                                   rtol=1e-6)
        if s < 2 - b:
            assert got["dw"] is None            # exactly zero: no gradient
            assert np.all(np.concatenate([
                v[s].ravel() for k, v in ref.items()
                if k.startswith(tag + "/dw")]) == 0)
            continue
        for k, v in got["dw"].items():
            path = tuple(k.strip("/").split("/"))
            for want in (want_w[k], ref[tag + "/dw" + k]):
                shard = pp_stage.model_shard(torch.from_numpy(want[s]),
                                             path, (t, 2)).numpy()
                _close(v, shard, msg=f"{tag} rank {r} {k}")
        if s == 1:
            for k, v in got["head"].items():
                _close(v, want_h[k], msg=k)
                _close(v, ref[tag + "/head" + k], msg=k)


@pytest.mark.parametrize("sp", [False, True], ids=["tp", "tp_sp"])
def test_model_group_calls_equal_the_count(sp, runs):
    """Each rank's model-group calls and payload bytes of each table equal
    ``roofline.pipeline_tp_calls`` (f32, microbatches of 2 rows x 32; the
    schedule alone, no update's norm)."""
    cfg = _cfg()
    ranks = runs["grads"].result()
    for r, out in enumerate(ranks):
        s = r // 2
        for kind, b in TABLES:
            live = s >= 2 - b
            want = roofline.pipeline_tp_calls(
                cfg, 2, M, 2, SEQ, model_parallel=2, live=live,
                need_dx=s > 0 and (s - 1) >= 2 - b, sequence_parallel=sp,
                update=False)
            assert out[(sp, kind, b)]["calls"] == want, (r, kind, b)


# -- the engine on the (2, 2, 2) grid -------------------------------------------

def test_tp_sp_zero2_engine_equals_the_reference_and_one_process(runs,
                                                                reference):
    ranks = runs["engine"].result()
    hist, params = ranks[0][True]
    assert all(out[True][0] == hist for out in ranks)
    assert all(out[True][1] is None for out in ranks[1:])
    assert [m["depth"] for m in hist] == list(DEPTHS)
    ref = reference()
    one = _engine()
    one.init_state(0)
    one_hist = _train(one, None, STEPS)
    assert [m["depth"] for m in one_hist] == list(DEPTHS)
    for s, m in enumerate(hist):
        for k in ("loss", "xent", "moe_aux", "grad_norm", "lr"):
            _close(m[k], float(ref[f"m{s}/{k}"]), msg=f"step {s} {k}")
            _close(m[k], one_hist[s][k], msg=f"step {s} {k}")
    mine = _flat(one.state["params"])
    for k, v in params.items():
        _close(v, ref["p" + k], msg=k)
        _close(v, mine[k], msg=k)


def test_zero2_equals_zero1_on_the_grid(runs):
    """The same grid without ``zero2`` (ZeRO-1): the losses equal, the
    final parameters within 1e-6 (only the gradient norm's order of sums
    differs: ZeRO-2 sums the data shards' squares)."""
    z2, z1 = runs["engine"].result()[0][True], runs["engine"].result()[0][
        False]
    assert [m["xent"] for m in z2[0]] == [m["xent"] for m in z1[0]]
    for k, v in z2[1].items():
        np.testing.assert_allclose(v, z1[1][k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


# -- checkpoints -----------------------------------------------------------------

def test_a_tp_pipelines_checkpoint_restores_into_one_process_and_back(
        runs, one_ckpt):
    where, one_cont = one_ckpt
    cont, from_one = runs["ckpt"].result()[0]
    _close(cont, one_cont)
    _close(from_one, one_cont)
    eng = _engine(steps=5)
    state, step = CheckpointManager(runs["pipe_ckpt"]).restore(
        eng.state_shapes, 3)
    assert step == 3
    eng.attach_state(state)
    _close([m["xent"] for m in _train(eng, None, 2, start=3)], cont)


# -- compression under a pipeline -------------------------------------------------

def _one_compressed(method, zero2=False):
    eng = _engine(steps=2, tcfg=_compressed_tcfg(method, zero2))
    eng.init_state(0)
    return _train(eng, None, 2), _flat(eng.state["params"])


@pytest.mark.parametrize("case", [(m, k, (2, 1, 1)) for m in COMPRESSIONS
                                  for k in ("1f1b", "gpipe")]
                         + [("topk", "1f1b", (2, 1, 2))]
                         + [(m, "1f1b", g, True) for g in ZERO2_GRIDS
                            for m in COMPRESSIONS],
                         ids=lambda c: "%s_%s_%d%d%d" % ((c[0], c[1]) + c[2])
                         + ("_zero2" if c[3:] else ""))
def test_compression_under_a_pipeline_equals_one_process(case, runs):
    """Two steps (depths 4 and 2: the second truncates the first stage)
    of a compressed pipeline against one process's compressed step:
    metrics and parameters within 1e-5.  Under ZeRO-2 the stage
    gradients are gathered over the data axis before the compressor."""
    method, kind, grid = case[:3]
    if case[3:]:
        key = "compress_zero2_%d%d%d" % grid
    else:
        key = "compress_tp" if grid[2] == 2 else f"compress_{kind}"
    hist, params = runs[key].result()[0][method]
    want_hist, want = _one_compressed(method, bool(case[3:]))
    assert [m["depth"] for m in hist] == [4, 2]
    for s, m in enumerate(hist):
        for k in ("loss", "xent", "grad_norm"):
            _close(m[k], want_hist[s][k], msg=f"step {s} {k}")
    for k, v in params.items():
        _close(v, want[k], msg=k)


# -- the train entry point ---------------------------------------------------------

def test_train_entry_compresses_under_zero2(tmp_path):
    """``--pipeline-data-parallel 2 --zero2 --compression topk`` over 2
    stages: one process's compressed xent, and the final checkpoint
    restores into one process with its parameters."""
    argv = ["--parallelism", "pipeline", "--pipeline-stages", "2",
            "--pipeline-data-parallel", "2", "--zero2",
            "--compression", "topk", "--microbatches", str(M),
            "--spb-mode", "temporal", "--device", "cpu", "--steps", "2",
            "--batch", str(B), "--seq", str(SEQ), "--use-pallas",
            "--log-every", "100", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "2"]
    got = train.train(argv)
    one = _engine(steps=2, tcfg={"compression": "topk"})
    one.init_state(0)
    _close(got, [m["xent"] for m in _train(one, None, 2)])
    state, step = CheckpointManager(tmp_path).restore(one.state_shapes, 2)
    assert step == 2
    want = _flat(one.state["params"])
    for k, v in _flat(state["params"]).items():
        _close(v, want[k], msg=k)


@pytest.mark.parametrize("flags", [[], ["--sequence-parallel"],
                                   ["--sequence-parallel",
                                    "--pipeline-data-parallel", "2",
                                    "--zero2"]],
                         ids=["tp", "tp_sp", "tp_sp_zero2"])
def test_train_entry_runs_tensor_parallel_stages(flags, tmp_path):
    """``--tensor-parallel 2`` over spawned ranks: one process's xent, and
    the final checkpoint restores into one process with its parameters."""
    argv = ["--parallelism", "pipeline", "--pipeline-stages", "2",
            "--tensor-parallel", "2", "--microbatches", str(M),
            "--spb-mode", "temporal", "--device", "cpu", "--steps", "2",
            "--batch", str(B), "--seq", str(SEQ), "--use-pallas",
            "--log-every", "100", "--checkpoint-dir", str(tmp_path),
            "--checkpoint-every", "2", *flags]
    got = train.train(argv)
    one = _engine(steps=2)
    one.init_state(0)
    _close(got, [m["xent"] for m in _train(one, None, 2)])
    state, step = CheckpointManager(tmp_path).restore(one.state_shapes, 2)
    assert step == 2
    want = _flat(one.state["params"])
    for k, v in _flat(state["params"]).items():
        _close(v, want[k], msg=k)
