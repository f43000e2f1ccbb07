"""Expert parallelism on a ``(data, model)`` grid on the CPU
(``models/moe.moe_fwd_ep``, ``models/layers.py``'s exchange and aux mean,
``dist/group.ModelGroup.all_to_all`` and ``GridGroup``,
``launch/mesh.init_grid_group``, ``dist/sharding.grid_state_pspec``,
``dist/steps.py``'s model-group sums and grid norm, ``SPBEngine(group=
<GridGroup>)``, the cached modes' expert route on the serving grid's
layout (``bridge.serve_params_from_numpy``) and the dry run's
``--model-parallel``).

The ranks are spawned (``launch/mesh.spawn(..., grid=(D, T))``, one
intra-op thread each); their target is this module's
:func:`_rank`, and the module imports JAX only inside the tests, so a
spawned rank does not load it.  Every run starts at the first test that
reads the runs, beside two subprocesses that run the reference on 8 and 4
virtual CPU devices.  f32 throughout.

* The layer: ``moe_fwd_ep`` over (D, T) of (1, 1), (2, 1), (1, 2), (2, 2),
  (1, 4) and (2, 4) against the reference's ``moe_fwd_ep`` on the same
  mesh (the host mesh at T = 1): the output, aux, and the gradients of a
  fixed linear functional of the output plus aux with respect to x, the
  router, the experts and the shared expert, at 1e-5, at capacity 1.25
  (some slots dropped) and 8.0, and on the small path (fewer than 4 T
  tokens a data index).
* The step: reduced deepseek-v2-lite-16b and qwen3-moe-235b-a22b with
  ``impl="ep"`` on (1, 2) and (2, 2), temporal k 2, two steps of SGD with
  momentum (:data:`OPT`): losses,
  moe_aux, grad norms and the final f32 parameters against the
  reference's ``SPBEngine`` on the same mesh at 1e-5; the model group's
  calls and bytes a step equal ``analysis/roofline.ep_calls``; every
  rank's non-expert leaves are bit-identical.  Compressed (``topk``,
  ``randk``, ``lowrank``) on both grids: the same against the reference's
  compressed step on the same mesh, ``randk`` and ``lowrank`` drawing
  there from the port's generator.  AdamW, the default, on
  (1, 2) for qwen3-reduced (:data:`ADAMW_CASE`): losses, grad norms and
  both moments at 1e-5, the parameters at 1e-5 where the first gradient
  is not within rounding of zero and within AdamW's step elsewhere.
* A grid checkpoint restores into one process; prefill and decode over a
  grid equal one process's dense path at capacity 8.
* The dry run's ``--model-parallel 2`` counts the all-to-all bytes of the
  formula exactly.
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

from repro_torch import bridge
from repro_torch.analysis import cost, roofline
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist import sharding
from repro_torch.dist import steps as steps_lib
from repro_torch.dist.group import GridGroup, ModelGroup
from repro_torch.engine.engine import SPBEngine
from repro_torch.launch import dryrun, mesh
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.models import moe
from repro_torch.optim import optimizers
from repro_torch.tree import tree_leaves, tree_map

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JOIN_S = 420.0
LAYER_ARCH = "deepseek-v2-lite-16b"       # 4 experts, top 2, 1 shared
LAYER_GRIDS = ((1, 1), (2, 1), (1, 2), (2, 2), (1, 4), (2, 4))
CAPACITIES = (1.25, 8.0)
# (capacity, small path): the routed path at each capacity; the small one
# drops nothing, so one capacity
LAYER_CASES = ((1.25, False), (8.0, False), (8.0, True))
XB, XS = 4, 16                            # the layer's x: 4 rows of 16
STEP_ARCHS = ("deepseek-v2-lite-16b", "qwen3-moe-235b-a22b")
STEP_GRIDS = ((1, 2), (2, 2))
COMPRESSIONS = ("topk", "randk", "lowrank")
B, SEQ, STEPS = 4, 32, 2
# the steps' optimizer: SGD with momentum, whose update is linear in the
# gradient, so the parameters show a gradient's rounding as it is.  AdamW's
# first update, lr g / (|g| + eps), turns the rounding of a gradient
# element near zero into up to 2 lr (one element of qwen3's table on
# (1, 2) lands 1.4e-5 from the reference's under AdamW), so AdamW has a
# case of its own that compares such elements within that bound
OPT = "sgdm"
ADAMW_CASE = ("qwen3-moe-235b-a22b", (1, 2))
# a first-step gradient element at most this far from zero is within its
# rounding of it for AdamW's sign-like first update
NEAR_ZERO_G = 1e-6
# the first two depths of the temporal k 2 cycle
DEPTHS = {"deepseek-v2-lite-16b": [3, 2], "qwen3-moe-235b-a22b": [4, 2]}


def _ep_cfg(arch, **moe_kw):
    cfg = reduced_config(arch)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl="ep", **moe_kw))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: None if tree is None else np.asarray(
        tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def _params(arch):
    return lm.init_lm(torch.Generator().manual_seed(0), _ep_cfg(arch), "cpu")


def _layer_params():
    """One MoE layer of the layer arch (the first MoE group's row 0)."""
    return tree_map(lambda t: t[0], _params(LAYER_ARCH)["groups"][1][0]["ffn"])


def _inputs():
    """Every array the port's ranks and the reference read, from seeded
    numpy generators and the port's seeded init."""
    rng = np.random.default_rng(0)
    d = reduced_config(LAYER_ARCH).d_model
    arr = {"layer/p" + k: v for k, v in _flat(_layer_params()).items()}
    # shifted toward expert 0's router column, so that capacity 1.25 drops
    # slots on every grid
    r0 = arr["layer/p/router"][:, 0]
    arr["layer/x"] = (rng.standard_normal((XB, XS, d)) * 0.5
                      + 0.5 * r0 / np.linalg.norm(r0)).astype(np.float32)
    arr["layer/w"] = rng.standard_normal((XB, XS, d)).astype(np.float32)
    for arch in STEP_ARCHS:
        arr.update({f"{arch}/p" + k: v
                    for k, v in _flat(_params(arch)).items()})
        pipe = Pipeline(_ep_cfg(arch), B, SEQ, seed=0)
        for s in range(STEPS):
            b = pipe.get_batch(s)
            arr[f"{arch}/tokens{s}"] = b["tokens"].numpy()
            arr[f"{arch}/labels{s}"] = b["labels"].numpy()
    return arr


def _layer_x(inp, small):
    """The layer's x and w: the small path takes one position of 2 rows,
    so a data index routes 2 / D tokens, fewer than 4 T for every grid."""
    x, w = inp["layer/x"], inp["layer/w"]
    return (x[:2, :1], w[:2, :1]) if small else (x, w)


# -- the spawned ranks ---------------------------------------------------------

def _layer_rank(group, path):
    """On (D, T): ``moe_fwd_ep`` at each capacity and on the small path:
    this rank's output, aux, dropped slots and gradients (of ``sum(out *
    w) + aux / D``, this data index's share of the reference's functional
    ``sum(out * w) + mean aux``)."""
    inp = np.load(path)
    D = group.data.size if isinstance(group, GridGroup) else group.size
    d = group.data_index if isinstance(group, GridGroup) else group.rank
    model = group.model if isinstance(group, GridGroup) else ModelGroup()
    T = model.size
    whole = {k[len("layer/p"):]: v for k, v in inp.items()
             if k.startswith("layer/p")}
    out = {}
    for cap in CAPACITIES:
        cfg = _ep_cfg(LAYER_ARCH, capacity_factor=cap)
        for small in (False, True):
            if small and cap != CAPACITIES[-1]:
                continue
            x, w = _layer_x(inp, small)
            rows = x.shape[0] // D
            p = {}
            for k, v in whole.items():
                t = torch.from_numpy(v)
                if k.split("/")[1] in ("wg", "wu", "wd"):
                    held = t.shape[0] // T
                    t = t[model.rank * held:(model.rank + 1) * held]
                p[k] = t.clone().requires_grad_(True)
            tree = {"router": p["/router"], "wg": p["/wg"], "wu": p["/wu"],
                    "wd": p["/wd"], "shared": {
                        n: p[f"/shared/{n}"] for n in ("wg", "wu", "wd")}}
            xd = torch.from_numpy(x[d * rows:(d + 1) * rows]).requires_grad_(
                True)
            drops = []
            moe.DROP_SINKS.append(lambda n, _k: drops.append(int(n)))
            try:
                y, aux = moe.moe_fwd_ep(tree, xd, cfg, group=model)
            finally:
                moe.DROP_SINKS.pop()
            wd = torch.from_numpy(w[d * rows:(d + 1) * rows])
            ((y * wd).sum() + aux / D).backward()
            out[(cap, small)] = {
                "y": y.detach().numpy(), "aux": float(aux),
                "dx": xd.grad.numpy(), "drops": sum(drops),
                "g": {k: t.grad.numpy() for k, t in p.items()}}
    return out


def _engine(cfg, group=None, steps=STEPS, opt=OPT, compression="none"):
    spb = SPBConfig(mode="temporal", k=2)
    tcfg = TrainConfig(num_steps=steps, optimizer=opt,
                       compression=compression)
    if group is None:
        return SPBEngine(cfg, tcfg, spb, device="cpu")
    return SPBEngine(cfg, tcfg, spb, group=group)


def _whole_state(arch, opt=OPT):
    params = _params(arch)
    return steps_lib.state_from_params(params, TrainConfig(optimizer=opt))


def _run_steps(eng, group, inp, arch):
    """Two steps of ``eng`` on ``arch``'s batches: each step's metrics,
    depth, and the model group's calls and bytes."""
    hist = []
    for s in range(STEPS):
        batch = group.shard({
            "tokens": torch.from_numpy(inp[f"{arch}/tokens{s}"]),
            "labels": torch.from_numpy(inp[f"{arch}/labels{s}"])})
        c0, b0 = dict(group.model.calls), dict(group.model.bytes)
        m = eng.train_step(batch, s)
        hist.append({**{k: float(v) for k, v in m.items()},
                     "depth": eng.last_depth,
                     "calls": {k: (group.model.calls[k] - c0.get(k, 0),
                                   group.model.bytes[k] - b0.get(k, 0))
                               for k in group.model.calls
                               if group.model.calls[k] - c0.get(k, 0)}})
    return hist


def _step_rank(group, path, ckpt_dir):
    """On (D, T): each step arch's engine from the port's seeded params,
    two temporal steps: the metrics, the model group's calls and bytes a
    step, this rank's replicated leaves and, on rank 0, the gathered
    whole parameters.  Rank 0 writes the gathered state of the first arch
    to ``ckpt_dir``.  On (1, 2) also prefill and decode at capacity 8."""
    inp = np.load(path)
    out = {}
    for arch in STEP_ARCHS:
        cfg = _ep_cfg(arch)
        eng = _engine(cfg, group)
        eng.attach_state(_whole_state(arch))
        hist = _run_steps(eng, group, inp, arch)
        roles = steps_lib.ep_roles(cfg)
        replicated = {k: v for (k, v), r in zip(
            _flat(eng.state["params"]).items(), tree_leaves(roles))
            if r != "expert"}
        whole = eng.gathered_state()
        if whole is not None and arch == STEP_ARCHS[0]:
            CheckpointManager(ckpt_dir, async_write=False).save(whole, STEPS)
        out[arch] = {"hist": hist, "replicated": replicated,
                     "whole": None if whole is None
                     else _flat(whole["params"]),
                     "whole_opt": None if whole is None
                     else _flat(whole["opt"])}
    if group.data.size == 1:
        out["serve"] = _serve_on_grid(group)
    return out


def _adamw_rank(group, path):
    """On :data:`ADAMW_CASE`'s grid: its arch's two steps under AdamW: the
    metrics and, on rank 0, the gathered whole parameters and moments."""
    inp = np.load(path)
    arch = ADAMW_CASE[0]
    eng = _engine(_ep_cfg(arch), group, opt="adamw")
    eng.attach_state(_whole_state(arch, "adamw"))
    hist = _run_steps(eng, group, inp, arch)
    whole = eng.gathered_state()
    return {"hist": hist, "whole": None if whole is None else
            {"params": _flat(whole["params"]), "opt": _flat(whole["opt"])}}


def _compress_rank(group, path):
    """On (D, T): each step arch under each compressor, two temporal
    steps: the metrics and, on rank 0, the gathered whole parameters."""
    inp = np.load(path)
    out = {}
    for arch in STEP_ARCHS:
        for method in COMPRESSIONS:
            eng = _engine(_ep_cfg(arch), group, compression=method)
            eng.attach_state(_whole_state(arch))
            hist = _run_steps(eng, group, inp, arch)
            whole = eng.gathered_state()
            out[(arch, method)] = {"hist": hist, "whole": None if whole is
                                   None else _flat(whole["params"])}
    return out


def _serve_on_grid(group):
    """Prefill 12 positions of 2 rows and decode 2 tokens over the grid's
    model group, at capacity 8 (nothing dropped), with the serving grid's
    layout (the experts and the dense FFN's columns over ``model``): the
    logits."""
    arch = STEP_ARCHS[0]
    cfg = _ep_cfg(arch, capacity_factor=8.0)
    t, T = group.model_index, group.model.size
    whole = tree_map(lambda v: v.detach(), _params(arch))
    params = bridge.serve_params_from_numpy(
        tree_map(lambda v: v.numpy(), whole), cfg, (t, T))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 14)))
    cache = lm.init_cache(cfg, 2, 16)
    logits = []
    with torch.no_grad():
        lg, cache = lm.prefill(params, {"tokens": tokens[:, :12]}, cfg,
                               cache, tp=group.model)
        logits.append(lg.numpy())
        for i in (12, 13):
            lg, cache = lm.decode_step(params, cache, tokens[:, i:i + 1],
                                       cfg, tp=group.model)
            logits.append(lg.numpy())
    return logits


def _restore_rank(group, ckpt_dir):
    """A grid checkpoint restored into this grid: rank 0's gathered state
    (parameters and optimizer state) and every rank's loss of one step
    from it."""
    arch = STEP_ARCHS[0]
    cfg = _ep_cfg(arch)
    eng = _engine(cfg, group, steps=STEPS + 1)
    state, step = CheckpointManager(ckpt_dir).restore(eng.state_shapes)
    eng.attach_state(state)
    whole = eng.gathered_state()
    pipe = Pipeline(cfg, B, SEQ, seed=0)
    m = eng.train_step(group.shard(pipe.get_batch(step)), step)
    return {"loss": float(m["loss"]), "whole": None if whole is None else
            {**_flat(whole["params"]), **_flat(whole["opt"])}}


def _rank(group, what, *args):
    """The spawned ranks' target."""
    return {"layer": _layer_rank, "step": _step_rank, "adamw": _adamw_rank,
            "restore": _restore_rank, "compress": _compress_rank}[what](
                group, *args)


def _spawn(grid, what, *args):
    return mesh.spawn(f"{__name__}:_rank", int(np.prod(grid)), what, *args,
                      device="cpu", threads=1, timeout_s=JOIN_S, grid=grid)


# -- the reference, in subprocesses on 8 and 4 virtual devices ---------------

_REFERENCE = textwrap.dedent("""
    import os, sys, dataclasses
    part = sys.argv[1]
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=%%d"
        %% {"layer": 8, "engine": 4}[part])
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.config import SPBConfig, TrainConfig
    from repro.configs import reduced_config
    from repro.dist import steps as jsteps
    from repro.models import moe as jmoe
    from repro.optim import optimizers

    inp = np.load(sys.argv[2])
    out = {}
    auto = lambda n: (jax.sharding.AxisType.Auto,) * n

    def key(path):
        return "/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                              for k in path)

    def grid_mesh(D, T):
        return jax.make_mesh((D, T), ("data", "model"), axis_types=auto(2),
                             devices=jax.devices()[:D * T])

    def ep_cfg(arch, **kw):
        cfg = reduced_config(arch)
        return cfg.scaled(moe=dataclasses.replace(cfg.moe, impl="ep", **kw))

    if part == "layer":
        p = jax.tree_util.tree_map_with_path(
            lambda q, v: jnp.asarray(inp["layer/p" + key(q)]),
            jmoe.init_moe(jax.random.key(0), ep_cfg(%(arch)r), jnp.float32))
        for D, T in %(grids)r:
            for cap in %(caps)r:
                cfg = ep_cfg(%(arch)r, capacity_factor=cap)
                for small in (False, True):
                    if small and cap != %(caps)r[-1]:
                        continue
                    x, w = inp["layer/x"], inp["layer/w"]
                    if small:
                        x, w = x[:2, :1], w[:2, :1]
                    x, w = jnp.asarray(x), jnp.asarray(w)

                    def f(pp, xx, cfg=cfg, w=w):
                        y, aux = jmoe.moe_fwd_ep(
                            pp, xx, cfg, ep_axis="model",
                            dp_spec=P("data", None, None))
                        return jnp.sum(y * w) + aux, (y, aux)
                    with jax.sharding.set_mesh(grid_mesh(D, T)):
                        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                            f, argnums=(0, 1), has_aux=True))(p, x)
                    tag = "layer/%%d%%d/%%s/%%d" %% (D, T, cap, small)
                    out[tag + "/y"] = np.asarray(y)
                    out[tag + "/aux"] = np.asarray(aux)
                    out[tag + "/dx"] = np.asarray(gx)
                    for q, v in jax.tree_util.tree_leaves_with_path(gp):
                        out[tag + "/g" + key(q)] = np.asarray(v)

    def leaves(tree, tag):
        for q, v in jax.tree_util.tree_leaves_with_path(tree):
            out[tag + key(q)] = np.asarray(v)

    if part == "engine":
        from repro.engine import SPBEngine
        cases = [(arch, grid, %(opt)r) for arch in %(archs)r
                 for grid in %(step_grids)r]
        cases.append(%(adamw)r + ("adamw",))
        for arch, (D, T), opt in cases:
            cfg = ep_cfg(arch)
            shapes = jsteps.train_state_shapes(cfg, TrainConfig())["params"]
            # each engine donates its state: fresh arrays each
            params = jax.tree_util.tree_map_with_path(
                lambda q, x: jnp.asarray(inp[arch + "/p" + key(q)]), shapes)
            tcfg = TrainConfig(num_steps=%(steps)d, optimizer=opt)
            eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal", k=2),
                            mesh=grid_mesh(D, T))
            eng.attach_state({"params": params,
                              "opt": optimizers.init_opt_state(params, tcfg),
                              "step": jnp.zeros((), jnp.int32)})
            tag = "%%s/%%d%%d" %% (arch, D, T)
            if opt != %(opt)r:
                tag += "/" + opt
            for s in range(%(steps)d):
                m = eng.train_step(
                    {"tokens": inp[arch + "/tokens%%d" %% s],
                     "labels": inp[arch + "/labels%%d" %% s]}, s)
                for kk, v in m.items():
                    out[tag + "/m%%d/%%s" %% (s, kk)] = np.asarray(v)
                if opt == "adamw" and s == 0:
                    leaves(eng.state["opt"]["mu"], tag + "/mu0")
            leaves(eng.state["params"], tag + "/p")
            if opt == "adamw":
                leaves(eng.state["opt"], tag + "/opt")

    if part == "engine":
        # compressed: the step the engine jits (make_train_step), its
        # gradient jitted on the mesh and its _finish_step (the compressor,
        # the optimizer) run eagerly, since the reference's topk does not
        # jit; randk and lowrank take the port's draw at the step, which
        # jax.random's cannot match
        import torch
        from repro.core import compress as jcompress
        from repro.core import spb as jspb
        from repro_torch.config import TrainConfig as TTrain
        from repro_torch.core import compress as tcompress
        from repro_torch.dist import steps as tsteps
        real, at = jcompress.compress_tree, {}

        def ported(grads, method, ratio, rng_key):
            if method == "topk":
                return real(grads, method, ratio, rng_key)
            got = tcompress.compress_tree(
                jax.tree.map(lambda g: torch.from_numpy(np.array(g)), grads),
                method, ratio, tsteps.compression_generator(
                    TTrain(seed=at["seed"]), at["step"]))
            return jax.tree.map(lambda t: jnp.asarray(t.numpy()), got)

        jcompress.compress_tree = ported
        spb = SPBConfig(mode="temporal", k=2)
        for arch in %(archs)r:
            cfg = ep_cfg(arch)
            shapes = jsteps.train_state_shapes(cfg, TrainConfig())["params"]
            sched = jspb.make_schedule(cfg, spb)
            for D, T in %(step_grids)r:
                grad_fns = {}
                for method in %(methods)r:
                    tcfg = TrainConfig(num_steps=%(steps)d, optimizer=%(opt)r,
                                       compression=method)
                    params = jax.tree_util.tree_map_with_path(
                        lambda q, x: jnp.asarray(inp[arch + "/p" + key(q)]),
                        shapes)
                    state = {"params": params,
                             "opt": optimizers.init_opt_state(params, tcfg),
                             "step": jnp.zeros((), jnp.int32)}
                    tag = "%%s/%%d%%d/%%s" %% (arch, D, T, method)
                    for s in range(%(steps)d):
                        depth = sched.depth_at(s)
                        if depth not in grad_fns:
                            grad_fns[depth] = jax.jit(jsteps._grad_fn(cfg,
                                                                      depth))
                        with jax.sharding.set_mesh(grid_mesh(D, T)):
                            (_, metrics), grads = grad_fns[depth](
                                state["params"],
                                {"tokens": inp[arch + "/tokens%%d" %% s],
                                 "labels": inp[arch + "/labels%%d" %% s]})
                        host = lambda t: jnp.asarray(np.asarray(t))
                        at.update(seed=tcfg.seed, step=s)
                        state, m = jsteps._finish_step(
                            jax.tree.map(host, state), jax.tree.map(
                                host, grads), jax.tree.map(host, metrics),
                            tcfg, cfg, spb)
                        out[tag + "/depth%%d" %% s] = np.asarray(depth)
                        for kk, v in m.items():
                            out[tag + "/m%%d/%%s" %% (s, kk)] = np.asarray(v)
                    leaves(state["params"], tag + "/p")
    np.savez(sys.argv[3], **out)
""") % {"arch": LAYER_ARCH, "grids": LAYER_GRIDS, "caps": CAPACITIES,
        "archs": STEP_ARCHS, "step_grids": STEP_GRIDS, "steps": STEPS,
        "opt": OPT, "adamw": ADAMW_CASE, "methods": COMPRESSIONS}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    where = tmp_path_factory.mktemp("ep_inputs") / "in.npz"
    np.savez(where, **_inputs())
    return where


@pytest.fixture(scope="module")
def reference(inputs):
    """Starts the reference's two parts at the first test that reads
    them; the returned callable waits for them and gives their outputs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    tmp = inputs.parent
    parts = ("layer", "engine")
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
def runs(reference, inputs, tmp_path_factory):
    """Every spawned run of the module, started together at the first
    test that reads them, a few at a time (the reference's subprocesses
    are already running)."""
    ckpt = tmp_path_factory.mktemp("ep_ckpt")
    with ThreadPoolExecutor(3) as pool:
        out = {("step", g): pool.submit(_spawn, g, "step", str(inputs),
                                        str(ckpt / f"{g[0]}{g[1]}"))
               for g in STEP_GRIDS}
        out["adamw"] = pool.submit(_spawn, ADAMW_CASE[1], "adamw",
                                   str(inputs))
        for g in STEP_GRIDS:
            out[("compress", g)] = pool.submit(_spawn, g, "compress",
                                               str(inputs))
        for g in LAYER_GRIDS:
            if g == (1, 1):         # the host mesh: one process, no group
                out[("layer", g)] = pool.submit(
                    lambda: [_layer_rank(mesh.init_data_group(
                        1, device="cpu"), str(inputs))])
            elif g[1] == 1:         # (n, 1): a data group, ep = 1
                out[("layer", g)] = pool.submit(
                    mesh.spawn, f"{__name__}:_layer_rank", g[0],
                    str(inputs), device="cpu", threads=1, timeout_s=JOIN_S)
            else:
                out[("layer", g)] = pool.submit(_spawn, g, "layer",
                                                str(inputs))
        out["ckpt"] = ckpt
        yield out


def _close(got, want, tol=1e-5, msg=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=msg)


# -- the layer ------------------------------------------------------------------

@pytest.mark.parametrize("cap,small", LAYER_CASES,
                         ids=["cap1.25", "cap8", "small"])
@pytest.mark.parametrize("grid", LAYER_GRIDS,
                         ids=[f"D{d}T{t}" for d, t in LAYER_GRIDS])
def test_layer_equals_the_references_moe_fwd_ep(grid, cap, small, runs,
                                                reference):
    """Each rank's output and input gradient against the reference's rows
    of its data index; aux's mean over the data indices against the
    reference's; the expert gradients summed over the data indices
    against the reference's rows of the rank's experts; the router's and
    the shared expert's summed over every rank against the reference's;
    at 1e-5.  At capacity 1.25 some slot is dropped."""
    D, T = grid
    ranks = runs[("layer", grid)].result()
    ref = reference()
    tag = f"layer/{D}{T}/{cap}/{int(small)}"
    got = [r[(cap, small)] for r in ranks]
    rows = ref[tag + "/y"].shape[0] // D
    for r, o in enumerate(got):
        d, t = r // T, r % T
        _close(o["y"], ref[tag + "/y"][d * rows:(d + 1) * rows],
               msg=f"y rank {r}")
        _close(o["dx"], ref[tag + "/dx"][d * rows:(d + 1) * rows],
               msg=f"dx rank {r}")
    _close(np.mean([got[d * T]["aux"] for d in range(D)]), ref[tag + "/aux"],
           msg="aux")
    for k in got[0]["g"]:
        name = k.split("/")[1]
        if name in ("wg", "wu", "wd"):
            whole = ref[tag + "/g" + k]
            held = whole.shape[0] // T
            for t in range(T):
                _close(sum(got[d * T + t]["g"][k] for d in range(D)),
                       whole[t * held:(t + 1) * held], msg=f"{k} t={t}")
        else:
            _close(sum(o["g"][k] for o in got), ref[tag + "/g" + k], msg=k)
    drops = sum(o["drops"] for o in got)
    if small or cap == 8.0:
        assert drops == 0
    else:
        assert drops > 0, "capacity 1.25 dropped no slot"


# -- the step ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", STEP_ARCHS)
@pytest.mark.parametrize("grid", STEP_GRIDS,
                         ids=[f"D{d}T{t}" for d, t in STEP_GRIDS])
def test_grid_steps_equal_the_references_engine(grid, arch, runs, reference):
    """Every rank's loss, xent, moe_aux and grad norm a step, and rank 0's
    gathered final parameters, against the reference's ``SPBEngine`` on
    the same (D, T) mesh at 1e-5; the depths are the cycle's."""
    D, T = grid
    ranks = runs[("step", grid)].result()
    ref = reference()
    tag = f"{arch}/{D}{T}"
    for r, out in enumerate(ranks):
        for s, m in enumerate(out[arch]["hist"]):
            for k in ("loss", "xent", "moe_aux", "grad_norm"):
                _close(m[k], ref[f"{tag}/m{s}/{k}"], msg=f"rank {r} {s} {k}")
    assert [m["depth"] for m in ranks[0][arch]["hist"]] == \
        DEPTHS[arch]
    whole = ranks[0][arch]["whole"]
    assert whole is not None and all(o[arch]["whole"] is None
                                     for o in ranks[1:])
    for k, v in whole.items():
        _close(v, ref[f"{tag}/p{k}"], msg=k)


def test_grid_adamw_steps_equal_the_references_engine(runs, reference):
    """AdamW on :data:`ADAMW_CASE`: every rank's loss, xent, moe_aux and
    grad norm a step, and rank 0's gathered moments, against the
    reference's ``SPBEngine`` at 1e-5; the gathered parameters at 1e-5
    wherever the reference's first gradient is farther than
    :data:`NEAR_ZERO_G` from zero.  Nearer, AdamW's first update lr g /
    (|g| + eps) turns the rounding of g into up to lr: there the two
    differ by no more than both engines' whole movement, each step at
    most its lr (two AdamW steps move ``|m^/(sqrt(v^) + eps)| <= 1.0004``
    at these betas) and its decay."""
    arch, (D, T) = ADAMW_CASE
    ranks = runs["adamw"].result()
    ref = reference()
    tag = f"{arch}/{D}{T}/adamw"
    for r, out in enumerate(ranks):
        for s, m in enumerate(out["hist"]):
            for k in ("loss", "xent", "moe_aux", "grad_norm"):
                _close(m[k], ref[f"{tag}/m{s}/{k}"], msg=f"rank {r} {s} {k}")
    whole = ranks[0]["whole"]
    assert whole is not None and all(o["whole"] is None for o in ranks[1:])
    assert {k.split("/")[1] for k in whole["opt"]} == {"mu", "nu"}
    for k, v in whole["opt"].items():
        _close(v, ref[f"{tag}/opt{k}"], msg=k)
    tcfg = TrainConfig(num_steps=STEPS, optimizer="adamw")
    movement = sum(optimizers.lr_at(tcfg, s) for s in range(STEPS))
    compared = 0
    for k, v in whole["params"].items():
        want = ref[f"{tag}/p{k}"]
        g0 = ref[f"{tag}/mu0{k}"] / (1 - tcfg.beta1)
        far = np.abs(g0) > NEAR_ZERO_G
        _close(v[far], want[far], msg=k)
        compared += int(far.sum())
        bound = 2 * movement * (1.0004 + tcfg.weight_decay
                                * np.abs(want[~far])) + 1e-5
        assert np.all(np.abs(v[~far] - want[~far]) <= bound), k
    assert compared > 0


@pytest.mark.parametrize("method", COMPRESSIONS)
@pytest.mark.parametrize("arch", STEP_ARCHS)
@pytest.mark.parametrize("grid", STEP_GRIDS,
                         ids=[f"D{d}T{t}" for d, t in STEP_GRIDS])
def test_grid_compressed_steps_equal_the_references_step(grid, arch, method,
                                                         runs, reference):
    """Compression on the grid: every rank's loss, xent, moe_aux and grad
    norm a step, its depth, and rank 0's gathered final parameters,
    against the reference's compressed step on the same (D, T) mesh at
    1e-5 (its compressor sees the logical tree, the experts whole).  The
    reference's step is the one its ``SPBEngine`` jits, its gradient
    jitted on the mesh and its compressor and optimizer run eagerly (its
    ``topk`` does not jit); ``randk`` and ``lowrank`` draw there from the
    port's generator at the step (``compression_generator``), which
    ``jax.random``'s key cannot match.  One process is no oracle here: on
    a grid the MoE aux averages each model rank's Switch loss over its own
    tokens, as the reference's does."""
    D, T = grid
    ranks = runs[("compress", grid)].result()
    ref = reference()
    tag = f"{arch}/{D}{T}/{method}"
    for r, out in enumerate(ranks):
        for s, m in enumerate(out[(arch, method)]["hist"]):
            assert m["depth"] == int(ref[f"{tag}/depth{s}"])
            for k in ("loss", "xent", "moe_aux", "grad_norm"):
                _close(m[k], ref[f"{tag}/m{s}/{k}"], msg=f"rank {r} {s} {k}")
    whole = ranks[0][(arch, method)]["whole"]
    assert whole is not None and all(o[(arch, method)]["whole"] is None
                                     for o in ranks[1:])
    for k, v in whole.items():
        _close(v, ref[f"{tag}/p{k}"], msg=k)


@pytest.mark.parametrize("grid", STEP_GRIDS,
                         ids=[f"D{d}T{t}" for d, t in STEP_GRIDS])
def test_model_group_calls_equal_the_reckoning(grid, runs):
    """Each step's calls and payload bytes on the model group equal
    ``roofline.ep_calls`` at the step's depth."""
    D, T = grid
    for arch in STEP_ARCHS:
        cfg = _ep_cfg(arch)
        for out in runs[("step", grid)].result():
            for m in out[arch]["hist"]:
                want = roofline.ep_calls(cfg, B // D, SEQ, model_parallel=T,
                                         depth=m["depth"])
                assert m["calls"] == want, (arch, m["depth"])


@pytest.mark.parametrize("grid", STEP_GRIDS,
                         ids=[f"D{d}T{t}" for d, t in STEP_GRIDS])
def test_replicated_leaves_are_bit_identical_on_every_rank(grid, runs):
    """Every leaf but the experts is the same, bit for bit, on every rank
    of the grid after the steps (model replicas and data replicas)."""
    ranks = runs[("step", grid)].result()
    for arch in STEP_ARCHS:
        first = ranks[0][arch]["replicated"]
        assert first
        for out in ranks[1:]:
            for k, v in out[arch]["replicated"].items():
                assert np.array_equal(v, first[k]), (arch, k)


def test_a_grid_checkpoint_restores_into_one_process(runs):
    """The (2, 2) grid's gathered state, written by rank 0, restores into
    one process bit for bit (parameters and optimizer state), and that
    process steps on from it."""
    ranks = runs[("step", (2, 2))].result()
    arch = STEP_ARCHS[0]
    cfg = _ep_cfg(arch)
    eng = _engine(cfg, steps=STEPS + 1)
    state, step = CheckpointManager(runs["ckpt"] / "22").restore(
        eng.state_shapes)
    assert step == STEPS
    eng.attach_state(state)
    assert eng.step_count == STEPS
    for k, v in _flat(eng.state["params"]).items():
        assert np.array_equal(v, ranks[0][arch]["whole"][k]), k
    for k, v in _flat(eng.state["opt"]).items():
        assert np.array_equal(v, ranks[0][arch]["whole_opt"][k]), k
    pipe = Pipeline(cfg, B, SEQ, seed=0)
    m = eng.train_step(pipe.get_batch(STEPS), STEPS)
    assert np.isfinite(float(m["loss"]))


def test_a_grid_checkpoint_restores_into_a_grid_of_another_t(runs):
    """The (2, 2) grid's checkpoint restored into a (1, 4) grid (one
    expert a rank): its gathered state is the checkpoint's bit for bit,
    and its ranks step on from it with one loss."""
    saved = runs[("step", (2, 2))].result()[0][STEP_ARCHS[0]]
    ranks = _spawn((1, 4), "restore", str(runs["ckpt"] / "22"))
    whole = ranks[0]["whole"]
    assert whole is not None and all(r["whole"] is None for r in ranks[1:])
    want = {**saved["whole"], **saved["whole_opt"]}
    assert set(whole) == set(want)
    for k, v in whole.items():
        assert np.array_equal(v, want[k]), k
    assert np.isfinite(ranks[0]["loss"])
    assert all(r["loss"] == ranks[0]["loss"] for r in ranks)


def test_prefill_and_decode_over_a_grid_equal_the_dense_path(runs):
    """On (1, 2) at capacity 8 the prefill's and the decode steps' logits
    (the routed path, then the small one) equal one process's dense path
    at 1e-5."""
    arch = STEP_ARCHS[0]
    cfg = dataclasses.replace(reduced_config(arch))
    params = _params(arch)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 14)))
    cache = lm.init_cache(cfg, 2, 16)
    want = []
    with torch.no_grad():
        lg, cache = lm.prefill(params, {"tokens": tokens[:, :12]}, cfg,
                               cache)
        want.append(lg.numpy())
        for i in (12, 13):
            lg, cache = lm.decode_step(params, cache, tokens[:, i:i + 1], cfg)
            want.append(lg.numpy())
    for out in runs[("step", (1, 2))].result():
        for got, w in zip(out["serve"], want):
            _close(got, w)


# -- the pieces, in one process ------------------------------------------------

def test_the_grids_layout_shards_only_the_experts():
    """``grid_state_pspec`` on (2, 2): the experts over ``model`` (and
    their moments also over ``data``), every other leaf never over
    ``model``; ``axis_slices`` gives rank t the experts [t E/T, (t+1)
    E/T); ``mesh_for`` a grid is (D, T)."""
    cfg = _ep_cfg(STEP_ARCHS[0])
    shapes = steps_lib.train_state_shapes(cfg, TrainConfig())
    m = sharding.mesh_for(GridGroup(data=mesh.DataGroup(size=2),
                                    model=ModelGroup(size=2)))
    assert m.shape == {"data": 2, "model": 2}
    specs = sharding.grid_state_pspec(shapes, m, zero1=True)
    roles = steps_lib.ep_roles(cfg)
    for spec, ospec, role in zip(
            tree_leaves(specs["params"], is_leaf=sharding._is_spec),
            tree_leaves(specs["opt"]["mu"], is_leaf=sharding._is_spec),
            tree_leaves(roles)):
        on_model = "model" in spec
        assert on_model == (role == "expert"), (spec, role)
        if role == "expert":
            assert spec == sharding.P(None, "model") and "data" in ospec
    parts = sharding.axis_slices(specs["params"], shapes["params"], m,
                                 "model", 1)
    ffn = parts["groups"][1][0]["ffn"]
    assert ffn["wg"] == (1, 2, 2) and ffn["router"] is None
    assert parts["embed"]["tok"] is None


def test_collective_functions_are_their_own_adjoints_at_one_rank():
    """At a group of one the exchange, the aux mean and the share are the
    identity, forward and backward; the all-to-all refuses a dim 0 that
    does not split and counts its calls and bytes."""
    g = ModelGroup()
    x = torch.randn(4, 3, requires_grad=True)
    for fn in (L.ep_all_to_all, L.model_mean, L.model_share):
        y = fn(x, g)
        y.backward(torch.ones_like(y))
        assert torch.equal(y, x) and torch.equal(x.grad, torch.ones_like(x))
        x.grad = None
    two = ModelGroup(size=2)
    with pytest.raises(ValueError, match="does not split"):
        two.all_to_all(torch.zeros(3, 2))
    with cost.CostMode() as mode:
        out = two.all_to_all(torch.zeros((4, 2), device="meta"))
    assert out.shape == (4, 2)
    assert mode.summary.collectives()["all-to-all"] == {
        "count": 1.0, "payload_bytes": 32.0, "wire_bytes": 16.0}


def test_ep_refusals():
    """The dense path takes no group of several ranks, tokens that do not
    split over T raise, spatial SPB on a grid raises with the reference's
    failure named (a compressed step builds); so do a grid's step table
    and AOT load."""
    cfg = _ep_cfg(LAYER_ARCH)
    p = _layer_params()
    two = ModelGroup(size=2)
    x = torch.zeros((1, 9, cfg.d_model))
    with pytest.raises(ValueError, match="do not split"):
        moe.moe_fwd_ep(tree_map(lambda t: t[:2] if t.dim() == 3 and
                                t.shape[0] == 4 else t, p), x, cfg,
                       group=two)
    dense = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, impl="dense"))
    with pytest.raises(ValueError, match="impl='dense'"):
        moe.moe_fwd(p, x, dense, group=two)
    with pytest.raises(ValueError, match="router scores"):
        moe.moe_fwd_ep(p, x, cfg, group=two)
    grid = GridGroup(data=mesh.DataGroup(size=2), model=two, size=4)
    with pytest.raises(NotImplementedError, match="does not lower"):
        SPBEngine(cfg, TrainConfig(), SPBConfig(mode="spatial", k=2),
                  group=grid)
    compressed = SPBEngine(cfg, TrainConfig(compression="topk"),
                           SPBConfig(mode="temporal", k=2), group=grid)
    assert set(compressed.depth_keys()) == {None, 2, 3}
    eng = SPBEngine(cfg, TrainConfig(), SPBConfig(mode="temporal", k=2),
                    group=grid)
    for what in (lambda: eng.compile_table({}), lambda: eng.load_aot("x")):
        with pytest.raises(NotImplementedError, match="grid of 2 x 2"):
            what()


def test_mesh_config_round_trip_matches_the_reference():
    """``parallel_config_for`` of a (D, T) mesh equals the reference's of
    the same jax mesh, and ``make_mesh_from_config`` gives it back."""
    import jax
    from repro.launch import mesh as jmesh
    m = sharding.Mesh((1, 1), ("data", "model"))
    got = mesh.parallel_config_for(m)
    want = jmesh.parallel_config_for(jax.make_mesh(
        (1, 1), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert mesh.make_mesh_from_config(got).shape == m.shape


@pytest.mark.parametrize("n", [1, 2], ids=["dp1", "dp2"])
def test_dryrun_counts_the_all_to_all_bytes_of_the_formula(n, tmp_path):
    """``--model-parallel 2`` on reduced deepseek-v2-lite-16b (batch 4 x
    64, full depth): the record's all-to-all wire bytes are half the
    payload of ``2 (2 + 2)`` exchanges of ``E C D 4`` bytes, C the
    capacity of the rank's ``4 / n x 64 / 2 x 2`` routed slots over 4
    experts; every model-group call equals ``roofline.ep_calls``; the
    record names the grid."""
    cfg = reduced_config(LAYER_ARCH)
    rec = dryrun.count_cell(LAYER_ARCH, "train_4k", cut="reduced", batch=4,
                            seq_len=64, data_parallel=n, model_parallel=2)
    m = cfg.moe
    c = moe.capacity(4 // n * 64 // 2 * m.top_k, m.num_experts,
                     m.capacity_factor)
    payload = 8 * m.num_experts * c * cfg.d_model * 4
    assert rec["collective_breakdown"]["all-to-all"] == payload / 2
    assert rec["model_parallel"] == 2 and rec["experts_held"] == 2
    want = roofline.ep_calls(cfg, 4 // n, 64, model_parallel=2, depth=None)
    assert want["all-to-all"] == (8, payload)
    got = dryrun.run_cell(LAYER_ARCH, "train_4k", cut="reduced", batch=4,
                          seq_len=64, data_parallel=n, model_parallel=2,
                          out_dir=tmp_path)
    assert got["ok"] and got["tag"].endswith("mp2")
