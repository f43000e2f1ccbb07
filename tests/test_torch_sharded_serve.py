"""Sharded serving on a ``(data, model)`` grid on the CPU
(``serve/engine.ServeEngine(group=, mesh=)``, the ``tp=`` of ``lm``'s
cached modes and ``models/layers.py``'s cached attention,
``models/moe.moe_fwd_held``, ``dist/sharding.serve_params_pspec`` and
``grid_cache_pspec``, ``serve/kvcache``'s ``model_parallel``,
``bridge.serve_params_from_numpy``, ``dist/steps.shard_decode_step``,
``analysis/roofline.serve_tp_calls``, ``launch/dryrun.py``'s serving grid
cells and ``launch/mesh.make_host_mesh``).

The weights are the reference's ``init_lm`` (seed 0) of reduced yi-6b,
gemma3-4b and deepseek-v2-lite-16b, f32, drawn in a subprocess that
writes them to a file; the reference then runs in two subprocesses, on 2
and 4 virtual CPU devices, while the port's ranks run (``launch/mesh.
spawn``, one intra-op thread each): one ``spawn(grid=(1, 2))`` for the
three archs and one ``(2, 2)`` spawn.  The ranks' target is this module's
:func:`_rank`, and the module imports JAX only inside the tests that call
it, so a spawned rank does not load it.

* (a) The grid engine's greedy tokens, staggered and solo, equal the
  reference ``ServeEngine(mesh=<(1, 2) mesh>)``'s (its params and state
  placed on the mesh by the caller: the reference engine does not place
  them itself, ROADMAP.md "Reference caveats").
* (b) ``serve_prefill`` / ``serve_decode`` logits with ``tp`` within 1e-5
  of the reference's on the same mesh.
* (c) The model ranks, and on ``(2, 2)`` the data replicas, hold
  bit-identical logits and emit the same tokens, sampled ones too.
* (d) A rank's param and pool bytes equal the reckoning
  (``sharding.sharded_state_bytes``, ``kvcache.cache_bytes``, the whole
  pool's K/V leaves cut to ``Hkv / T`` heads), its pool half the
  one-process pool for the attention archs.
* (e) The model group's calls and bytes of a prefill and a decode step
  equal ``roofline.serve_tp_calls``.
* (f) ``shard_decode_step`` on ``(2, 2)`` matches the reference's on a
  4-device mesh within 1e-5, in logits and in the updated cache.
* (g) The rule overrides with a path build (``kv_seq``, roles set to
  None, ``batch`` on the DP axes, a ``pod`` axis); a moved role raises;
  (h) the step table raises under the grid; (i) the dry run's
  reduced ``decode_32k`` cell under ``--model-parallel 2 --data-parallel
  2`` records the reckoned collective bytes, and ``--multi-pod`` an error
  record where the KV heads do not split.
"""
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
from repro_torch.configs import reduced_config
from repro_torch.dist import sharding
from repro_torch.dist import steps as steps_lib
from repro_torch.dist.group import DataGroup, GridGroup, ModelGroup
from repro_torch.launch import dryrun, mesh
from repro_torch.models import lm
from repro_torch.serve import ServeEngine, default_geometry, kvcache
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JOIN_S = 300.0
ARCHS = ("yi-6b", "gemma3-4b", "deepseek-v2-lite-16b")
PROMPT_A = [3, 1, 4, 1, 5, 9, 2, 6]
PROMPT_B = [2, 7, 1, 8, 2, 8]
MAX_NEW = (5, 6)
SLOTS, PAGE, CONTEXT, BUCKET = 2, 8, 48, 16
NEXT_TOKEN = 7                 # the decode step's input of slot 0 in (b)
DECODE_ARCH = "yi-6b"          # (f): shard_decode_step on (2, 2)
DECODE_BATCH, DECODE_LEN, DECODE_STEPS = 4, 16, 3
TOL = dict(rtol=1e-5, atol=1e-5)


def _geom():
    return default_geometry(num_slots=SLOTS, page_size=PAGE,
                            max_context=CONTEXT)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _numpy_params(path, arch):
    """The reference's params of ``arch`` from the file, as a nested
    numpy tree in the JAX layout."""
    arr = np.load(path)
    return tree_map_with_path(
        lambda keys, _: arr[arch + "/" + "/".join(keys)],
        lm.param_shapes(reduced_config(arch)))


def _tokens():
    return np.random.default_rng(3).integers(
        0, reduced_config(DECODE_ARCH).vocab_size,
        (DECODE_BATCH, DECODE_STEPS))


# -- the spawned ranks ---------------------------------------------------------

def _trace(eng, temperature=0.0):
    """A staggered trace (B joins two steps after A), then each prompt
    alone: the outputs of the three runs."""
    a = eng.submit(PROMPT_A, max_new=MAX_NEW[0], temperature=temperature)
    eng.step(2)
    b = eng.submit(PROMPT_B, max_new=MAX_NEW[1], temperature=temperature)
    eng.drain()
    solo = []
    for prompt, n in zip((PROMPT_A, PROMPT_B), MAX_NEW):
        r = eng.submit(prompt, max_new=n, temperature=temperature)
        eng.drain()
        solo.append(r.output)
    return {"staggered": [a.output, b.output], "solo": solo}


def _calls(model):
    return {k: (model.calls[k], model.bytes[k]) for k in model.calls}


def _delta(before, after):
    return {k: (v[0] - before.get(k, (0, 0))[0],
                v[1] - before.get(k, (0, 0))[1])
            for k, v in after.items() if v[0] != before.get(k, (0, 0))[0]}


def _logits(params, cfg, geom, model_parallel, tp):
    """(b): a prefill of PROMPT_A into slot 0 of a fresh pool (pages 1 to
    Pmax) and one decode step of both slots (slot 1 idle); the logits and
    the model group's calls of each."""
    pool = kvcache.init_paged_cache(cfg, geom, "cpu", model_parallel)
    P = geom.pages_per_slot
    tokens = torch.zeros((1, BUCKET), dtype=torch.int64)
    tokens[0, :len(PROMPT_A)] = torch.tensor(PROMPT_A)
    page_row = torch.arange(1, P + 1)
    c0 = _calls(tp)
    pre, _ = lm.serve_prefill(params, tokens, cfg, pool, page_row=page_row,
                              prompt_len=torch.tensor([len(PROMPT_A)]),
                              tp=tp)
    c1 = _calls(tp)
    table = torch.zeros((SLOTS, P), dtype=torch.int64)
    table[0] = page_row
    dec, _ = lm.serve_decode(
        params, pool, torch.tensor([[NEXT_TOKEN], [0]]), cfg,
        pos=torch.tensor([len(PROMPT_A), 0]), page_table=table,
        active=torch.tensor([True, False]), tp=tp)
    c2 = _calls(tp)
    V = cfg.vocab_size
    return {"prefill": pre[:, :V].numpy(), "decode": dec[:, :V].numpy(),
            "calls_prefill": _delta(c0, c1), "calls_decode": _delta(c1, c2)}


def _pool_by_heads(cfg, T):
    """One of T model ranks' pool bytes, reckoned from the whole pool:
    each attn/local K/V leaf cut to ``Hkv / T`` of its heads, an MLA
    leaf whole."""
    total = 0
    for g in kvcache.paged_cache_shapes(cfg, _geom()):
        for layer in g:
            for name, leaf in layer["self"].items():
                n = leaf.numel() * leaf.element_size()
                if name in ("k", "v"):
                    assert leaf.shape[-2] == cfg.num_kv_heads
                    n = n // cfg.num_kv_heads * (cfg.num_kv_heads // T)
                total += n
    return total


def _serve_rank(group, path, archs, sampled):
    """Each arch's grid engine from the reference's params: the traces
    (greedy, and sampled when ``sampled``), the logits of (b), the
    rank's bytes and the reckoning's."""
    T = group.model.size
    grid = sharding.mesh_for(group)
    out = {}
    for arch in archs:
        cfg = reduced_config(arch)
        whole = bridge.params_from_numpy(_numpy_params(path, arch), cfg)
        whole = tree_map(lambda p: p.detach(), whole)
        eng = ServeEngine(cfg, geom=_geom(), params=whole, group=group,
                          mesh=grid)
        res = {"greedy": _trace(eng)}
        if sampled:
            res["sampled"] = _trace(eng, temperature=0.8)
        shapes = lm.param_shapes(cfg)
        res["bytes"] = eng.held_bytes()
        res["reckoned"] = {
            "params": sharding.sharded_state_bytes(shapes, eng.params_specs,
                                                   grid),
            "pool": kvcache.cache_bytes(cfg, _geom(), T),
            "pool_by_heads": _pool_by_heads(cfg, T),
            "whole_pool": kvcache.cache_bytes(cfg, _geom())}
        res["pool_kv_heads"] = sorted({
            leaf.shape[-2] for g in eng.state["groups"] for layer in g
            for name, leaf in layer["self"].items() if name in ("k", "v")})
        res.update(_logits(eng.params, cfg, _geom(), T, group.model))
        out[arch] = res
    return out


def _decode_rank(group, path):
    """(f): the rank's ``shard_decode_step`` over ``DECODE_STEPS`` tokens
    from an empty dense cache: each step's logits and the final cache
    (flat); and (c) the serving engine's traces on the same grid."""
    cfg = reduced_config(DECODE_ARCH)
    d, t, T = group.data_index, group.model_index, group.model.size
    grid = sharding.mesh_for(group)
    fn, _, cshapes, specs = steps_lib.shard_decode_step(
        grid, cfg, DECODE_BATCH, DECODE_LEN, group=group)
    params = bridge.serve_params_from_numpy(_numpy_params(path, DECODE_ARCH),
                                            cfg, (t, T))
    cache = tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype),
                     sharding.local_shapes(specs["cache"], cshapes, grid))
    rows = DECODE_BATCH // grid.shape["data"]
    tokens = torch.from_numpy(_tokens()[d * rows:(d + 1) * rows])
    logits = []
    for i in range(DECODE_STEPS):
        lg, cache = fn(params, cache, tokens[:, i:i + 1])
        logits.append(lg[..., :cfg.vocab_size].numpy())
    out = {"logits": np.stack(logits), "cache": _flat(cache)}
    out["serve"] = _serve_rank(group, path, (DECODE_ARCH,), True)
    return out


def _rank(group, what, *args):
    """The spawned ranks' target."""
    return {"serve": _serve_rank, "decode": _decode_rank}[what](group, *args)


def _spawn(grid, what, *args):
    return mesh.spawn(f"{__name__}:_rank", int(np.prod(grid)), what, *args,
                      device="cpu", threads=1, timeout_s=JOIN_S, grid=grid)


# -- the reference, in subprocesses --------------------------------------------

_PARAMS = textwrap.dedent("""
    import sys
    import jax, numpy as np
    from repro.configs import reduced_config
    from repro.models import lm
    out = {}
    for arch in %(archs)r:
        p = lm.init_lm(jax.random.key(0), reduced_config(arch))
        for path, v in jax.tree_util.tree_leaves_with_path(p):
            out[arch + "/" + "/".join(
                str(getattr(k, "key", getattr(k, "idx", k)))
                for k in path)] = np.asarray(v)
    np.savez(sys.argv[1], **out)
""") % {"archs": ARCHS}

_REFERENCE = textwrap.dedent("""
    import os, sys
    part = sys.argv[1]
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%%d" %% (
        {"serve": 2, "decode": 4}[part])
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import reduced_config
    from repro.dist import sharding as shd
    from repro.dist import steps as jsteps
    from repro.models import lm
    from repro.serve import ServeEngine, default_geometry, kvcache

    inp = np.load(sys.argv[2])
    out = {}
    auto = lambda n: (jax.sharding.AxisType.Auto,) * n

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    def params_of(arch, cfg):
        shapes = jax.eval_shape(lambda: lm.init_lm(jax.random.key(0), cfg))
        return jax.tree_util.tree_map_with_path(
            lambda p, s: jnp.asarray(inp[arch + "/" + key(p)]), shapes)

    def placed(mesh, tree, specs):
        return jax.device_put(tree, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P)))

    def trace(eng):
        a = eng.submit(%(a)r, max_new=%(n0)d)
        eng.step(2)
        b = eng.submit(%(b)r, max_new=%(n1)d)
        eng.drain()
        solo = []
        for prompt, n in ((%(a)r, %(n0)d), (%(b)r, %(n1)d)):
            r = eng.submit(prompt, max_new=n)
            eng.drain()
            solo.append(np.asarray(r.output))
        return [np.asarray(a.output), np.asarray(b.output)], solo

    if part == "serve":
        mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=auto(2))
        geom = default_geometry(num_slots=%(slots)d, page_size=%(page)d,
                                max_context=%(context)d)
        for arch in %(archs)r:
            cfg = reduced_config(arch)
            params = params_of(arch, cfg)
            params = placed(mesh, params, shd.params_pspec(params,
                                                           mesh=mesh))
            eng = ServeEngine(cfg, mesh=mesh, params=params, geom=geom)
            # the engine's jit takes its state laid out, which it does not
            # do itself
            eng.state = jax.device_put(eng.state, eng.state_shardings)
            stag, solo = trace(eng)
            for i in range(2):
                out[arch + "/staggered/%%d" %% i] = stag[i]
                out[arch + "/solo/%%d" %% i] = solo[i]
            pool = kvcache.init_paged_cache(cfg, geom)
            pool = placed(mesh, pool, shd.paged_cache_pspec(pool, mesh=mesh))
            Pm = geom.pages_per_slot
            tokens = np.zeros((1, %(bucket)d), np.int32)
            tokens[0, :%(na)d] = %(a)r
            row = jnp.arange(1, Pm + 1, dtype=jnp.int32)
            with jax.sharding.set_mesh(mesh):
                pre, pool = jax.jit(lambda p, t, g, r, n: lm.serve_prefill(
                    p, t, cfg, g, page_row=r, prompt_len=n))(
                    params, jnp.asarray(tokens), pool, row,
                    jnp.int32(%(na)d))
                table = jnp.zeros((%(slots)d, Pm), jnp.int32).at[0].set(row)
                dec, _ = jax.jit(lambda p, g, t, pos, tb, act:
                                 lm.serve_decode(p, g, t, cfg, pos=pos,
                                                 page_table=tb, active=act))(
                    params, pool, jnp.asarray([[%(next)d], [0]], jnp.int32),
                    jnp.asarray([%(na)d, 0], jnp.int32), table,
                    jnp.asarray([True, False]))
            V = cfg.vocab_size
            out[arch + "/prefill"] = np.asarray(pre)[:, :V]
            out[arch + "/decode"] = np.asarray(dec)[:, :V]

    if part == "decode":
        cfg = reduced_config(%(darch)r)
        mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=auto(2))
        fn, pshapes, cshapes, sh = jsteps.shard_decode_step(
            mesh, cfg, %(dbatch)d, %(dlen)d)
        params = jax.device_put(params_of(%(darch)r, cfg), sh["params"])
        cache = jax.device_put(jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype), cshapes), sh["cache"])
        tokens = np.asarray(%(tokens)r, np.int32)
        logits = []
        for i in range(tokens.shape[1]):
            lg, cache = fn(params, cache, jax.device_put(
                jnp.asarray(tokens[:, i:i + 1]), sh["tokens"]))
            logits.append(np.asarray(lg)[..., :cfg.vocab_size])
        out["logits"] = np.stack(logits)
        for p, v in jax.tree_util.tree_leaves_with_path(cache):
            out["cache/" + key(p)] = np.asarray(v)
    np.savez(sys.argv[3], **out)
""") % {"archs": ARCHS, "a": PROMPT_A, "b": PROMPT_B, "na": len(PROMPT_A),
        "n0": MAX_NEW[0], "n1": MAX_NEW[1], "slots": SLOTS, "page": PAGE,
        "context": CONTEXT, "bucket": BUCKET, "next": NEXT_TOKEN,
        "darch": DECODE_ARCH, "dbatch": DECODE_BATCH, "dlen": DECODE_LEN,
        "tokens": _tokens().tolist()}


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=str(ROOT / "src"))


@pytest.fixture(scope="module")
def params_file(tmp_path_factory):
    """The reference's ``init_lm`` params of the three archs, in a file."""
    where = tmp_path_factory.mktemp("sharded_serve") / "params.npz"
    proc = subprocess.run([sys.executable, "-c", _PARAMS, str(where)],
                          env=_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return where


@pytest.fixture(scope="module")
def runs(params_file):
    """Starts the reference's two parts and the port's two spawns at once;
    the returned callable waits for them and gives their outputs."""
    tmp = params_file.parent
    parts = ("serve", "decode")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, part, str(params_file),
         str(tmp / f"ref_{part}.npz")], env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in parts]
    pool = ThreadPoolExecutor(2)
    port = {"serve": pool.submit(_spawn, (1, 2), "serve", str(params_file),
                                 ARCHS, True),
            "decode": pool.submit(_spawn, (2, 2), "decode",
                                  str(params_file))}
    done = {}

    def result():
        if not done:
            for part, proc in zip(parts, procs):
                _, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-3000:]
                done[part] = dict(np.load(tmp / f"ref_{part}.npz"))
            for k, f in port.items():
                done["port_" + k] = f.result()
        return done

    yield result
    pool.shutdown(wait=True)
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


# -- (a)-(e): the serving grid ------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_grid_engine_emits_the_reference_tokens(runs, arch):
    """(a) On (1, 2), both model ranks' greedy tokens, staggered and solo,
    equal the reference's ``ServeEngine(mesh=)``'s on the same weights;
    staggered equals solo."""
    ref = runs()["serve"]
    for rank in runs()["port_serve"]:
        got = rank[arch]["greedy"]
        for kind in ("staggered", "solo"):
            assert got[kind] == [ref[f"{arch}/{kind}/{i}"].tolist()
                                 for i in range(2)], (arch, kind)
        assert got["staggered"] == got["solo"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_logits_match_the_reference(runs, arch):
    """(b) ``serve_prefill`` and ``serve_decode`` with ``tp`` on each
    model rank within 1e-5 of the reference's on its (1, 2) mesh."""
    ref = runs()["serve"]
    for rank in runs()["port_serve"]:
        for kind in ("prefill", "decode"):
            np.testing.assert_allclose(rank[arch][kind],
                                       ref[f"{arch}/{kind}"], **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_ranks_are_bit_identical(runs, arch):
    """(c) The two model ranks' logits are bit-identical, and so are their
    tokens, greedy and sampled (one generator seed on every rank)."""
    r0, r1 = (rank[arch] for rank in runs()["port_serve"])
    for kind in ("prefill", "decode"):
        assert np.array_equal(r0[kind], r1[kind])
    assert r0["greedy"] == r1["greedy"] and r0["sampled"] == r1["sampled"]
    assert all(len(o) == n for o, n in zip(r0["sampled"]["solo"], MAX_NEW))


def test_data_replicas_and_model_ranks_are_bit_identical(runs):
    """(c) On (2, 2) the four ranks' engines emit the same tokens, greedy
    and sampled, and hold bit-identical logits; their greedy tokens equal
    the reference's."""
    ranks = [r["serve"][DECODE_ARCH] for r in runs()["port_decode"]]
    ref = runs()["serve"]
    for r in ranks[1:]:
        assert r["greedy"] == ranks[0]["greedy"]
        assert r["sampled"] == ranks[0]["sampled"]
        for kind in ("prefill", "decode"):
            assert np.array_equal(r[kind], ranks[0][kind])
    assert ranks[0]["greedy"]["staggered"] == [
        ref[f"{DECODE_ARCH}/staggered/{i}"].tolist() for i in range(2)]


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_bytes_equal_the_reckoning(runs, arch):
    """(d) Each rank's params and pool bytes equal the reckoning
    (``sharding.sharded_state_bytes`` under ``serve_params_pspec`` and
    ``kvcache.cache_bytes(model_parallel=)``, and the whole pool with
    each K/V leaf cut to ``Hkv / T`` heads); an attention arch's pool is
    half the one-process pool and holds ``Hkv / 2`` heads, an MLA arch's
    whole (its latent pool is replicated over ``model``)."""
    cfg = reduced_config(arch)
    mla = arch == "deepseek-v2-lite-16b"
    for rank in runs()["port_serve"]:
        got, want = rank[arch]["bytes"], rank[arch]["reckoned"]
        assert got == {"params": want["params"], "pool": want["pool"]}
        assert want["pool"] == want["pool_by_heads"]
        assert want["pool"] * (1 if mla else 2) == want["whole_pool"]
        assert rank[arch]["pool_kv_heads"] == \
            ([] if mla else [cfg.num_kv_heads // 2])
    whole = sum(t.numel() * t.element_size()
                for t in tree_leaves(lm.param_shapes(cfg)))
    assert got["params"] < whole


@pytest.mark.parametrize("arch", ARCHS)
def test_model_group_calls_equal_serve_tp_calls(runs, arch):
    """(e) The model group's calls and payload bytes of the prefill (one
    row of the 16 bucket) and of the decode step (2 slots) equal
    ``roofline.serve_tp_calls``."""
    cfg = reduced_config(arch)
    want = {"calls_prefill": roofline.serve_tp_calls(cfg, 2, 1, BUCKET),
            "calls_decode": roofline.serve_tp_calls(cfg, 2, SLOTS, 1)}
    assert want["calls_decode"]["all-reduce"][0] > 0
    for rank in runs()["port_serve"]:
        for k, v in want.items():
            assert rank[arch][k] == v


# -- (f)-(i): the sharded decode step, refusals, the dry run -----------------

def test_shard_decode_step_matches_the_reference(runs):
    """(f) On (2, 2) each rank's logits (its data index's rows, the vocab
    whole) and its block of the updated dense cache are within 1e-5 of the
    reference's ``shard_decode_step`` on 4 devices, every step."""
    ref = runs()["decode"]
    cfg = reduced_config(DECODE_ARCH)
    grid = sharding.Mesh((2, 2), ("data", "model"))
    _, _, cshapes, specs = steps_lib.shard_decode_step(
        grid, cfg, DECODE_BATCH, DECODE_LEN,
        group=GridGroup(data=DataGroup(size=2), model=ModelGroup(size=2),
                        size=4))
    whole = tree_map_with_path(
        lambda keys, _: torch.from_numpy(ref["cache/" + "/".join(keys)]),
        cshapes)
    rows = DECODE_BATCH // 2
    for r, got in enumerate(runs()["port_decode"]):
        d, t = divmod(r, 2)
        np.testing.assert_allclose(
            got["logits"], ref["logits"][:, d * rows:(d + 1) * rows], **TOL)
        want = _flat(tree_map(lambda x: x.numpy(), sharding.grid_share(
            whole, specs["cache"], grid, {"data": d, "model": t})))
        assert set(got["cache"]) == set(want)
        for k, v in want.items():
            assert got["cache"][k].shape == v.shape, k
            np.testing.assert_allclose(got["cache"][k], v, **TOL)


def test_overrides_without_a_path_raise_naming_item_11():
    """(g) The overrides with a path build: ``kv_seq`` on the grid's axes
    (the reference's small-batch override among them), any role set to
    None, ``batch`` on a subset of the DP axes, and a mesh with a ``pod``
    axis served by a grid whose data group holds pod x data ranks; a role
    moved onto another axis still raises ``NotImplementedError``, naming
    the deliberate difference (the port's parallel layers shard over the
    model group only)."""
    cfg = reduced_config(DECODE_ARCH)
    grid = sharding.Mesh((2, 2), ("data", "model"))
    group = GridGroup(data=DataGroup(size=2), model=ModelGroup(size=2),
                      size=4)
    for over in ({"heads": "data"}, {"expert": "data"},
                 {"vocab": "data"}):
        with pytest.raises(NotImplementedError, match="model group only"):
            steps_lib.shard_decode_step(grid, cfg, 4, 16,
                                        rules_overrides=over, group=group)
    for over in ({"kv_seq": ("data", "model")}, {"kv_seq": "model"},
                 {"batch": None, "kv_seq": ("data", "model")},
                 {"vocab": None}, {"heads": None}, {"batch": "data"}):
        fn, _, _, specs = steps_lib.shard_decode_step(
            grid, cfg, 4, 16, rules_overrides=over, group=group)
        assert callable(fn)
    pod = sharding.Mesh((2, 1, 2), ("pod", "data", "model"))
    fn, _, _, specs = steps_lib.shard_decode_step(pod, cfg, 4, 16,
                                                  group=group)
    assert tuple(specs["tokens"]) == (("pod", "data"),)
    with pytest.raises(ValueError, match="by a rank of"):
        steps_lib.shard_decode_step(
            sharding.Mesh((2, 2, 2), ("pod", "data", "model")), cfg, 4, 16,
            group=group)
    with pytest.raises(ValueError, match="does not split"):
        steps_lib.shard_decode_step(grid, cfg, 3, 16, group=group)
    with pytest.raises(ValueError, match="group="):
        steps_lib.shard_decode_step(grid, cfg, 4, 16)


def test_step_table_and_mesh_checks_under_the_grid():
    """(h) ``compile_table``, ``export_aot`` and ``load_aot`` raise under a
    grid of several ranks; ``mesh=`` must be the group's; a T that does not
    divide the heads raises naming the arch; the host mesh of the CPU is
    one device."""
    cfg = reduced_config("yi-6b")
    group = GridGroup(data=DataGroup(size=1), model=ModelGroup(size=2),
                      size=2)
    eng = ServeEngine(cfg, geom=_geom(), group=group,
                      mesh=sharding.Mesh((1, 2), ("data", "model")))
    for what in (eng.compile_table, lambda: eng.export_aot("x"),
                 lambda: eng.load_aot("x")):
        with pytest.raises(NotImplementedError, match="grid of 1 x 2"):
            what()
    with pytest.raises(ValueError, match="mesh is"):
        ServeEngine(cfg, geom=_geom(), group=group,
                    mesh=sharding.Mesh((2, 1), ("data", "model")))
    four = GridGroup(data=DataGroup(size=1), model=ModelGroup(size=4),
                     size=4)
    with pytest.raises(ValueError, match="yi-6b-reduced"):
        ServeEngine(cfg, geom=_geom(), group=four)
    host = mesh.make_host_mesh("cpu")
    assert host.axis_names == ("data", "model") and host.size == 1
    one = ServeEngine(cfg, geom=_geom(), device="cpu", mesh=host)
    assert one.tp is None and one.mesh.shape == {"data": 1, "model": 1}


def test_serve_layout_against_the_reference_rule_table():
    """The serving grid's param specs on (2, 2): every leaf the port
    shards has the reference's ``params_pspec`` entry; the rest (the table,
    MLA, a MoE layer's router and shared expert, the norms) is whole."""
    import jax
    from repro.configs import reduced_config as j_reduced
    from repro.dist import sharding as jshd
    from repro.models import lm as jlm
    grid = sharding.Mesh((2, 2), ("data", "model"))
    jmesh = jax.sharding.AbstractMesh((2, 2), ("data", "model"))
    for arch in ARCHS:
        cfg = reduced_config(arch)
        got = {}
        tree_map_with_path(
            lambda keys, spec: got.__setitem__("/".join(keys), tuple(spec)),
            sharding.serve_params_pspec(lm.param_shapes(cfg), cfg, grid),
            is_leaf=lambda x: isinstance(x, sharding.P))
        ref = jshd.params_pspec(jax.eval_shape(
            lambda: jlm.init_lm(jax.random.key(0), j_reduced(arch))),
            mesh=jmesh)
        want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in p): tuple(s)
                for p, s in jax.tree_util.tree_leaves_with_path(
                    ref, is_leaf=lambda x: isinstance(
                        x, jax.sharding.PartitionSpec))}
        assert set(got) == set(want)
        sharded = 0
        for k, spec in got.items():
            if any(e is not None for e in spec):
                assert spec == want[k], k
                sharded += 1
            else:
                assert not any(e == "data" for e in want[k]), k
        assert sharded


def test_dryrun_serving_cell_records_the_reckoned_collective_bytes(tmp_path):
    """(i) The reduced ``decode_32k`` (and ``prefill_32k``) cell of yi-6b
    under ``--model-parallel 2 --data-parallel 2``: the record's
    collective bytes are the ring's wire bytes of
    ``roofline.serve_tp_calls`` at the rank's 2 rows; the rank's param and
    cache bytes are the reckoning's; ``--multi-pod`` records the KV heads'
    refusal."""
    cfg = reduced_config("yi-6b")
    grid = sharding.Mesh((2, 2), ("data", "model"))
    for shape, seq in (("decode_32k", 1), ("prefill_32k", 64)):
        rec = dryrun.count_cell("yi-6b", shape, cut="reduced", batch=4,
                                seq_len=64, data_parallel=2,
                                model_parallel=2)
        want = roofline.serve_tp_calls(cfg, 2, 2, seq)
        assert rec["collective_breakdown"] == {
            k: cost.wire_bytes(k, 2, v[1]) for k, v in want.items()}
        assert rec["num_collectives"] == sum(v[0] for v in want.values())
        shapes = lm.param_shapes(cfg)
        assert rec["param_bytes"] == sharding.sharded_state_bytes(
            shapes, sharding.serve_params_pspec(shapes, cfg, grid), grid)
        cache = lm.cache_shapes(cfg, 4, 64)
        assert rec["cache_bytes"] == sharding.sharded_state_bytes(
            cache, sharding.grid_cache_pspec(cache, cfg, grid), grid)
    got = dryrun.run_cell("yi-6b", "decode_32k", cut="reduced", batch=4,
                          seq_len=64, data_parallel=2, model_parallel=2,
                          out_dir=tmp_path)
    assert got["ok"] and got["tag"] == "dp2mp2"
    # --multi-pod counts one rank of the (2, 16, 16) mesh, where the 4 KV
    # heads of yi-6b do not split over 16 model ranks (the reference's
    # refusal), recorded as an error
    bad = dryrun.run_cell("yi-6b", "decode_32k", cut="reduced", batch=32,
                          seq_len=64, multi_pod=True, out_dir=tmp_path)
    assert not bad["ok"] and bad["mesh"] == "pod2x16x16"
    assert "divisible by 16" in bad["error"]
