"""The production meshes and the sequence-sharded decode on the CPU
(``launch/mesh.make_production_mesh``, ``dist/sharding``'s rule overrides,
``grid_cache_pspec`` under ``kv_seq``, ``grid_share``/``axis_slices`` over
a tuple of axes, ``models/layers.py``'s partial decode attention and
``seq_combine``, ``dist/group.GridGroup.seq_group``,
``dist/steps.shard_decode_step`` under overrides and on a ``pod`` mesh,
``serve/kvcache.check_model_parallel``, ``bridge.serve_params_from_numpy``
under an override, ``analysis/roofline.serve_tp_calls`` with its combine
gathers, ``launch/dryrun.py``'s ``--pod`` and ``--multi-pod``).

* Decode parity: the reference's ``init_lm`` (seed 0) of reduced
  gemma3-4b, recurrentgemma-2b, deepseek-v2-lite-16b and mamba2-2.7b, f32,
  fills a cache by its ``lm.prefill`` and decodes a few tokens by its
  one-process ``lm.decode_step`` (JAX, CPU, no mesh) in a subprocess; four
  spawned gloo ranks (``launch/mesh.spawn``, one thread each, one spawn for
  every arch) decode the same tokens from that cache under the small-batch
  override ``{"batch": None, "kv_seq": ("data", "model")}`` on a ``(2, 2)``
  grid (4 sequence shards, the last of the global layers' holding no valid
  position) and on the ``(2, 1, 2)`` ``(pod, data, model)`` mesh (2 shards,
  2 pod replicas).  Logits within 1e-5 of the reference's, the ranks
  bit-identical, each rank's cache its block of the reference's, the
  seq group's gathers and the model group's all-reduces as
  ``roofline.serve_tp_calls`` reckons them.  The ranks start while the
  reference runs (a subprocess an arch) and wait for each arch's prefill.
* Spec parity: the port's ``params_pspec``, ``cache_pspec`` and
  ``state_pspec(zero1=True)`` equal the reference's on both production
  meshes (a stand-in mesh of axis names and sizes) for every arch, with and
  without the override; the serving grid's layouts differ from them only
  by the documented departures.
* Outcome parity: each cell of ``cells()`` on both meshes lays out in the
  port's dry run exactly where the reference's specs divide; gemma3-4b
  ``long_500k`` is counted on the pod and its record holds the reckoned
  bytes and collectives.
"""
import math
import os
import subprocess
import sys
import tempfile
import textwrap
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.analysis import roofline
from repro_torch.config import SHAPES, layer_groups
from repro_torch.configs import ARCHS, cells, get_config, reduced_config
from repro_torch.dist import sharding
from repro_torch.dist import steps as steps_lib
from repro_torch.dist.group import DataGroup, GridGroup, ModelGroup, SeqGroup
from repro_torch.launch import dryrun, mesh
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serve import kvcache
from repro_torch.tree import tree_map, tree_map_with_path

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JOIN_S = 300.0
DECODE_ARCHS = ("gemma3-4b", "recurrentgemma-2b", "deepseek-v2-lite-16b",
                "mamba2-2.7b")
B, MAX_LEN, PROMPT, STEPS = 2, 64, 40, 3
OVERRIDE = dryrun.SMALL_BATCH_DECODE
GRIDS = {"grid2x2": ((2, 2), ("data", "model")),
         "pod2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
TOL = dict(rtol=1e-5, atol=1e-5)


def _tokens(arch):
    return np.random.default_rng(5).integers(
        0, reduced_config(arch).vocab_size, (B, PROMPT + STEPS))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _tree(arr, arch, part, like):
    """The reference's ``part`` tree of ``arch`` from the file, laid out
    as the port's ``like`` (meta tensors), each leaf in its dtype."""
    return tree_map_with_path(
        lambda keys, m: torch.from_numpy(np.array(
            arr[f"{arch}/{part}/" + "/".join(keys)])).to(m.dtype), like)


# -- the spawned ranks ---------------------------------------------------------

def _calls(g):
    return {k: (g.calls[k], g.bytes[k]) for k in g.calls}


def _rank(group, ref_dir):
    """Every arch on both meshes: the logits of each step, the final cache
    (flat) and the seq and model groups' calls of a step."""
    out = {}
    deadline = time.monotonic() + JOIN_S
    for arch in DECODE_ARCHS:
        path = Path(ref_dir) / f"{arch}.prefill.npz"
        while not path.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"the reference's prefill of {arch} "
                                   f"never arrived")
            time.sleep(0.1)
        arr = np.load(path)
        cfg = reduced_config(arch)
        numpy_params = tree_map_with_path(
            lambda keys, _: arr[f"{arch}/params/" + "/".join(keys)],
            lm.param_shapes(cfg))
        tokens = torch.from_numpy(_tokens(arch))
        for name, (sizes, axes) in GRIDS.items():
            grid = sharding.Mesh(sizes, axes)
            fn, _, cshapes, specs = steps_lib.shard_decode_step(
                grid, cfg, B, MAX_LEN, rules_overrides=OVERRIDE, group=group)
            params = bridge.serve_params_from_numpy(
                numpy_params, cfg, (group.model_index, group.model.size),
                rules_overrides=OVERRIDE)
            whole = _tree(arr, arch, "cache", cshapes)
            cache = tree_map(lambda t: t.clone(), sharding.grid_share(
                whole, specs["cache"], grid,
                sharding.mesh_coords(grid, group.rank)))
            seq = group.seq_group(grid, OVERRIDE["kv_seq"])   # fn's own
            logits, calls = [], None
            for i in range(STEPS):
                before = (_calls(seq), _calls(group.model))
                lg, cache = fn(params, cache,
                               tokens[:, PROMPT + i:PROMPT + i + 1])
                logits.append(lg[..., :cfg.vocab_size].numpy())
                calls = (_delta(before[0], _calls(seq)),
                         _delta(before[1], _calls(group.model)))
            out[(arch, name)] = {"logits": np.stack(logits),
                                 "cache": _flat(cache), "calls": calls,
                                 "share": seq.rank, "shares": seq.size}
    return out


def _delta(before, after):
    return {k: (v[0] - before.get(k, (0, 0))[0],
                v[1] - before.get(k, (0, 0))[1])
            for k, v in after.items() if v[0] != before.get(k, (0, 0))[0]}


# -- the reference, in a subprocess --------------------------------------------

_REFERENCE = textwrap.dedent("""
    import os, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import reduced_config
    from repro.models import lm

    out_dir, arch = sys.argv[1], sys.argv[2]
    tokens = jnp.asarray(np.asarray(%(tokens)r[arch], np.int32))
    pre, dec = {}, {}

    def key(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    def put(into, prefix, tree):
        for p, v in jax.tree_util.tree_leaves_with_path(tree):
            into[prefix + key(p)] = np.asarray(v)

    def save(name, tree):
        tmp = os.path.join(out_dir, arch + "." + name + ".tmp.npz")
        np.savez(tmp, **tree)
        os.replace(tmp, os.path.join(out_dir, arch + "." + name + ".npz"))

    cfg = reduced_config(arch)
    params = jax.jit(lambda: lm.init_lm(jax.random.key(0), cfg))()
    cache = lm.init_cache(cfg, %(B)d, %(L)d)
    _, cache = jax.jit(lambda p, b, c: lm.prefill(p, b, cfg, c))(
        params, {"tokens": tokens[:, :%(P)d]}, cache)
    put(pre, arch + "/params/", params)
    put(pre, arch + "/cache/", cache)
    save("prefill", pre)
    step = jax.jit(lambda p, c, t: lm.decode_step(p, c, t, cfg))
    logits = []
    for i in range(%(S)d):
        lg, cache = step(params, cache, tokens[:, %(P)d + i:%(P)d + i + 1])
        logits.append(np.asarray(lg)[..., :cfg.vocab_size])
    dec[arch + "/logits"] = np.stack(logits)
    put(dec, arch + "/cache/", cache)
    save("decode", dec)
""") % {"tokens": {a: _tokens(a).tolist() for a in DECODE_ARCHS},
        "B": B, "L": MAX_LEN, "P": PROMPT, "S": STEPS}


@pytest.fixture(scope="module")
def runs():
    """Starts the reference (a subprocess an arch) and the port's one
    spawn at once; the returned callable waits for them and gives their
    outputs."""
    tmp = tempfile.TemporaryDirectory(prefix="production_mesh_")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, tmp.name, arch], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in DECODE_ARCHS]
    done = {}

    def result():
        if not done:
            pool = ThreadPoolExecutor(1)
            port = pool.submit(mesh.spawn, f"{__name__}:_rank", 4, tmp.name,
                               device="cpu", threads=1, timeout_s=JOIN_S,
                               grid=(2, 2))
            try:
                # this process is idle while the ranks run: count the pod
                # record of the last test meanwhile
                done["record"] = dryrun.run_cell(
                    "gemma3-4b", "long_500k", pod=True,
                    out_dir=Path(tmp.name) / "records")
                done["port"] = port.result()
            finally:
                pool.shutdown(wait=True)
                errs = [p.communicate(timeout=600)[1] for p in procs]
            for p, err in zip(procs, errs):
                assert p.returncode == 0, err[-3000:]
            done["ref"] = {k: v for arch in DECODE_ARCHS for k, v in np.load(
                Path(tmp.name) / f"{arch}.decode.npz").items()}
        return done

    yield result
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()
    tmp.cleanup()


# -- decode parity ----------------------------------------------------------------

@pytest.mark.parametrize("grid_name", sorted(GRIDS))
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sequence_sharded_decode_matches_the_reference(runs, arch,
                                                       grid_name):
    """The ranks' logits at every step within 1e-5 of the reference's
    one-process ``decode_step``, bit-identical across the ranks (pod
    replicas included), and each rank's updated cache its block of the
    reference's (the sequence over ``("data", "model")``, the batch and
    the KV heads whole)."""
    got = runs()
    ref = got["ref"]
    sizes, axes = GRIDS[grid_name]
    grid = sharding.Mesh(sizes, axes)
    cfg = reduced_config(arch)
    group = GridGroup(data=DataGroup(size=2), model=ModelGroup(size=2),
                      size=4)
    _, _, cshapes, specs = steps_lib.shard_decode_step(
        grid, cfg, B, MAX_LEN, rules_overrides=OVERRIDE, group=group)
    whole = _tree(ref, arch, "cache", cshapes)
    ranks = [r[(arch, grid_name)] for r in got["port"]]
    for r, rank in enumerate(ranks):
        np.testing.assert_allclose(rank["logits"], ref[f"{arch}/logits"],
                                   **TOL)
        assert np.array_equal(rank["logits"], ranks[0]["logits"]), r
        want = _flat(tree_map(lambda t: t.numpy(), sharding.grid_share(
            whole, specs["cache"], grid, sharding.mesh_coords(grid, r))))
        assert set(rank["cache"]) == set(want)
        for k, v in want.items():
            assert rank["cache"][k].shape == v.shape, k
            np.testing.assert_allclose(rank["cache"][k], v, **TOL)
    shares = math.prod(grid.shape[a] for a in OVERRIDE["kv_seq"])
    assert sorted(r["share"] for r in ranks) == sorted(
        list(range(shares)) * (4 // shares))


def test_a_share_with_no_valid_position_is_weighed_zero():
    """On the (2, 2) grid the global layers' cache (64 slots, 16 a share)
    holds positions up to 42 only, so share 3 attends nothing: its
    partial is ``m = -inf``, ``l = 0``, ``o = 0`` (no NaN), and the
    combine weighs it 0 -- checked above by the logits; here directly."""
    assert 3 * MAX_LEN // 4 > PROMPT + STEPS - 1
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen)
               for shape in ((1, 1, 2, 8), (1, 4, 2, 8), (1, 4, 2, 8)))
    o, m, l = L.decode_attention(q, k, v, torch.full((1, 4), 50),
                                 torch.tensor([42]), partial=True)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.isinf(m).all() and (m < 0).all()
    assert torch.equal(l, torch.zeros_like(l))
    # one live share and the empty one combine to the live share alone
    live = L.decode_attention(q, k, v, torch.arange(4)[None],
                              torch.tensor([42]), partial=True)
    parts = [live, (o, m, l)]

    class Two:
        """Two shares: the gather packs each share's parts as the ranks'
        would."""
        def all_gather(self, t, dim):
            return torch.cat([torch.cat([p[0].reshape(1, 2, 8),
                                         p[1][..., None], p[2][..., None]],
                                        -1)[None] for p in parts], dim)

    out = L.seq_combine(*live, Two())
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, live[0], rtol=1e-6, atol=0)
    whole = L.decode_attention(q, k, v, torch.arange(4)[None],
                               torch.tensor([42]))
    torch.testing.assert_close(out, whole, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_seq_and_model_group_calls_equal_the_reckoning(runs, arch):
    """A decode step's combine gathers (the seq group) and the model
    group's calls equal ``roofline.serve_tp_calls`` with ``seq_shards``
    and the kinds held whole under the override."""
    for name, (sizes, axes) in GRIDS.items():
        grid = sharding.Mesh(sizes, axes)
        cfg = reduced_config(arch)
        n = math.prod(grid.shape[a] for a in OVERRIDE["kv_seq"])
        with sharding.rules(OVERRIDE):
            whole = sharding.grid_whole(grid)
        assert "attn" in whole and "ffn" not in whole
        want = roofline.serve_tp_calls(cfg, 2, B, 1, seq_shards=n,
                                       whole=whole)
        combine = want.pop("combine", None)
        for rank in runs()["port"]:
            seq_calls, model_calls = rank[(arch, name)]["calls"]
            assert seq_calls == ({"all-gather": combine} if combine else {})
            assert model_calls == want
        if arch != "mamba2-2.7b":
            assert combine[0] == sum(
                m in ("attn", "local", "mla")
                for unit, count in layer_groups(cfg) for m, _ in unit
                for _ in range(count))


# -- the meshes, overrides and placement ------------------------------------------

def test_make_production_mesh_and_its_parallel_config():
    pod = mesh.make_production_mesh()
    multi = mesh.make_production_mesh(multi_pod=True)
    assert pod == sharding.Mesh((16, 16), ("data", "model"))
    assert multi == sharding.Mesh((2, 16, 16), ("pod", "data", "model"))
    assert (pod.size, multi.size) == (256, 512)
    assert mesh.parallel_config_for(multi).dp_axes == ("pod", "data")
    assert mesh.parallel_config_for(pod).dp_axes == ("data",)


@pytest.mark.parametrize("over", [
    None, {"vocab": None}, {"heads": None}, {"model": None},
    {"expert": None}, {"batch": None}, {"batch": "data"},
    {"batch": ("pod", "data")}, {"kv_seq": "model"},
    {"kv_seq": ("data", "model")}, {"kv_seq": ("model", "data")},
    {"batch": None, "kv_seq": ("pod", "data", "model")},
    {"heads": "model", "expert": "model"}])
def test_overrides_with_a_path_pass(over):
    sharding.check_overrides(over)


@pytest.mark.parametrize("over", [
    {"heads": "data"}, {"expert": "data"}, {"batch": "model"},
    {"vocab": "data"}, {"kv_seq": "stage"}, {"model": ("data", "model")}])
def test_moved_roles_raise_naming_the_deliberate_difference(over):
    with pytest.raises(NotImplementedError, match="model group only"):
        sharding.check_overrides(over)


def test_grid_share_and_axis_slices_over_a_tuple_of_axes():
    """A dim sharded over ``("data", "model")`` is cut row-major, the first
    axis major (as GSPMD orders a mesh's devices); given a coord on the
    major axis only, a rank's slice holds all its minor blocks; given one on
    the minor axis only it is not one slice and raises."""
    grid = sharding.Mesh((2, 3), ("data", "model"))
    t = torch.arange(2 * 12).reshape(2, 12)
    spec = sharding.P(None, ("data", "model"))
    for d in range(2):
        for m in range(3):
            got = sharding.grid_share(t, spec, grid, {"model": m, "data": d})
            assert torch.equal(got, t[:, (d * 3 + m) * 2:(d * 3 + m + 1) * 2])
    assert sharding.axis_slices(spec, t, grid, "data", 1) == (1, 6, 6)
    assert sharding.axis_slices(sharding.P("model"), t, grid, "data",
                                1) is None
    with pytest.raises(ValueError, match="not one slice"):
        sharding.axis_slices(spec, t, grid, "model", 1)
    assert tuple(sharding.local_shapes(spec, t, grid).shape) == (2, 2)
    with pytest.raises(ValueError, match="divisible by 6"):
        sharding.check_divides(spec, torch.empty(2, 8), grid, "x")


def test_kv_seq_takes_model_first_and_holds_the_heads_whole():
    """Under the override on the pod the cache's k/v resolve to ``P(None,
    None, ("data", "model"))`` (``kv_seq`` claims ``model`` before
    ``heads``), MLA's latents to ``P(None, None, ("data", "model"))``; the
    attention then runs whole (``grid_whole``), the dense FFN over
    ``model``, and ``check_model_parallel`` skips the heads."""
    pod = mesh.make_production_mesh()
    cfg = get_config("gemma3-4b")
    cache = lm.cache_shapes(cfg, 1, 524288)
    with sharding.rules(OVERRIDE):
        assert sharding.seq_axes(pod) == ("data", "model")
        assert sharding.grid_whole(pod) == frozenset({"attn"})
        specs = sharding.grid_cache_pspec(cache, cfg, pod)
        pspec = sharding.serve_params_pspec(lm.param_shapes(cfg), cfg, pod)
    assert tuple(specs["groups"][0][0]["self"]["k"]) == (
        None, None, ("data", "model"))
    assert tuple(pspec["groups"][0][0]["mixer"]["wq"]) == ()
    assert tuple(pspec["groups"][0][0]["ffn"]["wg"]) == (None, None, "model")
    with pytest.raises(ValueError, match="num_kv_heads"):
        kvcache.check_model_parallel(cfg, 16)
    kvcache.check_model_parallel(cfg, 16, frozenset({"attn"}))
    mla = get_config("deepseek-v2-lite-16b")
    with sharding.rules(OVERRIDE):
        spec = sharding.grid_cache_pspec(lm.cache_shapes(mla, 1, 4096), mla,
                                         pod)
    assert tuple(spec["groups"][0][0]["self"]["ckv"]) == (
        None, None, ("data", "model"))
    assert sharding.sharded_state_bytes(cache, specs, pod) == \
        42418176 + 8                    # the share, and the position


def test_seq_group_picks_the_ranks_of_its_axes():
    """The seq group is the world, the model group or the data group where
    its members are theirs (no new process group), its rank the share
    index row-major over the axes as listed."""
    grid = sharding.Mesh((2, 2), ("data", "model"))
    pod = sharding.Mesh((2, 1, 2), ("pod", "data", "model"))
    for rank in range(4):
        world, data, model = object(), object(), object()
        g = GridGroup(data=DataGroup(rank=rank // 2, size=2, pg=data),
                      model=ModelGroup(rank=rank % 2, size=2, pg=model),
                      rank=rank, size=4, pg=world)
        s = g.seq_group(grid, ("data", "model"))
        assert isinstance(s, SeqGroup)
        assert (s.pg, s.rank, s.size) == (world, rank, 4)
        assert g.seq_group(grid, ("model",)).pg is model
        assert g.seq_group(grid, ("data",)).pg is data
        s = g.seq_group(pod, ("data", "model"))
        assert (s.pg, s.rank, s.size) == (model, rank % 2, 2)
        s = g.seq_group(grid, ("model", "data"))
        assert (s.rank, s.pg) == ((rank % 2) * 2 + rank // 2, world)


# -- spec parity with the reference ------------------------------------------------

def _stand_in(sizes, names):
    return types.SimpleNamespace(axis_names=tuple(names),
                                 shape=dict(zip(names, sizes)))


def _flat_spec(tree):
    out = {}
    tree_map_with_path(lambda keys, s: out.setdefault("/".join(keys),
                                                      tuple(s)),
                       tree, is_leaf=lambda x: isinstance(x, sharding.P))
    return out


def _flat_ref(tree):
    import jax
    from jax.sharding import PartitionSpec as JP
    from repro.dist import sharding as jshd
    return {"/".join(jshd._path_keys(p)): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))}


def _headless(spec):
    """A cache spec with its KV-head entry whole."""
    e = list(spec)
    if len(e) > 3 and e[3] == "model":
        e[3] = None
    while e and e[-1] is None:
        e.pop()
    return tuple(e)


PRODUCTION = {"pod16x16": ((16, 16), ("data", "model")),
              "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_specs_equal_the_reference_on_the_production_meshes(arch):
    """``params_pspec``, ``cache_pspec`` (a long_500k-sized cache) and
    ``state_pspec(zero1=True)`` leaf by leaf equal to the reference's on
    both production meshes, with and without the small-batch override;
    the serving grid's params either the reference's spec or whole (MLA,
    the table and norms, the attention under the override), its cache the
    reference's but for a cross-attending layer's heads, and the training
    grid's state the reference's under ``EXPERT_ONLY``."""
    import jax
    from repro.config import TrainConfig as JTrain
    from repro.configs import get_config as j_get
    from repro.dist import sharding as jshd
    from repro.dist import steps as j_steps
    from repro.models import lm as jlm
    from repro_torch.config import TrainConfig
    cfg, jcfg = get_config(arch), j_get(arch)
    enc = 4096 if cfg.enc_layers else 0
    shapes = lm.param_shapes(cfg)
    j_shapes = jax.eval_shape(lambda: jlm.init_lm(jax.random.key(0), jcfg))
    cache = lm.cache_shapes(cfg, 1, 4096, enc_len=enc)
    j_cache = jlm.cache_shapes(jcfg, 1, 4096, enc_len=enc)
    state = steps_lib.train_state_shapes(cfg, TrainConfig())
    j_state = j_steps.train_state_shapes(jcfg, JTrain())
    kinds = {(m, f) for unit, _ in layer_groups(cfg) for m, f in unit}
    for name, (sizes, axes) in PRODUCTION.items():
        m, jm = sharding.Mesh(sizes, axes), _stand_in(sizes, axes)
        for over in (None, OVERRIDE):
            with sharding.rules(over), jshd.rules(over):
                ref_p = _flat_ref(jshd.params_pspec(j_shapes, mesh=jm))
                ref_c = _flat_ref(jshd.cache_pspec(j_cache, mesh=jm))
                assert _flat_spec(sharding.params_pspec(shapes, m)) == ref_p
                assert _flat_spec(sharding.cache_pspec(cache, m)) == ref_c
                assert _flat_spec(sharding.state_pspec(
                    state, m, zero1=True)) == _flat_ref(jshd.state_pspec(
                        j_state, mesh=jm, zero1=True))
                serve_p = _flat_spec(sharding.serve_params_pspec(
                    shapes, cfg, m))
                grid_c = _flat_spec(sharding.grid_cache_pspec(cache, cfg,
                                                              m))
            assert set(serve_p) == set(ref_p)
            for k, spec in serve_p.items():
                assert spec in (ref_p[k], ()), (name, over, k)
                if over and "/mixer/" in k:
                    assert spec == (), k
            for k, spec in grid_c.items():
                if spec != ref_c[k]:
                    # a cross-attending layer's KV heads, whole
                    assert ("xdec", "dense") in kinds, (name, over, k)
                    assert spec == _headless(ref_c[k]), k
        with jshd.rules(sharding.EXPERT_ONLY):
            want = _flat_ref(jshd.state_pspec(j_state, mesh=jm, zero1=True))
        assert _flat_spec(sharding.grid_state_pspec(state, m,
                                                    zero1=True)) == want


# -- outcome parity: the dry run on the production meshes ---------------------------

def _reference_divides(arch, shape_name, multi_pod):
    """Whether the reference's rule table lays the cell out on the
    production mesh (a stand-in), as its ``lower_cell`` places it."""
    import jax
    from jax.sharding import PartitionSpec as JP
    from repro.config import SHAPES as J_SHAPES, TrainConfig as JTrain
    from repro.configs import get_config as j_get
    from repro.dist import sharding as jshd
    from repro.dist import steps as j_steps
    from repro.models import lm as jlm
    sizes, axes = PRODUCTION["pod2x16x16" if multi_pod else "pod16x16"]
    jm = _stand_in(sizes, axes)
    cfg, shape = j_get(arch), J_SHAPES[shape_name]
    trees = []
    with jshd.rules(dryrun.cell_overrides(shape.kind, shape.global_batch)):
        if shape.kind == "train":
            st = j_steps.train_state_shapes(cfg, JTrain(optimizer="adamw"))
            trees.append((jshd.state_pspec(st, mesh=jm, zero1=True), st))
        else:
            p = jax.eval_shape(lambda: jlm.init_lm(jax.random.key(0), cfg))
            c = jlm.cache_shapes(cfg, shape.global_batch, shape.seq_len,
                                 enc_len=shape.seq_len if cfg.enc_layers
                                 else 0)
            trees += [(jshd.params_pspec(p, mesh=jm), p),
                      (jshd.cache_pspec(c, mesh=jm), c)]
        rows = jax.ShapeDtypeStruct((shape.global_batch, 1), np.int32)
        trees.append((jshd.batch_pspec(rows, mesh=jm), rows))
    ok = True

    def one(spec, leaf):
        nonlocal ok
        for i, e in enumerate(spec):
            n = math.prod(jm.shape[a] for a in sharding.axes_of(e))
            ok &= leaf.shape[i] % n == 0

    for specs, shapes in trees:
        jax.tree.map(one, specs, shapes, is_leaf=lambda x: isinstance(x, JP))
    return ok


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_dryrun_outcome_agrees_with_the_reference_divisibility(arch):
    """Each cell of ``cells()`` on both production meshes lays out in the
    port's dry run (``layout_cell``, the count's layout) exactly where the
    reference's specs divide."""
    for a, shape, skip in cells(include_skipped=True):
        if a != arch or skip:
            continue
        for multi in (False, True):
            want = _reference_divides(arch, shape, multi)
            try:
                dryrun.layout_cell(arch, shape, pod=not multi,
                                   multi_pod=multi)
                got = True
            except ValueError as e:
                assert "divisible by 16" in str(e), e
                got = False
            assert got == want, (arch, shape, multi)
            expect = {("yi-6b", "decode_32k"): False,
                      ("gemma3-4b", "decode_32k"): False,
                      ("gemma3-4b", "long_500k"): True,
                      ("recurrentgemma-2b", "long_500k"): True,
                      ("deepseek-v2-lite-16b", "decode_32k"): True,
                      ("mamba2-2.7b", "prefill_32k"): True}
            assert expect.get((arch, shape), got) == got, (arch, shape)


def test_pod_record_holds_the_reckoned_bytes_and_collectives(runs,
                                                            tmp_path):
    """gemma3-4b ``long_500k`` counted on one rank of the pod (while the
    decode ranks run): the small-batch override, 256 sequence shards, the
    rank's params (the attention whole, the FFN over 16) and cache bytes as
    reckoned, the collective bytes the combine gathers and the FFN
    all-reduces of ``serve_tp_calls``; ``--multi-pod``'s rank lays out the
    same; yi-6b ``decode_32k`` writes an error record."""
    rec = runs()["record"]
    assert rec["ok"] and (rec["mesh"], rec["chips"]) == ("pod16x16", 256)
    assert rec["rules_overrides"] == OVERRIDE
    assert rec["seq_shards"] == 256
    cfg = get_config("gemma3-4b")
    calls = roofline.serve_tp_calls(cfg, 16, 1, 1, seq_shards=256,
                                    whole=frozenset({"attn"}))
    assert rec["collective_breakdown"] == pytest.approx(
        roofline.serve_wire_bytes(calls, 16, 256), rel=1e-12)
    assert rec["num_collectives"] == sum(v[0] for v in calls.values())
    assert rec["param_bytes"] == 2 * 1373155840
    assert rec["cache_bytes"] == 42418176 + 8
    multi = dryrun.layout_cell("gemma3-4b", "long_500k", multi_pod=True)
    assert (multi.n, multi.T, multi.n_seq) == (32, 16, 256)
    bad = dryrun.run_cell("yi-6b", "decode_32k", pod=True, out_dir=tmp_path)
    assert not bad["ok"] and "divisible by 16" in bad["error"]
    assert SHAPES["long_500k"].global_batch < 16 <= \
        SHAPES["decode_32k"].global_batch
