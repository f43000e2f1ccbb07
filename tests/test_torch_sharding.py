"""The port's sharding rules and ZeRO-1 state layout
(``repro_torch/dist/sharding.py``) against the reference's
``repro/dist/sharding.py``: pure index logic, no process is spawned.

* Each case of the reference's ``tests/test_sharding.py``, rebuilt on the
  port's ``Mesh`` and meta-device state.
* Every registered arch's reduced train state: ``state_pspec(zero1=True)``
  leaf by leaf equal to the reference's (``jax.eval_shape`` on its side)
  on meshes of data 2, 4 and 16 and (pod 2, data 16, model 16), and
  ``pipeline_state_pspec`` on (stage 2, data 2); ``sharded_state_bytes``
  equal, also at yi-6b's published widths cut to 4 layers.
* ``params_pspec``, ``batch_pspec``, ``cache_pspec``, ``paged_cache_pspec``
  and ``serve_state_pspec`` on the same trees, and the rule overrides.
* A ``hypothesis`` property: ``dp_partition_plan`` agrees on random shapes
  and specs.
* ``shard_slices``: each rank's slices tile every sharded leaf.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh, PartitionSpec as JP

from repro.config import TrainConfig as JTrain
from repro.configs import get_config as j_get, reduced_config as j_reduced
from repro.dist import sharding as jshd
from repro.dist import steps as j_steps
from repro_torch.config import TrainConfig
from repro_torch.configs import ARCHS, full_width_config, reduced_config
from repro_torch.dist import sharding as shd
from repro_torch.dist import steps as steps_lib
from repro_torch.dist.group import DataGroup
from repro_torch.dist.sharding import Mesh, P
from repro_torch.tree import tree_leaves, tree_map, tree_map_with_path

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

MESHES = {       # name: (sizes, axis names)
    "data2": ((2, 1), ("data", "model")),
    "data4": ((4, 1), ("data", "model")),
    "data16": ((16, 1), ("data", "model")),
    "pod2_data16_model16": ((2, 16, 16), ("pod", "data", "model")),
}
STAGE_DATA = ((2, 2), ("stage", "data"))


def _meshes(sizes, names):
    """The reference's new-style ``AbstractMesh`` and the port's ``Mesh``."""
    return AbstractMesh(sizes, names), Mesh(sizes, names)


def _shapes(cfg, tcfg=None):
    return steps_lib.train_state_shapes(cfg, tcfg or TrainConfig())


def _flat_ref(tree):
    """{path: the spec's entries} of a reference spec tree."""
    return {"/".join(jshd._path_keys(p)): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))}


def _flat(tree):
    """{path: the spec's entries} of a port spec tree."""
    out = {}
    tree_map_with_path(lambda keys, s: out.setdefault("/".join(keys),
                                                      tuple(s)),
                       tree, is_leaf=lambda x: isinstance(x, P))
    return out


# -- the reference's tests/test_sharding.py, rebuilt -------------------------

def test_zero1_prefers_largest_divisible_dim():
    mesh = Mesh((4, 1), ("data", "model"))
    assert shd.zero1_spec(P(), (8, 256), mesh) == P(None, "data")
    assert shd.zero1_spec(P(), (8, 3), mesh) == P("data")
    assert shd.zero1_spec(P(), (64, 64), mesh) == P("data")


def test_zero1_respects_existing_axes():
    mesh = Mesh((4, 1), ("data", "model"))
    assert shd.zero1_spec(P("model", None), (512, 64), mesh) == \
        P("model", "data")
    assert shd.zero1_spec(P("data", None), (8, 256), mesh) == \
        P("data", None)
    assert shd.zero1_spec(P(), (3, 5), mesh) == P()
    assert shd.zero1_spec(P(), (8, 256), Mesh((4,), ("model",))) == P()


def test_zero1_multi_pod_axes():
    mesh = Mesh((2, 2, 1), ("pod", "data", "model"))
    assert shd.zero1_spec(P(), (4, 64), mesh) == P(None, ("pod", "data"))


def test_state_pspec_zero1_locked_specs():
    shapes = _shapes(reduced_config("yi-6b"), TrainConfig(optimizer="adamw"))
    mesh = Mesh((4, 1), ("data", "model"))
    specs = shd.state_pspec(shapes, mesh=mesh, zero1=True)
    assert specs["opt"]["mu"]["embed"]["tok"] == P("model", "data")
    assert specs["opt"]["mu"]["groups"][0][0]["mixer"]["wq"] == \
        P(None, "data", "model")
    assert specs["params"]["groups"][0][0]["mixer"]["wq"] == \
        P(None, None, "model")
    assert specs["step"] == P()
    base = {k: shd.params_pspec(v, mesh=mesh)
            for k, v in shapes["opt"].items()}

    def check(bspec, zspec, leaf):
        b = list(bspec) + [None] * (leaf.dim() - len(bspec))
        z = list(zspec) + [None] * (leaf.dim() - len(zspec))
        added = [i for i, (x, y) in enumerate(zip(b, z)) if x != y]
        if added:
            (i,) = added
            assert z[i] == "data"
            assert leaf.shape[i] == max(
                leaf.shape[j] for j, e in enumerate(b)
                if e is None and leaf.shape[j] % 4 == 0
                and leaf.shape[j] >= 4)

    for key in shapes["opt"]:
        tree_map(check, base[key], specs["opt"][key], shapes["opt"][key],
                 is_leaf=lambda x: isinstance(x, P))


def test_zero1_composes_with_pipeline_state_pspec():
    shapes = _shapes(reduced_config("yi-6b"), TrainConfig(optimizer="adamw"))
    mesh = Mesh((2, 2), ("stage", "data"))
    specs = shd.pipeline_state_pspec(shapes, mesh=mesh, zero1=True)
    is_p = lambda x: isinstance(x, P)   # noqa: E731
    p_leaves = tree_leaves(specs["params"]["groups"], is_leaf=is_p)
    assert p_leaves
    for s in p_leaves:
        assert s[0] == "stage" and "data" not in tuple(s)
    assert specs["opt"]["mu"]["groups"][0][0]["mixer"]["wq"] == \
        P("stage", "data")
    mu = tree_leaves(specs["opt"]["mu"]["groups"], is_leaf=is_p)
    assert all(s[0] == "stage" for s in mu)
    assert any("data" in tuple(s) for s in mu)
    for s in mu:
        flat = [a for e in s if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]
        assert flat.count("stage") == 1
    assert "data" in tuple(specs["opt"]["mu"]["embed"]["tok"])
    assert specs["params"]["final_norm"] == P()
    assert specs["step"] == P()


def test_pipeline_state_pspec_without_zero1_keeps_data_free():
    shapes = _shapes(reduced_config("yi-6b"))
    specs = shd.pipeline_state_pspec(shapes, mesh=Mesh(*STAGE_DATA),
                                     zero1=False)
    for tree in (specs["params"], specs["opt"]):
        for s in tree_leaves(tree, is_leaf=lambda x: isinstance(x, P)):
            assert "data" not in tuple(s)


MESH3D = Mesh((2, 2, 2), ("stage", "data", "model"))


def test_dp_partition_plan_skips_claimed_dims():
    assert shd.dp_partition_plan(P("stage", None, "model"), (4, 64, 128),
                                 MESH3D) == (1, ("data",))
    assert shd.dp_partition_plan(P("stage", None, "model"), (4, 3, 128),
                                 MESH3D) is None
    assert shd.dp_partition_plan(P("stage", "data"), (4, 64, 128),
                                 MESH3D) is None


def test_zero2_spec_matches_zero1_plan():
    for spec, shape in [(P("stage", None, None, "model"), (2, 2, 64, 32)),
                        (P("stage", None, "model"), (2, 128, 64)),
                        (P("stage"), (2, 2, 64)), (P(), (512, 64))]:
        assert shd.zero2_spec(spec, shape, MESH3D) == \
            shd.zero1_spec(spec, shape, MESH3D)


def test_zero1_composes_with_model_on_3d_mesh():
    shapes = _shapes(reduced_config("yi-6b"), TrainConfig(optimizer="adamw"))
    specs = shd.pipeline_state_pspec(shapes, mesh=MESH3D, zero1=True)
    attn = lambda t: t["groups"][0][0]["mixer"]     # noqa: E731
    assert attn(specs["params"])["wq"] == P("stage", None, "model")
    assert attn(specs["opt"]["mu"])["wq"] == P("stage", "data", "model")
    assert attn(specs["params"])["wo"] == P("stage", "model")
    assert attn(specs["opt"]["mu"])["wo"] == P("stage", "model", "data")
    assert specs["opt"]["mu"]["groups"][0][0]["ln1"] == P("stage", "data")


def test_param_leaf_spec_matches_param_spec_on_views():
    shapes = _shapes(reduced_config("yi-6b"))
    want = shd.params_pspec(shapes["params"], mesh=MESH3D)

    def check(keys, leaf):
        node = want
        for k in keys:
            node = node[int(k) if isinstance(node, list) else k]
        assert shd.param_leaf_spec(keys, leaf.shape, mesh=MESH3D) == node

    tree_map_with_path(check, shapes["params"])


def test_sharded_state_bytes_shrink_by_mesh_factors():
    shapes = _shapes(reduced_config("yi-6b"), TrainConfig(optimizer="adamw"))
    mesh2d = Mesh(*STAGE_DATA)
    b3 = shd.sharded_state_bytes(
        shapes, shd.pipeline_state_pspec(shapes, mesh=MESH3D, zero1=True),
        MESH3D)
    b2 = shd.sharded_state_bytes(
        shapes, shd.pipeline_state_pspec(shapes, mesh=mesh2d, zero1=True),
        mesh2d)
    assert b3 < b2
    p3 = shd.pipeline_state_pspec(shapes, mesh=MESH3D)["params"]["groups"]
    g3 = shd.sharded_state_bytes(shapes["params"]["groups"], p3, MESH3D)
    repl = tree_map(lambda s: P(), p3, is_leaf=lambda x: isinstance(x, P))
    g0 = shd.sharded_state_bytes(shapes["params"]["groups"], repl, MESH3D)
    assert g0 / g3 > 3.5


# -- leaf by leaf against the reference ---------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_state_specs_equal_the_reference(arch):
    """``state_pspec(zero1=True)`` on every mesh of :data:`MESHES`,
    ``pipeline_state_pspec`` on (stage 2, data 2) with ZeRO-1 on and off,
    and ``sharded_state_bytes`` of each, equal the reference's leaf by
    leaf on the arch's reduced AdamW train state."""
    shapes = _shapes(reduced_config(arch))
    j_shapes = j_steps.train_state_shapes(j_reduced(arch), JTrain())
    for sizes, names in MESHES.values():
        jm, m = _meshes(sizes, names)
        want = jshd.state_pspec(j_shapes, mesh=jm, zero1=True)
        got = shd.state_pspec(shapes, mesh=m, zero1=True)
        assert _flat(got) == _flat_ref(want), (arch, names)
        assert shd.sharded_state_bytes(shapes, got, m) == \
            jshd.sharded_state_bytes(j_shapes, want, jm)
    jm, m = _meshes(*STAGE_DATA)
    for zero1 in (True, False):
        want = jshd.pipeline_state_pspec(j_shapes, mesh=jm, zero1=zero1)
        got = shd.pipeline_state_pspec(shapes, mesh=m, zero1=zero1)
        assert _flat(got) == _flat_ref(want), (arch, zero1)
        assert shd.sharded_state_bytes(shapes, got, m) == \
            jshd.sharded_state_bytes(j_shapes, want, jm)


def test_uneven_pipeline_groups_equal_the_reference():
    shapes = _shapes(reduced_config("recurrentgemma-2b"))
    j_shapes = j_steps.train_state_shapes(j_reduced("recurrentgemma-2b"),
                                          JTrain())
    jm, m = _meshes(*STAGE_DATA)
    for uniform in ([True], [False], [True, False]):
        want = jshd.pipeline_state_pspec(j_shapes, mesh=jm, zero1=True,
                                         uniform_groups=uniform)
        got = shd.pipeline_state_pspec(shapes, mesh=m, zero1=True,
                                       uniform_groups=uniform)
        assert _flat(got) == _flat_ref(want)


def test_state_bytes_at_published_widths_equal_the_reference():
    """yi-6b at published widths cut to 4 layers (954,241,024 parameters,
    bf16 with f32 masters and moments): a rank's state bytes with ZeRO-1
    over 2 and 4 ranks and replicated equal the reference's, 2 + 12 / n
    bytes a parameter where a dim splits."""
    cfg = dataclasses.replace(full_width_config("yi-6b"), num_layers=4)
    jcfg = dataclasses.replace(j_get("yi-6b"), num_layers=4)
    shapes = _shapes(cfg)
    j_shapes = j_steps.train_state_shapes(jcfg, JTrain())
    params = sum(t.numel() for t in tree_leaves(shapes["params"]))
    assert params == 954_241_024
    for n in (1, 2, 4):
        jm, m = _meshes((n, 1), ("data", "model"))
        for zero1 in (True, False):
            got = shd.sharded_state_bytes(
                shapes, shd.state_pspec(shapes, mesh=m, zero1=zero1), m)
            assert got == jshd.sharded_state_bytes(
                j_shapes, jshd.state_pspec(j_shapes, mesh=jm, zero1=zero1),
                jm)
            per = 2 + 12 / (n if zero1 else 1)
            assert abs(got - 4 - per * params) <= 1e-6 * got


def _cache_tree(lib):
    """A cache / serving-state tree of every name the rules key on, as
    ``lib`` (``jax`` or ``torch``) shapes."""
    if lib == "jax":
        leaf = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)  # noqa: E731
    else:
        leaf = lambda *s: torch.empty(s, device="meta")         # noqa: E731
    return {"groups": [[{"k": leaf(2, 4, 16, 2, 8), "v": leaf(2, 4, 16, 2, 8),
                         "ckv": leaf(2, 4, 16, 8), "kr": leaf(2, 4, 16, 4),
                         "pos": leaf(4, 16), "state": leaf(2, 4, 3, 8),
                         "scalar": leaf(4)}]],
            "page_table": leaf(4, 8), "lens": leaf(4)}


@pytest.mark.parametrize("mesh", ["none", *MESHES])
def test_param_batch_and_cache_specs_equal_the_reference(mesh):
    """``params_pspec`` (yi-6b, MoE and MLA trees), ``batch_pspec``,
    ``cache_pspec``, ``paged_cache_pspec`` and ``serve_state_pspec``, with
    and without a mesh and under a rule override."""
    jm, m = (None, None) if mesh == "none" else _meshes(*MESHES[mesh])
    if jm is None:
        # the reference reads the ambient mesh: none is set here
        assert jax.sharding.get_abstract_mesh().empty
    for arch in ("yi-6b", "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b"):
        got = shd.params_pspec(_shapes(reduced_config(arch))["params"], m)
        want = jshd.params_pspec(j_steps.train_state_shapes(
            j_reduced(arch), JTrain())["params"], jm)
        assert _flat(got) == _flat_ref(want), arch
    cache = {"j": _cache_tree("jax"), "t": _cache_tree("torch")}
    for port, ref in ((shd.cache_pspec, jshd.cache_pspec),
                      (shd.paged_cache_pspec, jshd.paged_cache_pspec),
                      (shd.serve_state_pspec, jshd.serve_state_pspec),
                      (shd.batch_pspec, jshd.batch_pspec)):
        assert _flat(port(cache["t"], m)) == _flat_ref(ref(cache["j"], jm))
        with shd.rules({"batch": None, "kv_seq": ("data", "model")}), \
                jshd.rules({"batch": None, "kv_seq": ("data", "model")}):
            assert _flat(port(cache["t"], m)) == \
                _flat_ref(ref(cache["j"], jm))


AXES = [None, "data", "model", "stage", "pod", ("pod", "data")]
MESH_CHOICES = [((2, 1), ("data", "model")), ((4, 2), ("data", "model")),
                ((2, 4, 2), ("pod", "data", "model")),
                ((2, 2, 2), ("stage", "data", "model")), ((8,), ("model",)),
                ((3, 2), ("data", "model"))]


@settings(max_examples=150, deadline=None)
@given(mesh=st.sampled_from(MESH_CHOICES),
       shape=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 24, 64]),
                      min_size=0, max_size=4),
       entries=st.lists(st.sampled_from(AXES), max_size=4))
def test_dp_partition_plan_agrees_with_the_reference(mesh, shape, entries):
    entries = entries[:len(shape)]
    jm, m = _meshes(*mesh)
    want = jshd.dp_partition_plan(JP(*entries), tuple(shape), jm)
    got = shd.dp_partition_plan(P(*entries), tuple(shape), m)
    assert got == want
    assert tuple(shd.zero1_spec(P(*entries), tuple(shape), m)) == \
        tuple(jshd.zero1_spec(JP(*entries), tuple(shape), jm))


@pytest.mark.parametrize("n", [2, 4])
def test_rank_slices_tile_every_sharded_leaf(n):
    """Over n ranks of ``mesh_for``'s (n, 1) mesh each ZeRO-1 leaf's
    slices lie on its spec's data dim and tile it in rank order."""
    shapes = _shapes(reduced_config("yi-6b"))
    mesh = shd.mesh_for(DataGroup(size=n))
    specs = shd.state_pspec(shapes, mesh, zero1=True)["opt"]["mu"]
    slices = [shd.shard_slices(specs, shapes["opt"]["mu"], mesh, r)
              for r in range(n)]
    leaves = tree_leaves(shapes["opt"]["mu"])
    spec_leaves = tree_leaves(specs, is_leaf=lambda x: isinstance(x, P))
    per_rank = [tree_leaves(s, is_leaf=shd.is_slice) for s in slices]
    assert any(p is not None for p in per_rank[0])
    for i, (leaf, spec) in enumerate(zip(leaves, spec_leaves)):
        parts = [r[i] for r in per_rank]
        if "data" not in tuple(spec):
            assert parts == [None] * n
            continue
        dim = tuple(spec).index("data")
        size = leaf.shape[dim] // n
        assert parts == [(dim, r * size, size) for r in range(n)]
    assert np.all([p is None for p in tree_leaves(
        shd.shard_slices(specs, shapes["opt"]["mu"],
                         shd.mesh_for(DataGroup()), 0),
        is_leaf=shd.is_slice)])


@pytest.mark.parametrize("walk", ["tree_map", "tree_map_with_path"])
def test_tree_walk_frees_its_function_at_once(walk):
    """A tree walk leaves no reference cycle: what ``fn``'s closure holds
    (a train step's tensors) is freed when the walk returns, not at the
    next full garbage collection."""
    import gc
    import weakref

    held = torch.ones(4)
    gone = weakref.ref(held)
    fn = (lambda x, h=held: x + h) if walk == "tree_map" else \
        (lambda _, x, h=held: x + h)
    tree = {"a": [torch.zeros(4), torch.zeros(4)], "b": {"c": torch.zeros(4)}}
    enabled = gc.isenabled()
    gc.disable()
    try:
        gc.collect()
        out = (tree_map if walk == "tree_map" else tree_map_with_path)(
            fn, tree)
        del fn, held
        assert gone() is None
        assert float(out["b"]["c"].sum()) == 4.0
    finally:
        if enabled:
            gc.enable()
