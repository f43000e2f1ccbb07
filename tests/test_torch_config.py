"""The port's config and SPB schedule code must equal the JAX package's:
same fields, layer groups, snapping, depth cycles, rebalancing and
per-block scales, for yi-6b at full and reduced size and cut depths, and
the fields of every registered arch (the encoder-decoder's combined
stack and its pipeline-stage cuts among them); the full-width cuts."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import config as jc
from repro.configs import get_config as j_get, reduced_config as j_reduced
from repro.core import spb as jspb
from repro.models import lm as jlm
from repro_torch import config as tc
from repro_torch.configs import get_config as t_get, reduced_config as t_reduced
from repro_torch.core import spb as tspb
from repro_torch.models import lm as tlm

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

CFGS = [("full", None), ("full", 8), ("reduced", None), ("reduced", 1),
        ("reduced", 3), ("reduced", 8)]


def _pair(size, layers):
    j, t = ((j_get("yi-6b"), t_get("yi-6b")) if size == "full"
            else (j_reduced("yi-6b"), t_reduced("yi-6b")))
    if layers:
        j, t = j.scaled(num_layers=layers), t.scaled(num_layers=layers)
    return j, t


@pytest.mark.parametrize("size,layers", CFGS)
def test_model_config_and_layer_groups_match(size, layers):
    j, t = _pair(size, layers)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.padded_vocab, j.q_dim, j.kv_dim) == \
        (t.padded_vocab, t.q_dim, t.kv_dim)
    assert jc.layer_groups(j) == tc.layer_groups(t)
    assert jc.combined_layer_groups(j) == tc.combined_layer_groups(t)
    L = jc.total_layers(j)
    assert L == tc.total_layers(t)
    assert [jc.snap_depth(j, d) for d in range(L + 2)] == \
        [tc.snap_depth(t, d) for d in range(L + 2)]


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("size,layers", CFGS)
def test_spb_schedules_match(size, layers, k):
    j, t = _pair(size, layers)
    js = jc.SPBConfig(mode="temporal", k=k, warmup_steps=1)
    ts = tc.SPBConfig(mode="temporal", k=k, warmup_steps=1)
    L = jc.total_layers(j)
    assert js.depths(L) == ts.depths(L)
    assert jspb.snapped_depths(j, js) == tspb.snapped_depths(t, ts)
    assert jspb.layer_contributors(j, js) == tspb.layer_contributors(t, ts)
    jsch, tsch = jspb.make_schedule(j, js), tspb.make_schedule(t, ts)
    assert jsch.order == tsch.order
    assert [jsch.depth_at(s) for s in range(3 * k + 2)] == \
        [tsch.depth_at(s) for s in range(3 * k + 2)]
    for slow in ([0], [1, 2], [k - 1, 2 * k]):
        assert jsch.rebalance(slow).order == tsch.rebalance(slow).order
    jscales = jspb.group_layer_scales(j, js)
    tscales = tspb.group_layer_scales(t, ts)
    assert len(jscales) == len(tscales)
    for jg, tg in zip(jscales, tscales):
        for a, b in zip(jg, tg):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("lr_rescale", [True, False])
def test_scale_params_tree_matches(lr_rescale):
    """The SPB weighted-average scaling of a gradient tree: the same
    multiplications by the same f32 scales, so equal to the bit."""
    j, t = _pair("reduced", None)
    js = jc.SPBConfig(mode="temporal", k=4, lr_rescale=lr_rescale)
    ts = tc.SPBConfig(mode="temporal", k=4, lr_rescale=lr_rescale)
    shapes = jlm.param_shapes(j)
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    want = jax.tree.map(np.asarray, jspb.scale_params_tree(tree, j, js))
    got = tspb.scale_params_tree(
        jax.tree.map(torch.from_numpy, tree), t, ts)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(w, g.numpy())


MAMBA2 = [("full", None), ("full", 32), ("reduced", None), ("reduced", 3)]


def _mamba2_pair(size, layers):
    j, t = ((j_get("mamba2-2.7b"), t_get("mamba2-2.7b")) if size == "full"
            else (j_reduced("mamba2-2.7b"), t_reduced("mamba2-2.7b")))
    if layers:
        j, t = j.scaled(num_layers=layers), t.scaled(num_layers=layers)
    return j, t


@pytest.mark.parametrize("size,layers", MAMBA2)
def test_mamba2_config_and_spb_schedules_match(size, layers):
    j, t = _mamba2_pair(size, layers)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert jc.layer_groups(j) == tc.layer_groups(t)
    L = jc.total_layers(j)
    assert [jc.snap_depth(j, d) for d in range(L + 2)] == \
        [tc.snap_depth(t, d) for d in range(L + 2)]
    js, ts = jc.SPBConfig(mode="temporal", k=4), tc.SPBConfig(mode="temporal",
                                                             k=4)
    assert jspb.snapped_depths(j, js) == tspb.snapped_depths(t, ts)
    jsch, tsch = jspb.make_schedule(j, js), tspb.make_schedule(t, ts)
    assert [jsch.depth_at(s) for s in range(8)] == \
        [tsch.depth_at(s) for s in range(8)]


RECURRENTGEMMA = [("full", None), ("full", 12), ("reduced", None),
                  ("reduced", 4)]


@pytest.mark.parametrize("size,layers", RECURRENTGEMMA)
def test_recurrentgemma_config_and_spb_schedules_match(size, layers):
    """Griffin's (rglru, rglru, local) units: the same fields, layer
    groups (a trailing short unit at 26 layers), snapping to whole units
    and depth cycles as the JAX package."""
    j, t = ((j_get("recurrentgemma-2b"), t_get("recurrentgemma-2b"))
            if size == "full" else (j_reduced("recurrentgemma-2b"),
                                    t_reduced("recurrentgemma-2b")))
    if layers:
        j, t = j.scaled(num_layers=layers), t.scaled(num_layers=layers)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert jc.layer_groups(j) == tc.layer_groups(t)
    L = jc.total_layers(j)
    assert [jc.snap_depth(j, d) for d in range(L + 2)] == \
        [tc.snap_depth(t, d) for d in range(L + 2)]
    js, ts = jc.SPBConfig(mode="temporal", k=4), tc.SPBConfig(mode="temporal",
                                                             k=4)
    assert jspb.snapped_depths(j, js) == tspb.snapped_depths(t, ts)
    jsch, tsch = jspb.make_schedule(j, js), tspb.make_schedule(t, ts)
    assert [jsch.depth_at(s) for s in range(8)] == \
        [tsch.depth_at(s) for s in range(8)]


def test_recurrentgemma_full_width_cut():
    """12 layers are four whole units in one layer group: 8 RG-LRU and 4
    local-attention layers, 1,683,192,320 parameters (655,360,000 of them
    the tied embedding), depths snapped to 3, 6, 9, 12; the same count as
    the JAX package's shapes."""
    from repro_torch.configs import full_width_config
    from repro_torch.models import lm as tlm
    from repro_torch.tree import tree_leaves
    cfg = full_width_config("recurrentgemma-2b")
    unit = (("rglru", "dense"), ("rglru", "dense"), ("local", "dense"))
    assert tc.layer_groups(cfg) == ((unit, 4),)
    shapes = tlm.param_shapes(cfg)
    assert sum(t.numel() for t in tree_leaves(shapes)) == 1_683_192_320
    assert shapes["embed"]["tok"].numel() == 655_360_000
    jshapes = jlm.param_shapes(j_get("recurrentgemma-2b").scaled(
        num_layers=12))
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(jshapes)) == \
        1_683_192_320
    ts = tc.SPBConfig(mode="temporal", k=4)
    assert tspb.snapped_depths(cfg, ts) == (3, 6, 9, 12)


@pytest.mark.parametrize("arch,layers,cycle,held", [
    ("yi-6b", 8, (8, 2, 6, 4), None),
    ("mamba2-2.7b", 32, (32, 8, 24, 16), None),
    ("recurrentgemma-2b", 12, (12, 3, 9, 6), None),
    ("gemma3-4b", 12, (12, 6, 12, 6), None),
    ("qwen3-moe-235b-a22b", 4, (4, 1, 3, 2), 8),
    ("deepseek-v2-lite-16b", 4, (4, 1, 3, 2), None),
    ("minicpm3-4b", 24, (24, 6, 18, 12), None),
    ("seamless-m4t-medium", 12, (24, 6, 18, 12), None),
    ("internvl2-26b", 4, (4, 1, 3, 2), None)])
def test_full_width_config_per_arch(arch, layers, cycle, held):
    from repro_torch.configs import full_width_config
    cfg = full_width_config(arch)
    want = t_get(arch)
    assert cfg.num_layers == layers and cfg.use_pallas
    moe = cfg.moe and dataclasses.replace(cfg.moe, experts_held=None)
    assert dataclasses.replace(cfg, num_layers=want.num_layers,
                               use_pallas=False, moe=moe) == want
    assert (cfg.moe and cfg.moe.experts_held) == held
    sch = tspb.make_schedule(cfg, tc.SPBConfig(mode="temporal", k=4))
    assert tuple(sch.depth_at(s) for s in range(4)) == cycle


def test_deepseek_67b_has_no_full_width_cut():
    from repro_torch.configs import full_width_config
    with pytest.raises(KeyError, match="no full-width cut"):
        full_width_config("deepseek-67b")


# parameters at the full-width cut, counted on the JAX package's shapes
# (qwen3 with 8 of each layer's 128 experts: the reference's config with
# num_experts=8 but the router's 128 outputs, 4,096 x 120 more a layer;
# deepseek-v2-lite-16b holds all 64)
@pytest.mark.parametrize("arch,n_params", [
    ("gemma3-4b", 1_803_614_720), ("qwen3-moe-235b-a22b", 2_137_034_752),
    ("deepseek-v2-lite-16b", 2_045_267_968), ("minicpm3-4b", 1_692_289_536),
    ("seamless-m4t-medium", 715_454_464), ("internvl2-26b", 2_129_713_152)])
def test_full_width_parameter_count(arch, n_params):
    from repro_torch.configs import full_width_config
    from repro_torch.tree import tree_leaves
    cfg = full_width_config(arch)
    assert sum(t.numel() for t in tree_leaves(tlm.param_shapes(cfg))) == \
        n_params
    j = j_get(arch).scaled(num_layers=cfg.num_layers,
                           enc_layers=cfg.enc_layers)
    held = cfg.moe is not None and cfg.moe.experts_held
    if held:
        j = j.scaled(moe=dataclasses.replace(j.moe, num_experts=held))
    extra = cfg.num_layers * cfg.d_model * 120 if held else 0
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        jlm.param_shapes(j))) + extra == n_params


NEW_ARCHS = [("gemma3-4b", None), ("gemma3-4b", 12), ("deepseek-67b", None),
             ("deepseek-67b", 2), ("qwen3-moe-235b-a22b", None),
             ("qwen3-moe-235b-a22b", 4), ("deepseek-v2-lite-16b", None),
             ("deepseek-v2-lite-16b", 4), ("minicpm3-4b", None),
             ("minicpm3-4b", 24), ("seamless-m4t-medium", None),
             ("internvl2-26b", None), ("internvl2-26b", 4)]


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch,layers", NEW_ARCHS)
def test_new_arch_config_and_spb_schedules_match(arch, layers, size):
    """gemma3-4b, deepseek-67b, qwen3-moe-235b-a22b and the MLA archs
    deepseek-v2-lite-16b and minicpm3-4b: the same fields (the port's
    ``MoEConfig.experts_held`` left out, and None), layer groups, snapping
    and depth cycles as the JAX package."""
    j, t = ((j_get(arch), t_get(arch)) if size == "full"
            else (j_reduced(arch), t_reduced(arch)))
    if layers:
        j, t = j.scaled(num_layers=layers), t.scaled(num_layers=layers)
    got = dataclasses.asdict(t)
    if t.moe is not None:
        assert got["moe"].pop("experts_held") is None
    assert got == dataclasses.asdict(j)
    assert jc.layer_groups(j) == tc.layer_groups(t)
    L = jc.total_layers(j)
    assert [jc.snap_depth(j, d) for d in range(L + 2)] == \
        [tc.snap_depth(t, d) for d in range(L + 2)]
    js, ts = jc.SPBConfig(mode="temporal", k=4), tc.SPBConfig(mode="temporal",
                                                             k=4)
    assert jspb.snapped_depths(j, js) == tspb.snapped_depths(t, ts)
    jsch, tsch = jspb.make_schedule(j, js), tspb.make_schedule(t, ts)
    assert [jsch.depth_at(s) for s in range(8)] == \
        [tsch.depth_at(s) for s in range(8)]


def test_registry_holds_eight_archs_and_serving_sizes():
    """All ten of the reference's archs are registered; at published
    widths and full depth the three serving archs and the two frontend
    archs have the reference's parameter counts."""
    from repro.configs import ARCHS as J_ARCHS
    from repro_torch.configs import ARCHS
    from repro_torch.tree import tree_leaves
    assert sorted(ARCHS) == sorted(J_ARCHS) == sorted([
        "yi-6b", "mamba2-2.7b", "recurrentgemma-2b", "gemma3-4b",
        "deepseek-67b", "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b",
        "minicpm3-4b", "seamless-m4t-medium", "internvl2-26b"])
    for arch, n in (("yi-6b", 5_798_891_520), ("gemma3-4b", 3_879_907_840),
                    ("deepseek-v2-lite-16b", 15_496_769_024),
                    ("seamless-m4t-medium", 715_454_464),
                    ("internvl2-26b", 19_293_345_792)):
        got = sum(t.numel() for t in tree_leaves(tlm.param_shapes(
            t_get(arch))))
        want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
            jlm.param_shapes(j_get(arch))))
        assert got == want == n


FRONTEND_ARCHS = [(a, size) for a in ("seamless-m4t-medium", "internvl2-26b")
                  for size in ("full", "cut", "reduced")]


def _frontend_pair(arch, size):
    from repro_torch.configs import full_width_config
    if size == "reduced":
        return j_reduced(arch), t_reduced(arch)
    j, t = j_get(arch), t_get(arch)
    if size == "cut":
        cut = full_width_config(arch)
        j = j.scaled(num_layers=cut.num_layers, enc_layers=cut.enc_layers)
        t = t.scaled(num_layers=cut.num_layers, enc_layers=cut.enc_layers)
    return j, t


@pytest.mark.parametrize("arch,size", FRONTEND_ARCHS)
def test_frontend_arch_spb_and_stage_cuts_match(arch, size):
    """seamless-m4t-medium (the encoder first in the combined stack) and
    internvl2-26b: the same combined groups, snapped depths, contributors,
    per-block scales and pipeline-stage cuts, stage snapping and live
    stages at every depth, as the JAX package."""
    j, t = _frontend_pair(arch, size)
    assert jc.combined_layer_groups(j) == tc.combined_layer_groups(t)
    L = jc.total_layers(j)
    assert L == tc.total_layers(t) == j.num_layers + j.enc_layers
    js, ts = jc.SPBConfig(mode="temporal", k=4), tc.SPBConfig(mode="temporal",
                                                             k=4)
    assert jspb.snapped_depths(j, js) == tspb.snapped_depths(t, ts)
    assert jspb.layer_contributors(j, js) == tspb.layer_contributors(t, ts)
    for a, b in zip(jspb.group_layer_scales(j, js),
                    tspb.group_layer_scales(t, ts), strict=True):
        for x, y in zip(a, b, strict=True):
            np.testing.assert_array_equal(np.asarray(x), y.numpy())
    for n in range(1, min(4, len(tc._flat_unit_lens(t))) + 1):
        assert jc.stage_unit_cuts(j, n) == tc.stage_unit_cuts(t, n)
        for d in list(range(0, L + 2)) + [None]:
            if d is not None:
                assert jc.snap_depth_to_stages(j, d, n) == \
                    tc.snap_depth_to_stages(t, d, n)
            assert jc.depth_to_bwd_stages(j, d, n) == \
                tc.depth_to_bwd_stages(t, d, n)
        ps = dataclasses.replace(ts, pipeline_stages=n)
        assert tspb.snapped_depths(t, ps) == jspb.snapped_depths(
            j, dataclasses.replace(js, pipeline_stages=n))


@pytest.mark.parametrize("lr_rescale", [True, False])
def test_scale_params_tree_scales_the_encoder_as_the_reference(lr_rescale):
    """An encoder-decoder's gradient tree: the encoder's groups take the
    first group's scales, the decoder's the rest; equal to the bit."""
    j, t = j_reduced("seamless-m4t-medium"), t_reduced("seamless-m4t-medium")
    js = jc.SPBConfig(mode="temporal", k=4, lr_rescale=lr_rescale)
    ts = tc.SPBConfig(mode="temporal", k=4, lr_rescale=lr_rescale)
    rng = np.random.default_rng(1)
    tree = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        jlm.param_shapes(j))
    want = jax.tree.map(np.asarray, jspb.scale_params_tree(tree, j, js))
    got = tspb.scale_params_tree(jax.tree.map(torch.from_numpy, tree), t, ts)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(got), strict=True):
        np.testing.assert_array_equal(w, g.numpy())
    if lr_rescale:      # only depth 4 of 4 reaches encoder layer 0: x 4
        assert not np.array_equal(want["enc"]["groups"][0][0]["ln1"],
                                  tree["enc"]["groups"][0][0]["ln1"])
