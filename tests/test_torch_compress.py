"""The gradient compressors (``repro_torch/core/compress.py``) against
``repro.core.compress`` on the same numpy inputs.

``topk`` is deterministic and equals the reference bit for bit.  ``randk``
and ``lowrank`` draw from ``torch.Generator`` streams that cannot match
``jax.random``'s: the lowrank projection is held at 1e-5 against the
reference when fed the reference's own draw, randk by its structure.  A
3-step temporal SPB run with ``topk`` tracks the reference's step driven
eagerly (its topk does not jit), at 1e-5 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.config import SPBConfig as JSPB, TrainConfig as JTrain
from repro.configs import reduced_config as j_reduced
from repro.core import compress as j_compress
from repro.core import spb as j_spb
from repro.data.pipeline import Pipeline as JPipeline
from repro.dist import steps as j_steps
from repro_torch import bridge
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.core import compress
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist import steps as steps_lib
from repro_torch.engine.engine import SPBEngine

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)


def _normal(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.37, 0.9])
@pytest.mark.parametrize("shape", [(64, 32), (4, 16, 24), (100,)])
def test_topk_equals_the_reference_bit_for_bit(ratio, shape):
    x = _normal(shape, seed=len(shape))
    want = np.asarray(j_compress.topk_apply(jnp.asarray(x), ratio))
    got = compress.topk_apply(torch.from_numpy(x), ratio).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,rank", [((32, 32), 3), ((32, 48), 8),
                                        ((4, 16, 24), 3), ((2, 8, 8), 3)])
def test_lowrank_projection_equals_the_reference_on_its_draw(shape, rank):
    """``_lowrank_project`` on the reference's own ``q`` (the normal draw
    of its key, redrawn here) gives the reference's output to 1e-5."""
    x = _normal(shape, seed=1)
    key = jax.random.key(7)
    want = np.asarray(j_compress.lowrank_apply(jnp.asarray(x), rank, key))
    cols = int(np.prod(shape[1:]))
    q = np.array(jax.random.normal(key, (cols, rank), jnp.float32))
    got = compress._lowrank_project(torch.from_numpy(x),
                                    torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_lowrank_passes_a_vector_unchanged():
    g = torch.from_numpy(_normal((17,)))
    assert compress.lowrank_apply(g, 3, torch.Generator()) is g


@pytest.mark.parametrize("ratio", [0.05, 0.25, 0.5])
def test_randk_keeps_k_entries_scaled_and_is_seeded(ratio):
    g = torch.from_numpy(_normal((48, 20), seed=2))
    k = max(1, int(g.numel() * ratio))
    out = compress.randk_apply(g, ratio, torch.Generator().manual_seed(3))
    kept = out != 0
    assert int(kept.sum()) == k
    # the reference's scaling: times the reciprocal of the ratio
    assert torch.equal(out[kept], g[kept] * (1.0 / ratio))
    again = compress.randk_apply(g, ratio, torch.Generator().manual_seed(3))
    other = compress.randk_apply(g, ratio, torch.Generator().manual_seed(4))
    assert torch.equal(out, again) and not torch.equal(out, other)


# -- mirrors of tests/test_optim_compress_data.py (compression) ----------

@given(ratio=st.floats(0.05, 0.9))
@settings(max_examples=10, deadline=None)
def test_topk_keeps_largest(ratio):
    g = torch.from_numpy(_normal((64, 32)))
    out = compress.topk_apply(g, ratio).numpy()
    kept = out != 0
    k = max(1, int(g.numel() * ratio))
    assert kept.sum() == k
    thresh = np.sort(np.abs(g.numpy()).ravel())[-k]
    assert np.all(np.abs(g.numpy())[kept] >= thresh - 1e-7)


def test_compress_tree_roundtrip_none():
    g = {"a": torch.ones(4, 4), "b": [torch.zeros(2)]}
    out = compress.compress_tree(g, "none", 0.1, torch.Generator())
    assert out is g


def test_lowrank_reduces_error_with_rank():
    g = torch.from_numpy(_normal((32, 32), seed=1))
    e = []
    for r in (1, 8, 32):
        approx = compress.lowrank_apply(g, r, torch.Generator().manual_seed(2))
        e.append(float(torch.linalg.norm(approx - g)))
    assert e[0] > e[1] > e[2]
    assert e[2] < 1e-3                       # full rank ~ exact


# -- the tree --------------------------------------------------------------

def test_compress_tree_keeps_none_and_gives_each_leaf_its_stream():
    """A None leaf stays None; each leaf's draw comes from a stream of its
    own, seeded from the generator in sorted-key order, so a None leaf or
    another leaf's shape moves no other leaf's draw."""
    a, b = torch.from_numpy(_normal((8, 8), 1)), torch.from_numpy(
        _normal((8, 8), 2))
    full = compress.compress_tree({"b": b, "a": a, "c": torch.ones(3, 3)},
                                  "randk", 0.25, torch.Generator().manual_seed(5))
    gaps = compress.compress_tree({"a": a, "b": b, "c": None},
                                  "randk", 0.25, torch.Generator().manual_seed(5))
    assert gaps["c"] is None
    assert torch.equal(full["a"], gaps["a"]) and torch.equal(full["b"],
                                                             gaps["b"])
    assert not torch.equal(full["a"] != 0, full["b"] != 0)
    with pytest.raises(ValueError, match="unknown compression"):
        compress.compress_tree({"a": a}, "sign", 0.1, torch.Generator())


def test_compression_generator_is_seeded_by_seed_and_step():
    draw = lambda seed, step: torch.randint(
        0, 2 ** 62, (4,), generator=steps_lib.compression_generator(
            TrainConfig(seed=seed), step))
    assert torch.equal(draw(0, 3), draw(0, 3))
    assert not torch.equal(draw(0, 3), draw(0, 4))
    assert not torch.equal(draw(0, 3), draw(1, 3))


# -- a compressed SPB run against the reference ---------------------------

def test_topk_temporal_run_tracks_the_reference_eager_step():
    """yi-6b-reduced, temporal SPB k=4, compression topk at ratio 0.1,
    batch 2 x 64, 3 steps (depths 4, 1, 3): the reference's step through
    ``make_train_step`` without ``jax.jit`` and the port's engine agree on
    loss, xent, grad_norm and lr to 1e-5 relative."""
    jcfg = j_reduced("yi-6b")
    jt = JTrain(num_steps=3, compression="topk")
    jspb = JSPB(mode="temporal", k=4)
    jstate = j_steps.init_train_state(jax.random.key(0), jcfg, jt)
    params = jax.tree.map(np.asarray, jstate["params"])
    sched = j_spb.make_schedule(jcfg, jspb)
    jpipe = JPipeline(jcfg, 2, 64, seed=0)
    want = []
    for s in range(3):
        step = j_steps.make_train_step(jcfg, jt, jspb,
                                       depth=sched.depth_at(s))
        jstate, m = step(jstate, jpipe.get_batch(s))
        want.append({k: float(v) for k, v in m.items()})

    cfg = t_reduced("yi-6b")
    tcfg = TrainConfig(num_steps=3, compression="topk")
    eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal", k=4), device="cpu")
    eng.attach_state(steps_lib.state_from_params(
        bridge.params_from_numpy(params, cfg), tcfg))
    pipe = Pipeline(cfg, 2, 64, seed=0)
    for s, jm in enumerate(want):
        m = eng.train_step(pipe.get_batch(s), s)
        for key in ("loss", "xent", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), jm[key], rtol=1e-5,
                                       err_msg=f"step {s} {key}")
