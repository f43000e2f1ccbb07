"""The port's MoE layer against the JAX package's: routing invariants and
values, the dense layer's output, aux and gradients for qwen3-moe-reduced's
and deepseek-v2-lite-reduced's MoEConfig (the latter with a shared
expert), and the expert-parallel share: the parts that all the shares of
a layer compute add up to the whole layer.

Tolerance 2e-4 (the LM suites' f32 tolerance): f32 products summed in
another order on each side."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro_torch import bridge
from repro_torch import config as tc
from repro_torch.configs import reduced_config as t_reduced
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-lite-16b")


def _port_cfg(arch: str, **moe) -> tc.ModelConfig:
    """The reference's reduced config as the port's ModelConfig, with its
    MoE fields (the layer needs only d_model and the MoE)."""
    j = j_reduced(arch)
    return tc.ModelConfig(
        name=j.name, family=j.family, d_model=j.d_model,
        num_layers=j.num_layers, vocab_size=j.vocab_size, d_ff=j.d_ff,
        moe=tc.MoEConfig(**dict(dataclasses.asdict(j.moe), **moe)),
        dtype=j.dtype)


def _layer(arch: str, seed: int = 0, tokens: int = 16):
    """The reference's init_moe weights and an input, as numpy."""
    j = j_reduced(arch)
    p = jax.tree.map(np.asarray,
                     jmoe.init_moe(jax.random.key(seed), j, jnp.float32))
    x = np.random.default_rng(seed).standard_normal(
        (2, tokens // 2, j.d_model)).astype(np.float32) * 0.5
    return j, p, x


def test_route_topk_invariants_and_values():
    j = j_reduced("qwen3-moe-235b-a22b")
    m = j.moe
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, j.d_model)).astype(np.float32)
    router = rng.standard_normal((j.d_model, m.num_experts)).astype(np.float32)
    topv, topi, aux = tmoe._route(torch.from_numpy(x),
                                  torch.from_numpy(router),
                                  _port_cfg("qwen3-moe-235b-a22b").moe)
    assert topv.shape == (32, m.top_k) and topi.shape == (32, m.top_k)
    torch.testing.assert_close(topv.sum(-1), torch.ones(32), rtol=1e-5,
                               atol=1e-5)
    assert bool((topv >= 0).all())
    for row in topi.tolist():               # distinct experts per token
        assert len(set(row)) == m.top_k
    assert float(aux) > 0
    jv, ji, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(router), m)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(topv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_layer_output_aux_and_grads_match(arch):
    j, p, x = _layer(arch)
    gw = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def jloss(pp, xx):
        out, aux = jmoe.moe_fwd_dense(pp, xx, j)
        return jnp.sum(out * gw) + 3.0 * aux, (out, aux)

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(p, x)
    tp = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), p)
    tx = torch.tensor(x, requires_grad=True)
    out, aux = tmoe.moe_fwd(tp, tx, _port_cfg(arch))
    ((out * torch.from_numpy(gw)).sum() + 3.0 * aux).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **TOL)
    names = {"router", "wg", "wu", "wd"} | ({"shared"} if j.moe.num_shared
                                            else set())
    assert set(tp) == names
    for w, t in zip(jax.tree.leaves(jgp), jax.tree.leaves(tp)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), **TOL)
    assert float(tp["router"].grad.abs().max()) > 0


@pytest.mark.parametrize("held", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_shares_add_up_to_the_whole_layer(arch, held):
    """Each of the E / held shares holds experts [r * held, (r + 1) * held)
    and combines only the slots routed to them; with the shared expert
    counted once, their outputs add up to the reference's whole layer, and
    each share's aux is the whole layer's (the router sees all E)."""
    j, p, x = _layer(arch, seed=2, tokens=32)
    E = j.moe.num_experts
    whole, whole_aux = jmoe.moe_fwd_dense(p, x, j)
    cfg = _port_cfg(arch, experts_held=held)
    tx = torch.tensor(x)
    shared = 0.0
    if j.moe.num_shared:
        shared = tlayers.ffn_fwd(jax.tree.map(torch.tensor, p["shared"]),
                                 tx.reshape(-1, j.d_model)).reshape(x.shape)
    total = shared
    for r in range(E // held):
        rows = slice(r * held, (r + 1) * held)
        share = {k: torch.tensor(p[k][rows]) for k in ("wg", "wu", "wd")}
        share["router"] = torch.tensor(p["router"])
        if j.moe.num_shared:
            share["shared"] = jax.tree.map(torch.tensor, p["shared"])
        with torch.no_grad():
            out, aux = tmoe.moe_fwd_dense(share, tx, cfg,
                                          first_expert=r * held)
        total = total + (out - shared)
        np.testing.assert_allclose(float(aux), float(whole_aux), **TOL)
    np.testing.assert_allclose(total.numpy(), np.asarray(whole), **TOL)


def test_share_layout_and_validation():
    cfg = dataclasses.replace(
        t_reduced("qwen3-moe-235b-a22b"),
        moe=tc.MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                         experts_held=2))
    ffn = tlm.param_shapes(cfg)["groups"][0][0]["ffn"]
    assert tuple(ffn["router"].shape) == (4, 64, 4)       # all 4 scored
    assert tuple(ffn["wg"].shape) == (4, 2, 64, 32)       # 2 held
    assert tuple(ffn["wd"].shape) == (4, 2, 32, 64)
    for held in (0, 3, 5):
        with pytest.raises(ValueError, match="must divide"):
            tc.MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                         experts_held=held)


def test_ep_impl_and_unported_mixers_raise():
    """``impl="ep"`` at T = 1 (no group) against the reference's
    ``moe_fwd_ep`` on its host mesh of one device: at capacity 1.25, which
    drops slots here, the output, aux and the gradients of a linear
    functional of the output plus aux with respect to x and every weight,
    at 1e-5.  Then the mixers that once raised now build."""
    from jax.sharding import PartitionSpec as P
    cfg = t_reduced("qwen3-moe-235b-a22b")
    j, p, x = _layer("deepseek-v2-lite-16b", tokens=32)
    j = j.scaled(moe=dataclasses.replace(j.moe, impl="ep"))
    w = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)

    def f(pp, xx):
        y, aux = jmoe.moe_fwd_ep(pp, xx, j, ep_axis="model",
                                 dp_spec=P("data", None, None))
        return jnp.sum(y * w) + aux, (y, aux)

    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    with jax.sharding.set_mesh(mesh):
        (_, (jy, jaux)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, x)
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a),
                                             requires_grad=True), p)
    tx = torch.tensor(x, requires_grad=True)
    drops = []
    tmoe.DROP_SINKS.append(lambda n, _k: drops.append(int(n)))
    try:
        ty, taux = tmoe.moe_fwd_ep(tp, tx, _port_cfg(
            "deepseek-v2-lite-16b", impl="ep"))
    finally:
        tmoe.DROP_SINKS.pop()
    ((ty * torch.from_numpy(w)).sum() + taux).backward()
    assert sum(drops) > 0
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(float(taux), float(jaux), **tol)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), **tol)
    for got, want in zip(jax.tree.leaves(jax.tree.map(lambda t: t.grad, tp,
                                                      is_leaf=torch.is_tensor)),
                         jax.tree.leaves(gp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    # xdec layers (here with MoE FFNs), a frontend and an encoder now
    # build, as the reference's param trees
    for change in (dict(pattern=("xdec",)), dict(frontend="vision"),
                   dict(enc_layers=2)):
        jcfg = dataclasses.replace(j_reduced("qwen3-moe-235b-a22b"), **change)
        want = jax.eval_shape(lambda k: jlm.init_lm(k, jcfg),
                              jax.random.key(0))
        got = tlm.param_shapes(dataclasses.replace(cfg, **change))
        assert [tuple(w.shape) for w in jax.tree.leaves(want)] == \
            [tuple(t.shape) for t in jax.tree.leaves(got)]


def test_bridge_keeps_the_router_f32_and_rejects_a_wrong_expert_count():
    """At bf16 the router stays f32, in the layout, in the port's init and
    through the bridge; a tree with another expert count is refused."""
    j = j_reduced("qwen3-moe-235b-a22b").scaled(dtype="bfloat16")
    t = t_reduced("qwen3-moe-235b-a22b").scaled(dtype="bfloat16")
    want = jax.eval_shape(lambda k: jlm.init_lm(k, j), jax.random.key(0))
    shapes = tlm.param_shapes(t)
    tdt = lambda x: str(x.dtype).removeprefix("torch.")
    for w, s in zip(jax.tree.leaves(want), jax.tree.leaves(shapes)):
        assert (tuple(w.shape), str(w.dtype)) == (tuple(s.shape), tdt(s))
    ffn = want["groups"][0][0]["ffn"]
    assert {k for k, v in ffn.items() if v.dtype == jnp.float32} == \
        {"router"}
    init = tlm.init_lm(torch.Generator().manual_seed(0), t)
    for s, x in zip(jax.tree.leaves(shapes), jax.tree.leaves(init)):
        assert (x.shape, x.dtype) == (s.shape, s.dtype)
    router = init["groups"][0][0]["ffn"]["router"]
    assert abs(float(router.std()) * 8.0 - 0.88) < 0.1    # trunc N / sqrt(64)
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), want)
    bridged = bridge.params_from_numpy(tree, t)
    assert bridged["groups"][0][0]["ffn"]["router"].dtype == torch.float32
    for w, x in zip(jax.tree.leaves(want), jax.tree.leaves(bridged)):
        assert tdt(x) == str(w.dtype)
    tree["groups"][0][0]["ffn"]["wg"] = np.zeros((4, 8, 64, 32), np.float32)
    with pytest.raises(ValueError, match="wg"):
        bridge.params_from_numpy(tree, t)
