"""The layer recompute (``lm``'s ``remat``: the reference's ``REMAT`` none /
dots / full) on every train path of the port, on the CPU, f32:

  * the eager loss and every gradient leaf under 'dots' and 'full' equal
    'none''s bit for bit, and ``lm.swept_grads`` (the recompute of the
    functional steps) within 1e-6, for yi-6b (GQA), mamba2-2.7b (SSD),
    recurrentgemma-2b (RG-LRU and local attention), qwen3-moe (the MoE
    aux) and seamless-m4t-medium (the encoder and ``xdec``), reduced, at
    full backprop, at a depth that splits a group and at depth 1 -- the
    kernels' Functions on (their plain versions here);
  * each family matches the reference's ``loss_fn`` plus ``jax.grad``
    with ``repro.models.lm.REMAT`` set to the same policy (the reference
    without its Pallas kernels: the math the port's plain versions hold
    to), within 1e-5 of the leaf's largest entry, at a depth inside a
    group (seamless: depth 1, inside its decoder group); seamless's
    ``enc.final_norm`` keeps its exemption where the boundary lies in the
    decoder (ROADMAP.md Queue 3, ``tests/test_torch_encdec.py``);
  * the fused step under 'full' equals 'none''s, and one under 'dots'
    builds and steps (``tests/test_torch_fused_dots.py`` holds it);
  * the policy is part of the step-cache key, ``aot.step_ident`` and a
    stored table's key, and a table stored under 'none' misses under
    'full';
  * ``launch/train.py --remat full`` reproduces ``--remat none``'s losses.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils import checkpoint as ckpt
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import reduced_config as j_reduced
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import make_batch, reduced_config
from repro_torch.engine import aot
from repro_torch.engine.engine import SPBEngine
from repro_torch.engine.fused import FusedEngine, stack_batches
from repro_torch.launch import train as train_launch
from repro_torch.models import lm
from repro_torch.tree import tree_leaves, tree_map

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

REF_TOL = 1e-5          # the reference's f32 gradient tolerance
SWEEP_TOL = 1e-6
B, S = 2, 32

# (arch, depth): full backprop, a depth inside a group, depth 1 (which
# snaps to a whole unit of recurrentgemma's three layers)
CASES = [(a, d) for a in ("yi-6b", "mamba2-2.7b", "qwen3-moe-235b-a22b")
         for d in (None, 3, 1)]
CASES += [("recurrentgemma-2b", d) for d in (None, 3)]
CASES += [("seamless-m4t-medium", d) for d in (None, 3, 1)]


def _rel_err(got, want) -> float:
    return float(np.abs(got - want).max(initial=0.0)
                 / max(np.abs(want).max(initial=0.0), 1.0))


@pytest.fixture(scope="module")
def arch_setup():
    """Per arch: the reference's config, params and numpy batch, and the
    port's config (kernels on)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = dataclasses.replace(j_reduced(arch), use_pallas=False)
            tcfg = dataclasses.replace(reduced_config(arch), use_pallas=True)
            params = jax.tree.map(np.asarray,
                                  jlm.init_lm(jax.random.key(0), jcfg))
            rng = np.random.default_rng(0)
            batch = {k: rng.integers(0, jcfg.vocab_size, (B, S)).astype(
                np.int32) for k in ("tokens", "labels")}
            if jcfg.enc_layers:
                batch["frames"] = rng.standard_normal(
                    (B, S, jcfg.d_model)).astype(np.float32)
            cache[arch] = jcfg, tcfg, params, batch
        return cache[arch]

    return get


def _tbatch(batch):
    return {k: torch.from_numpy(v) if v.dtype == np.float32
            else torch.from_numpy(v).long() for k, v in batch.items()}


def _port(tcfg, params, batch, depth, remat):
    tp = bridge.params_from_numpy(params, tcfg)
    loss, _ = lm.loss_fn(tp, _tbatch(batch), tcfg, bwd_layers=depth,
                         remat=remat)
    loss.backward()
    # in the reference's leaf order (jax.tree sorts a dict's keys)
    grads = jax.tree.leaves(tree_map(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad, tp))
    return loss.detach(), grads


def _reference(jcfg, params, batch, depth, remat):
    token = jlm.REMAT.set(remat)
    try:
        loss, g = jax.value_and_grad(lambda p: jlm.loss_fn(
            p, batch, jcfg, bwd_layers=depth)[0])(params)
    finally:
        jlm.REMAT.reset(token)
    return float(loss), [np.asarray(x) for x in jax.tree.leaves(g)]


def _exempt(jcfg, params, depth):
    """The leaf index of seamless's ``enc.final_norm`` in ``params`` (the
    module's shared reference params) where the boundary lies in the
    decoder (the reference backpropagates through frozen decoder layers
    into it), else None."""
    if not jcfg.enc_layers or depth is None or depth >= jcfg.num_layers:
        return None
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    (i,) = [i for i, n in enumerate(names)
            if n == "['enc']['final_norm']"]
    return i


@pytest.mark.parametrize("arch,depth", CASES)
def test_recompute_equals_none(arch_setup, arch, depth):
    jcfg, tcfg, params, batch = arch_setup(arch)
    none_loss, none_g = _port(tcfg, params, batch, depth, "none")
    for remat in ("dots", "full"):
        loss, grads = _port(tcfg, params, batch, depth, remat)
        assert torch.equal(loss, none_loss), remat
        for g, w in zip(grads, none_g):
            assert torch.equal(g, w), remat
    # the functional steps' sweep
    sg, metrics = lm.swept_grads(bridge.params_from_numpy(params, tcfg),
                                 _tbatch(batch), tcfg, bwd_layers=depth)
    assert torch.equal(metrics["loss"], none_loss)
    for g, w in zip(jax.tree.leaves(sg), none_g):
        assert _rel_err(g.detach().numpy(), w.numpy()) <= SWEEP_TOL


# the reference's grad compiles its scans anew each call (2-7 s a call
# here), so each family is held to it once under 'full' at a depth inside
# a group (seamless: depth 1, inside its decoder group), and GQA, SSD and
# the encoder-decoder also under 'dots'
REF_CASES = [("yi-6b", 3, "full"), ("yi-6b", 3, "dots"),
             ("mamba2-2.7b", 3, "full"), ("mamba2-2.7b", 3, "dots"),
             ("qwen3-moe-235b-a22b", 3, "full"),
             ("recurrentgemma-2b", 3, "full"),
             ("seamless-m4t-medium", 1, "full"),
             ("seamless-m4t-medium", 1, "dots")]


@pytest.mark.parametrize("arch,depth,remat", REF_CASES)
def test_recompute_matches_the_reference_under_its_remat(arch_setup, arch,
                                                          depth, remat):
    jcfg, tcfg, params, batch = arch_setup(arch)
    loss, grads = _port(tcfg, params, batch, depth, remat)
    want_loss, want = _reference(jcfg, params, batch, depth, remat)
    assert abs(float(loss) - want_loss) <= REF_TOL * max(abs(want_loss), 1)
    assert len(want) == len(grads)
    skip = _exempt(jcfg, params, depth)
    for i, (g, w) in enumerate(zip(grads, want)):
        if i != skip:
            assert _rel_err(g.numpy(), w) <= REF_TOL, i


def test_a_projection_dispatches_as_mm_and_dots_keeps_it():
    """``x @ W`` at any rank reaches ``aten.mm`` (the policy keeps it),
    an attention-score einsum ``bmm`` (recomputed), and 'dots' reports
    the kept bytes."""
    seen = []

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func)
            return func(*args, **(kwargs or {}))

    x, w = torch.randn(2, 3, 4), torch.randn(4, 5)
    with Ops():
        x @ w
        torch.einsum("bqd,bkd->bqk", x, x)
    assert torch.ops.aten.mm.default in seen
    assert torch.ops.aten.bmm.default in seen
    ctx = ckpt.SelectiveCheckpointContext(is_recompute=False)
    keep = ckpt.CheckpointPolicy.MUST_SAVE
    kept = []
    lm.KEPT_SINKS.append(lambda ts, n: kept.append(n))
    try:
        assert lm._dots_policy(ctx, torch.ops.aten.mm.default,
                               x.reshape(6, 4), w) == keep
        assert lm._dots_policy(ctx, torch.ops.aten.bmm.default, x,
                               x.transpose(1, 2)) != keep
    finally:
        lm.KEPT_SINKS.pop()
    assert kept == [6 * 5 * 4]
    with pytest.raises(ValueError, match="remat"):
        lm.resolve_remat("some")
    token = lm.REMAT.set("full")
    try:
        assert lm.resolve_remat(None) == "full"
        assert lm.resolve_remat("none") == "none"
    finally:
        lm.REMAT.reset(token)
    assert lm.resolve_remat(None) == "none"


@pytest.mark.parametrize("arch,mode", [("yi-6b", "temporal"),
                                       ("seamless-m4t-medium", "temporal"),
                                       ("yi-6b", "temporal-mb")])
def test_fused_step_under_full_equals_none(arch, mode):
    cfg = reduced_config(arch)
    spb = SPBConfig(mode=mode, k=2)
    out = {}
    for remat in ("none", "full"):
        eng = FusedEngine(cfg, TrainConfig(), spb, num_jobs=2, device="cpu",
                          remat=remat, shared_cache=False)
        eng.init_states([0, 1])
        losses = []
        for s in range(2):
            batch = stack_batches([make_batch(cfg, 4, 16, seed=2 * s + j,
                                              device="cpu")
                                   for j in range(2)])
            losses.append(eng.train_step(batch, s)["loss"])
        out[remat] = losses, tree_leaves(eng.state["params"])
    # the first step's losses from one state; seamless's sweep sums the
    # encoder output's cotangent in another order (~1e-9)
    assert torch.equal(out["none"][0][0], out["full"][0][0])
    for a, b in zip(out["none"][0], out["full"][0]):
        assert _rel_err(b.numpy(), a.numpy()) <= SWEEP_TOL
    for a, b in zip(out["none"][1], out["full"][1]):
        assert _rel_err(b.numpy(), a.numpy()) <= SWEEP_TOL
    dots = FusedEngine(cfg, TrainConfig(), spb, num_jobs=2, device="cpu",
                       remat="dots", shared_cache=False)
    dots.init_states([0, 1])
    loss = dots.train_step(stack_batches([
        make_batch(cfg, 4, 16, seed=j, device="cpu") for j in range(2)]),
        0)["loss"]
    assert torch.equal(loss, out["none"][0][0])


def test_the_policy_keys_the_step_cache_and_the_table(tmp_path):
    cfg, tcfg = reduced_config("yi-6b"), TrainConfig()
    spb = SPBConfig(mode="temporal", k=2)
    idents = {r: aot.step_ident(cfg, tcfg, spb, remat=r)
              for r in lm.REMAT_POLICIES}
    assert len({str(sorted(v.items())) for v in idents.values()}) == 3
    engines = {r: SPBEngine(cfg, tcfg, spb, device="cpu", remat=r)
               for r in ("none", "full")}
    assert engines["none"].step_cache_key(2) != \
        engines["full"].step_cache_key(2)
    token = lm.REMAT.set("full")
    try:           # the context variable gives the default at build time
        assert SPBEngine(cfg, tcfg, spb, device="cpu").remat == "full"
    finally:
        lm.REMAT.reset(token)
    batch = make_batch(cfg, 2, 16, device="cpu")
    specs = engines["none"].batch_specs_like(batch)
    paths = {r: e.aot_cache_path(specs, tmp_path) for r, e in
             engines.items()}
    assert paths["none"] != paths["full"]
    engines["none"].init_state(0)
    engines["none"].export_aot(paths["none"], specs)
    assert aot.read_manifest(paths["none"])["env"]["remat"] == "none"
    full = engines["full"]
    full.init_state(0)
    assert not full.load_aot(paths["full"])          # no table there
    assert not full.load_aot(paths["none"])          # another policy's
    assert not full._frozen
    fresh = SPBEngine(cfg, tcfg, spb, device="cpu", remat="none")
    fresh.init_state(0)
    assert fresh.load_aot(paths["none"])


def test_train_launcher_remat_reproduces_the_losses(capsys):
    argv = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
            "16", "--spb-mode", "temporal", "--spb-k", "2", "--use-pallas",
            "--log-every", "1"]
    none = train_launch.train(argv + ["--remat", "none"])
    full = train_launch.train(argv + ["--remat", "full"])
    assert len(none) == 3 and none == full
    assert capsys.readouterr().out.count("[train] step=") == 6
