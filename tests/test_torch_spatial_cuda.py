"""Spatial SPB on two ranks that share the card over gloo, held against the
same two ranks on the CPU (yi-6b-reduced, f32, the kernels on: their
plain versions on the CPU), from one set of weights drawn on the CPU, 2
steps at k 2: each group's replicas bit-identical; the losses within the
card-vs-CPU tolerance of ``chip_smoke.py`` phase 4 (1e-3 relative); and,
since 2 warm-up steps move the loss and the weights too little for that
to see a wrong gradient, each step's grad norm and AdamW's first moment
within 1e-4 relative and the parameters' change within 1e-3 (the
relative L2 distance over the whole tree), as ``chip_smoke.py`` phase 18
(a) holds them.

Marked ``cuda``: skips without a card.  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spatial_cuda.py``
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist import steps as steps_lib
from repro_torch.engine.engine import SPBEngine
from repro_torch.launch import mesh
from repro_torch.models import lm
from repro_torch.tree import tree_leaves, tree_map

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

LOSS_TOL = 1e-3         # phase 4's card against CPU
GRAD_TOL = 1e-4         # grad norm, first moment
CHANGE_TOL = 1e-3       # the parameters' change (AdamW's second step)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _rank(group, params):
    """One rank (the spawned ranks' target): spatial k 2 from ``params``
    (numpy, the param tree's layout) for 2 steps on this rank's rows of
    the seeded global batches; each step's loss and grad norm, and the
    final parameters and first moment as numpy arrays."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)
    tcfg = TrainConfig(num_steps=2)
    eng = SPBEngine(cfg, tcfg, SPBConfig(mode="spatial", k=2), group=group)
    eng.attach_state(steps_lib.state_from_params(
        bridge.params_from_numpy(params, cfg), tcfg))
    pipe = Pipeline(cfg, 4, 64, seed=0)
    out = {"losses": [], "grad_norms": []}
    for s in range(2):
        m = eng.train_step(group.shard(pipe.get_batch(s)), s)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    host = lambda t: t.detach().float().cpu().numpy()
    out["params"] = tree_map(host, eng.state["params"])
    out["mu"] = tree_map(host, eng.state["opt"]["mu"])
    return out


def _ranks(device, params):
    return mesh.spawn(f"{__name__}:_rank", 2, params, device=device,
                      timeout_s=600)


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over every leaf, in f64."""
    pairs = [(np.float64(a), np.float64(b))
             for a, b in zip(tree_leaves(got), tree_leaves(want))]
    return float(np.sqrt(sum(np.sum((a - b) ** 2) for a, b in pairs)
                         / sum(np.sum(b ** 2) for _, b in pairs)))


def test_two_ranks_on_the_card_equal_the_cpu(cuda):
    init = tree_map(lambda t: t.detach().numpy(), lm.init_lm(
        torch.Generator().manual_seed(0), reduced_config("yi-6b"), "cpu"))
    card, cpu = _ranks("cuda", init), _ranks("cpu", init)
    for ranks in (card, cpu):
        for a, b in zip(tree_leaves(ranks[0]["params"]),
                        tree_leaves(ranks[1]["params"])):
            assert np.array_equal(a, b)
    np.testing.assert_allclose(card[0]["losses"], cpu[0]["losses"],
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(card[0]["grad_norms"], cpu[0]["grad_norms"],
                               rtol=GRAD_TOL)
    change = lambda out: tree_map(lambda p, p0: p - p0, out["params"], init)
    assert _rel_l2(card[0]["mu"], cpu[0]["mu"]) <= GRAD_TOL
    assert _rel_l2(change(card[0]), change(cpu[0])) <= CHANGE_TOL
