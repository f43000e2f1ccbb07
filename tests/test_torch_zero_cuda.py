"""ZeRO-1 on two ranks that share the card over gloo (yi-6b-reduced, f32,
the kernels on), from one set of weights drawn on the CPU, temporal k 2
for 2 steps, with ZeRO-1 and replicated: on the card, ZeRO-1's
parameters and gathered AdamW moments bit-identical to the replicated
group's and each rank's parameters to rank 0's; against the same ZeRO-1
ranks on the CPU, the losses within 1e-3 relative, each step's grad norm
and the first moment within 1e-4 and the parameters' change within 1e-3,
as ``chip_smoke.py`` phase 19 (a) holds them.

Marked ``cuda``: skips without a card.  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_zero_cuda.py``
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
CHANGE_TOL = 1e-3       # the parameters' change


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _rank(group, params):
    """One rank: temporal k 2 from ``params`` for 2 steps, replicated and
    with ZeRO-1; each run's losses, grad norms and parameters, and on
    rank 0 the gathered parameters and moments, as numpy arrays."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)
    tcfg = TrainConfig(num_steps=2)
    host = lambda t: t.detach().float().cpu().numpy()   # noqa: E731
    out = {}
    for zero1 in (False, True):
        eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal", k=2),
                        group=group, zero1=zero1, shared_cache=False)
        eng.attach_state(steps_lib.state_from_params(
            bridge.params_from_numpy(params, cfg), tcfg))
        pipe = Pipeline(cfg, 4, 64, seed=0)
        run = {"losses": [], "grad_norms": []}
        for s in range(2):
            m = eng.train_step(group.shard(pipe.get_batch(s)), s)
            run["losses"].append(float(m["loss"]))
            run["grad_norms"].append(float(m["grad_norm"]))
        run["params"] = tree_map(host, eng.state["params"])
        whole = eng.gathered_state()
        run["whole"] = None if whole is None else tree_map(
            host, {"params": whole["params"], "opt": whole["opt"]})
        out[zero1] = run
    return out


def _rel_l2(got, want) -> float:
    pairs = [(np.float64(a), np.float64(b))
             for a, b in zip(tree_leaves(got), tree_leaves(want))]
    return float(np.sqrt(sum(np.sum((a - b) ** 2) for a, b in pairs)
                         / sum(np.sum(b ** 2) for _, b in pairs)))


def test_zero1_on_the_card(cuda):
    init = tree_map(lambda t: t.detach().numpy(), lm.init_lm(
        torch.Generator().manual_seed(0), reduced_config("yi-6b"), "cpu"))
    card, cpu = (mesh.spawn(f"{__name__}:_rank", 2, init, device=dev,
                            timeout_s=600) for dev in ("cuda", "cpu"))
    for ranks in (card, cpu):
        for z in (False, True):
            for a, b in zip(tree_leaves(ranks[0][z]["params"]),
                            tree_leaves(ranks[1][z]["params"])):
                assert np.array_equal(a, b)
        zero, repl = ranks[0][True], ranks[0][False]
        assert zero["losses"] == repl["losses"]
        for a, b in zip(tree_leaves(zero["whole"]),
                        tree_leaves(repl["whole"])):
            assert np.array_equal(a, b)
    got, want = card[0][True], cpu[0][True]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_TOL)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=GRAD_TOL)
    assert _rel_l2(got["whole"]["opt"]["mu"],
                   want["whole"]["opt"]["mu"]) <= GRAD_TOL
    change = lambda run: tree_map(lambda p, p0: p - p0,     # noqa: E731
                                  run["whole"]["params"], init)
    assert _rel_l2(change(got), change(want)) <= CHANGE_TOL
