"""Expert parallelism on the card: reduced deepseek-v2-lite-16b with
``impl="ep"`` on a (data 2, model 2) grid of four ranks that share the
card over gloo, held against the same four ranks on the CPU (f32, the
kernels on: their plain versions on the CPU), from one set of weights
drawn on the CPU, temporal k 4, one cycle: the losses within the
card-vs-CPU tolerance of ``chip_smoke.py`` phase 4 (1e-3 relative), each
step's grad norm within 1e-4 relative and the parameters' change within
1e-3 (the relative L2 distance over the whole tree), as
``tests/test_torch_tensor_parallel_cuda.py`` holds a pipeline; each card
step's launches (every MLA layer launches the flash forward, a live one
the backward kernels too); the model group's calls and bytes a step equal
on the card and the CPU, and every rank's non-expert parameters are
bit-identical on the card.

Marked ``cuda``: skips without a card.  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_expert_parallel_cuda.py``
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.dist import steps as steps_lib
from repro_torch.engine.engine import SPBEngine
from repro_torch.engine.graphs import launch_counters
from repro_torch.launch import mesh
from repro_torch.models import lm
from repro_torch.tree import tree_leaves, tree_map

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

LOSS_TOL = 1e-3         # phase 4's card against CPU
GRAD_TOL = 1e-4         # grad norm
CHANGE_TOL = 1e-3       # the parameters' change
STEPS = 4
GRID = (2, 2)
BACKWARD = ("flash_delta", "flash_dq", "flash_dkv")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _cfg():
    cfg = dataclasses.replace(reduced_config("deepseek-v2-lite-16b"),
                              use_pallas=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            impl="ep"))


def _rank(group, params):
    """One rank of the grid (the spawned ranks' target): the engine from
    ``params`` (numpy, the whole tree) for one cycle on the seeded
    batches; each step's loss, grad norm, depth, launches and model-group
    calls, this rank's non-expert parameters, and the whole final
    parameters on rank 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg()
    tcfg = TrainConfig(num_steps=STEPS)
    eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal", k=4), group=group)
    eng.attach_state(steps_lib.state_from_params(
        tree_map(torch.from_numpy, params), tcfg))
    pipe = Pipeline(cfg, 4, 32, seed=0)
    counters = launch_counters()
    out = {"losses": [], "grad_norms": [], "depths": [], "launches": [],
           "calls": []}
    for s in range(STEPS):
        before = {n: f.launches for n, f in counters.items()}
        calls = {k: (group.model.calls[k], group.model.bytes[k])
                 for k in group.model.calls}
        m = eng.train_step(group.shard(pipe.get_batch(s)), s)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["depths"].append(eng.last_depth)
        out["launches"].append({n: f.launches - before[n]
                                for n, f in counters.items()})
        out["calls"].append({k: (group.model.calls[k] - calls.get(k, (0, 0))[0],
                                 group.model.bytes[k] - calls.get(k, (0, 0))[1])
                             for k in group.model.calls})
    roles = tree_leaves(steps_lib.ep_roles(cfg))
    out["replicated"] = [t.detach().cpu().numpy() for t, r in zip(
        tree_leaves(eng.state["params"]), roles) if r != "expert"]
    whole = eng.gathered_state()
    if whole is not None:
        out["params"] = tree_map(lambda t: t.detach().float().cpu().numpy(),
                                 whole["params"])
    return out


def _ranks(device, params):
    return mesh.spawn(f"{__name__}:_rank", 4, params, device=device,
                      grid=GRID, timeout_s=600)


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over every leaf, in f64."""
    pairs = [(np.float64(a), np.float64(b))
             for a, b in zip(tree_leaves(got), tree_leaves(want))]
    return float(np.sqrt(sum(np.sum((a - b) ** 2) for a, b in pairs)
                         / sum(np.sum(b ** 2) for _, b in pairs)))


def test_ep_grid_on_the_card_equals_the_cpu(cuda):
    init = tree_map(lambda t: t.detach().numpy(), lm.init_lm(
        torch.Generator().manual_seed(0), _cfg(), "cpu"))
    card, cpu = _ranks("cuda", init), _ranks("cpu", init)
    for ranks in (card, cpu):
        assert all(r["losses"] == ranks[0]["losses"] for r in ranks)
    np.testing.assert_allclose(card[0]["losses"], cpu[0]["losses"],
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(card[0]["grad_norms"], cpu[0]["grad_norms"],
                               rtol=GRAD_TOL)
    change = lambda out: tree_map(lambda p, p0: p - p0, out["params"], init)
    assert _rel_l2(change(card[0]), change(cpu[0])) <= CHANGE_TOL
    assert cpu[0]["launches"][0] == dict.fromkeys(cpu[0]["launches"][0], 0)
    layers = _cfg().num_layers
    for r, out in enumerate(card):
        assert out["calls"] == cpu[r]["calls"]
        for a, b in zip(out["replicated"], card[0]["replicated"]):
            assert np.array_equal(a, b)
        for depth, grew in zip(out["depths"], out["launches"]):
            assert grew["flash_fwd"] == layers
            assert all(grew[n] == depth for n in BACKWARD)
