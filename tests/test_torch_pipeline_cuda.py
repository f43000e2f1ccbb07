"""A pipeline of two stage ranks that share the card over gloo, held against
the same two ranks on the CPU (yi-6b-reduced and mamba2-reduced, f32, the
kernels on: their plain versions on the CPU), from one set of weights drawn
on the CPU, 1F1B over 2 microbatches, temporal k 4 (depths snapped to the
stages), one cycle: the losses within the card-vs-CPU tolerance of
``chip_smoke.py`` phase 4 (1e-3 relative), each step's grad norm and
AdamW's first moment within 1e-4 relative and the parameters' change
within 1e-3 (the relative L2 distance over the whole tree), as
``tests/test_torch_spatial_cuda.py`` holds a data group; and each card
step's launches: a frozen stage's rank launches the forward kernels
alone.

Marked ``cuda``: skips without a card.  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_pipeline_cuda.py``
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
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

LOSS_TOL = 1e-3         # phase 4's card against CPU
GRAD_TOL = 1e-4         # grad norm, first moment
CHANGE_TOL = 1e-3       # the parameters' change
M, STEPS = 2, 4
BACKWARD = ("flash_delta", "flash_dq", "flash_dkv", "ssd_bwd", "rglru_bwd")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _rank(group, arch, params):
    """One stage's rank (the spawned ranks' target): the pipeline from
    ``params`` (numpy, the whole tree) for one cycle on the seeded batches;
    each step's loss, grad norm, bwd_stages and launches, and the whole
    final parameters and first moment on rank 0."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(reduced_config(arch), use_pallas=True)
    tcfg = TrainConfig(num_steps=STEPS, microbatches=M)
    eng = SPBEngine(cfg, tcfg, SPBConfig(mode="temporal", k=4), group=group,
                    parallelism="pipeline")
    eng.attach_state(steps_lib.state_from_params(
        tree_map(torch.from_numpy, params), tcfg))
    pipe = Pipeline(cfg, 4, 64, seed=0)
    counters = launch_counters()
    out = {"losses": [], "grad_norms": [], "bwd_stages": [], "launches": []}
    for s in range(STEPS):
        before = {n: f.launches for n, f in counters.items()}
        m = eng.train_step(group.shard(pipe.get_batch(s), M), s)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
        out["bwd_stages"].append(eng.step_fn(eng.last_depth).bwd_stages)
        out["launches"].append({n: f.launches - before[n]
                                for n, f in counters.items()})
    whole = eng.gathered_state()
    if whole is not None:
        host = lambda t: t.detach().float().cpu().numpy()
        out["params"] = tree_map(host, whole["params"])
        out["mu"] = tree_map(host, whole["opt"]["mu"])
    return out


def _ranks(device, arch, params):
    return mesh.spawn(f"{__name__}:_rank", 2, arch, params, device=device,
                      grid=(2, 1, 1), timeout_s=600)


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want|| over every leaf, in f64."""
    pairs = [(np.float64(a), np.float64(b))
             for a, b in zip(tree_leaves(got), tree_leaves(want))]
    return float(np.sqrt(sum(np.sum((a - b) ** 2) for a, b in pairs)
                         / sum(np.sum(b ** 2) for _, b in pairs)))


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-2.7b"])
def test_two_stages_on_the_card_equal_the_cpu(cuda, arch):
    init = tree_map(lambda t: t.detach().numpy(), lm.init_lm(
        torch.Generator().manual_seed(0), reduced_config(arch), "cpu"))
    card, cpu = _ranks("cuda", arch, init), _ranks("cpu", arch, init)
    for ranks in (card, cpu):
        assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(card[0]["losses"], cpu[0]["losses"],
                               rtol=LOSS_TOL)
    np.testing.assert_allclose(card[0]["grad_norms"], cpu[0]["grad_norms"],
                               rtol=GRAD_TOL)
    change = lambda out: tree_map(lambda p, p0: p - p0, out["params"], init)
    assert _rel_l2(card[0]["mu"], cpu[0]["mu"]) <= GRAD_TOL
    assert _rel_l2(change(card[0]), change(cpu[0])) <= CHANGE_TOL
    assert cpu[0]["launches"][0] == dict.fromkeys(cpu[0]["launches"][0], 0)
    for stage, out in enumerate(card):
        for b, grew in zip(out["bwd_stages"], out["launches"]):
            backward = sum(grew[n] for n in BACKWARD)
            assert any(grew.values())
            assert (backward == 0) if stage < 2 - b else (backward > 0)
