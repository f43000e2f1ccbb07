"""The 'dots' recompute in the fused step on the card: ``FusedEngine`` of
two yi-6b-reduced tenants (f32, the kernels on; phase 14's path at the
reduced widths), temporal k 4 over one cycle, under 'dots' and 'none'
from the same seeds and batches: every 'dots' step launches what
``chip_smoke.expected_launches(..., "dots")`` counts at its depth (a live
layer's flash forward twice) and every 'none' step what 'none' counts,
and each tenant's losses, grad norms and updated parameters under 'dots'
equal 'none''s within 1e-6 of the leaf's largest entry, as on the CPU
(``tests/test_torch_fused_dots.py``).

Marked ``cuda``: skips without a card.  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fused_dots_cuda.py``
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.config import SPBConfig, TrainConfig
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import Pipeline
from repro_torch.engine.fused import FusedEngine, stack_batches
from repro_torch.tree import tree_leaves

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

J = 2
STEPS = 4               # one k 4 cycle
SWEEP_TOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _run(smoke, cfg, remat):
    """Each step's loss and grad norm (host) and the params after, with
    every step's launches held to ``expected_launches`` under
    ``remat``."""
    eng = FusedEngine(cfg, TrainConfig(num_steps=8),
                      SPBConfig(mode="temporal", k=4), num_jobs=J,
                      device="cuda", remat=remat, shared_cache=False)
    eng.init_states(list(range(J)))
    pipes = [Pipeline(cfg, 2, 64, seed=j) for j in range(J)]
    hist = []
    for s in range(STEPS):
        batch = stack_batches([p.get_batch(s) for p in pipes])
        before = smoke.launches_now()
        m = eng.train_step({k: v.cuda() for k, v in batch.items()}, s)
        grew = smoke.launches_since(before)
        assert grew == smoke.expected_launches(cfg, [eng.last_depth],
                                               remat), (remat, s)
        hist.append({k: m[k].cpu() for k in ("loss", "xent", "grad_norm")})
    return hist, [t.cpu() for t in tree_leaves(eng.state["params"])]


def _rel_err(got, want) -> float:
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), 1.0))


def test_fused_dots_on_the_card_equals_fused_none(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke = _smoke()
    cfg = dataclasses.replace(reduced_config("yi-6b"), use_pallas=True)
    got_hist, got = _run(smoke, cfg, "dots")
    want_hist, want = _run(smoke, cfg, "none")
    for s, (a, b) in enumerate(zip(got_hist, want_hist)):
        for k in a:
            assert _rel_err(a[k], b[k]) <= SWEEP_TOL, (s, k)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= SWEEP_TOL
