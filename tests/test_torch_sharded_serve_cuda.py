"""Sharded serving on the card: reduced yi-6b, gemma3-4b and
deepseek-v2-lite-16b in f32 with the kernels on, served by a (data 1,
model 2) grid of two ranks that share the card over gloo
(``ServeEngine(group=)``), emit a one-process engine's greedy tokens on
the card token for token, staggered and solo, from one set of weights
drawn on the CPU; the two ranks' tokens are the same, and each rank
launches the flash forward once a prefill and attention layer, at its
local heads.

Marked ``cuda``: skips without a card.  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sharded_serve_cuda.py``
"""
import dataclasses

import pytest
import torch

from repro_torch.config import layer_kinds
from repro_torch.configs import reduced_config
from repro_torch.engine.graphs import launch_counters
from repro_torch.launch import mesh
from repro_torch.models import lm
from repro_torch.serve import ServeEngine, default_geometry
from repro_torch.tree import tree_map

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

ARCHS = ("yi-6b", "gemma3-4b", "deepseek-v2-lite-16b")
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8])
MAX_NEW = (6, 5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _cfg(arch):
    return dataclasses.replace(reduced_config(arch), use_pallas=True)


def _geom():
    return default_geometry(num_slots=2, page_size=8, max_context=48)


def _params(arch):
    """One arch's weights, drawn on the CPU, as numpy."""
    params = lm.init_lm(torch.Generator().manual_seed(0), _cfg(arch), "cpu")
    return tree_map(lambda t: t.numpy(), params)


def _trace(eng):
    """B joins two steps after A, then each alone: (staggered, solo)."""
    a = eng.submit(PROMPTS[0], max_new=MAX_NEW[0])
    eng.step(2)
    b = eng.submit(PROMPTS[1], max_new=MAX_NEW[1])
    eng.drain()
    solo = []
    for prompt, n in zip(PROMPTS, MAX_NEW):
        r = eng.submit(prompt, max_new=n)
        eng.drain()
        solo.append(r.output)
    return [a.output, b.output], solo


def _rank(group, params):
    """One rank of the grid (the spawned ranks' target): each arch's
    traces and flash-forward launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    counter = launch_counters()["flash_fwd"]
    out = {}
    for arch, whole in params.items():
        eng = ServeEngine(_cfg(arch), geom=_geom(), group=group,
                          params=tree_map(lambda a: torch.from_numpy(a).to(
                              group.device), whole))
        before = counter.launches
        out[arch] = (_trace(eng), counter.launches - before)
    return out


def test_grid_on_the_card_emits_one_process_tokens(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    params = {arch: _params(arch) for arch in ARCHS}
    ranks = mesh.spawn(f"{__name__}:_rank", 2, params, device="cuda",
                       grid=(1, 2), timeout_s=600)
    for arch in ARCHS:
        one = ServeEngine(_cfg(arch), geom=_geom(), device="cuda",
                          params=tree_map(lambda a: torch.from_numpy(a).cuda(),
                                          params[arch]))
        want = _trace(one)
        assert want[0] == want[1]
        attn = sum(m in ("attn", "local", "mla")
                   for m, _ in layer_kinds(_cfg(arch)))
        for got, launches in (r[arch] for r in ranks):
            assert got == want, arch
            # four prefills (two staggered, two solo) a rank
            assert launches == 4 * attn, (arch, launches)
