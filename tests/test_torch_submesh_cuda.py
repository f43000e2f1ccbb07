"""Spatial co-location on the card: the shares themselves
(``chip_smoke.phase_spatial_share``: each submesh's SMs, a port kernel and
a product reading and writing the primary context's memory on each share,
the half share's slowdown on a bf16 8192^3 product, and two shares'
products overlapping at their alone speed) and a spatial session with
``--aot-cache``: three reduced yi-6b jobs on two submeshes, the kernels
on, whose step tables are captured on their shares' streams at arrival,
between rounds (job 2 arrives on job 0's submesh and loads its table),
then resized and run eagerly in concurrent rounds.

Marked ``cuda``: skips without a card.  On the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_submesh_cuda.py``
"""
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from repro_torch.launch import cluster as cluster_mod
from repro_torch.launch.mesh import make_submeshes

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


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


def test_shares_partition_the_card_and_overlap(cuda):
    subs = make_submeshes(count=2, device="cuda")
    fig = _smoke().phase_spatial_share(subs)        # raises on a failure
    units = fig["units"]
    assert sum(len(s.units) for s in subs) == units["count"]
    assert fig["submesh_sms"] == [len(s.units) * units["unit_sms"]
                                  for s in subs]
    assert fig["overlap_ms"] > 0


def test_spatial_session_with_aot_cache(cuda, tmp_path):
    out = tmp_path / "session.json"
    cluster_mod.main(["--jobs", "3", "--machines", "2", "--workers", "2",
                      "--iters", "2", "--arrival", "0.0", "--batch", "2",
                      "--seq", "64", "--use-pallas", "--spatial", "--quiet",
                      "--aot-cache", str(tmp_path / "aot"),
                      "--json-out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["spatial"] is True and len(rec["jct"]) == 3
    assert rec["aot_events"] == {"0": "exported", "1": "exported",
                                 "2": "loaded"}
    assert rec["max_concurrent_tasks"] == 2
    assert sum(rec["resizes"].values()) >= 1
    for s in rec["summary"].values():
        assert s["steps_run"] == 2 * 2
