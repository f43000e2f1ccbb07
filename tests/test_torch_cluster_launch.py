"""The port's cluster driver (``python -m repro_torch.launch.cluster``)
against the reference's: the live CPU session ends on the reference's
summary line, ``--sim --json-out`` writes the reference's makespan,
utilization, completion times and migrations, ``--fuse`` fuses the same
jobs as the reference's (both driven by one scripted clock, so their
completion times agree), ``--aot-cache`` and ``--compilation-cache-dir``
work, and ``--spatial`` and ``--round-quantum``, refused before the
submeshes were ported, run."""
import itertools
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.launch import cluster as j_cluster
from repro_torch.launch import cluster as cluster_mod

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--jobs", "2", "--machines", "2", "--iters", "2", "--workers", "2",
         "--batch", "2", "--seq", "16", "--require-distinct-depths"]
# the part of the summary line that does not depend on measured times
SUMMARY = re.compile(r"\[cluster\] scheduler=\S+ jobs_done=\S+ "
                     r"distinct_depths=\[[^]]*\]")


def test_live_driver_on_the_cpu_prints_the_reference_summary(capsys):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.cluster", "--device",
         "cpu", *FLAGS], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    ours = SUMMARY.findall(res.stdout)
    assert ours == ["[cluster] scheduler=jigsaw jobs_done=2/2 "
                    "distinct_depths=[2, 4]"], res.stdout
    assert "[cluster] max_concurrent=1" in res.stdout
    j_cluster.main(FLAGS)
    assert SUMMARY.findall(capsys.readouterr().out) == ours


@pytest.mark.parametrize("scheduler", ["jigsaw", "tiresias"])
def test_sim_json_equals_reference(tmp_path, capsys, scheduler):
    flags = ["--sim", "--jobs", "4", "--machines", "3", "--iters", "5",
             "--workers", "2", "--arrival", "0.2", "--scheduler", scheduler,
             "--fault-plan", "crash:1@1.5+1;fail:2.1@1", "--ckpt-every",
             "2", "--degrade"]
    cluster_mod.main(flags + ["--json-out", str(tmp_path / "ours.json")])
    j_cluster.main(flags + ["--json-out", str(tmp_path / "ref.json")])
    ours, ref = (json.loads((tmp_path / n).read_text())
                 for n in ("ours.json", "ref.json"))
    for key in ("makespan", "util", "jct", "migrations", "goodput",
                "wasted_s", "crashes", "task_retries", "lost_iterations",
                "recovery_s", "failed_jobs", "degraded_steps"):
        assert ours[key] == ref[key], key
    assert ours["crashes"] == 1 and ours["task_retries"] == 1
    out = capsys.readouterr().out.splitlines()
    faults = [ln for ln in out if ln.startswith("[cluster] faults:")]
    assert len(faults) == 2 and faults[0] == faults[1]


@pytest.mark.parametrize("flag", [["--spatial"], ["--round-quantum", "0"]],
                         ids=["spatial", "round-quantum"])
def test_flags_that_are_not_ported_raise(flag, tmp_path):
    """The flags refused before the port had submeshes now run:
    ``--spatial`` over two CPU submeshes (concurrent rounds), and
    ``--round-quantum``, which the runtime ignores without it."""
    out = tmp_path / "session.json"
    res = cluster_mod.main(["--device", "cpu", *FLAGS, *flag, "--quiet",
                            "--json-out", str(out)])
    rec = json.loads(out.read_text())
    assert len(res.jct) == 2
    assert rec["spatial"] is (flag == ["--spatial"])
    # jobs arrive 0.5 s apart here, and a job's two workers take its
    # engine in turn: tasks overlap only in tests/test_torch_submesh.py's
    # sessions
    assert rec["max_concurrent_tasks"] == 1
    assert set(rec) >= {"resizes", "stepcache"}


@pytest.mark.parametrize("flag", ["--aot-cache", "--compilation-cache-dir"])
def test_cache_flags_work(flag, tmp_path, capsys):
    """``--aot-cache``: the first job stores its table and the second,
    with the same scrubbed key, loads it; the reference's stepcache line.
    ``--compilation-cache-dir``: the reference's ``[cc]`` line."""
    cluster_mod.main(["--device", "cpu", *FLAGS, "--iters", "1", flag,
                      str(tmp_path / "cache")])
    out = capsys.readouterr().out
    assert "[cluster] scheduler=jigsaw jobs_done=2/2" in out
    assert re.search(r"\[cluster\] stepcache hits=\d+ misses=\d+ "
                     r"entries=\d+", out)
    if flag == "--aot-cache":
        assert "[live] job=0 AOT step table compiled + exported to" in out
        assert "[live] job=1 AOT step table loaded" in out
    else:
        assert f"[cc] persistent compilation cache {tmp_path / 'cache'}: " \
               f"0 new entries (hit" in out


class _StepClock:
    """Each (start, end) pair of calls measures the next scripted
    duration, so two sessions see the same virtual clock."""

    def __init__(self):
        self.durations = itertools.cycle((0.3, 0.1, 0.25, 0.15))
        self.t, self.mid = 0.0, False

    def __call__(self):
        if self.mid:
            self.t += next(self.durations)
        self.mid = not self.mid
        return self.t


def _scripted(backend_cls):
    class Scripted(backend_cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, timer=_StepClock(), **kw)
    return Scripted


@pytest.mark.parametrize("archs,groups", [("yi-6b", {"0": [0, 1, 2]}),
                                          ("yi-6b,yi-6b,mamba2-2.7b",
                                           {"0": [0, 1]})],
                         ids=["one_group", "group_and_solo"])
def test_fuse_json_equals_reference(tmp_path, capsys, monkeypatch, archs,
                                    groups):
    """``--fuse`` on the CPU: the fused groups, their count and the
    completion times of the scheduled jobs are the reference's; every
    member runs every step of its iterations."""
    monkeypatch.setattr(cluster_mod, "LiveBackend",
                        _scripted(cluster_mod.LiveBackend))
    monkeypatch.setattr(j_cluster, "LiveBackend",
                        _scripted(j_cluster.LiveBackend))
    flags = ["--jobs", "3", "--machines", "2", "--iters", "2", "--workers",
             "2", "--batch", "2", "--seq", "16", "--archs", archs, "--fuse",
             "--quiet"]
    cluster_mod.main(["--device", "cpu", *flags,
                      "--json-out", str(tmp_path / "ours.json")])
    ours_out = capsys.readouterr().out
    j_cluster.main(flags + ["--json-out", str(tmp_path / "ref.json")])
    ref_out = capsys.readouterr().out
    ours, ref = (json.loads((tmp_path / n).read_text())
                 for n in ("ours.json", "ref.json"))
    assert ours["fused"] == ref["fused"] == groups
    assert ours["jct"] == ref["jct"]
    assert len(ours["jct"]) == 3 - len(groups["0"]) + 1
    count = re.compile(r"fused_groups=(\d+)")
    assert count.findall(ours_out) == count.findall(ref_out) == ["1"]
    assert SUMMARY.findall(ours_out) == SUMMARY.findall(ref_out)
    for jid, s in ours["summary"].items():
        assert s["steps_run"] == 4
        assert s["fused_with"] == ref["summary"][jid]["fused_with"]
        assert s["depths"] == ref["summary"][jid]["depths"] == [2, 4]
