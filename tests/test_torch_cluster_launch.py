"""The port's cluster driver (``python -m repro_torch.launch.cluster``)
against the reference's: the live CPU session ends on the reference's
summary line, ``--sim --json-out`` writes the reference's makespan,
utilization, completion times and migrations, and the flags that are not
ported raise."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.launch import cluster as j_cluster
from repro_torch.launch import cluster as cluster_mod

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


@pytest.mark.parametrize("flag", [["--spatial"], ["--round-quantum", "0"],
                                  ["--fuse"], ["--aot-cache", "cache"],
                                  ["--compilation-cache-dir", "cc"]],
                         ids=["spatial", "round-quantum", "fuse",
                              "aot-cache", "compilation-cache-dir"])
def test_flags_that_are_not_ported_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 B"):
        cluster_mod.main(["--device", "cpu", *FLAGS, *flag])
