"""The port's serving client: ``python -m repro_torch.launch.serve
--device cpu`` replays its trace to the end and prints the reference
driver's summary lines; the reference's AOT and compilation-cache flags
store and load the serve table and report the kernel-library cache; the
reduced configs'
prompts are the reference's; the encoder-decoder and frontend archs are
refused, by the engine and the client, with the reference's reason."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced
from repro.data.pipeline import MarkovLM as JMarkovLM
from repro.serve import kvcache as j_kvcache
from repro_torch.configs import reduced_config
from repro_torch.launch import serve as serve_mod
from repro_torch.serve import ServeEngine, default_geometry
from repro_torch.serve import kvcache

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_cli_completes_every_request():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "yi-6b", "--requests", "6", "--arrive-every", "3",
         "--slots", "2", "--max-new", "8"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
        check=True)
    lines = res.stdout.splitlines()
    assert lines[0].startswith("[serve] arch=yi-6b-reduced device=cpu")
    assert any(ln.startswith("[serve] completed=6/6 ") for ln in lines)
    assert any("slots_reused=2" in ln and "free_pages=16" in ln
               for ln in lines)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "minicpm3-4b"])
def test_mla_archs_serve_in_process(arch, capsys):
    done = serve_mod.serve(["--device", "cpu", "--arch", arch, "--requests",
                            "3", "--arrive-every", "2", "--slots", "2",
                            "--max-new", "4", "--use-pallas"])
    assert sorted(len(r.output) for r in done) == [4, 4, 4]
    assert "[serve] completed=3/3 " in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--aot-cache",
                                  "--compilation-cache-dir"])
def test_cache_flags_work(flag, tmp_path, capsys):
    """Run twice: ``--aot-cache`` stores the table, then loads it (the
    reference's lines); ``--compilation-cache-dir`` reports the library
    directory (no library on the CPU: a hit with 0 entries)."""
    argv = ["--device", "cpu", "--requests", "2", "--max-new", "3",
            flag, str(tmp_path / "cache")]
    outs = []
    for _ in range(2):
        done = serve_mod.serve(argv)
        assert sorted(len(r.output) for r in done) == [3, 3]
        outs.append(capsys.readouterr().out)
    if flag == "--aot-cache":
        assert "serve AOT table compiled + exported to" in outs[0]
        assert "serve AOT table loaded from" in outs[1]
    else:
        assert all(f"[cc] persistent compilation cache {tmp_path / 'cache'}"
                   f": 0 new entries (hit" in o for o in outs)


def test_reduced_prompts_are_the_reference_markov_stream():
    class Args:
        reduced, requests, prompt_len, seed = True, 3, 16, 0

    cfg = reduced_config("yi-6b")
    want = JMarkovLM(cfg.vocab_size, seed=0).sample(3, 17, step=0)[:, :16]
    assert serve_mod._prompts(cfg, Args) == want.tolist()
    Args.reduced = False                     # --full: make_batch's tokens
    got = np.asarray(serve_mod._prompts(cfg, Args))
    assert got.shape == (3, 16) and got.max() < cfg.vocab_size


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-26b"])
def test_frontend_archs_are_refused_with_the_reference_reason(arch):
    reason = j_kvcache.supports(j_reduced(arch))
    assert reason and kvcache.supports(reduced_config(arch)) == reason
    with pytest.raises(NotImplementedError, match=reason):
        ServeEngine(reduced_config(arch), device="cpu",
                    geom=default_geometry(num_slots=2, page_size=8,
                                          max_context=48))
    with pytest.raises(NotImplementedError, match=reason):
        serve_mod.serve(["--device", "cpu", "--arch", arch])
