"""The port and its chip smoke script stand alone: importing every
``repro_torch`` module pulls in neither ``jax`` nor any module of the JAX
package, and no source of the port or of ``chip_smoke.py`` names one in
an import."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

# one intra-op thread in each test process: pytest-xdist runs several
# workers on the machine's CPUs, and torch's default of a thread a CPU
# in each of them oversubscribes the CPUs many times over
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SMOKE = ROOT / "chip_smoke.py"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n in ("jax", "repro") or n.startswith(("jax.", "repro.")))
print("BAD", bad)
"""


def _forbidden(name: str) -> bool:
    return name in ("jax", "repro") or name.startswith(("jax.", "repro."))


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert "BAD []" in out, out


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [SMOKE]
    names = {p.relative_to(PORT).as_posix() for p in files[:-1]}
    assert {"kernels/ssd.py", "kernels/ssd_bwd.py", "models/ssm.py",
            "configs/mamba2_2_7b.py", "core/compress.py",
            "jigsaw/costmodel.py", "checkpoint/manager.py"} <= names
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), (path, names)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No card, or a directory holding nothing of the repo but the script:
    a non-zero exit and no result on stdout."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the script would run")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(SMOKE.read_text())
    for script, cwd in ((SMOKE, ROOT), (alone, tmp_path)):
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert res.stdout == ""
