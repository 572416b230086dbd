"""Hygiene of the port: it imports neither jax nor the JAX package, and
chip_smoke.py refuses to run, printing no result, without a GPU or
without the repository around it."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import newsched_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "newsched_tpu_torch"


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return env


def test_importing_every_port_module_leaves_jax_out():
    mods = [m.name for m in pkgutil.walk_packages(newsched_tpu_torch.__path__,
                                                  "newsched_tpu_torch.")]
    assert "newsched_tpu_torch.ops.cuda.fm_chain" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith"
            "(('jax.', 'jaxlib', 'newsched_tpu.')) or m == 'newsched_tpu')\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_port_sources_name_no_jax_import():
    for path in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "newsched_tpu"), (path, n)


def test_port_sources_import_neither_the_root_bench_nor_bench_dir():
    """The port keeps its own bench (newsched_tpu_torch/bench.py) and
    probes: neither it nor chip_smoke.py imports the JAX package's bench.py
    or its experiments under bench/."""
    for path in list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [("." * node.level) + (node.module or "")]
            else:
                continue
            for n in names:
                assert n.split(".")[0] != "bench", (path, n)
        text = path.read_text()
        for needle in ("import_module(\"bench", "import_module('bench",
                       "sys.path.insert"):
            assert needle not in text, (path, needle)


def test_chip_smoke_without_cuda_exits_nonzero_and_prints_no_result():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "torch.cuda.is_available() is false" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_in_a_directory_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=_env(), capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "newsched_tpu_torch" in r.stderr
    assert '"ok"' not in r.stdout
