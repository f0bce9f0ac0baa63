"""The port stands alone: no JAX and nothing of the reference package in it
or in chip_smoke.py, no eager GPU toolchain on import, and a clean lint."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("*_torch.py")))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_is_lazy():
    code = ("import sys, repro_torch, repro_torch.kernels, repro_torch.recon, "
            "repro_torch.launch.ct_train, repro_torch.launch.ct_serve, "
            "repro_torch.core.distributed, repro_torch.launch.mesh, "
            "repro_torch.launch.train, "
            "repro_torch.nn, repro_torch.optim; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'triton', 'repro')]; "
            "from repro_torch.kernels import build; "
            "assert not build._LIBS, 'kernel library loaded on import'; "
            "import torch.distributed as dist; "
            "assert not dist.is_initialized(), 'process group started on import'; "
            "import multiprocessing as mp; "
            "assert not mp.active_children(), 'process started on import'; "
            "print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_refuses_without_cuda_or_checkout(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        out = subprocess.run([sys.executable, str(script)], env=env, cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert out.stdout == ""


def test_lint_clean_with_port_present():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", "repro.lint", "src", "tests",
                          "benchmarks"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
