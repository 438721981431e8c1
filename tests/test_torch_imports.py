"""The port stands alone: `bls12_381_torch` and `chip_smoke.py` import
neither JAX nor the JAX package, entry points default to the card and
raise without one, and wrappers never send a tensor of another device to
the plain path.

Tolerance: none (integer arithmetic) -- no numeric comparison here.
"""

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from bls12_381_torch import entry, limbs
from bls12_381_torch.kernels import mont, plan_exec as pe

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "bls12_381_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "bls12_381_tpu", "__graft_entry__", "bench")


def imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_imports_no_jax_package():
    assert len(PORT_FILES) > 10
    bad = [(p.relative_to(ROOT).as_posix(), m) for p in PORT_FILES
           for m in imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        limbs.resolve_device("cuda")


def test_wrappers_take_the_plain_path_only_for_cpu_tensors():
    x = torch.zeros((1, 24, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mont.sop(x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        mont.sqr(x)
    plan = pe.compile_plan(pe.fp12_sqr_plan())
    with pytest.raises(ValueError, match="unsupported device"):
        pe.plan_exec(torch.zeros((12, 24, 2), dtype=torch.int32,
                                 device="meta"), plan)


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    """No result and a non-zero exit where there is no CUDA device, and in
    a directory that holds chip_smoke.py and nothing else."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
