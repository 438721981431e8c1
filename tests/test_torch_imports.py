"""The port stands alone: `bls12_381_torch`, `chip_smoke.py` and the tests'
shared module `tests/port_cases.py` import neither JAX nor the JAX
package, and the tests import `chip_smoke` only to test the kernel timer;
entry points default to the card and raise without one, and wrappers
never send a tensor of another device to the plain path.

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
    ROOT / "chip_smoke.py", ROOT / "tests" / "port_cases.py"]
# the test files that test the kernel timer itself (its recording of the
# row kernel's calls); the others take what they share from port_cases
TIMER_TESTS = ("test_torch_smul.py",)
# the port's C++ and CUDA sources (the native host runtime's among them)
PORT_SOURCES = sorted(p for ext in ("*.cpp", "*.cu", "*.cuh")
                      for p in (ROOT / "bls12_381_torch").rglob(ext))
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
    assert ROOT / "bls12_381_torch" / "utils" / "native.py" in PORT_FILES
    bad = [(p.relative_to(ROOT).as_posix(), m) for p in PORT_FILES
           for m in imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_tests_import_chip_smoke_only_to_test_the_timer():
    importers = sorted(p.name for p in (ROOT / "tests").glob("*.py")
                       if "chip_smoke" in set(imported_modules(p)))
    assert importers == list(TIMER_TESTS)


def test_port_sources_include_nothing_of_the_jax_package():
    """The kernels and the native host runtime build from the port's own
    sources: no #include reaches outside the port's tree."""
    names = [p.relative_to(ROOT).as_posix() for p in PORT_SOURCES]
    assert "bls12_381_torch/utils/csrc/bls_host.cpp" in names
    for path in PORT_SOURCES:
        for line in path.read_text().splitlines():
            if line.startswith("#include"):
                assert "bls12_381_tpu" not in line and ".." not in line, (
                    path.name, line)


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        limbs.resolve_device("cuda")


@pytest.mark.parametrize("group", ["g1", "g2", "gt"])
def test_smul_entry_defaults_to_the_card(group):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.smul_entry(2, group)


@pytest.mark.parametrize("make", [
    lambda: entry.codec_entry(2, "g1", "compressed"),
    lambda: entry.codec_entry(2, "g2", "uncompressed"),
    lambda: entry.h2c_entry(1, "g2", "hash")])
def test_codec_and_h2c_entries_default_to_the_card(make):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_wrappers_take_the_plain_path_only_for_cpu_tensors():
    x = torch.zeros((1, 24, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mont.sop(x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        mont.sqr(x)
    with pytest.raises(ValueError, match="unsupported device"):
        mont.fp2_pow_fixed(x[0], x[0], 3)
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
