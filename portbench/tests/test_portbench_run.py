"""The command's contract around the result line: no result and another
exit code than 0 without a card or with JAX loaded; otherwise the result
object as the last line of standard output, checks last."""

import json
import subprocess
import sys
import types

import pytest

import harness
import run
from conftest import BENCH_DIR, ROOT


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload",
         "msm_g1_2p20", "--seed", str(2 ** 33 + 1), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "is_available() is false" in proc.stderr


def fake_result(*args, **kw):
    return {"correct": True, "attempted": 1, "failed": 0,
            "metrics": {"setup_s": {"value": 1.0, "unit": "s"}},
            "device": None, "checks": {"wrong_commitments":
                                       {"value": 0, "limit": 0}}}


def test_jax_loaded_no_result(monkeypatch, capsys):
    monkeypatch.setattr(harness, "run", fake_result)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", "x", "--seed", "1", "--seconds", "1"]) \
        == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_result_line(monkeypatch, capsys):
    monkeypatch.setattr(harness, "run", fake_result)
    assert run.main(["--workload", "x", "--seed", "-5", "--seconds", "1"]) \
        == 0
    out = capsys.readouterr()
    res = json.loads(out.out.strip().splitlines()[-1])
    assert list(res)[-1] == "checks"
    assert out.err.strip().splitlines()[-1] == \
        "check wrong_commitments = 0 (limit 0)"
