"""Test set-up of the benchmark's own tests (run as
`python -m pytest portbench/tests`; the repository's `pytest tests/` does
not collect them).  Tests that need a card carry the `gpu` marker and skip
inside the test where there is none."""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH_DIR = HERE.parent
ROOT = BENCH_DIR.parent
sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

# tiny cells of the two configurations, small enough for the program's
# plain PyTorch path on the CPU
TINY = {
    "msm_tiny": {"config": "kzg_commit_g1", "traffic": "commit_tiny",
                 "why": "eight points on the CPU",
                 "params": {"points_per_call": 8, "scalar_sets": 2,
                            "warmup_calls": 0,
                            "trace_calls": 1,
                            "roofline": {"window": 2, "fp_products": 1}}},
    "verify_tiny": {"config": "eth_bls_verify", "traffic": "verify_tiny",
                    "why": "five sets on the CPU, one of each kind",
                    "params": {"sets_per_call": 5, "batches": 2, "block": 5,
                               "reference_sample": 1, "warmup_calls": 0,
                               "trace_calls": 1}},
}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "gpu: needs a CUDA device (skips without one)")


def make_root(tmp: Path, cells=TINY) -> Path:
    """A checkout-like root under tmp: BENCHMARK.json and a copy of
    portbench/, with `cells` added as new workload files and entries."""
    shutil.copytree(BENCH_DIR, tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cell in cells.items():
        (tmp / "portbench" / "workloads" / f"{name}.json").write_text(
            json.dumps(cell))
        spec["workloads"].append({"name": name, "config": cell["config"],
                                  "traffic": cell["traffic"], "chips": 1,
                                  "why": cell["why"]})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "workloads" in m and any(
                    w["config"] == cell["config"] and w["name"] in
                    m["workloads"] for w in spec["workloads"]):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    return tmp


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
