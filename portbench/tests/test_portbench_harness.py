"""The harness finds what BENCHMARK.json names, by name, and nothing more:
a configuration, a cell and a metric added as new files are found with no
other file edited; every name and unit keeps to the allowed characters."""

import json
import re
import shutil
from pathlib import Path

import pytest

import conftest
import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
SPEC = json.loads((conftest.ROOT / "BENCHMARK.json").read_text())


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names += [m["name"] for m in metrics]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    lines = [x["why"] for x in SPEC["configs"] + SPEC["workloads"]]
    lines += [m["layer"] for m in SPEC["per_layer"]]
    lines += [c["source"] for c in SPEC["configs"]] + SPEC["command"]
    assert all(LINE.match(x) for x in lines)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [x["name"] for x in SPEC[group]]
        assert len(group_names) == len(set(group_names)), group
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((conftest.ROOT / "BENCHMARK.json").read_bytes()) <= 64 << 10
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(SPEC["paths"][0] + "/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        reported = [m for m in SPEC["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in SPEC["per_layer"])


def test_every_named_file_exists_and_agrees():
    bench = harness.Bench()
    for w in SPEC["workloads"]:
        data = json.loads((bench.dir / "workloads" / f"{w['name']}.json")
                          .read_text())
        assert data["why"] == w["why"]
        assert bench.traffic(w["name"]) == data["params"]
        assert bench.driver_module(w["config"]).Driver
        cfg = bench.config(w["config"])
        assert cfg["name"] == w["config"]
        assert cfg["reduced"] == [c for c in SPEC["configs"]
                                  if c["name"] == w["config"]][0]["reduced"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(bench.metric_reader(m["name"]))


def test_additions_are_found_as_new_files(tmp_path):
    """A new configuration (a copy of a driver under a new name), a new cell
    of it and a new per-layer metric, each added as files and entries only,
    are found; no file already there changes."""
    root = conftest.make_root(tmp_path, cells={})
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    cfgs = root / "portbench" / "configs"
    shutil.copy(cfgs / "kzg_commit_g1.py", cfgs / "kzg_commit_other.py")
    cfg = json.loads((cfgs / "kzg_commit_g1.json").read_text())
    cfg["name"] = "kzg_commit_other"
    (cfgs / "kzg_commit_other.json").write_text(json.dumps(cfg))
    cell = {"config": "kzg_commit_other", "traffic": "commit_2p12",
            "why": "a new cell", "params": {"points_per_call": 4096,
                                            "scalar_sets": 2}}
    (root / "portbench" / "workloads" / "msm_other.json").write_text(
        json.dumps(cell))
    (root / "portbench" / "metrics" / "calls_traced.py").write_text(
        "def read(run):\n    return None if run.trace is None else "
        "run.trace.calls\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "kzg_commit_other", "source": "x",
                            "file": "portbench/configs/kzg_commit_other.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "msm_other",
                              "config": "kzg_commit_other",
                              "traffic": "commit_2p12", "chips": 1,
                              "why": "a new cell"})
    spec["end_to_end"][1]["workloads"].append("msm_other")
    spec["per_layer"].append({"name": "calls_traced", "unit": "calls",
                              "better": "higher", "source": "device_trace",
                              "layer": "device", "moves": "msm_points_per_s",
                              "workloads": ["msm_other"]})
    # a new group of a quantity that has a reader: an entry alone
    spec["per_layer"].append({"name": "launches_per_call.other",
                              "unit": "launches", "better": "lower",
                              "source": "device_trace",
                              "layer": "host dispatch",
                              "moves": "msm_points_per_s",
                              "workloads": ["msm_other"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = harness.Bench(root)
    assert bench.traffic("msm_other")["points_per_call"] == 4096
    assert bench.config("kzg_commit_other")["name"] == "kzg_commit_other"
    assert bench.driver_module("kzg_commit_other").Driver
    assert [m["name"] for m in bench.metrics_of("msm_other", False)] == \
        ["setup_s", "msm_points_per_s"]
    assert [m["name"] for m in bench.metrics_of("msm_other", True)] == \
        ["calls_traced", "launches_per_call.other"]
    run = harness.Run(1.0, [], {}, None)
    assert bench.metric_reader("calls_traced")(run) is None
    reader = bench.metric_reader("launches_per_call.other")
    assert reader.__module__ == "portbench_metric_launches_per_call"
    assert reader(run) is None
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_cell_mismatch_is_refused(tmp_path):
    root = conftest.make_root(tmp_path)
    path = root / "portbench" / "workloads" / "msm_tiny.json"
    data = json.loads(path.read_text())
    data["config"] = "eth_bls_verify"
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError):
        harness.Bench(root).traffic("msm_tiny")


def test_each_cell_has_one_group_of_layer_metrics():
    """Each cell's traced metrics are one group (one name suffix, or a
    roofline), each moving an end-to-end metric the cell reports."""
    bench = harness.Bench()
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in bench.metrics_of(w["name"], False)}
        traced = bench.metrics_of(w["name"], True)
        quantities = {m["name"].rsplit(".", 1)[0] for m in traced
                      if "." in m["name"]}
        assert quantities == {"launches_per_call", "glue_device_ms_per_call",
                              "port_kernel_ms_per_call", "device_idle_share"}
        assert len({m["name"].rsplit(".", 1)[-1] for m in traced
                    if "." in m["name"]}) == 1
        assert all(m["moves"] in e2e for m in traced)
        assert "setup_s" in e2e
