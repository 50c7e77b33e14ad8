"""BENCHMARK.json against the benchmark's contract, every cell resolving
by name, and a new configuration, mix or metric found without an edit."""
import json
import re

import pytest
from perfbench_cells import ROOT, spec

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"] == ["python3", "perfbench/run.py"]
    assert s["paths"] == ["perfbench"]
    assert 1 <= s["run_seconds"] <= 51
    assert len(json.dumps(s)) <= 64 * 1024
    # a full check at 24 cells fits its 43200 s
    assert 2 + 14 * 24 * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_keep_to_the_contract():
    s = spec()
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in s[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or "d_model" in k
                       or "d_ff" in k or "top_k" in k for k in c["reduced"])
    used = {w["config"] for w in s["workloads"]}
    assert used == {c["name"] for c in s["configs"]}
    pairs = {(w["config"], w["traffic"]) for w in s["workloads"]}
    assert len(pairs) == len(s["workloads"])
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in s["end_to_end"])


def test_every_cell_reports_what_its_layers_move():
    s = spec()
    for w in s["workloads"]:
        cell = harness.resolve(s, ROOT, w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e and "\n" not in m["layer"]
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")


@pytest.mark.parametrize("workload", [w["name"] for w in spec()["workloads"]])
def test_cell_resolves_by_name(workload):
    cell = harness.resolve(spec(), ROOT, workload)
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["kind"] == "requests"
    drv = harness.driver_for(ROOT, cell)
    assert callable(drv.run)
    assert (ROOT / "perfbench" / "reference"
            / f"{cell.config['reference']}.py").is_file()
    for m in cell.per_layer:
        assert callable(harness.reader_for(ROOT, m["name"]).read)


def test_a_new_config_mix_and_metric_are_found_without_an_edit(tmp_path):
    """A later change adds a cell by adding files and entries only."""
    s = spec()
    s["configs"].append({"name": "new-config", "source": "https://example.org",
                         "file": "perfbench/configs/new-config.json",
                         "reduced": [], "why": "a test"})
    s["workloads"].append({"name": "new-cell", "config": "new-config",
                           "traffic": "new-mix", "chips": 1, "why": "a test"})
    s["per_layer"].append({"name": "new_metric.x", "unit": "ms",
                           "better": "lower", "source": "host_clock",
                           "layer": "a layer", "moves": "setup_s",
                           "workloads": ["new-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(s))
    for sub in ("configs", "traffic", "metrics"):
        (tmp_path / "perfbench" / sub).mkdir(parents=True)
    (tmp_path / "perfbench/configs/new-config.json").write_text(
        json.dumps({"name": "new-config", "driver": "serve",
                    "reference": "mixtral"}))
    (tmp_path / "perfbench/traffic/new-mix.json").write_text(
        json.dumps({"kind": "requests"}))
    (tmp_path / "perfbench/metrics/new_metric.x.py").write_text(
        "def read(rec):\n    return rec.counters.get('x')\n")
    cell = harness.resolve(harness.load_spec(tmp_path), tmp_path, "new-cell")
    assert cell.traffic == {"kind": "requests"}
    assert [m["name"] for m in cell.per_layer] == ["new_metric.x"]
    rec = harness.Record(cell="new-cell", counters={"x": 3.0})
    assert harness.reader_for(tmp_path, "new_metric.x").read(rec) == 3.0
