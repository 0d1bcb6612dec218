"""BENCHMARK.json and the files it names: every cell, configuration and
per-layer metric is found by its name, and the file keeps to the
benchmark's format."""

import json
import re

import pytest

from benchmark.core import spec as specs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = specs.benchmark_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_paths():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_found_by_name(cell):
    c = specs.load_cell(cell, SPEC)
    cfg = specs.load_config(c["config"], SPEC)
    assert cell == f"{c['config']}.{c['traffic']}"
    assert (specs.BENCH_DIR / "drivers" / f"{c['driver']}.py").is_file()
    assert set(c["limits"]) and all(v >= 0 for v in c["limits"].values())
    entry = next(e for e in SPEC["configs"] if e["name"] == c["config"])
    assert cfg["reduced"] == entry["reduced"]
    assert set(cfg["reduced"]) <= set(cfg)
    assert not [k for k in cfg["reduced"] if k.endswith(
        ("_dim", "_rank", "_size")) and k != "batch_size"]
    if c["driver"] == "train_lstm":
        traffic = c["traffic_params"]
        assert (traffic["unroll"], traffic["batch"]) == (cfg["seq_len"],
                                                         cfg["batch_size"])
    for kind in ("end_to_end", "per_layer"):
        assert specs.cell_metrics(SPEC, kind, cell)
    assert "setup_s" in [m["name"] for m in
                         specs.cell_metrics(SPEC, "end_to_end", cell)]


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_per_layer_metric_has_a_reader(metric):
    module = specs.load_module("metrics", metric)
    assert callable(module.read)


def test_names_units_and_entries():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert specs.load_config(c["name"], SPEC)["name"] == c["name"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(CELLS) if "workloads" in m \
            else True
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        specs.load_cell("no_such.cell", SPEC)
    with pytest.raises(FileNotFoundError):
        specs.load_module("metrics", "no_such_metric")
