"""Finds the benchmark's parts by the names in BENCHMARK.json.

A cell `<config>.<traffic>` is `workloads/<cell>.json` (its traffic
parameters, chips, driver and limits); its configuration is
`configs/<config>.json`; its driver is `drivers/<driver>.py`; a per-layer
metric `<name>` is read by `metrics/<name>.py`.  Adding any of these is a
matter of adding files and entries: nothing here lists them.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"{what} {name!r} is not in BENCHMARK.json")


def load_cell(name: str, spec: dict) -> dict:
    """The cell's BENCHMARK.json entry merged with its workload file; the
    two must agree on the configuration, the traffic and the chips."""
    entry = _entry(spec["workloads"], name, "workload")
    cell = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if cell[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json: {key} {cell[key]!r} "
                             f"differs from BENCHMARK.json's {entry[key]!r}")
    return {**cell, "name": name}


def load_config(name: str, spec: dict) -> dict:
    entry = _entry(spec["configs"], name, "config")
    path = ROOT / entry["file"]
    return {**load_json(path), "name": name}


def load_module(kind: str, name: str) -> ModuleType:
    """`<kind>/<name>.py` under the benchmark's folder, as a module; for a
    name with a dot that has no file of its own (`device_idle_share.loss`),
    the file of the part before the dot, which serves each kind of cell."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        path = BENCH_DIR / kind / f"{name.split('.', 1)[0]}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    mod_name = f"benchmark_{kind}_{name}".replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(spec: dict, kind: str, cell: str) -> list:
    """The `end_to_end` or `per_layer` entries this cell reports: those that
    list it, and those with no `workloads` list."""
    return [m for m in spec[kind]
            if "workloads" not in m or cell in m["workloads"]]
