"""A whole run of each cell on the CPU at tiny sizes: the last line's
shape, the checks on standard error, and the refusal to print a result
where JAX or the JAX package was loaded."""

import json
import subprocess
import sys
import types

import pytest
import torch

from benchmark import run
from benchmark.core import guard, spec as specs

SPEC = specs.benchmark_spec()
TINY = {
    "train_lstm": {"obs_dim": 8, "hidden_size": 16, "action_dim": 4,
                   "unroll": 4, "batch": 6, "pool": 4},
    "vtrace_loss": {"unroll": 16, "batch": 8, "action_dim": 5},
}
CELLS = [w["name"] for w in SPEC["workloads"]]


def cell_of(driver):
    return next(c for c in CELLS
                if specs.load_cell(c, SPEC)["driver"] == driver)


def tiny(cell):
    return TINY[specs.load_cell(cell, SPEC)["driver"]]


def run_cell(cell, capsys, seed=2 ** 31 + 11, overrides=None):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.2", "--trace", "0"], device=torch.device("cpu"),
                  overrides=overrides or tiny(cell))
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("cell", CELLS)
def test_last_line(cell, capsys):
    rc, out, err = run_cell(cell, capsys)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = {m["name"]: m["unit"] for m in
            specs.cell_metrics(SPEC, "end_to_end", cell)}
    assert {k: v["unit"] for k, v in line["metrics"].items()} == want
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    checks = line["checks"]
    assert set(checks) == set(specs.load_cell(cell, SPEC)["limits"])
    tail = err.strip().splitlines()[-len(checks):]
    for text, (name, c) in zip(tail, checks.items()):
        assert text == f"check {name}: {c['value']!r} limit {c['limit']!r}"


def test_same_seed_same_numbers(capsys):
    cell = cell_of("train_lstm")
    lines = [json.loads(run_cell(cell, capsys, seed=9)[1].splitlines()[-1])
             for _ in range(2)]
    assert lines[0]["checks"] == lines[1]["checks"]


def test_no_result_where_the_jax_package_was_loaded(capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "di_hpc_tpu",
                        types.ModuleType("di_hpc_tpu"))
    rc, out, err = run_cell(cell_of("vtrace_loss"), capsys)
    assert rc != 0 and out == ""
    assert "di_hpc_tpu" in err


def test_no_result_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "no CUDA device" in err


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["di_hpc_tpu_torch",
                                    "di_hpc_tpu_torch.ops", "jaxtyping",
                                    "flaxen", "torch"]) == []
    assert guard.forbidden_modules(["di_hpc_tpu.ops", "jax._src", "jaxlib",
                                    "flax.linen"]) == ["di_hpc_tpu", "flax",
                                                       "jax", "jaxlib"]


def test_harness_and_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import benchmark.run, benchmark.calibrate;"
            "from benchmark.core import spec;"
            "[spec.load_module(k, n) for k, n in ("
            "('drivers', 'train_lstm'), ('drivers', 'vtrace_loss'))];"
            "import di_hpc_tpu_torch, di_hpc_tpu_torch.models,"
            " di_hpc_tpu_torch.ops, di_hpc_tpu_torch.parallel;"
            "from benchmark.core.guard import forbidden_modules;"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=specs.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_window_reads_each_step_before_the_next():
    from benchmark.core.window import run_window, summarize
    queued, read = [], []

    class Loss:
        def __init__(self, i):
            self.i = i

        def __float__(self):
            read.append((self.i, len(queued)))
            return float(self.i)

    def step(i):
        queued.append(i)
        return Loss(i)

    w = run_window(step, 0.0, first=5, steps=4)
    assert w["losses"] == [5.0, 6.0, 7.0, 8.0] and w["steps"] == 4
    assert read == [(5, 1), (6, 2), (7, 3), (8, 4)]
    assert sum(w["step_s"]) <= w["window_s"]
    s = summarize(w, 10)
    assert s["samples_per_s"] == pytest.approx(40 / w["window_s"])
