"""`correct` comes out false where the timed path is broken underneath:
the harness runs on the CPU at tiny sizes (skipping its look for a card)
with each fault a cell can have planted in the program, and with the
control (the reference one precision below the cell's in the program's
place)."""

import json

import pytest
import torch

from benchmark.calibrate import readings
from benchmark.core import spec as specs
from test_bm_run import TINY, run_cell

SPEC = specs.benchmark_spec()
TRAIN = [w["name"] for w in SPEC["workloads"]
         if specs.load_cell(w["name"], SPEC)["driver"] == "train_lstm"]
VTRACE = [w["name"] for w in SPEC["workloads"]
          if specs.load_cell(w["name"], SPEC)["driver"] == "vtrace_loss"]


def result(cell, capsys):
    driver = specs.load_cell(cell, SPEC)["driver"]
    rc, out, _ = run_cell(cell, capsys, overrides=TINY[driver])
    assert rc == 0
    return json.loads(out.splitlines()[-1])


def half(t, dim=1):
    return t.narrow(dim, 0, t.shape[dim] // 2)


@pytest.mark.parametrize("cell", TRAIN)
def test_unchanged_state_is_caught(cell, capsys, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    assert result(cell, capsys)["correct"] is False


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_is_caught(cell, capsys, monkeypatch):
    from di_hpc_tpu_torch.models import actor_critic_lstm as acl
    real = acl._vtrace_losses

    def halved(logits, value, batch, gamma, lambda_):
        return real(half(logits), half(value), type(batch)(
            *(half(t) for t in batch)), gamma, lambda_)
    monkeypatch.setattr(acl, "_vtrace_losses", halved)
    assert result(cell, capsys)["correct"] is False


@pytest.mark.parametrize("cell", VTRACE)
def test_altered_answer_is_caught(cell, capsys, monkeypatch):
    from di_hpc_tpu_torch import ops
    real = ops.vtrace_error

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        return out._replace(value_loss=out.value_loss * (1 + 1e-3))
    monkeypatch.setattr(ops, "vtrace_error", altered)
    assert result(cell, capsys)["correct"] is False


@pytest.mark.parametrize("cell", VTRACE)
def test_half_batch_of_vtrace_is_caught(cell, capsys, monkeypatch):
    from di_hpc_tpu_torch import ops
    real = ops.vtrace_error

    def halved(data, *args, **kwargs):
        return real(type(data)(*(None if t is None else half(t)
                                 for t in data)), *args, **kwargs)
    monkeypatch.setattr(ops, "vtrace_error", halved)
    assert result(cell, capsys)["correct"] is False


@pytest.mark.parametrize("cell", TRAIN + VTRACE)
def test_control_fails_a_limit(cell):
    c = specs.load_cell(cell, SPEC)
    out, = readings(cell, [2 ** 31 + 3], ["control"], torch.device("cpu"),
                    TINY[c["driver"]])
    assert all(v <= c["limits"][k] for k, v in out["program"].items())
    assert any(v > c["limits"][k] for k, v in out["control"].items())
