"""Each one-card cell for a few seconds on the card (long enough for every
sampled step of the V-trace cell's 36-ms calls), with its check; skips
without a card:

    python -m pytest benchmark/tests -q -m gpu
"""

import json

import pytest
import torch

from benchmark import run
from benchmark.core import spec as specs

SPEC = specs.benchmark_spec()
ONE_CARD = [w["name"] for w in SPEC["workloads"] if w["chips"] == 1]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ONE_CARD)
def test_cell_on_the_card(cell, card, capsys):
    rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 99),
                   "--seconds", "3", "--trace", "0"])
    out, _ = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
