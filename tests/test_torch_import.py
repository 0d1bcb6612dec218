"""The port stands alone: di_hpc_tpu_torch and chip_smoke.py import no JAX
and nothing of the JAX package di_hpc_tpu, and chip_smoke.py refuses to run
without a card."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now fails
import di_hpc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(di_hpc_tpu_torch.__path__,
                                               "di_hpc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "di_hpc_tpu" or m.startswith("di_hpc_tpu."))
print(json.dumps({"imported": names, "leaked": leaked}))
"""


def _run(args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""        # no card, on any machine
    return subprocess.run([sys.executable, *args], cwd=kw.pop("cwd", ROOT),
                          env=env, capture_output=True, text=True,
                          timeout=300, **kw)


def test_package_imports_without_jax_or_the_jax_package():
    out = _run(["-c", _PROBE])
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["leaked"] == []
    for sub in ("kernels.lstm_cell", "kernels.rl_scans", "kernels._build",
                "models.actor_critic_lstm", "models.convert", "network.lstm",
                "ops.categorical", "ops.vtrace", "ops.scan", "ops.gae",
                "ops.td", "ops.ppo", "ops._backend", "origin.gae",
                "origin.td", "origin.ppo", "kernels.linear_scan", "ops.upgo",
                "origin.upgo", "origin.scatter_connection",
                "network.scatter_connection", "models.actor_critic",
                "models.entity_selection", "ops.padding", "origin.padding",
                "data", "utils.native", "utils.checkpoint",
                "utils.profiling", "entry", "examples.episodic_a2c_padding",
                "examples.impala_actor_learner", "examples.impala_training",
                "examples.c51_training", "examples.quantile_dqn_training",
                "examples.ppo_training", "examples.alphastar_policy_training",
                "examples.r2d2_training",
                "parallel", "parallel.mesh",
                "parallel.dscan", "parallel.api", "parallel.runtime",
                "parallel._comm", "utils.transfer"):
        assert "di_hpc_tpu_torch." + sub in result["imported"]


def test_sources_name_no_jax_import():
    files = [ROOT / "chip_smoke.py", *(ROOT / "di_hpc_tpu_torch").rglob("*.py")]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "di_hpc_tpu", "optax"), \
                    f"{path.name} imports {m}"


def test_chip_smoke_fails_without_a_card():
    """With no card visible the script exits non-zero before it prints a
    result line."""
    out = _run(["chip_smoke.py"])
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script cannot find the port and fails."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    out = _run(["chip_smoke.py"], cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
