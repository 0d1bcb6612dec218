"""The port's utils (checkpoint, profiling, the exported names) and its
entry point against the JAX package's, on the CPU.

Checkpoints must give back every leaf bit for bit.  The entry's forward
runs on weights carried over from the JAX entry (models.from_jax_params)
with JAX under `jax.default_matmul_precision("float32")`: rtol=1e-4,
atol=1e-5, as the JAX package's own op tests use.
"""

import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from di_hpc_tpu_torch import entry, models, origin, utils
from di_hpc_tpu_torch.utils import checkpoint

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
H100_SXM = "NVIDIA H100 80GB HBM3"


def _equal_trees(got, want):
    g_leaves, _ = checkpoint.tree_flatten(got)
    w_leaves, _ = checkpoint.tree_flatten(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.device == w.device
            assert torch.equal(g, w)
        else:
            assert g == w


def _trained_model():
    """Actor-critic params and an Adam state after one step."""
    cfg = models.ActorCriticConfig(6, 8, 2, 3)
    params = models.init_actor_critic(cfg, torch.Generator().manual_seed(1),
                                      device="cpu")
    opt = torch.optim.Adam(params.parameters(), lr=1e-3)
    sum(p.square().sum() for p in params.parameters()).backward()
    opt.step()
    return cfg, params, opt


def test_checkpoint_round_trip_of_params_and_adam_state(tmp_path):
    cfg, params, opt = _trained_model()
    lstm = origin.init_lstm_params(torch.Generator().manual_seed(2), 6, 4, 2,
                                   "LN", device="cpu")
    tree = {"model": params, "adam": opt.state_dict(), "lstm": lstm,
            "extra": [torch.arange(3, dtype=torch.int32), None, 2.5]}
    utils.save_pytree(tmp_path / "ckpt", tree)
    assert (tmp_path / "ckpt.pt").exists()
    _, fresh, fresh_opt = _trained_model()
    with torch.no_grad():
        for p in fresh.parameters():
            p.zero_()
    like = {"model": fresh, "adam": fresh_opt.state_dict(),
            "lstm": origin.init_lstm_params(torch.Generator().manual_seed(3),
                                            6, 4, 2, "LN", device="cpu"),
            "extra": [torch.zeros(3, dtype=torch.int32), None, 0.0]}
    loaded = utils.load_pytree(tmp_path / "ckpt.pt", like)
    assert isinstance(loaded["model"], models.ActorCriticParams)
    assert isinstance(loaded["lstm"], origin.LSTMParams)
    _equal_trees(loaded, tree)
    # `like` itself is left as it was.
    assert all(bool((p == 0).all()) for p in fresh.parameters())
    # The loaded Adam state takes up where the saved one left off.
    fresh_opt.load_state_dict(loaded["adam"])
    _equal_trees(fresh_opt.state_dict(), opt.state_dict())


def test_checkpoint_of_carried_over_weights_gives_their_bits(tmp_path):
    """numpy weights in the JAX package's layout (models.from_jax_params),
    saved and loaded: the arrays' bits."""
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    H, L = 8, 2
    arrays = models.ActorCriticArrays(
        f(6, H), f(H), origin.LSTMParams(
            tuple(f(H, 4 * H) for _ in range(L)),
            tuple(f(H, 4 * H) for _ in range(L)), f(L, 4 * H),
            f(L, 4 * H), f(L, 4 * H), f(L, 4 * H), f(L, 4 * H)),
        f(H, 3), f(3), f(H, 1), f(1))
    port = models.from_jax_params(arrays, device="cpu")
    utils.save_pytree(tmp_path / "p", port)
    loaded = models.to_numpy_params(utils.load_pytree(tmp_path / "p", port))
    for got, want in zip(jax.tree.leaves(loaded), jax.tree.leaves(arrays)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_checkpoint_structure_mismatch(tmp_path):
    gen = torch.Generator().manual_seed(4)
    params = origin.init_lstm_params(gen, 6, 4, 2, "LN", device="cpu")
    utils.save_pytree(tmp_path / "p", params)
    other = origin.init_lstm_params(gen, 6, 4, 3, "LN", device="cpu")
    with pytest.raises(ValueError, match="checkpoint has 9 leaves, "
                                         "structure expects 11"):
        utils.load_pytree(tmp_path / "p", other)
    wider = origin.init_lstm_params(gen, 6, 5, 2, "LN", device="cpu")
    with pytest.raises(ValueError, match="shape"):
        utils.load_pytree(tmp_path / "p", wider)


def test_roofline_arithmetic():
    r = utils.roofline(seconds=100e-6, bytes_accessed=50 * 2 ** 20,
                       chip=H100_SXM)
    assert r.sol_seconds == pytest.approx(50 * 2 ** 20 / 3.35e12)
    assert r.achieved_gbps == pytest.approx(50 * 2 ** 20 / 100e-6)
    assert r.sol_fraction == pytest.approx(r.sol_seconds / 100e-6)
    assert 0 < r.sol_fraction < 1
    assert "GB/s" in str(r) and "speed-of-light" in str(r)
    with pytest.raises(ValueError, match="no HBM bandwidth on record"):
        utils.roofline(1e-3, 1, chip="v5e")


def test_roofline_without_a_card_needs_the_chip_named():
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    with pytest.raises(RuntimeError, match="name the chip"):
        utils.roofline(1e-3, 1)


@pytest.mark.parametrize("method", ["barrier", "perturb"])
def test_bench_fn_measures_positive_time_on_the_cpu(method):
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 64)).astype(np.float32))
    t = utils.bench_fn(lambda a: a @ a, x, k1=2, k2=12, reps=2,
                       method=method)
    assert t > 0
    with pytest.raises(ValueError, match="unknown method"):
        utils.bench_fn(lambda a: a, x, method="fori")


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(32, 32)
    with utils.trace(tmp_path / "t") as log_dir:
        (x @ x).sum()
    files = list(Path(log_dir).glob("*.json"))
    assert len(files) == 1
    assert "traceEvents" in json.loads(files[0].read_text())


def test_utils_exports_every_name_of_the_jax_utils():
    tree = ast.parse((ROOT / "di_hpc_tpu" / "utils" / "__init__.py")
                     .read_text())
    names = [a.asname or a.name for node in ast.walk(tree)
             if isinstance(node, ast.ImportFrom) for a in node.names]
    assert len(names) == 10
    for name in names:
        assert hasattr(utils, name), name
    from di_hpc_tpu.utils import constants as jax_constants
    for name in names[:5]:
        assert getattr(utils, name) == getattr(jax_constants, name)


def test_entry_forward_matches_jax_entry():
    j_fwd, (j_params, j_obs) = __graft_entry__.entry()
    fwd, (params, obs) = entry.entry(device="cpu")
    assert obs.shape == j_obs.shape
    for got, want in zip(
            jax.tree.leaves(models.to_numpy_params(params)),
            jax.tree.leaves(jax.tree.map(np.asarray, j_params))):
        assert got.shape == want.shape
    carried = models.from_jax_params(jax.tree.map(np.asarray, j_params),
                                     device="cpu")
    with torch.no_grad():
        logits, value = fwd(carried, torch.from_numpy(np.array(j_obs)))
    with jax.default_matmul_precision("float32"):
        j_logits, j_value = jax.jit(j_fwd)(j_params, j_obs)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_value),
                               rtol=RTOL, atol=ATOL)
