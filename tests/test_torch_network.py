"""The port's LN-LSTM (di_hpc_tpu_torch.network and .origin.rnn) against
the JAX package's, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both
sides.  The JAX fused LSTM runs its Pallas layer kernel in interpret mode
(H = 128, S >= 8 reach it) under float32 matmuls.  Tolerances: rtol=1e-4,
atol=1e-5, as the JAX package's own LSTM kernel tests use -- float32 on
both sides, differing only in the order of sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import di_hpc_tpu.pallas_kernels.linear_scan as ls
from di_hpc_tpu.network import lstm as jax_network_lstm
from di_hpc_tpu.origin import rnn as jax_rnn

from di_hpc_tpu_torch import network, origin
from di_hpc_tpu_torch.models import from_jax_params, to_numpy_params

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def interpret():
    ls.INTERPRET = True
    jax.clear_caches()          # no trace cached by an earlier test's mode
    yield
    ls.INTERPRET = False


@pytest.fixture
def f32_matmuls():
    with jax.default_matmul_precision("float32"):
        yield


def _np_lstm_params(seed, I, H, L, norm=True):
    """JAX LSTMParams of numpy arrays with non-trivial LN params."""
    rng = np.random.default_rng(seed)
    g = np.sqrt(1.0 / H)
    u = lambda *s: rng.uniform(-g, g, s).astype(np.float32)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    dims = [I] + [H] * L
    ln = ((1 + 0.1 * n(L, 4 * H), 0.1 * n(L, 4 * H),
           1 + 0.1 * n(L, 4 * H), 0.1 * n(L, 4 * H)) if norm
          else (None,) * 4)
    return jax_rnn.LSTMParams(tuple(u(dims[l], 4 * H) for l in range(L)),
                              tuple(u(H, 4 * H) for _ in range(L)),
                              u(L, 4 * H), *ln)


def _state(seed, L, B, H):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((L, B, H)).astype(np.float32)
                 for _ in range(2))


def _port_params(np_params):
    return from_jax_params(np_params, device="cpu").params()


def _check(got, want):
    y, (h, c) = got
    wy, (wh, wc) = want
    for name, g, w in (("y", y, wy), ("h", h, wh), ("c", c, wc)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL, err_msg=name)


def test_lstm_fused_matches_jax_kernel_path(interpret, f32_matmuls,
                                            monkeypatch):
    S, B, I, H, L = 8, 5, 20, 128, 2
    p = _np_lstm_params(0, I, H, L)
    x = np.random.default_rng(1).standard_normal((S, B, I)).astype(np.float32)
    h0, c0 = _state(2, L, B, H)

    calls = []
    real = jax_network_lstm._lstm_cell.lstm_layer_fused
    monkeypatch.setattr(jax_network_lstm._lstm_cell, "lstm_layer_fused",
                        lambda *a: calls.append(1) or real(*a))
    want = jax_network_lstm.lstm_fused(p, jnp.asarray(x),
                                       (jnp.asarray(h0), jnp.asarray(c0)))
    assert len(calls) == L          # the JAX side really ran its kernel
    got = network.lstm_fused(_port_params(p), torch.from_numpy(x),
                             (torch.from_numpy(h0), torch.from_numpy(c0)))
    _check(got, want)


def test_lstm_fused_without_norm_matches_jax_scan(f32_matmuls):
    S, B, I, H, L = 6, 3, 12, 32, 2
    p = _np_lstm_params(3, I, H, L, norm=False)
    x = np.random.default_rng(4).standard_normal((S, B, I)).astype(np.float32)
    want = jax_network_lstm.lstm_fused(p, jnp.asarray(x), None, None)
    got = network.lstm_fused(_port_params(p), torch.from_numpy(x), None, None)
    _check(got, want)


def test_lstm_fused_float16_takes_the_recurrent_path_as_jax_does():
    """No kernel takes float16 streams, so each layer takes the recurrent
    path, on the CPU as on the card, as JAX's op routes float16 to its scan
    (its network/lstm.py:134-135).  Against JAX's float16 op within 1e-2 of
    max|want|: both round every op to float16, in other orders."""
    S, B, I, H, L = 6, 5, 12, 32, 2
    p = _np_lstm_params(3, I, H, L)
    st = _state(4, L, B, H)
    x = np.random.default_rng(5).standard_normal((S, B, I)).astype(
        np.float32)
    half = lambda a: None if a is None else jnp.asarray(a, jnp.float16)
    want = jax_network_lstm.lstm_fused(
        jax.tree_util.tree_map(half, p), half(x), tuple(map(half, st)), "LN")
    tp = network.LSTMParams(*(
        tuple(w.half() for w in f) if isinstance(f, tuple) else f.half()
        for f in _port_params(p)))
    network.reset_route_counts()
    y, (h, c) = network.lstm_fused(tp, torch.from_numpy(x).half(), tuple(
        torch.from_numpy(a).half() for a in st))
    assert network.lstm_fused.routes == {"kernel": 0, "recurrent": L}
    for name, g, w in (("y", y, want[0]), ("h", h, want[1][0]),
                       ("c", c, want[1][1])):
        assert g.dtype == torch.float16, name
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.detach().float().numpy(), w, rtol=0,
                                   atol=1e-2 * np.abs(w).max(), err_msg=name)


@pytest.mark.parametrize("case,want", [
    ("float32", {"kernel": 2, "recurrent": 0}),
    ("bf16", {"kernel": 2, "recurrent": 0}),
    ("remat", {"kernel": 0, "recurrent": 2}),
    ("mixed", {"kernel": 0, "recurrent": 2})])
def test_lstm_fused_counts_the_route_of_each_layer(case, want):
    """On the CPU only remat, mixed dtypes and streams other than float32
    and bf16 leave the kernel wrapper (which runs its plain version here);
    the card's shape rules are held in tests/test_torch_kernels.py and
    tests/test_torch_gpu.py.  reset_route_counts zeroes the counter."""
    S, B, I, H, L = 3, 4, 12, 30, 2
    p = _port_params(_np_lstm_params(6, I, H, L))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (S, B, I)).astype(np.float32))
    dt = torch.bfloat16 if case in ("bf16", "mixed") else torch.float32
    p = network.LSTMParams(*(
        tuple(w.to(dt) for w in f) if isinstance(f, tuple) else f.to(dt)
        for f in p))
    network.lstm_fused.routes["kernel"] += 5
    network.reset_route_counts()
    network.lstm_fused(p, x if case == "mixed" else x.to(dt),
                       remat=case == "remat")
    assert network.lstm_fused.routes == want


@pytest.mark.parametrize("norm_type", ["LN", None])
def test_origin_lstm_matches_jax_oracle(f32_matmuls, norm_type):
    S, B, I, H, L = 7, 4, 10, 24, 2
    p = _np_lstm_params(5, I, H, L, norm=norm_type == "LN")
    x = np.random.default_rng(6).standard_normal((S, B, I)).astype(np.float32)
    h0, c0 = _state(7, L, B, H)
    want = jax_rnn.lstm(p, jnp.asarray(x), (jnp.asarray(h0), jnp.asarray(c0)),
                        norm_type)
    got = origin.lstm(_port_params(p), torch.from_numpy(x),
                      (torch.from_numpy(h0), torch.from_numpy(c0)), norm_type)
    _check(got, want)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(8)
    x, g, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((5, 64), (64,), (64,)))
    want = jax_rnn.layer_norm(*map(jnp.asarray, (x, g, b)))
    got = origin.layer_norm(*map(torch.from_numpy, (x, g, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_flatten_roundtrip_matches_jax_layout():
    I, H, L = 6, 8, 3
    p = _np_lstm_params(9, I, H, L)
    want = jax_network_lstm.flatten_lstm_params(p)
    got = network.flatten_lstm_params(_port_params(p))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.detach().numpy(), np.asarray(w))
    back = network.unflatten_lstm_params(*got, I, H, L)
    for g, w in zip(jax.tree.leaves(to_numpy_params(network.LSTMWeights(back))),
                    jax.tree.leaves(p)):
        np.testing.assert_array_equal(g, w)
    assert network.flatten_lstm_params(
        _port_params(_np_lstm_params(9, I, H, L, norm=False)))[3:] == (None,
                                                                       None)


def test_sequence_mask_and_get_lstm_match_jax():
    lengths = np.array([3, 0, 5, 1])
    np.testing.assert_array_equal(
        origin.sequence_mask(torch.from_numpy(lengths)).numpy(),
        np.asarray(jax_rnn.sequence_mask(jnp.asarray(lengths))))
    init_fn, apply_fn = origin.get_lstm("pytorch", 4, 8, 2)
    params = init_fn(torch.Generator().manual_seed(0), device="cpu")
    assert params.ln_gamma_x is None
    y, (h, c) = apply_fn(params, torch.zeros(3, 2, 4))
    assert y.shape == (3, 2, 8) and h.shape == c.shape == (2, 2, 8)


def test_init_lstm_params_scale_and_seed():
    make = lambda: origin.init_lstm_params(torch.Generator().manual_seed(3),
                                           16, 64, 2, device="cpu")
    a, b = make(), make()
    for x, y in zip(jax.tree.leaves(tuple(a)), jax.tree.leaves(tuple(b))):
        assert torch.equal(x, y)
    gain = np.sqrt(1 / 64)
    assert a.wx[0].shape == (16, 256) and a.wh[1].shape == (64, 256)
    assert float(a.wh[0].abs().max()) <= gain
    assert float(a.wh[0].std()) == pytest.approx(gain / np.sqrt(3), rel=0.05)
    assert torch.equal(a.ln_gamma_h, torch.ones(2, 256))


def test_dropout_statistics():
    """Dropout cannot reproduce jax.random's masks, so it is checked by its
    statistics: the kept share is 1 - p within 5 standard deviations, kept
    values are scaled by 1/(1 - p), and a seed reproduces the mask."""
    p, n = 0.3, 200_000
    x = torch.ones(n)
    out = origin.rnn.dropout_mask(x, p, torch.Generator().manual_seed(0))
    kept = out != 0
    frac = kept.float().mean().item()
    assert abs(frac - (1 - p)) < 5 * np.sqrt(p * (1 - p) / n)
    assert torch.allclose(out[kept], torch.full_like(out[kept], 1 / (1 - p)))
    again = origin.rnn.dropout_mask(x, p, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)
    with pytest.raises(ValueError, match="torch.Generator"):
        origin.rnn.dropout_mask(x, p, None)


def test_lstm_module_dropout_and_shape_check():
    mod = network.LSTM(4, 3, 6, 16, 2, dropout=0.5,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    x = torch.randn(4, 3, 6, generator=torch.Generator().manual_seed(1))
    run = lambda seed: mod(x, generator=torch.Generator().manual_seed(seed))[0]
    assert torch.equal(run(2), run(2))
    assert not torch.equal(run(2), run(3))
    mod.eval()                      # eval mode: no dropout, no generator
    y0 = mod(x)[0]
    y1 = network.lstm_fused(mod.params(), x)[0]
    assert torch.equal(y0, y1)
    with pytest.raises(ValueError, match="LSTM: inputs must be"):
        mod(torch.zeros(4, 3, 5))
    with pytest.raises(ValueError, match="lstm_fused: prev_state"):
        network.lstm_fused(mod.params(), x,
                           (torch.zeros(2, 3, 8), torch.zeros(2, 3, 8)))
