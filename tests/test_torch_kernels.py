"""The port's kernel modules (di_hpc_tpu_torch.kernels) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.  (The CUDA
builds are held against their plain versions in tests/test_torch_gpu.py.)

Inputs are made with numpy from a seed and handed to both sides.
Tolerances: rtol=1e-4, atol=1e-5, as the JAX package's own kernel tests use
-- both sides compute in float32, and they differ only in the order of sums
(matmul blocking, reduction trees), which a multi-step recurrence carries
forward at the 1e-6 level.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import di_hpc_tpu.pallas_kernels.linear_scan as ls
from di_hpc_tpu.pallas_kernels import lstm_cell as jax_lstm_cell
from di_hpc_tpu.pallas_kernels import rl_scans as jax_rl_scans

from di_hpc_tpu_torch import kernels

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


def _layer_inputs(seed, S, B, H):
    rng = np.random.default_rng(seed)
    G = 4 * H
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(S, B, G), 0.1 * f(H, G), 1 + 0.1 * f(G), 0.1 * f(G),
            1 + 0.1 * f(G), 0.1 * f(G), 0.1 * f(G), f(B, H), f(B, H))


def _vtrace_inputs(seed, T, B):
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((T + 1, B)).astype(np.float32)
    reward = rng.standard_normal((T, B)).astype(np.float32)
    is_w = np.exp(0.3 * rng.standard_normal((T, B))).astype(np.float32)
    lp = -np.abs(rng.standard_normal((T, B))).astype(np.float32)
    return is_w, lp, reward, value


CLIPS = (0.99, 0.95, 1.0, 0.9, 1.2)   # gamma, lambda, rho, c, pg


# S >= 8 and H = 128 reach the TPU kernel; B = 13 is not a multiple of the
# CUDA kernel's 8-row block; S = 9 runs the TPU kernel one step per grid
# step; norm=False drops both LayerNorms.
@pytest.mark.parametrize("S,B,norm", [(8, 4, True), (8, 13, True),
                                      (9, 5, False)])
def test_lstm_layer_plain_matches_pallas(interpret, f32_matmuls, S, B, norm):
    args = _layer_inputs(0, S, B, 128)
    want = jax_lstm_cell.lstm_layer_fused(*map(jnp.asarray, args), norm)
    got = kernels.lstm_layer_plain(*map(torch.from_numpy, args), norm=norm)
    for name, g, w in zip(("y", "h_n", "c_n"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_lstm_layer_wrapper_on_cpu_runs_plain_without_launch():
    args = tuple(map(torch.from_numpy, _layer_inputs(1, 3, 5, 16)))
    before = kernels.lstm_layer_fused.launches
    got = kernels.lstm_layer_fused(*args)
    want = kernels.lstm_layer_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kernels.lstm_layer_fused.launches == before


def test_lstm_layer_plain_keeps_autograd():
    args = [torch.from_numpy(a).requires_grad_() for a in
            _layer_inputs(2, 3, 2, 8)]
    y, hn, cn = kernels.lstm_layer_fused(*args)
    (y.sum() + hn.sum() + cn.sum()).backward()
    assert all(a.grad is not None and torch.isfinite(a.grad).all()
               for a in args)


@pytest.mark.parametrize("T,B", [(36, 136), (128, 96)])
def test_vtrace_losses_plain_matches_pallas(interpret, T, B):
    is_w, lp, reward, value = _vtrace_inputs(3, T, B)
    want = jax_rl_scans.vtrace_losses_pallas(
        *map(jnp.asarray, (is_w, lp, reward, value)), *CLIPS)
    got = kernels.vtrace_losses(*map(torch.from_numpy,
                                     (is_w, lp, reward, value)), *CLIPS)
    np.testing.assert_allclose([float(x) for x in got],
                               [float(x) for x in want], rtol=RTOL, atol=ATOL)


def test_vtrace_losses_plain_gradients_match_pallas(interpret):
    """The plain version's autograd follows the kernel's gradient contract:
    d pg/d lp = -adv/TB, d vl/d value[:-1] = 2(V - vs)/TB, and value[T]
    gets none (the recurrence reads detached inputs)."""
    T, B = 36, 136
    is_w, lp, reward, value = _vtrace_inputs(4, T, B)
    j = lambda l_, v_, k: jax_rl_scans.vtrace_losses_pallas(
        jnp.asarray(is_w), l_, jnp.asarray(reward), v_, *CLIPS)[k]
    want_lp = jax.grad(j, argnums=0)(jnp.asarray(lp), jnp.asarray(value), 0)
    want_v = jax.grad(j, argnums=1)(jnp.asarray(lp), jnp.asarray(value), 1)
    lp_t = torch.from_numpy(lp).requires_grad_()
    v_t = torch.from_numpy(value).requires_grad_()
    pg, vl = kernels.vtrace_losses(torch.from_numpy(is_w), lp_t,
                                   torch.from_numpy(reward), v_t, *CLIPS)
    (pg + vl).backward()
    np.testing.assert_allclose(lp_t.grad.numpy(), np.asarray(want_lp),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(v_t.grad.numpy(), np.asarray(want_v),
                               rtol=RTOL, atol=1e-7)


# (37, 9): odd T and a B far below any block size.
@pytest.mark.parametrize("T,B", [(36, 136), (37, 9)])
def test_vtrace_returns_adv_plain_matches_pallas(interpret, T, B):
    is_w, _, reward, value = _vtrace_inputs(5, T, B)
    want = jax_rl_scans.vtrace_returns_adv_pallas(
        *map(jnp.asarray, (is_w, reward, value)), *CLIPS)
    got = kernels.vtrace_returns_adv(
        *map(torch.from_numpy, (is_w, reward, value)), *CLIPS)
    for name, g, w in zip(("vs", "adv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_non_cpu_inputs_go_to_the_kernel_checks_not_the_plain_version():
    """A tensor off the CPU never falls back: the CUDA path's checks refuse
    what is not a float32 CUDA tensor (meta tensors stand in here)."""
    is_w, lp, reward, value = (torch.from_numpy(a) for a in
                               _vtrace_inputs(6, 4, 8))
    with pytest.raises(ValueError, match="vtrace_losses: all inputs must lie"):
        kernels.vtrace_losses(is_w.to("meta"), lp, reward, value)
    with pytest.raises(ValueError, match="vtrace_returns_adv: all inputs"):
        kernels.vtrace_returns_adv(is_w, reward.to("meta"), value)
    args = [torch.from_numpy(a) for a in _layer_inputs(7, 2, 3, 8)]
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="lstm_layer_fused: all inputs"):
        kernels.lstm_layer_fused(*args)


def test_launch_counts_reset():
    kernels.vtrace_losses.launches = 3
    kernels.lstm_layer_bwd_v2.launches = 2
    kernels.td_lambda_err.launches = 1
    kernels.linear_scan.launches = 4
    kernels.upgo_loss.launches = 5
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {
        "lstm_layer_fused": 0, "lstm_layer_bwd_v2": 0, "lstm_layer_bwd_v1": 0,
        "vtrace_losses": 0, "vtrace_returns_adv": 0, "gae": 0,
        "lambda_returns": 0, "td_lambda_loss": 0, "td_lambda_err": 0,
        "linear_scan": 0, "upgo_advantages": 0, "upgo_loss": 0}


def _bwd_np(seed, S, B, H):
    """Forward inputs, the plain stash forward's y and c_seq, and random
    cotangents, as numpy: the arguments of _bwd_impl_v2 in its order."""
    fwd = _layer_inputs(seed, S, B, H)
    gxp, wh, glnx, blnx, gln, bln, bias, h0, c0 = fwd
    with torch.no_grad():
        y, c_seq, _, _ = kernels.lstm_layer_stash_plain(
            *map(torch.from_numpy, fwd))
    rng = np.random.default_rng(seed + 100)
    dy, dhn, dcn = (rng.standard_normal(s).astype(np.float32)
                    for s in ((S, B, H), (B, H), (B, H)))
    return (gxp, y.numpy(), c_seq.numpy(), dy, wh, glnx, blnx, gln, bln,
            bias, h0, c0, dhn, dcn)


def _v1_np(v2_args, norm):
    """The V1 kernel's streams, made from the V2 arguments as
    lstm_cell.py:_layer_bwd makes them (in float32 numpy)."""
    gxp, y, c_seq, dy, wh, glnx, blnx, gln, bln, bias, h0, c0, dhn, dcn = \
        v2_args
    if norm:
        m = gxp.mean(-1, keepdims=True)
        rstd = 1 / np.sqrt(np.maximum((gxp * gxp).mean(-1, keepdims=True)
                                      - m * m, 0) + 1e-5)
        gx = (gxp - m) * rstd * glnx + blnx + bias
    else:
        gx = gxp + bias
    h_prev = np.concatenate([h0[None], y[:-1]])
    c_prev = np.concatenate([c0[None], c_seq[:-1]])
    return tuple(a.astype(np.float32) for a in (
        gx, h_prev @ wh, c_prev, c_seq, dy, wh, gln, bln, dhn, dcn))


def _sum_atol(S, B):
    """Tolerance of the sums over all S*B rows (parameter gradients): they
    add S*B terms in another order than the JAX side, and float32 rounding
    of such a sum grows like sqrt(S*B)."""
    return ATOL * np.sqrt(S * B)


# B = 64: one JAX block; B = 88 with the JAX block forced to 16: a ragged
# last block on the TPU side (and 88 % 8 = 0, B = 13 below, on the CUDA
# side); norm=False drops both LayerNorms.
@pytest.mark.parametrize("S,B,norm,force_blk", [(8, 64, True, None),
                                                (3, 88, True, 16),
                                                (8, 64, False, None)])
def test_lstm_bwd_v2_plain_matches_pallas(interpret, f32_matmuls, monkeypatch,
                                          S, B, norm, force_blk):
    if force_blk is not None:
        monkeypatch.setattr(jax_lstm_cell, "_pick_blk_b_v2",
                            lambda *a, **k: force_blk)
    jax.clear_caches()
    args = _bwd_np(8, S, B, 128)
    want = jax_lstm_cell._bwd_impl_v2(*map(jnp.asarray, args), norm)
    got = kernels.lstm_layer_bwd_v2(*map(torch.from_numpy, args), norm=norm)
    names = ("dgxp", "dg_pre", "dgamma_h", "dgamma_x", "dsum", "dh0", "dc0")
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        atol = _sum_atol(S, B) if 2 <= i <= 4 else ATOL
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape),
                                   rtol=RTOL, atol=atol, err_msg=name)


# B = 13 leaves a ragged last block of the CUDA kernel's 8-row CTAs.
@pytest.mark.parametrize("S,B,norm", [(8, 13, True), (9, 5, False)])
def test_lstm_bwd_v1_plain_matches_pallas(interpret, f32_matmuls, S, B,
                                          norm):
    jax.clear_caches()
    args = _v1_np(_bwd_np(9, S, B, 128), norm)
    want = jax_lstm_cell._bwd_impl(*map(jnp.asarray, args), norm)
    got = kernels.lstm_layer_bwd_v1(*map(torch.from_numpy, args), norm=norm)
    for name, g, w in zip(("dgate", "dg_pre", "dh0", "dc0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def _layer_loss(y, hn, cn, xp):
    return (y * xp.cos(y)).sum() + (hn ** 2).sum() + xp.sin(cn).sum()


# B = 64 routes both sides' backward through V2, B = 5 through V1.
@pytest.mark.parametrize("S,B,norm", [(8, 64, True), (8, 5, True),
                                      (8, 64, False)])
def test_layer_function_gradients_match_jax(interpret, f32_matmuls, S, B,
                                            norm):
    """The autograd.Function around lstm_layer_fused against jax.grad of
    the JAX package's custom VJP (as tests/test_pallas_fused.py drives it):
    the same 9 gradients in the same order, from the hand-derived backward
    on both sides."""
    jax.clear_caches()
    args = _layer_inputs(10, S, B, 128)
    want = jax.grad(lambda a: _layer_loss(
        *jax_lstm_cell.lstm_layer_fused(*a, norm), jnp))(
        tuple(map(jnp.asarray, args)))
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    kernels.reset_launch_counts()
    got = torch.autograd.grad(
        _layer_loss(*kernels.lstm_layer_fused(*t, norm=norm), torch), t)
    assert set(kernels.launch_counts().values()) == {0}   # CPU: plain only
    names = ("dgxp", "dwh", "dglnx", "dblnx", "dgln", "dbln", "dbias", "dh0",
             "dc0")
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        atol = _sum_atol(S, B) if 1 <= i <= 6 else ATOL
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=atol, err_msg=name)
