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


# T = 63 and 65 straddle the CUDA kernels' 64-step span of 8 chunks.
@pytest.mark.parametrize("T,B", [(36, 136), (128, 96), (63, 9), (65, 9)])
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


# (37, 9): odd T and a B far below any block size; T = 63 and 65 as above.
@pytest.mark.parametrize("T,B", [(36, 136), (37, 9), (63, 9), (65, 9)])
def test_vtrace_returns_adv_plain_matches_pallas(interpret, T, B):
    is_w, _, reward, value = _vtrace_inputs(5, T, B)
    want = jax_rl_scans.vtrace_returns_adv_pallas(
        *map(jnp.asarray, (is_w, reward, value)), *CLIPS)
    got = kernels.vtrace_returns_adv(
        *map(torch.from_numpy, (is_w, reward, value)), *CLIPS)
    for name, g, w in zip(("vs", "adv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("B", [1, 8, 256, 4096, 4100])
@pytest.mark.parametrize("T", [1, 16, 32, 65, 1024, 4099])
def test_vtrace_launch_shape_covers_the_planes(T, B):
    """The V-trace kernels' tiles cover T and B, a CTA holds at most 512
    threads and its shared memory fits the H100's 227 KB, and wide B keeps
    32-column tiles (coalesced 128-byte rows) while narrow B takes narrower
    tiles for more CTAs."""
    shape = kernels.vtrace_launch_shape(T, B)
    assert shape["grid"] >= 1 and shape["grid"] * shape["cols"] >= B
    assert (shape["grid"] - 1) * shape["cols"] < B
    steps, tiles = shape["chunks"] * shape["chunk"], shape["super_tiles"]
    assert shape["super_tile_steps"] == steps
    assert (tiles - 1) * steps < T <= tiles * steps
    assert shape["threads"] == shape["cols"] * shape["chunks"] <= 512
    assert shape["smem_bytes"] <= 232448
    assert shape["cols"] == (32 if B >= 4096 else 8)
    assert shape["chunks"] == min(-(-T // 8), 16)


@pytest.mark.parametrize("B", [1, 5, 33, 4096, 4100])
@pytest.mark.parametrize("T", [1, 7, 8, 9, 65, 1000, 1024])
@pytest.mark.parametrize("shape_fn", ["linear_scan_launch_shape",
                                      "td_lambda_launch_shape",
                                      "td_lambda_err_launch_shape",
                                      "gae_launch_shape",
                                      "lambda_returns_launch_shape",
                                      "upgo_loss_launch_shape",
                                      "upgo_advantages_launch_shape"])
def test_chunked_scan_launch_shapes_cover_the_planes(shape_fn, T, B):
    """Kernels 6, 9, 10, 7, 8, 12 and 11 take the V-trace kernels' tiling: the
    tiles cover T and B, a CTA holds at most 512 threads, its shared memory
    (two buffers of (A, D) pairs, and the losses' chunk partials) fits the
    H100's 227 KB, and the cols and chunks overrides are taken as given."""
    fn = getattr(kernels, shape_fn)
    shape = fn(T, B)
    assert shape == {**kernels.vtrace_launch_shape(T, B),
                     "smem_bytes": shape["smem_bytes"]}
    assert (shape["grid"] - 1) * shape["cols"] < B <= \
        shape["grid"] * shape["cols"]
    steps, tiles = shape["super_tile_steps"], shape["super_tiles"]
    assert steps == shape["chunks"] * 8 and (tiles - 1) * steps < T <= \
        tiles * steps
    assert shape["threads"] == shape["cols"] * shape["chunks"] <= 512
    floats = 5 if shape_fn in ("td_lambda_launch_shape",
                               "upgo_loss_launch_shape") else 4
    assert shape["smem_bytes"] == floats * 4 * shape["threads"] <= 232448
    assert fn(T, B, 132, 16, 16)["grid"] == -(-B // 16)
    assert fn(T, B, 132, 5, 7)["super_tile_steps"] == 56
    with pytest.raises(ValueError, match="exceed 512 threads"):
        fn(T, B, 132, 64, 16)


def test_gae_launch_shape_at_the_ppo_trainers_shape():
    """The PPO trainer's rollouts (T=16, B=256) take 8 columns x 2 chunks, a
    grid of 32 CTAs: narrower tiles, so that the grid fills more SMs."""
    shape = kernels.gae_launch_shape(16, 256)
    assert (shape["cols"], shape["chunks"], shape["grid"]) == (8, 2, 32)
    assert (shape["threads"], shape["super_tiles"]) == (16, 1)


@pytest.mark.parametrize("T,B,want", [(16, 8, (8, 2, 1, 16, 1)),
                                      (128, 512, (8, 16, 64, 128, 1))])
def test_upgo_loss_launch_shape_at_its_callers_shapes(T, B, want):
    """The AlphaStar step's T=16, B=8 takes 8 columns x 2 chunks in one CTA;
    ops.upgo_loss's T=128, B=512 takes 8 x 16 in 64 CTAs; each CTA walks
    one super-tile.  Narrow tiles, so that the grid fills more SMs."""
    shape = kernels.upgo_loss_launch_shape(T, B)
    assert (shape["cols"], shape["chunks"], shape["grid"], shape["threads"],
            shape["super_tiles"]) == want
    assert shape["smem_bytes"] == 5 * 4 * shape["threads"]


@pytest.mark.parametrize("T,B,want", [(16, 8, (8, 2, 1, 16, 1)),
                                      (128, 512, (8, 16, 64, 128, 1)),
                                      (1024, 4096, (32, 16, 128, 512, 8))])
def test_upgo_advantages_launch_shape_at_its_callers_shapes(T, B, want):
    """Kernel 11 takes kernel 12's tiling at the AlphaStar step's T=16, B=8,
    at the backward of ops.upgo_loss (T=128, B=512) and at the north-star
    plane; its shared memory holds only the two buffers of pairs."""
    shape = kernels.upgo_advantages_launch_shape(T, B)
    assert (shape["cols"], shape["chunks"], shape["grid"], shape["threads"],
            shape["super_tiles"]) == want
    loss = kernels.upgo_loss_launch_shape(T, B)
    assert {**shape, "smem_bytes": loss["smem_bytes"]} == loss
    assert shape["smem_bytes"] == 4 * 4 * shape["threads"]


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


class _FakeLayerLibrary:
    """The forward's launch-shape exports as the library reckons them at
    H=512 (8 CTAs, 24 rows) and H=510 (the 8-row route), for the Python
    side of kernels.layer_launch_shape without a card."""

    def lstm_layer_fwd_cluster_size(self, H):
        return 8 if H % 4 == 0 else 0

    def lstm_layer_fwd_rows_per_group(self, B, H, item):
        return 24 if H % 4 == 0 else 8

    def lstm_layer_fwd_smem_bytes(self, H, item, rows):
        return 1000 * rows + item

    def lstm_layer_fwd_max_active_clusters(self, B, H, item, rows):
        return 15


@pytest.mark.parametrize("H,rows,want", [
    (512, None, {"route": "cluster", "cluster": 8, "rows_per_group": 24,
                 "groups": 11, "grid": 88, "smem_bytes": 24004,
                 "max_active_clusters": 15}),
    (512, 16, {"route": "cluster", "cluster": 8, "rows_per_group": 16,
               "groups": 16, "grid": 128, "smem_bytes": 16004,
               "max_active_clusters": 15}),
    (510, 16, {"route": "rows8", "cluster": 1, "rows_per_group": 8,
               "groups": 32, "grid": 32, "smem_bytes": 8004,
               "max_active_clusters": None})])
def test_layer_launch_shape_reads_the_route_from_the_library(monkeypatch, H,
                                                             rows, want):
    """B=256: groups and grid from the library's rows and cluster size; a
    rows override applies to the cluster route only; the 8-row route has
    no cluster and no cluster occupancy."""
    from di_hpc_tpu_torch.kernels import _build
    fake = type("Lib", (), {"cdll": _FakeLayerLibrary()})()
    monkeypatch.setattr(_build, "library", lambda: fake)
    assert kernels.layer_launch_shape(256, H, 4, rows) == want


class _FakeSizingLibrary:
    """The sizing exports that network.layer_route reads, with plans that
    end at made-up widths on a card of SMEM_LIMIT bytes per CTA: the
    forward past H=1160, V2 past 580, V1 past 724 (float32; twice the
    widths for bf16), each a multiple of 4."""

    SMEM_LIMIT = 232000

    def lstm_layer_smem_bytes(self, H, item):
        return 50 * H * item

    def lstm_layer_bwd_v2_smem_bytes(self, H, item):
        return 100 * H * item

    def lstm_layer_bwd_v1_cluster_size(self, H):
        return 16 if H % 64 == 0 else 4

    def lstm_layer_bwd_v1_rows_per_group(self, B, H, item, cluster):
        return 8

    def lstm_layer_bwd_v1_smem_bytes(self, H, item, cluster, rows):
        return 80 * H * item + 1


@pytest.mark.parametrize("B,H,dtype,grad,want", [
    (4, 30, torch.float32, True, "recurrent"),       # H % 4 != 0, V1
    (64, 30, torch.float32, True, "recurrent"),      # H % 4 != 0, V2
    (4, 30, torch.float32, False, "kernel"),         # the 8-row forward
    (8, 32, torch.float16, False, "recurrent"),      # no float16 kernel
    (8, 32, torch.float64, True, "recurrent"),
    (4, 1164, torch.float32, False, "recurrent"),    # past the forward
    (4, 1160, torch.float32, False, "kernel"),
    (64, 584, torch.float32, True, "recurrent"),     # past V2
    (64, 584, torch.float32, False, "kernel"),
    (4, 584, torch.float32, True, "kernel"),         # V1 takes it
    (4, 728, torch.float32, True, "recurrent"),      # past V1
    (64, 724, torch.bfloat16, True, "kernel"),       # bf16 plans go further
    (64, 512, torch.float32, True, "kernel"),        # the flagship
    (32, 512, torch.float32, True, "kernel"),
    (256, 512, torch.bfloat16, True, "kernel"),
    (1, 512, torch.bfloat16, False, "kernel")])
def test_layer_route_reads_the_plans_from_the_library(monkeypatch, B, H,
                                                      dtype, grad, want):
    """network.layer_route sends a layer to the recurrent path where the
    kernel library cannot launch it, read from the library's sizing
    exports (a fake library here) against the card's shared-memory limit:
    H % 4 != 0 with a gradient, a dtype other than float32 and bf16, and a
    width past the forward's plan or past the plan of the backward that B
    selects (V2 from B = 64)."""
    from di_hpc_tpu_torch import network
    from di_hpc_tpu_torch.kernels import _build
    fake = type("Lib", (), {"cdll": _FakeSizingLibrary()})()
    monkeypatch.setattr(_build, "library", lambda: fake)
    assert network.layer_route(B, H, dtype, grad,
                               _FakeSizingLibrary.SMEM_LIMIT) == want


def test_launch_counts_reset():
    kernels.vtrace_losses.launches = 3
    kernels.lstm_layer_bwd_v2.launches = 2
    kernels.td_lambda_err.launches = 1
    kernels.linear_scan.launches = 4
    kernels.upgo_loss.launches = 5
    kernels.categorical_fwd.launches = 8
    kernels.categorical_bwd.launches = 9
    kernels.lstm_layer_fused.launches_bf16 = 6
    kernels.lstm_layer_bwd_v1.launches_bf16 = 7
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {
        "lstm_layer_fused": 0, "lstm_layer_bwd_v2": 0, "lstm_layer_bwd_v1": 0,
        "vtrace_losses": 0, "vtrace_returns_adv": 0, "gae": 0,
        "lambda_returns": 0, "td_lambda_loss": 0, "td_lambda_err": 0,
        "linear_scan": 0, "upgo_advantages": 0, "upgo_loss": 0,
        "categorical_fwd": 0, "categorical_bwd": 0,
        "lstm_layer_fused_bf16": 0, "lstm_layer_bwd_v2_bf16": 0,
        "lstm_layer_bwd_v1_bf16": 0}


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
