"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs, the LSTM layer's autograd.Function against
autograd through the plain forward, the forward/serving path, one training
step and the GAE and TD(lambda) ops on the card against the same calls on
the CPU; the full-plane kernels (the linear recurrence, UPGO) against their
plain versions, the scan entry points, ops.upgo_loss and the scatter
connection on the card against the CPU, and one step of the AlphaStar
trainer of di_hpc_tpu_torch.examples.alphastar_policy_training on the card
against the CPU; the bf16 instantiations of the
three LSTM kernels against their plain bf16 versions, the bf16 train step on
the card against the CPU, and strided (T, B) inputs through the RL ops;
the chunked linear recurrence (kernel 6), TD(lambda) loss (kernel 9), GAE
(kernel 7), TD(lambda) error plane (kernel 10), lambda-returns plane
(kernel 8), UPGO loss (kernel 12) and UPGO advantage plane (kernel 11)
against their plain versions at ragged shapes, boundaries, (gamma, lambda),
exact ties and tilings; the batch-bound TD family (ops.q_nstep_td_error and
its kin) on the card against the same calls on the CPU, and the C51,
QR-DQN and IQN trainers' steps of di_hpc_tpu_torch.examples (chip_smoke's
phase replay legs) on the card against the CPU; and
`network.lstm_fused` with a gradient where the kernels cannot take the
layer (H % 4 != 0, widths past each shared-memory plan, float16), against
the same call on the CPU, with the route each layer took; and the host data
plane: ragged padding from numpy and from CUDA inputs bitwise equal to the
CPU's, `TrajectoryBuffer.sample_batch` on the card equal to the CPU's, one
episodic A2C step (kernels 8 and 6 once per bucket) against the CPU, and a
checkpoint round trip of card parameters and Adam state; the sharded train
step in a world of two ranks on the card against the unsharded step, and
`sample_batch(mesh=)` in a world of one; and the `dihpc.kernel.` and
`dihpc.lstm.layer.` spans of a profiled train step against
`kernels.launch_counts()` and `network.lstm_fused.routes`; and the
categorical head's kernels (ops.logp_entropy and ops.logp on the card)
against the plain body called on the same card tensors at N from 1 to
4096, float32 and bf16 logits, int32 and int64 actions, masked logits and
broadcast incoming gradients, and the inputs the route casts first.

Every test here is marked `gpu` and skips without a card (decided in the
`cuda` fixture, never at import).  This file imports no JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance: rtol=1e-4, atol=1e-4.  Both sides are float32 without TF32;
they differ in summation order (the kernel's k-loop and warp sums against
cuBLAS and PyTorch's reduction trees) and in FMA contraction, carried
through the recurrences.  bf16 outputs: chip_smoke.compare_bf16's bound,
stated in chip_smoke.py at BF16_REL.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from di_hpc_tpu_torch import kernels, models, network, ops
from di_hpc_tpu_torch.examples import alphastar_policy_training as alphastar
from di_hpc_tpu_torch.kernels import _build
from di_hpc_tpu_torch.kernels.linear_scan import _linear_scan

RTOL, ATOL = 1e-4, 1e-4
CLIPS = (0.99, 0.95, 1.0, 0.9, 1.2)   # gamma, lambda, rho, c, pg

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _layer_inputs(seed, S, B, H, dev):
    rng = np.random.default_rng(seed)
    G = 4 * H
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrays = (f(S, B, G), 0.1 * f(H, G), 1 + 0.1 * f(G), 0.1 * f(G),
              1 + 0.1 * f(G), 0.1 * f(G), 0.1 * f(G), f(B, H), f(B, H))
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _vtrace_inputs(seed, T, B, dev):
    rng = np.random.default_rng(seed)
    arrays = (np.exp(0.3 * rng.standard_normal((T, B))),
              -np.abs(rng.standard_normal((T, B))),
              rng.standard_normal((T, B)), rng.standard_normal((T + 1, B)))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrays]


# B = 13 and 17 leave a partial last group of rows; S = 1 is the serving
# step; H = 96 is no power of two; norm=False drops both LNs.
@pytest.mark.parametrize("S,B,H,norm", [(9, 13, 128, True), (1, 8, 128, True),
                                        (5, 17, 96, False)])
def test_lstm_layer_kernel_matches_plain(cuda, S, B, H, norm):
    args = _layer_inputs(8, S, B, H, cuda)
    with torch.no_grad():
        before = kernels.lstm_layer_fused.launches
        got = kernels.lstm_layer_fused(*args, norm=norm)
        want = kernels.lstm_layer_plain(*args, norm=norm)
    torch.cuda.synchronize()
    assert kernels.lstm_layer_fused.launches == before + 1
    for name, g, w in zip(("y", "h_n", "c_n"), got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=name)


def test_lstm_layer_stash_kernel_matches_plain(cuda):
    """The forward kernel in stash mode also writes the cell state of every
    step; y, h_n and c_n are those of the run without the stash."""
    args = _layer_inputs(19, 9, 13, 128, cuda)
    with torch.no_grad():
        got = kernels.lstm_layer_stash(*args)
        plain = kernels.lstm_layer_fused(*args)
        want = kernels.lstm_layer_stash_plain(*args)
    for name, g, w in zip(("y", "c_seq", "h_n", "c_n"), got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=name)
    for g, p in zip((got[0], got[2], got[3]), plain):
        assert torch.equal(g, p)


def _layer_inputs_at(seed, S, B, H, dev, dtype):
    """_layer_inputs with Wh scaled to 1/sqrt(H) from H = 200 up, in
    `dtype`."""
    args = _layer_inputs(seed, S, B, H, dev)
    if H >= 200:
        args[1] = args[1] * (1 / np.sqrt(H) / 0.1)
    return [a.to(dtype) for a in args]


def _close_to_plain(args, got, want, norm):
    """f32 at RTOL/ATOL; bf16 at chip_smoke.compare_bf16's bound."""
    if args[0].dtype == torch.bfloat16:
        _close_bf16(kernels.lstm_layer_stash_plain, args, got, want,
                    "forward", norm=norm)
        return
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL,
                                   msg=f"output {i}")


# The cluster kernel at each cluster size and row-group size: H = 36 (6
# CTAs of 6 units, which are no multiple of 4, so they move one element at a
# time), 48 (6 of 8), 56 (7 of 8), 200 (5 of 40), 524 (4 of 131) and 544 (8
# of 68); B = 5 takes groups of 8 rows, 13 of 16, 17 and 30 of 24, each with
# a partial last group; S = 1 is the serving step.
@pytest.mark.parametrize("S,B,H,norm", [(9, 13, 36, True), (1, 17, 48, False),
                                        (9, 5, 56, True), (9, 30, 200, True),
                                        (1, 13, 524, False),
                                        (9, 17, 544, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_layer_cluster_kernel_matches_plain(cuda, dtype, S, B, H, norm):
    """Against the plain version; the stash mode's y, h_n and c_n bitwise
    equal to the serving mode's, and a second run bitwise equal to the
    first."""
    args = _layer_inputs_at(45, S, B, H, cuda, dtype)
    shape = kernels.layer_launch_shape(B, H, args[0].element_size())
    assert shape["route"] == "cluster" and 4 <= shape["cluster"] <= 8
    wrapper = kernels.lstm_layer_fused
    with torch.no_grad():
        before = wrapper.launches + wrapper.launches_bf16
        got = kernels.lstm_layer_stash(*args, norm=norm)
        fused = wrapper(*args, norm=norm)
        again = wrapper(*args, norm=norm)
        torch.cuda.synchronize()
        want = kernels.lstm_layer_stash_plain(*args, norm=norm)
    assert wrapper.launches + wrapper.launches_bf16 == before + 3
    assert all(torch.equal(a, b) for a, b in zip(fused, again))
    for g, f in zip((got[0], got[2], got[3]), fused):
        assert torch.equal(g, f)
    _close_to_plain(args, got, want, norm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_layer_cluster_row_groups_give_the_same_bits(cuda, dtype):
    """Groups of 8, 16 and 24 rows: a row's arithmetic does not depend on
    where in its group it lies, so each gives the default's bits."""
    args = _layer_inputs_at(46, 9, 40, 128, cuda, dtype)
    with torch.no_grad():
        default = kernels.lstm_layer_fused(*args)
        for rows in (8, 16, 24):
            y, _, hn, cn = kernels.lstm_cell._lstm_layer_cuda(
                *args, norm=True, stash=False, rows=rows)
            assert all(torch.equal(a, b) for a, b in
                       zip((y, hn, cn), default)), rows
        want = kernels.lstm_layer_stash_plain(*args)
    _close_to_plain(args, kernels.lstm_layer_stash(*args), want, True)


def test_lstm_layer_takes_every_width_up_to_726(cuda):
    """The 8-row kernel before the cluster kernel took every H up to 726
    (320*H + 128 bytes of shared memory): every such H still runs in both
    stream types, H % 4 == 0 on the cluster route and any other H on the
    8-row route, each against the plain version."""
    props = torch.cuda.get_device_properties(cuda)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    for dtype in (torch.float32, torch.bfloat16):
        item = torch.finfo(dtype).bits // 8
        for H in range(1, 727):
            shape = kernels.layer_launch_shape(3, H, item)
            assert shape["route"] == ("cluster" if H % 4 == 0 else "rows8")
            assert shape["smem_bytes"] <= limit, (H, item)
            if H % 4 == 0:
                assert H % shape["cluster"] == 0 and shape["cluster"] >= 4
            args = _layer_inputs_at(47, 2, 3, H, cuda, dtype)
            with torch.no_grad():
                got = kernels.lstm_layer_stash(*args)
                torch.cuda.synchronize()
                want = kernels.lstm_layer_stash_plain(*args)
            _close_to_plain(args, got, want, True)


# The kernels chunk T by 8 steps, up to 16 chunks to a 128-step super-tile,
# and tile B by 32, 16 or 8 columns (kernels.vtrace_launch_shape): T = 1 and
# 65 and B = 5, 9, 33 and 4100 leave partial chunks and tiles, T = 1000 walks
# eight super-tiles, and (16, 8), (32, 32), (32, 256) are the AlphaStar
# step's, the B=32 train leg's and the forward's shapes.  "wide": IS spread
# over 0.1-10 so that every clip binds; "unit": gamma = lambda = 1 and IS >=
# 1, so every a_t = 1 and the chunk products never shrink.
@pytest.mark.parametrize("T,B,case", [
    (36, 136, "default"), (37, 9, "default"), (1, 5, "default"),
    (16, 8, "default"), (32, 32, "default"), (32, 256, "default"),
    (65, 33, "default"), (1000, 4100, "default"), (65, 33, "wide"),
    (200, 64, "unit")])
def test_vtrace_kernels_match_plain(cuda, T, B, case):
    is_w, lp, reward, value = _vtrace_inputs(9, T, B, cuda)
    clips = CLIPS
    if case == "wide":
        rng = np.random.default_rng(19)
        is_w = torch.from_numpy(np.exp(rng.uniform(
            np.log(0.1), np.log(10.0), (T, B))).astype(np.float32)).to(cuda)
        clips = (0.99, 0.95, 1.2, 0.9, 1.0)
    elif case == "unit":
        is_w = 1.0 / is_w.clamp(max=1.0)
        clips = (1.0, 1.0, 1.0, 1.0, 1.0)
    before = (kernels.vtrace_losses.launches,
              kernels.vtrace_returns_adv.launches)
    got = kernels.vtrace_losses(is_w, lp, reward, value, *clips)
    again = kernels.vtrace_losses(is_w, lp, reward, value, *clips)
    want = kernels.vtrace_losses_plain(is_w, lp, reward, value, *clips)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)              # no atomics: bitwise repeatable
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    got = kernels.vtrace_returns_adv(is_w, reward, value, *clips)
    again = kernels.vtrace_returns_adv(is_w, reward, value, *clips)
    want = kernels.vtrace_returns_adv_plain(is_w, reward, value, *clips)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    assert (kernels.vtrace_losses.launches,
            kernels.vtrace_returns_adv.launches) == (before[0] + 2,
                                                     before[1] + 2)


def test_vtrace_kernels_take_every_tiling(cuda):
    """Any columns x chunks tiling up to 512 threads gives the plain
    version's results: one chunk or one column per CTA, a partial warp, and
    the tilings vtrace_launch_shape chooses at other shapes."""
    T, B = 100, 70
    is_w, lp, reward, value = _vtrace_inputs(12, T, B, cuda)
    want_l = kernels.vtrace_losses_plain(is_w, lp, reward, value, *CLIPS)
    want_r = kernels.vtrace_returns_adv_plain(is_w, reward, value, *CLIPS)
    for cols, chunks in ((1, 1), (1, 16), (8, 1), (8, 3), (16, 16),
                         (32, 16), (32, 1), (5, 7)):
        tiling = {"cols": cols, "chunks": chunks}
        got = kernels.rl_scans._vtrace_losses_cuda(
            is_w, lp, reward, value, *CLIPS, **tiling)
        torch.testing.assert_close(got, want_l, rtol=RTOL, atol=ATOL,
                                   msg=str(tiling))
        got = kernels.rl_scans._vtrace_returns_adv_cuda(
            is_w, reward, value, *CLIPS, **tiling)
        torch.testing.assert_close(got, want_r, rtol=RTOL, atol=ATOL,
                                   msg=str(tiling))


def test_cuda_wrappers_raise_on_what_they_cannot_take(cuda):
    args = _layer_inputs(10, 2, 3, 16, cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernels.lstm_layer_fused(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="must be contiguous"):
        kernels.lstm_layer_fused(args[0].transpose(0, 1), *args[1:])
    with pytest.raises(ValueError, match="all inputs must lie"):
        kernels.lstm_layer_fused(args[0], args[1].cpu(), *args[2:])
    H = 4096
    big = [torch.zeros(s, device=cuda) for s in
           [(1, 1, 4 * H), (H, 4 * H)] + [(4 * H,)] * 5 + [(1, H)] * 2]
    with pytest.raises(ValueError, match="shared memory"):
        kernels.lstm_layer_fused(*big)
    is_w, lp, reward, value = _vtrace_inputs(11, 4, 8, cuda)
    with pytest.raises(ValueError, match=r"value must be \(5, 8\)"):
        kernels.vtrace_losses(is_w, lp, reward, value[:-1])


def test_forward_and_serving_on_card_match_cpu(cuda):
    """The slice through its entry points at a small width: the card's run
    (kernels) against the CPU's (plain versions), with every kernel of the
    path launched."""
    cfg = models.ActorCriticConfig(obs_dim=24, hidden_size=128, num_layers=2,
                                   action_dim=16)
    cpu = models.init_actor_critic(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    gpu = models.from_jax_params(models.to_numpy_params(cpu), device=cuda)
    rng = np.random.default_rng(12)
    T, B = 8, 5
    obs = torch.from_numpy(rng.standard_normal((T + 1, B, 24))
                           .astype(np.float32))
    data = (torch.from_numpy(rng.standard_normal((T, B, 16))
                             .astype(np.float32)),
            torch.from_numpy(rng.integers(0, 16, (T, B))),
            torch.from_numpy(rng.standard_normal((T, B)).astype(np.float32)),
            torch.from_numpy(rng.uniform(0, 2, (T, B)).astype(np.float32)))

    def run(params, dev):
        logits, value, state = models.actor_critic_forward(params,
                                                           obs.to(dev))
        b, a, r, w = (x.to(dev) for x in data)
        losses = [ops.vtrace_error(ops.vtrace_data(logits[:T], b, a, value,
                                                   r, weight))
                  for weight in (None, w)]
        gen = torch.Generator(device=dev).manual_seed(0)
        step = models.actor_step(params, obs[0].to(dev), state, gen)
        return (logits, value, *state, *losses[0], *losses[1], step[1],
                step[2], *step[3])

    with torch.no_grad():
        kernels.reset_launch_counts()
        got = run(gpu, cuda)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = run(cpu, torch.device("cpu"))
    assert counts == {"lstm_layer_fused": 4, "lstm_layer_bwd_v2": 0,
                      "lstm_layer_bwd_v1": 0, "vtrace_losses": 1,
                      "vtrace_returns_adv": 1, "gae": 0, "lambda_returns": 0,
                      "td_lambda_loss": 0, "td_lambda_err": 0,
                      "linear_scan": 0, "upgo_advantages": 0,
                      "upgo_loss": 0, "categorical_fwd": 4,
                      "categorical_bwd": 0, "lstm_layer_fused_bf16": 0,
                      "lstm_layer_bwd_v2_bf16": 0,
                      "lstm_layer_bwd_v1_bf16": 0}
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g.cpu(), w, rtol=RTOL, atol=ATOL,
                                   msg=f"output {i}")


def _bwd_inputs(seed, S, B, H, dev, wh_scale=0.1):
    """A stashed forward (plain, on the card) and random cotangents: the
    V2 kernel's arguments, then the V1 kernel's arguments made from them."""
    rng = np.random.default_rng(seed)
    fwd = _layer_inputs(seed, S, B, H, dev)
    fwd[1] = fwd[1] * (wh_scale / 0.1)
    with torch.no_grad():
        y, c_seq, _, _ = kernels.lstm_layer_stash_plain(*fwd)
    dy, dhn, dcn = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                    .to(dev) for s in ((S, B, H), (B, H), (B, H)))
    gxp, wh, glnx, blnx, gln, bln, bias, h0, c0 = fwd
    return (gxp, y, c_seq, dy, wh, glnx, blnx, gln, bln, bias, h0, c0, dhn,
            dcn)


def _v1_args(v2_args, norm):
    """The V1 kernel's arguments, made from the V2 kernel's as the layer's
    backward makes them."""
    gxp, y, c_seq, dy, wh, glnx, blnx, gln, bln, bias, h0, c0, dhn, dcn = \
        v2_args
    gx, gh_pre, c_prev = kernels.lstm_layer_bwd_v1_streams(
        gxp, y, c_seq, wh, glnx, blnx, bias, h0, c0, norm)
    return gx, gh_pre, c_prev, c_seq, dy, wh, gln, bln, dhn, dcn


# B = 13 and 17 leave a ragged last block (V1's 8-row CTAs, V2's 24-row
# clusters); H = 96 is no power of two; norm=False drops both LNs; the last
# case is the train step's width (S = T+1 = 33, B = 256 for V2, 32 for V1).
@pytest.mark.parametrize("S,B,H,norm", [(9, 13, 128, True), (5, 17, 96, False),
                                        (33, 0, 512, True)])
@pytest.mark.parametrize("variant", ["v2", "v1"])
def test_lstm_bwd_kernels_match_plain(cuda, variant, S, B, H, norm):
    if B == 0:
        B, wh_scale = (256 if variant == "v2" else 32), 1 / np.sqrt(H)
    else:
        wh_scale = 0.1
    args = _bwd_inputs(13, S, B, H, cuda, wh_scale)
    if variant == "v1":
        args = _v1_args(args, norm)
    wrapper = getattr(kernels, f"lstm_layer_bwd_{variant}")
    plain = getattr(kernels, f"lstm_layer_bwd_{variant}_plain")
    with torch.no_grad():
        before = wrapper.launches
        got = wrapper(*args, norm=norm)
        torch.cuda.synchronize()
        want = plain(*args, norm=norm)
    assert wrapper.launches == before + 1
    for i, (g, w) in enumerate(zip(got, want)):
        # The reverse loop carries every step's rounding into all earlier
        # steps (through dg_pre @ Wh^T and the LayerNorm backward's 1/std),
        # and V2's parameter sums add all S*B rows in another order than the
        # plain loop: an entry's error follows its output's scale, so atol
        # grows by 1e-5 times the output's largest |entry|.
        atol = ATOL + 1e-5 * float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=RTOL, atol=atol,
                                   msg=f"{variant} output {i}")


def test_lstm_bwd_v2_is_bitwise_repeatable(cuda):
    """Per-group partial sums reduced by torch.sum, DSM sums in rank order,
    no float atomics."""
    args = _bwd_inputs(14, 9, 88, 128, cuda)
    with torch.no_grad():
        first = kernels.lstm_layer_bwd_v2(*args)
        second = kernels.lstm_layer_bwd_v2(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# V2's row groups and clusters: B = 64 is the smallest batch the backward
# routes to V2 and B = 200 another; both leave a partial last group of rows
# (groups of 24).  The other widths take each other cluster size and both
# row-group sizes: H = 48 a cluster of 6 CTAs of 8 units, whose 32-column
# slices are no multiple of the 16-row MMA tile; H = 56 a cluster of 7;
# H = 200 a cluster of 5 with 40 units each; H = 36 (6 CTAs of 6 units) and
# H = 524 (4 of 131) units that are no multiple of 4, so their pieces move
# one element at a time, and bf16 Wh^T rows (H % 8 != 0) that are read
# element-wise; H = 524 and, in f32, H = 544 (8 CTAs) groups of 8 rows,
# since 24 rows do not fit in shared memory there.
@pytest.mark.parametrize("S,B,H", [(9, 64, 512), (9, 200, 512), (5, 40, 48),
                                   (5, 30, 56), (5, 64, 200), (5, 17, 36),
                                   (3, 64, 524), (3, 64, 544)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_v2_groups_and_clusters_match_plain(cuda, dtype, S, B, H):
    wh_scale = 1 / np.sqrt(H) if H >= 200 else 0.1
    if dtype == torch.float32:
        args = _bwd_inputs(42, S, B, H, cuda, wh_scale)
    else:
        args = _bwd_inputs_bf16(42, S, B, H, cuda, wh_scale)
    with torch.no_grad():
        before = kernels.lstm_layer_bwd_v2.launches + \
            kernels.lstm_layer_bwd_v2.launches_bf16
        got = kernels.lstm_layer_bwd_v2(*args)
        again = kernels.lstm_layer_bwd_v2(*args)
        torch.cuda.synchronize()
        want = kernels.lstm_layer_bwd_v2_plain(*args)
    assert kernels.lstm_layer_bwd_v2.launches + \
        kernels.lstm_layer_bwd_v2.launches_bf16 == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if dtype == torch.bfloat16:
        _close_bf16(kernels.lstm_layer_bwd_v2_plain, args, got, want, "v2")
        return
    for i, (g, w) in enumerate(zip(got, want)):
        # As in test_lstm_bwd_kernels_match_plain.
        atol = ATOL + 1e-5 * float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=RTOL, atol=atol,
                                   msg=f"output {i}")


def test_lstm_bwd_v2_takes_every_width_up_to_580(cuda):
    """The 8-row CTAs V2 had before its cluster split took every H % 4 == 0
    up to 580 (400*H + 256 bytes of shared memory); the cluster kernel fits
    each of them in both stream types."""
    lib = _build.library().cdll
    props = torch.cuda.get_device_properties(cuda)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    for item in (4, 2):
        for H in range(4, 581, 4):
            shape = kernels.v2_launch_shape(64, H, item)
            assert H % shape["cluster"] == 0 and shape["cluster"] >= 4, H
            assert lib.lstm_layer_bwd_v2_smem_bytes(H, item) <= limit, \
                (H, item)


def test_lstm_bwd_v2_raises_on_what_it_cannot_take(cuda):
    """On CUDA tensors the V2 wrapper launches its kernel or raises; it
    never returns the plain version's result."""
    v2 = kernels.lstm_layer_bwd_v2
    before = (v2.launches, v2.launches_bf16)
    args = list(_bwd_inputs(43, 3, 8, 32, cuda))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        v2(*[a.double() for a in args])
    strided = torch.cat([args[0], args[0]], dim=-1)[..., :args[0].shape[-1]]
    with pytest.raises(ValueError, match="must be contiguous"):
        v2(strided, *args[1:])
    with pytest.raises(ValueError, match="all inputs must lie"):
        v2(*args[:4], args[4].cpu(), *args[5:])
    with pytest.raises(ValueError, match=r"dy must be \(3, 8, 32\)"):
        v2(*args[:3], args[3][:, :4].contiguous(), *args[4:])
    odd = _bwd_inputs(44, 2, 8, 30, cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        v2(*odd)
    H = 4096
    big = [torch.zeros(s, device=cuda) for s in
           [(1, 1, 4 * H)] + [(1, 1, H)] * 3 + [(H, 4 * H)] + [(4 * H,)] * 5
           + [(1, H)] * 4]
    with pytest.raises(ValueError, match="shared memory"):
        v2(*big)
    assert (v2.launches, v2.launches_bf16) == before


def _v1_inputs(seed, S, B, H, dev, dtype, norm=True):
    """The V1 kernel's arguments in `dtype` (gh_pre float32), Wh scaled to
    1/sqrt(H) from H = 200 up."""
    wh_scale = 1 / np.sqrt(H) if H >= 200 else 0.1
    make = _bwd_inputs if dtype == torch.float32 else _bwd_inputs_bf16
    return _v1_args(make(seed, S, B, H, dev, wh_scale), norm)


def _close_v1(args, got, want, norm, msg="v1"):
    """f32 at RTOL and ATOL + 1e-5 * max|want|, as in
    test_lstm_bwd_kernels_match_plain; bf16 at chip_smoke's bound."""
    if args[0].dtype == torch.bfloat16:
        _close_bf16(kernels.lstm_layer_bwd_v1_plain, args, got, want, msg,
                    norm=norm)
        return
    for i, (g, w) in enumerate(zip(got, want)):
        atol = ATOL + 1e-5 * float(w.abs().max())
        torch.testing.assert_close(g, w, rtol=RTOL, atol=atol,
                                   msg=f"{msg} output {i}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_v1_is_bitwise_repeatable(cuda, dtype):
    """DSM sums in rank order, no float atomics; at the train step's B=32
    leg (S=33, H=512) on the cluster route."""
    args = _v1_inputs(50, 33, 32, 512, cuda, dtype)
    shape = kernels.v1_launch_shape(32, 512, args[0].element_size())
    assert shape["route"] == "cluster" and shape["cluster"] >= 4
    with torch.no_grad():
        first = kernels.lstm_layer_bwd_v1(*args)
        second = kernels.lstm_layer_bwd_v1(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# V1's clusters and row groups: ragged B = 13, 17 and 40 (a partial last
# group of rows); H = 96 (a cluster of 8 CTAs of 12 units), 128 and 512 (16
# CTAs of 8 and of 32 units), H = 36 (6 CTAs of 6 units, which move one
# element at a time) and the AlphaStar core's shape (S = 17, B = 8, H =
# 128); norm on and off.
@pytest.mark.parametrize("S,B,H,norm", [(9, 13, 96, True), (5, 17, 128, False),
                                        (5, 40, 512, True), (9, 40, 128, True),
                                        (5, 13, 36, False), (17, 8, 128, True),
                                        (3, 17, 512, False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_v1_clusters_match_plain(cuda, dtype, S, B, H, norm):
    args = _v1_inputs(51, S, B, H, cuda, dtype, norm)
    wrapper = kernels.lstm_layer_bwd_v1
    with torch.no_grad():
        before = wrapper.launches + wrapper.launches_bf16
        got = wrapper(*args, norm=norm)
        again = wrapper(*args, norm=norm)
        torch.cuda.synchronize()
        want = kernels.lstm_layer_bwd_v1_plain(*args, norm=norm)
    assert wrapper.launches + wrapper.launches_bf16 == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    _close_v1(args, got, want, norm)


# Every route the kernel takes at H = 128, B = 17: clusters of 4, 8 and 16
# CTAs, 8 and 16 rows per group.  Within one cluster size a row's arithmetic
# does not depend on its group, so both group sizes give the same bits.
@pytest.mark.parametrize("cluster", [4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_v1_routes_match_plain(cuda, dtype, cluster):
    args = _v1_inputs(52, 9, 17, 128, cuda, dtype)
    with torch.no_grad():
        outs = [kernels.lstm_cell._lstm_layer_bwd_v1_cuda(
                    *args, norm=True, cluster=cluster, rows=rows)
                for rows in (8, 16)]
        torch.cuda.synchronize()
        want = kernels.lstm_layer_bwd_v1_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    _close_v1(args, outs[0], want, True, f"v1 cluster={cluster}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lstm_bwd_v1_takes_every_width_up_to_724(cuda, dtype):
    """The 8-row kernel V1 had before its cluster split took every H % 4 ==
    0 up to 724 (320*H + 128 bytes of shared memory): each such H runs on
    the cluster route, against the plain version."""
    props = torch.cuda.get_device_properties(cuda)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    item = torch.finfo(dtype).bits // 8
    for H in range(4, 725, 4):
        shape = kernels.v1_launch_shape(3, H, item)
        assert shape["route"] == "cluster" and H % shape["cluster"] == 0
        assert shape["cluster"] >= 4 and shape["smem_bytes"] <= limit, H
        args = _v1_inputs(53, 2, 3, H, cuda, dtype)
        with torch.no_grad():
            got = kernels.lstm_layer_bwd_v1(*args)
            torch.cuda.synchronize()
            want = kernels.lstm_layer_bwd_v1_plain(*args)
        _close_v1(args, got, want, True, f"v1 H={H}")


def test_lstm_bwd_v1_raises_on_what_it_cannot_take(cuda):
    """On CUDA tensors the V1 wrapper launches its kernel or raises; it
    never returns the plain version's result."""
    v1 = kernels.lstm_layer_bwd_v1
    before = (v1.launches, v1.launches_bf16)
    args = list(_v1_inputs(54, 3, 8, 32, cuda, torch.float32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        v1(*[a.double() for a in args])
    strided = torch.cat([args[0], args[0]], dim=-1)[..., :args[0].shape[-1]]
    with pytest.raises(ValueError, match="must be contiguous"):
        v1(strided, *args[1:])
    with pytest.raises(ValueError, match="all inputs must lie"):
        v1(*args[:5], args[5].cpu(), *args[6:])
    with pytest.raises(ValueError, match=r"dy must be \(3, 8, 32\)"):
        v1(*args[:4], args[4][:, :4].contiguous(), *args[5:])
    with pytest.raises(ValueError, match="does not divide"):
        kernels.lstm_cell._lstm_layer_bwd_v1_cuda(*args, norm=True,
                                                  cluster=3)
    odd = _v1_inputs(55, 2, 8, 30, cuda, torch.float32)
    with pytest.raises(ValueError, match="multiple of 4"):
        v1(*odd)
    H = 4096
    big = [torch.zeros(s, device=cuda) for s in
           [(1, 1, 4 * H)] * 2 + [(1, 1, H)] * 3 + [(H, 4 * H)]
           + [(4 * H,)] * 2 + [(1, H)] * 2]
    with pytest.raises(ValueError, match="shared memory"):
        v1(*big)
    assert (v1.launches, v1.launches_bf16) == before


def _layer_loss(y, hn, cn):
    return (y * torch.cos(y)).sum() + (hn ** 2).sum() + torch.sin(cn).sum()


# B = 13 routes the backward through V1, B = 72 through V2 (ragged).
@pytest.mark.parametrize("B,norm", [(13, True), (72, True), (72, False)])
def test_layer_function_matches_autograd_through_plain(cuda, B, norm):
    """The autograd.Function's 9 gradients (stash forward, hand-derived
    backward kernels) against PyTorch's autograd through the plain forward,
    both on the card."""
    args = [a.requires_grad_() for a in _layer_inputs(15, 9, B, 128, cuda)]
    kernels.reset_launch_counts()
    got = torch.autograd.grad(
        _layer_loss(*kernels.lstm_layer_fused(*args, norm=norm)), args)
    counts = kernels.launch_counts()
    want = torch.autograd.grad(
        _layer_loss(*kernels.lstm_layer_plain(*args, norm=norm)), args,
        allow_unused=True)
    variant = "lstm_layer_bwd_v2" if B >= kernels.V2_MIN_BATCH \
        else "lstm_layer_bwd_v1"
    assert counts["lstm_layer_fused"] == 1 and counts[variant] == 1
    names = ("dgxp", "dwh", "dglnx", "dblnx", "dgln", "dbln", "dbias", "dh0",
             "dc0")
    for name, g, w in zip(names, got, want):
        w = torch.zeros_like(g) if w is None else w
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL, msg=name)


def test_cuda_inputs_that_require_grad_get_gradients(cuda):
    args = [a.requires_grad_() for a in _layer_inputs(16, 3, 8, 32, cuda)]
    _layer_loss(*kernels.lstm_layer_fused(*args)).backward()
    assert all(a.grad is not None and torch.isfinite(a.grad).all()
               for a in args)
    is_w, lp, reward, value = _vtrace_inputs(17, 6, 8, cuda)
    lp.requires_grad_()
    value.requires_grad_()
    pg, vl = kernels.vtrace_losses(is_w, lp, reward, value, *CLIPS)
    (pg + vl).backward()
    assert torch.isfinite(lp.grad).all() and torch.isfinite(value.grad).all()
    assert float(value.grad[-1].abs().max()) == 0.0


# B = 5 routes the LSTM backward through V1, B = 64 through V2.
@pytest.mark.parametrize("B", [5, 64])
def test_train_step_on_card_matches_cpu(cuda, B):
    """One make_train_step step with Adam on the card (kernels) against the
    same step on the CPU (plain versions): metrics, every gradient, and the
    updated parameters where the gradient is above 10x the tolerance (Adam's
    first step moves an entry by lr * g / (|g| + eps), so an entry whose
    gradient is at the noise floor may move either way)."""
    cfg = models.ActorCriticConfig(obs_dim=24, hidden_size=128, num_layers=2,
                                   action_dim=16)
    arrays = models.to_numpy_params(models.init_actor_critic(
        cfg, torch.Generator().manual_seed(1), device="cpu"))
    rng = np.random.default_rng(18)
    T = 8
    batch = models.TrainBatch(
        torch.from_numpy(rng.standard_normal((T + 1, B, 24))
                         .astype(np.float32)),
        torch.from_numpy(rng.integers(0, 16, (T, B))),
        torch.from_numpy(rng.standard_normal((T, B)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((T, B, 16)).astype(np.float32)))

    def run(dev):
        params = models.from_jax_params(arrays, device=dev)
        opt = torch.optim.Adam(params.parameters(), lr=1e-3)
        step = models.make_train_step(cfg, opt)
        metrics = step(params, models.TrainBatch(*(x.to(dev) for x in batch)))
        return metrics, params

    kernels.reset_launch_counts()
    got_m, got_p = run(cuda)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want_m, want_p = run(torch.device("cpu"))
    variant = "lstm_layer_bwd_v2" if B >= kernels.V2_MIN_BATCH \
        else "lstm_layer_bwd_v1"
    assert counts["lstm_layer_fused"] == 2 and counts[variant] == 2
    assert counts["vtrace_losses"] == 1 and counts["vtrace_returns_adv"] == 1
    for k in want_m:
        torch.testing.assert_close(got_m[k].cpu(), want_m[k], rtol=RTOL,
                                   atol=ATOL, msg=k)
    for (name, g), (_, w) in zip(got_p.named_parameters(),
                                 want_p.named_parameters()):
        torch.testing.assert_close(g.grad.cpu(), w.grad, rtol=RTOL, atol=ATOL,
                                   msg=f"grad {name}")
        big = w.grad.abs() > 10 * ATOL
        torch.testing.assert_close(g.detach().cpu()[big], w.detach()[big],
                                   rtol=0, atol=1e-6, msg=f"param {name}")


SCAN_ARGS = {"gae": (0.99, 0.97), "lambda_returns": (0.9, 0.8),
             "td_lambda_loss": (0.95, 0.7), "td_lambda_err": (0.9, 0.8)}


def _scan_inputs(seed, T, B, dev):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev) for s in ((T + 1, B), (T, B))]


# B = 13 and 1000 are not multiples of the kernels' 32-column block; T = 1
# leaves one step.
@pytest.mark.parametrize("T,B", [(1, 13), (37, 1000), (130, 64)])
@pytest.mark.parametrize("name", list(SCAN_ARGS))
def test_scan_kernels_match_plain(cuda, name, T, B):
    value, reward = _scan_inputs(20, T, B, cuda)
    wrapper = getattr(kernels, name)
    before = wrapper.launches
    got = wrapper(value, reward, *SCAN_ARGS[name])
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    want = getattr(kernels, name + "_plain")(value, reward, *SCAN_ARGS[name])
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_td_lambda_loss_is_bitwise_repeatable(cuda):
    """One partial per column, reduced by torch.sum: no float atomics."""
    value, reward = _scan_inputs(21, 300, 4100, cuda)
    first = kernels.td_lambda_loss(value, reward, 0.9, 0.8)
    second = kernels.td_lambda_loss(value, reward, 0.9, 0.8)
    assert torch.equal(first, second)


@pytest.mark.parametrize("weight", [None, "B", "TB"])
def test_gae_and_td_lambda_ops_on_card_match_cpu(cuda, weight):
    """ops.gae and ops.td_lambda_error (value and gradient in value) on the
    card against the CPU, with the kernels each path launches: GAE, then
    the loss kernel and its error kernel for unit weight, the returns kernel
    with a weight."""
    T, B = 50, 45
    value, reward = _scan_inputs(22, T, B, torch.device("cpu"))
    rng = np.random.default_rng(23)
    w = {None: None, "B": rng.uniform(0, 2, B),
         "TB": rng.uniform(0, 2, (T, B))}[weight]
    w = None if w is None else torch.from_numpy(w.astype(np.float32))

    def run(dev):
        v = value.to(dev).requires_grad_()
        adv = ops.gae(ops.gae_data(v, reward.to(dev)), 0.99, 0.95)
        loss = ops.td_lambda_error(ops.td_lambda_data(
            v, reward.to(dev), None if w is None else w.to(dev)), 0.9, 0.8)
        loss.backward()
        return adv, loss, v.grad

    kernels.reset_launch_counts()
    got = run(cuda)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = run(torch.device("cpu"))
    assert counts["gae"] == 1
    if weight is None:
        assert counts["td_lambda_loss"] == 1 and counts["td_lambda_err"] == 1
        assert counts["lambda_returns"] == 0
    else:
        assert counts["lambda_returns"] == 1
        assert counts["td_lambda_loss"] == counts["td_lambda_err"] == 0
    for name, g, wv in zip(("adv", "loss", "dvalue"), got, want):
        torch.testing.assert_close(g.cpu(), wv, rtol=RTOL, atol=ATOL,
                                   msg=name)


def test_scan_wrappers_raise_on_what_they_cannot_take(cuda):
    value, reward = _scan_inputs(24, 6, 40, cuda)
    for name in SCAN_ARGS:
        fn = getattr(kernels, name)
        with pytest.raises(TypeError, match="as torch.float32; got"):
            fn(value.double(), reward.double(), *SCAN_ARGS[name])
        # A strided reward is copied to a dense plane by the wrapper.
        torch.testing.assert_close(
            fn(value, reward.t().contiguous().t(), *SCAN_ARGS[name]),
            fn(value, reward, *SCAN_ARGS[name]), rtol=0, atol=0)
        with pytest.raises(ValueError, match=r"value must be \(7, 40\)"):
            fn(value[:-1], reward, *SCAN_ARGS[name])
        with pytest.raises(ValueError, match="all inputs must lie"):
            fn(value, reward.cpu(), *SCAN_ARGS[name])


# ---------------------------------------------- full-plane scans, UPGO ----

def _full_plane_inputs(seed, T, B, dev):
    """a, b (T, B) for the linear recurrence; rhos, lp, reward (T, B) and
    value (T+1, B) for UPGO."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                    ).to(dev)
    b = torch.from_numpy(rng.uniform(0.5, 1.0, (T, B)).astype(np.float32))
    return (f(T, B), b.to(dev), torch.exp(0.3 * f(T, B)), -f(T, B).abs(),
            f(T, B), f(T + 1, B))


# B = 13 and 1000 are not multiples of the kernels' 32-column block; T = 1
# leaves one step.
@pytest.mark.parametrize("T,B", [(1, 13), (37, 1000), (130, 64)])
@pytest.mark.parametrize("boundary", ["zero", "scalar", "vector"])
@pytest.mark.parametrize("reverse", [True, False])
def test_linear_scan_kernel_matches_plain(cuda, T, B, boundary, reverse):
    a, b = _full_plane_inputs(25, T, B, cuda)[:2]
    y = {"zero": None, "scalar": torch.tensor(-0.4, device=cuda),
         "vector": torch.linspace(-1, 1, B, device=cuda)}[boundary]
    before = kernels.linear_scan.launches
    got = kernels.linear_scan(a, b, y, reverse)
    torch.cuda.synchronize()
    assert kernels.linear_scan.launches == before + 1
    want = kernels.linear_scan_plain(a, b, None if y is None else y.expand(B),
                                     reverse)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("T,B", [(1, 13), (37, 1000), (130, 64)])
def test_upgo_kernels_match_plain(cuda, T, B):
    rhos, lp, reward, value = _full_plane_inputs(26, T, B, cuda)[2:]
    kernels.reset_launch_counts()
    got_adv = kernels.upgo_advantages(rhos, reward, value)
    got_loss = kernels.upgo_loss(rhos, lp, reward, value)
    torch.cuda.synchronize()
    assert kernels.upgo_advantages.launches == kernels.upgo_loss.launches == 1
    torch.testing.assert_close(
        got_adv, kernels.upgo_advantages_plain(rhos, reward, value),
        rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(
        got_loss, kernels.upgo_loss_plain(rhos, lp, reward, value),
        rtol=RTOL, atol=ATOL)


def test_upgo_loss_is_bitwise_repeatable(cuda):
    """One partial per column, reduced by torch.sum: no float atomics."""
    rhos, lp, reward, value = _full_plane_inputs(27, 300, 4100, cuda)[2:]
    first = kernels.upgo_loss(rhos, lp, reward, value)
    second = kernels.upgo_loss(rhos, lp, reward, value)
    assert torch.equal(first, second)


def test_upgo_kernels_break_ties_as_the_plain_version(cuda):
    """Integer-valued inputs make exact ties r_{t+1} + V_{t+2} = V_{t+1}:
    the kernel's rounded add and the plain version's take the same branch,
    so the advantages agree exactly."""
    rng = np.random.default_rng(28)
    T, B = 40, 70
    reward, value = (torch.from_numpy(rng.integers(-2, 3, s).astype(
        np.float32)).to(cuda) for s in ((T, B), (T + 1, B)))
    rhos = torch.ones((T, B), device=cuda)
    got = kernels.upgo_advantages(rhos, reward, value)
    assert torch.equal(got, kernels.upgo_advantages_plain(rhos, reward,
                                                          value))


def test_scan_entry_points_on_card_match_cpu(cuda):
    """"auto" on float32 (T, B) CUDA inputs that need no gradient takes the
    kernel: the linear recurrence both ways, the lambda-returns with (T, B)
    gamma and lambda planes and the UPGO returns, each against the CPU."""
    T, B = 45, 70
    a, b, _, _, reward, value = _full_plane_inputs(29, T, B,
                                                   torch.device("cpu"))
    rng = np.random.default_rng(30)
    g, lam = (torch.from_numpy(rng.uniform(lo, 1, (T, B)).astype(np.float32))
              for lo in (0.9, 0.0))
    y = torch.linspace(-1, 1, B)

    def run(dev):
        to = lambda t: t.to(dev)
        return (ops.linear_recurrence_reverse(to(a), to(b), to(y)),
                ops.linear_recurrence_forward(to(a), to(b[:, :1]), 0.5),
                ops.generalized_lambda_returns(to(value), to(reward), to(g),
                                               to(lam)),
                ops.upgo_returns(to(reward), to(value)))

    kernels.reset_launch_counts()
    got = run(cuda)
    torch.cuda.synchronize()
    assert kernels.linear_scan.launches == 4
    for i, (gt, w) in enumerate(zip(got, run(torch.device("cpu")))):
        torch.testing.assert_close(gt.cpu(), w, rtol=RTOL, atol=ATOL,
                                   msg=f"output {i}")


def test_upgo_loss_op_on_card_matches_cpu(cuda):
    """ops.upgo_loss and its gradient in the logits: the fused kernel
    forward and the advantage kernel in the backward, against the CPU."""
    rng = np.random.default_rng(31)
    T, B, N = 20, 45, 7
    logits = rng.standard_normal((T, B, N)).astype(np.float32)
    rhos = np.exp(0.2 * rng.standard_normal((T, B))).astype(np.float32)
    action = rng.integers(0, N, (T, B))
    reward = rng.standard_normal((T, B)).astype(np.float32)
    value = rng.standard_normal((T + 1, B)).astype(np.float32)

    def run(dev):
        lg = torch.from_numpy(logits).to(dev).requires_grad_()
        loss = ops.upgo_loss(lg, *(torch.from_numpy(x).to(dev) for x in
                                   (rhos, action, reward, value)))
        loss.backward()
        return loss, lg.grad

    kernels.reset_launch_counts()
    got = run(cuda)
    torch.cuda.synchronize()
    assert kernels.upgo_loss.launches == kernels.upgo_advantages.launches == 1
    for gt, w in zip(got, run(torch.device("cpu"))):
        torch.testing.assert_close(gt.detach().cpu(), w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["add", "cover"])
def test_scatter_on_card_matches_cpu(cuda, mode):
    """Forward and the custom backward of the one-hot products, with
    collisions and one out-of-range entity, against the CPU."""
    rng = np.random.default_rng(32)
    B, M, N, H, W = 3, 40, 5, 4, 4
    x = rng.standard_normal((B, M, N)).astype(np.float32)
    loc = np.stack([rng.integers(0, H, (B, M)), rng.integers(0, W, (B, M))],
                   axis=-1)
    loc[0, 0] = (H, 0)
    gout = rng.standard_normal((B, N, H, W)).astype(np.float32)

    def run(dev):
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        out = network.scatter_connection(xt, (H, W),
                                         torch.from_numpy(loc).to(dev), mode)
        (out * torch.from_numpy(gout).to(dev)).sum().backward()
        return out.detach(), xt.grad

    for gt, w in zip(run(cuda), run(torch.device("cpu"))):
        torch.testing.assert_close(gt.cpu(), w, rtol=RTOL, atol=ATOL)


def test_alphastar_step_on_card_matches_cpu(cuda):
    """One step of the example module's AlphaStar trainer (the example's
    configuration, greedy selection) on the card against the CPU: the
    launches of its path, the metrics, every gradient, and the parameters by
    the Adam rule of chip_smoke.check_adam_params."""
    rng = np.random.default_rng(33)
    arrays = chip_smoke.alphastar_arrays(rng, **chip_smoke.AS_CFG)
    batches = chip_smoke.alphastar_batches(rng, 1, **chip_smoke.AS_CFG)

    def step(dev):
        p, opt, (batch,) = chip_smoke.alphastar_setup(arrays, batches, dev)
        return (*alphastar.train_step(p, opt, batch, **chip_smoke.AS_STEP),
                dict(p.named_parameters()))

    kernels.reset_launch_counts()
    m, g, params = step(cuda)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for name in ("lstm_layer_fused", "lstm_layer_bwd_v1", "vtrace_losses",
                 "vtrace_returns_adv", "upgo_loss", "upgo_advantages"):
        assert counts[name] == 1, (name, counts)
    wm, wg, want_params = step(torch.device("cpu"))
    for k in wm:
        torch.testing.assert_close(m[k].cpu(), wm[k], rtol=RTOL, atol=ATOL,
                                   msg=k)
    for k in wg:
        atol = chip_smoke.GRAD_ATOL_REL * float(wg[k].abs().max())
        torch.testing.assert_close(g[k].cpu(), wg[k], rtol=RTOL, atol=atol,
                                   msg=f"grad {k}")
    chip_smoke.check_adam_params("alphastar", params, want_params, [wg],
                                 alphastar.LR, 1)


def test_full_plane_wrappers_raise_on_what_they_cannot_take(cuda):
    a, b, rhos, lp, reward, value = _full_plane_inputs(34, 6, 40, cuda)
    with pytest.raises(TypeError, match="as torch.float32; got"):
        kernels.linear_scan(a.double(), b.double())
    with pytest.raises(ValueError, match="all inputs must lie"):
        kernels.linear_scan(a, b.cpu())
    with pytest.raises(ValueError, match=r"a must be \(T, B\)"):
        kernels.linear_scan(a[..., None], b[..., None])
    with pytest.raises(ValueError, match=r"value must be \(7, 40\)"):
        kernels.upgo_advantages(rhos, reward, value[:-1])
    # A strided lp is copied to a dense plane by the wrapper.
    torch.testing.assert_close(
        kernels.upgo_loss(rhos, lp.t().contiguous().t(), reward, value),
        kernels.upgo_loss(rhos, lp, reward, value), rtol=0, atol=0)
    with pytest.raises(TypeError, match="as torch.float32; got"):
        kernels.upgo_loss(rhos, lp.double(), reward, value)


# ------------------------------------------------------------ strided ----

def test_strided_inputs_through_the_rl_ops_equal_the_contiguous_call(cuda):
    """A (T, B) slice of a (T, B, 2) buffer through ops.gae,
    ops.td_lambda_error (with its gradient), ops.upgo_loss and
    ops.vtrace_error (unit weight and weighted) gives what its contiguous
    copy gives: the wrappers copy strided inputs to dense planes."""
    rng = np.random.default_rng(35)
    T, B, N = 24, 40, 6
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(cuda)
    value2, reward2 = f(T + 1, B, 2), f(T, B, 2)
    value, reward = value2[..., 0], reward2[..., 0]
    assert not value.is_contiguous() and not reward.is_contiguous()
    logits, behaviour = f(T, B, N), f(T, B, N)
    action = torch.from_numpy(rng.integers(0, N, (T, B))).to(cuda)
    rhos = torch.exp(0.2 * f(T, B))
    weight = torch.rand((T, B), device=cuda)

    def run(v, r):
        vg = v.clone().requires_grad_() if v.is_contiguous() else \
            v.detach().requires_grad_()
        td = ops.td_lambda_error(ops.td_lambda_data(vg, r, None), 0.9, 0.8)
        td.backward()
        out = [ops.gae(ops.gae_data(v, r), 0.99, 0.95), td, vg.grad,
               ops.upgo_loss(logits, rhos, action, r, v)]
        for w in (None, weight):
            out += list(ops.vtrace_error(ops.vtrace_data(
                logits, behaviour, action, v, r, w)))
        return out

    kernels.reset_launch_counts()
    got = run(value, reward)
    counts = kernels.launch_counts()
    want = run(value.contiguous(), reward.contiguous())
    for name in ("gae", "td_lambda_loss", "td_lambda_err", "upgo_loss",
                 "vtrace_losses", "vtrace_returns_adv"):
        assert counts[name] >= 1, (name, counts)
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=f"output {i}")


# --------------------------------------------------------------- bf16 ----

def _close_bf16(plain, args, got, want, msg, **kw):
    """A bf16 kernel's outputs against its plain version's on the card, at
    chip_smoke's bound: BF16_REL times the output's largest |entry| plus
    twice the spread between the plain version on the CPU and on the card
    (over a long unroll the recurrence amplifies bf16 rounding flips: to
    0.046 of the largest |y| after 33 steps at H=512, measured on an
    H100)."""
    spread = chip_smoke.spread_vs_cpu(lambda *a: plain(*a, **kw), args, want)
    chip_smoke.compare_bf16(msg, got, want, spread)


def _bf16(tensors):
    return [t.bfloat16() for t in tensors]


def _bwd_inputs_bf16(seed, S, B, H, dev, wh_scale=0.1):
    """_bwd_inputs in bf16, with y and c_seq from the plain bf16 forward."""
    args = _bf16(_bwd_inputs(seed, S, B, H, dev, wh_scale))
    with torch.no_grad():
        y, c_seq, _, _ = kernels.lstm_layer_stash_plain(args[0], args[4],
                                                        *args[5:12])
    return [args[0], y, c_seq, *args[3:]]


@pytest.mark.parametrize("S,B,H,norm", [(9, 13, 128, True), (1, 8, 128, True),
                                        (5, 17, 96, False),
                                        (33, 256, 512, True)])
def test_lstm_layer_bf16_kernel_matches_plain(cuda, S, B, H, norm):
    """The forward in bf16, with and without the stash, against the plain
    bf16 version (its rounding points are the kernel's)."""
    args = _bf16(_layer_inputs(36, S, B, H, cuda))
    if H == 512:
        args[1] = args[1] * (1 / np.sqrt(H) / 0.1)
    with torch.no_grad():
        before = (kernels.lstm_layer_fused.launches,
                  kernels.lstm_layer_fused.launches_bf16)
        got = kernels.lstm_layer_fused(*args, norm=norm)
        stash = kernels.lstm_layer_stash(*args, norm=norm)
        want = kernels.lstm_layer_stash_plain(*args, norm=norm)
    torch.cuda.synchronize()
    assert (kernels.lstm_layer_fused.launches,
            kernels.lstm_layer_fused.launches_bf16) == (before[0],
                                                       before[1] + 2)
    _close_bf16(kernels.lstm_layer_stash_plain, args, stash, want, "stash",
                norm=norm)
    for g, p in zip(got, (stash[0], stash[2], stash[3])):
        assert torch.equal(g, p)


@pytest.mark.parametrize("S,B,H,norm", [(9, 13, 128, True), (5, 17, 96, False),
                                        (33, 0, 512, True)])
@pytest.mark.parametrize("variant", ["v2", "v1"])
def test_lstm_bwd_bf16_kernels_match_plain(cuda, variant, S, B, H, norm):
    if B == 0:
        B, wh_scale = (256 if variant == "v2" else 32), 1 / np.sqrt(H)
    else:
        wh_scale = 0.1
    args = _bwd_inputs_bf16(37, S, B, H, cuda, wh_scale)
    if variant == "v1":
        args = _v1_args(args, norm)
        assert args[1].dtype == torch.float32          # gh_pre stays f32
    wrapper = getattr(kernels, f"lstm_layer_bwd_{variant}")
    plain = getattr(kernels, f"lstm_layer_bwd_{variant}_plain")
    with torch.no_grad():
        before = wrapper.launches_bf16
        got = wrapper(*args, norm=norm)
        torch.cuda.synchronize()
        want = plain(*args, norm=norm)
    assert wrapper.launches_bf16 == before + 1
    _close_bf16(plain, args, got, want, variant, norm=norm)


def test_lstm_bwd_v2_bf16_is_bitwise_repeatable(cuda):
    args = _bwd_inputs_bf16(38, 9, 88, 128, cuda)
    with torch.no_grad():
        first = kernels.lstm_layer_bwd_v2(*args)
        second = kernels.lstm_layer_bwd_v2(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_bf16_call_with_a_float32_tensor_raises(cuda):
    args = _bf16(_layer_inputs(39, 3, 8, 32, cuda))
    with pytest.raises(TypeError, match="takes wh as torch.bfloat16"):
        kernels.lstm_layer_fused(args[0], args[1].float(), *args[2:])
    bwd = _bwd_inputs_bf16(40, 3, 8, 32, cuda)
    v1 = _v1_args(bwd, True)
    with pytest.raises(TypeError, match="takes dy as torch.bfloat16"):
        kernels.lstm_layer_bwd_v1(*v1[:4], v1[4].float(), *v1[5:])
    with pytest.raises(TypeError, match="takes gh_pre as torch.float32"):
        kernels.lstm_layer_bwd_v1(v1[0], v1[1].bfloat16(), *v1[2:])
    with pytest.raises(TypeError, match="takes c0 as torch.bfloat16"):
        kernels.lstm_layer_bwd_v2(*bwd[:11], bwd[11].float(), *bwd[12:])


# B = 5 routes the LSTM backward through V1, B = 64 through V2.
@pytest.mark.parametrize("B", [5, 64])
def test_bf16_train_step_on_card_matches_cpu(cuda, B):
    """One make_train_step(compute_dtype=torch.bfloat16) step with Adam on
    the card (the bf16 kernels) against the same step on the CPU (the plain
    bf16 versions): the metrics within 2e-3, every float32 master
    gradient within 5e-2 times its largest |entry| (bf16 GEMMs round their
    outputs on both sides, with other summation orders, and the bias
    gradients sum (T+1)*B such rows), the parameters where the gradient is
    above 1e-2 times its largest |entry| within 1e-6."""
    cfg = models.ActorCriticConfig(obs_dim=24, hidden_size=128, num_layers=2,
                                   action_dim=16)
    arrays = models.to_numpy_params(models.init_actor_critic(
        cfg, torch.Generator().manual_seed(2), device="cpu"))
    rng = np.random.default_rng(41)
    T = 8
    batch = models.TrainBatch(
        torch.from_numpy(rng.standard_normal((T + 1, B, 24))
                         .astype(np.float32)),
        torch.from_numpy(rng.integers(0, 16, (T, B))),
        torch.from_numpy(rng.standard_normal((T, B)).astype(np.float32)),
        torch.from_numpy(rng.standard_normal((T, B, 16)).astype(np.float32)))

    def run(dev):
        params = models.from_jax_params(arrays, device=dev)
        opt = torch.optim.Adam(params.parameters(), lr=1e-3)
        step = models.make_train_step(cfg, opt, compute_dtype=torch.bfloat16)
        metrics = step(params, models.TrainBatch(*(x.to(dev) for x in batch)))
        return metrics, params

    kernels.reset_launch_counts()
    got_m, got_p = run(cuda)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want_m, want_p = run(torch.device("cpu"))
    variant = "lstm_layer_bwd_v2" if B >= kernels.V2_MIN_BATCH \
        else "lstm_layer_bwd_v1"
    assert counts["lstm_layer_fused_bf16"] == 2
    assert counts[variant + "_bf16"] == 2
    assert counts["lstm_layer_fused"] == counts[variant] == 0
    for k in want_m:
        assert got_m[k].dtype == torch.float32
        torch.testing.assert_close(got_m[k].cpu(), want_m[k], rtol=2e-3,
                                   atol=2e-3, msg=k)
    for (name, g), (_, w) in zip(got_p.named_parameters(),
                                 want_p.named_parameters()):
        assert g.dtype == g.grad.dtype == torch.float32, name
        scale = float(w.grad.abs().max())
        torch.testing.assert_close(g.grad.cpu(), w.grad, rtol=0,
                                   atol=5e-2 * scale, msg=f"grad {name}")
        big = w.grad.abs() > 1e-2 * scale
        torch.testing.assert_close(g.detach().cpu()[big], w.detach()[big],
                                   rtol=0, atol=1e-6, msg=f"param {name}")


# ---------------------------------------- chunked scans: kernels 6, 9 ----

# T = 1, 7, 9, 65, 1000 leave partial chunks or super-tiles (T = 8 one whole
# chunk, T = 1024 whole 128-step super-tiles); B = 1, 5, 33 and 4100 leave
# partial column tiles.
CHUNKED_T = (1, 7, 8, 9, 65, 1000, 1024)
CHUNKED_B = (1, 5, 33, 4100)


@pytest.mark.parametrize("B", CHUNKED_B)
@pytest.mark.parametrize("T", CHUNKED_T)
def test_linear_scan_chunked_kernel_matches_plain(cuda, T, B):
    """Both directions with a zero, a scalar and a large (B,) boundary: in
    the reverse walk the steps past T come first and must be the identity
    (a = 0, b = 1), or the boundary would be lost at a T that is not a
    multiple of the super-tile."""
    a, b = _full_plane_inputs(62, T, B, cuda)[:2]
    boundaries = {"zero": None, "scalar": torch.tensor(3.0, device=cuda),
                  "vector": 100 * torch.linspace(-1, 1, B, device=cuda)}
    for reverse in (True, False):
        for kind, y in boundaries.items():
            before = kernels.linear_scan.launches
            got = kernels.linear_scan(a, b, y, reverse)
            torch.cuda.synchronize()
            assert kernels.linear_scan.launches == before + 1
            want = kernels.linear_scan_plain(
                a, b, None if y is None else y.expand(B), reverse)
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                       msg=f"reverse={reverse} {kind}")


# The tilings chip_smoke.py times against the chosen one, and the extremes:
# one chunk or one column per CTA, a partial warp.
CHUNKED_TILINGS = ((32, 16), (16, 16), (32, 8), (1, 1), (1, 16), (8, 1),
                   (8, 3), (5, 7))


def test_linear_scan_chunked_kernel_takes_every_tiling(cuda):
    T, B = 1000, 70
    a, b = _full_plane_inputs(63, T, B, cuda)[:2]
    y = 10 * torch.linspace(-1, 1, B, device=cuda)
    for reverse in (True, False):
        want = kernels.linear_scan_plain(a, b, y, reverse)
        for cols, chunks in CHUNKED_TILINGS:
            got = _linear_scan(a, b, y, reverse, cols=cols, chunks=chunks)
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                       msg=f"{reverse} {cols}x{chunks}")


# gamma*lambda = 0 (each step its own one-step return), lambda = 1 (the
# Monte Carlo return, nothing decays), gamma = 1.
TD_CASES = ((0.9, 0.8), (0.9, 0.0), (0.95, 1.0), (1.0, 0.8), (1.0, 1.0))


@pytest.mark.parametrize("B", CHUNKED_B)
@pytest.mark.parametrize("T", CHUNKED_T)
def test_td_lambda_loss_chunked_kernel_matches_plain(cuda, T, B):
    """The loss against the plain version, and bitwise equal on a second
    run (one partial per column, summed in a fixed order)."""
    value, reward = _scan_inputs(64, T, B, cuda)
    for gamma, lambda_ in TD_CASES:
        before = kernels.td_lambda_loss.launches
        got = kernels.td_lambda_loss(value, reward, gamma, lambda_)
        again = kernels.td_lambda_loss(value, reward, gamma, lambda_)
        torch.cuda.synchronize()
        assert kernels.td_lambda_loss.launches == before + 2
        assert torch.equal(got, again)
        want = kernels.td_lambda_loss_plain(value, reward, gamma, lambda_)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                   msg=f"gamma={gamma} lambda={lambda_}")


def test_td_lambda_loss_chunked_kernel_takes_every_tiling(cuda):
    T, B = 1000, 70
    value, reward = _scan_inputs(65, T, B, cuda)
    want = kernels.td_lambda_loss_plain(value, reward, 0.9, 0.8)
    for cols, chunks in CHUNKED_TILINGS:
        got = kernels.rl_scans._td_lambda_loss_cuda(
            value, reward, 0.9, 0.8, cols=cols, chunks=chunks)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                   msg=f"{cols}x{chunks}")


# -------------------------------------- chunked scans: kernels 7, 10 ----

# (gamma, lambda) of GAE: the trainer's default, gamma*lambda = 0, lambda = 1
# (the denominators grow to T - t and the chunk products stay 1), and
# gamma = lambda = 1.
GAE_CASES = ((0.99, 0.97), (0.99, 0.0), (0.95, 1.0), (1.0, 1.0))


def _twice(wrapper, *args):
    """wrapper(*args) launched twice: two launches counted, the same bits."""
    before = wrapper.launches
    got = wrapper(*args)
    again = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert torch.equal(got, again)
    return got


@pytest.mark.parametrize("B", CHUNKED_B)
@pytest.mark.parametrize("T", CHUNKED_T)
def test_gae_chunked_kernel_matches_plain(cuda, T, B):
    """GAE at GAE_CASES against the plain version, bitwise equal on a second
    run: steps past T must compose to the identity (a = 0, coefficient 1),
    or a T that is not a multiple of the super-tile would carry -V_T into
    the last steps."""
    value, reward = _scan_inputs(66, T, B, cuda)
    for gamma, lambda_ in GAE_CASES:
        got = _twice(kernels.gae, value, reward, gamma, lambda_)
        want = kernels.gae_plain(value, reward, gamma, lambda_)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                   msg=f"gamma={gamma} lambda={lambda_}")


def test_gae_chunked_kernel_at_the_ppo_trainers_shape(cuda):
    """The PPO trainer's rollouts, T=16 and B=256: 8 columns x 2 chunks in
    each of 32 CTAs on the H100's 132 SMs."""
    shape = kernels.gae_launch_shape(16, 256, kernels.rl_scans._sms(cuda))
    assert (shape["cols"], shape["chunks"], shape["grid"]) == (8, 2, 32)
    value, reward = _scan_inputs(67, 16, 256, cuda)
    for gamma, lambda_ in GAE_CASES:
        got = _twice(kernels.gae, value, reward, gamma, lambda_)
        want = kernels.gae_plain(value, reward, gamma, lambda_)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                   msg=f"gamma={gamma} lambda={lambda_}")


@pytest.mark.parametrize("B", CHUNKED_B)
@pytest.mark.parametrize("T", CHUNKED_T)
def test_td_lambda_err_chunked_kernel_matches_plain(cuda, T, B):
    """The error plane at TD_CASES against the plain version, bitwise equal
    on a second run."""
    value, reward = _scan_inputs(68, T, B, cuda)
    for gamma, lambda_ in TD_CASES:
        got = _twice(kernels.td_lambda_err, value, reward, gamma, lambda_)
        want = kernels.td_lambda_err_plain(value, reward, gamma, lambda_)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                   msg=f"gamma={gamma} lambda={lambda_}")


@pytest.mark.parametrize("name,scalars", [("gae", (0.99, 0.97)),
                                          ("td_lambda_err", (0.9, 0.8))])
def test_gae_and_td_lambda_err_chunked_kernels_take_every_tiling(
        cuda, name, scalars):
    T, B = 1000, 70
    value, reward = _scan_inputs(69, T, B, cuda)
    want = getattr(kernels, name + "_plain")(value, reward, *scalars)
    launch = getattr(kernels.rl_scans, f"_{name}_cuda")
    for cols, chunks in CHUNKED_TILINGS:
        got = launch(value, reward, *scalars, cols=cols, chunks=chunks)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                   msg=f"{cols}x{chunks}")


def test_gae_and_td_lambda_err_refuse_a_tiling_past_512_threads(cuda):
    """64 x 16 threads: the wrappers raise before a launch, and the C entry
    points return cudaErrorInvalidValue (1) without launching."""
    T, B = 20, 40
    value, reward = _scan_inputs(70, T, B, cuda)
    for name in ("gae", "td_lambda_err"):
        with pytest.raises(ValueError, match="exceed 512 threads"):
            getattr(kernels.rl_scans, f"_{name}_cuda")(
                value, reward, 0.9, 0.8, cols=64, chunks=16)
    out = torch.full_like(reward, 7.0)
    denom = torch.ones(T, device=cuda)
    lib = _build.library().cdll
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda *ts: [t.data_ptr() for t in ts]
    statuses = [
        lib.gae_f32(*ptr(value, reward, denom, out), T, B, 0.9, 0.72, 64, 16,
                    stream),
        lib.td_lambda_err_f32(*ptr(value, reward, out), T, B, 0.9, 0.72, 64,
                              16, stream)]
    torch.cuda.synchronize()
    assert statuses == [1, 1]
    assert torch.equal(out, torch.full_like(reward, 7.0))


# ------------------------------------ chunked scans: kernels 8, 12 ----

@pytest.mark.parametrize("B", CHUNKED_B)
@pytest.mark.parametrize("T", CHUNKED_T)
def test_lambda_returns_chunked_kernel_matches_plain(cuda, T, B):
    """The returns plane at TD_CASES against the plain version (JAX's form
    of the last step, one rounding apart), bitwise equal on a second run."""
    value, reward = _scan_inputs(71, T, B, cuda)
    for gamma, lambda_ in TD_CASES:
        got = _twice(kernels.lambda_returns, value, reward, gamma, lambda_)
        want = kernels.lambda_returns_plain(value, reward, gamma, lambda_)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                   msg=f"gamma={gamma} lambda={lambda_}")


@pytest.mark.parametrize("B", CHUNKED_B)
@pytest.mark.parametrize("T", CHUNKED_T)
def test_upgo_loss_chunked_kernel_matches_plain(cuda, T, B):
    """The loss against the plain version, bitwise equal on a second run:
    steps past T compose to the identity and d_{T-1} = 0 cuts the carry, so
    a T that is not a multiple of the super-tile adds nothing from above."""
    rhos, lp, reward, value = _full_plane_inputs(72, T, B, cuda)[2:]
    got = _twice(kernels.upgo_loss, rhos, lp, reward, value)
    torch.testing.assert_close(
        got, kernels.upgo_loss_plain(rhos, lp, reward, value), rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("T,B,tiling", [(16, 8, (8, 2, 1)),
                                        (128, 512, (8, 16, 64))])
def test_upgo_loss_chunked_kernel_at_its_callers_shapes(cuda, T, B, tiling):
    """The AlphaStar step's T=16, B=8 (8 columns x 2 chunks, one CTA) and
    ops.upgo_loss's T=128, B=512 (8 x 16, 64 CTAs) on the H100's 132 SMs."""
    shape = kernels.upgo_loss_launch_shape(T, B, kernels.rl_scans._sms(cuda))
    assert (shape["cols"], shape["chunks"], shape["grid"]) == tiling
    rhos, lp, reward, value = _full_plane_inputs(73, T, B, cuda)[2:]
    got = _twice(kernels.upgo_loss, rhos, lp, reward, value)
    torch.testing.assert_close(
        got, kernels.upgo_loss_plain(rhos, lp, reward, value), rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("T,B", [(40, 70), (1000, 33), (16, 8), (128, 512)])
def test_upgo_loss_breaks_ties_as_the_plain_version(cuda, T, B):
    """Integer-valued inputs make exact ties r_{t+1} + V_{t+2} = V_{t+1} and
    exact sums, whatever their order: the chunked kernel's loss equals the
    plain version's bit for bit."""
    rng = np.random.default_rng(74)
    reward, value, lp = (torch.from_numpy(rng.integers(-2, 3, s).astype(
        np.float32)).to(cuda) for s in ((T, B), (T + 1, B), (T, B)))
    rhos = torch.ones((T, B), device=cuda)
    got = kernels.upgo_loss(rhos, lp, reward, value)
    assert torch.equal(got, kernels.upgo_loss_plain(rhos, lp, reward, value))


@pytest.mark.parametrize("name", ["lambda_returns", "upgo_loss"])
def test_lambda_returns_and_upgo_loss_chunked_kernels_take_every_tiling(
        cuda, name):
    T, B = 1000, 70
    value, reward = _scan_inputs(75, T, B, cuda)
    rhos, lp = _full_plane_inputs(76, T, B, cuda)[2:4]
    args = ((value, reward, 0.9, 0.8) if name == "lambda_returns"
            else (rhos, lp, reward, value))
    want = getattr(kernels, name + "_plain")(*args)
    launch = getattr(kernels.rl_scans, f"_{name}_cuda")
    for cols, chunks in CHUNKED_TILINGS:
        got = launch(*args, cols=cols, chunks=chunks)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                   msg=f"{cols}x{chunks}")


def test_lambda_returns_and_upgo_loss_refuse_a_tiling_past_512_threads(
        cuda):
    """64 x 16 threads: the wrappers raise before a launch, and the C entry
    points return cudaErrorInvalidValue (1) without launching."""
    T, B = 20, 40
    value, reward = _scan_inputs(77, T, B, cuda)
    rhos, lp = _full_plane_inputs(78, T, B, cuda)[2:4]
    with pytest.raises(ValueError, match="exceed 512 threads"):
        kernels.rl_scans._lambda_returns_cuda(value, reward, 0.9, 0.8,
                                              cols=64, chunks=16)
    with pytest.raises(ValueError, match="exceed 512 threads"):
        kernels.rl_scans._upgo_loss_cuda(rhos, lp, reward, value, cols=64,
                                         chunks=16)
    out = torch.full_like(reward, 7.0)
    parts = torch.full((1, B), 7.0, device=cuda)
    lib = _build.library().cdll
    stream = torch.cuda.current_stream().cuda_stream
    ptr = lambda *ts: [t.data_ptr() for t in ts]
    statuses = [
        lib.lambda_returns_f32(*ptr(value, reward, out), T, B, 0.9, 0.72, 64,
                               16, stream),
        lib.upgo_loss_f32(*ptr(rhos, lp, reward, value, parts), T, B, 64, 16,
                          stream)]
    torch.cuda.synchronize()
    assert statuses == [1, 1]
    assert torch.equal(out, torch.full_like(reward, 7.0))
    assert torch.equal(parts, torch.full((1, B), 7.0, device=cuda))


# ------------------------------------------- chunked scans: kernel 11 ----

@pytest.mark.parametrize("B", CHUNKED_B)
@pytest.mark.parametrize("T", CHUNKED_T)
def test_upgo_advantages_chunked_kernel_matches_plain(cuda, T, B):
    """The advantage plane against the plain version, bitwise equal on a
    second run: kernel 12's walk, so a T that is not a multiple of the
    super-tile adds nothing from above (T = 1, 1000; B = 4100)."""
    rhos, _, reward, value = _full_plane_inputs(81, T, B, cuda)[2:]
    got = _twice(kernels.upgo_advantages, rhos, reward, value)
    torch.testing.assert_close(
        got, kernels.upgo_advantages_plain(rhos, reward, value), rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("T,B,tiling", [(16, 8, (8, 2, 1)),
                                        (128, 512, (8, 16, 64))])
def test_upgo_advantages_chunked_kernel_at_its_callers_shapes(cuda, T, B,
                                                              tiling):
    """The AlphaStar step's T=16, B=8 and the backward of ops.upgo_loss at
    T=128, B=512 take kernel 12's tilings on the H100's 132 SMs."""
    shape = kernels.upgo_advantages_launch_shape(
        T, B, kernels.rl_scans._sms(cuda))
    assert (shape["cols"], shape["chunks"], shape["grid"]) == tiling
    rhos, _, reward, value = _full_plane_inputs(82, T, B, cuda)[2:]
    got = _twice(kernels.upgo_advantages, rhos, reward, value)
    torch.testing.assert_close(
        got, kernels.upgo_advantages_plain(rhos, reward, value), rtol=RTOL,
        atol=ATOL)


@pytest.mark.parametrize("T,B", [(40, 70), (1000, 33), (16, 8), (128, 512)])
def test_upgo_advantages_equal_the_plain_version_on_integer_inputs(cuda, T,
                                                                   B):
    """Integer-valued inputs make exact ties and exact sums, whatever their
    order: the chunked kernel's plane equals the plain version's."""
    rng = np.random.default_rng(83)
    reward, value = (torch.from_numpy(rng.integers(-2, 3, s).astype(
        np.float32)).to(cuda) for s in ((T, B), (T + 1, B)))
    rhos = torch.from_numpy(rng.integers(1, 3, (T, B)).astype(
        np.float32)).to(cuda)
    got = kernels.upgo_advantages(rhos, reward, value)
    assert torch.equal(got, kernels.upgo_advantages_plain(rhos, reward,
                                                          value))


def test_upgo_advantages_chunked_kernel_takes_every_tiling(cuda):
    T, B = 1000, 70
    rhos, _, reward, value = _full_plane_inputs(84, T, B, cuda)[2:]
    want = kernels.upgo_advantages_plain(rhos, reward, value)
    for cols, chunks in CHUNKED_TILINGS:
        got = kernels.rl_scans._upgo_advantages_cuda(
            rhos, reward, value, cols=cols, chunks=chunks)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                   msg=f"{cols}x{chunks}")


@pytest.mark.parametrize("T,B", [(1000, 4100), (128, 512), (16, 8)])
def test_upgo_advantages_column_sums_agree_with_the_loss_partials(cuda, T,
                                                                  B):
    """Kernel 11's adv * lp summed down each column against kernel 12's
    (1, B) partials at the same tiling: one walk, two epilogues, so they
    agree to float tolerance (the sums are taken in another order)."""
    rhos, lp, reward, value = _full_plane_inputs(85, T, B, cuda)[2:]
    adv = kernels.upgo_advantages(rhos, reward, value)
    parts = torch.empty((1, B), device=cuda)
    tiling = kernels.rl_scans._tiling(kernels.upgo_loss_launch_shape, reward,
                                      None, None)
    status = _build.library().cdll.upgo_loss_f32(
        *(t.data_ptr() for t in (rhos, lp, reward, value, parts)), T, B,
        *tiling, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert status == 0
    torch.testing.assert_close(parts[0], (adv * lp).sum(dim=0), rtol=RTOL,
                               atol=ATOL)


def test_upgo_advantages_refuse_a_tiling_past_512_threads(cuda):
    T, B = 20, 40
    rhos, _, reward, value = _full_plane_inputs(86, T, B, cuda)[2:]
    with pytest.raises(ValueError, match="exceed 512 threads"):
        kernels.rl_scans._upgo_advantages_cuda(rhos, reward, value, cols=64,
                                               chunks=16)
    out = torch.full_like(reward, 7.0)
    status = _build.library().cdll.upgo_advantages_f32(
        *(t.data_ptr() for t in (rhos, reward, value, out)), T, B, 64, 16,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert status == 1
    assert torch.equal(out, torch.full_like(reward, 7.0))


# ------------------------------------------ the batch-bound TD family ----

TD_OPS = ["q_nstep_td_error", "q_nstep_td_error_with_rescale",
          "dist_nstep_td_error", "qrdqn_nstep_td_error", "iqn_nstep_td_error"]


def _td_inputs(dev):
    """chip_smoke's inputs of the five TD ops (the JAX bench's shapes) on
    dev."""
    x_np = chip_smoke.nstep_arrays(np.random.default_rng(87))
    return {k: chip_smoke.to_dev(v, dev) for k, v in x_np.items()}


@pytest.mark.parametrize("name", TD_OPS)
def test_td_ops_on_card_match_cpu(cuda, name):
    """Each TD op's loss, per-sample errors and gradient in q (or dist) on
    the card against the same call on the CPU; the gradients, which sum
    over the batch, within chip_smoke.GRAD_ATOL_REL of their largest
    entry."""
    got = chip_smoke.nstep_op_calls(_td_inputs(cuda))[name]()
    want = chip_smoke.nstep_op_calls(_td_inputs(torch.device("cpu")))[name]()
    torch.cuda.synchronize()
    chip_smoke.compare(name, got[:2], want[:2])
    chip_smoke.compare(f"{name} grad", got[2:], want[2:], atol=0.0,
                       atol_rel=chip_smoke.GRAD_ATOL_REL)


def test_dist_nstep_td_error_is_bitwise_repeatable_on_the_card(cuda):
    """The C51 projection is built dense (no scatter-add, no float
    atomics): repeated runs give the same bits, gradient included."""
    run = chip_smoke.nstep_op_calls(_td_inputs(cuda))["dist_nstep_td_error"]
    first, second = run(), run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("name", ["c51", "qrdqn", "iqn"])
def test_replay_learner_steps_on_card_match_cpu(cuda, name):
    """chip_smoke's phase replay leg for one learner at its JAX example's
    configuration: REPLAY_STEPS steps on the card, each against the same
    step on the CPU from the card's state before it and with the card's
    next action (the loss and TD errors at REPLAY_RTOL/REPLAY_ATOL, every
    gradient within GRAD_ATOL_REL of its max, the parameters by
    check_adam_params); no kernel launches on these paths."""
    spec = chip_smoke.replay_learners(chip_smoke.example_modules())[name]
    kernels.reset_launch_counts()
    out = chip_smoke.replay_leg(name, *spec, cuda)
    assert set(kernels.launch_counts().values()) == {0}
    assert len(out["losses"]) == chip_smoke.REPLAY_STEPS


# ------------------------------------------------ lstm_fused routing ----

def _smem_limit(dev) -> int:
    props = torch.cuda.get_device_properties(dev)
    return getattr(props, "shared_memory_per_block_optin", 232448)


def _first_width_past(need, limit) -> int:
    """The least H % 4 == 0 whose shared-memory plan `need(H)` exceeds
    `limit`."""
    return next(H for H in range(4, 1 << 15, 4) if need(H) > limit)


def _route_case(case, dev):
    """(H, B, dtype, layers, carried state) of a routing case; widths past a
    plan come from the library's sizing exports on this card."""
    lib = _build.library().cdll
    limit = _smem_limit(dev)
    f32 = torch.float32
    if case == "past_forward":
        H = _first_width_past(lambda H: lib.lstm_layer_smem_bytes(H, 4),
                              limit)
        return H, 4, f32, 1, False
    if case == "past_v2":
        H = _first_width_past(
            lambda H: lib.lstm_layer_bwd_v2_smem_bytes(H, 4), limit)
        assert lib.lstm_layer_smem_bytes(H, 4) <= limit   # the forward fits
        return H, 64, f32, 1, False
    if case == "past_v1":
        H = _first_width_past(
            lambda H: kernels.v1_launch_shape(4, H, 4)["smem_bytes"], limit)
        assert lib.lstm_layer_smem_bytes(H, 4) <= limit
        return H, 4, f32, 1, False
    return {"H30_B4": (30, 4, f32, 2, False), "H30_B64": (30, 64, f32, 2,
                                                          False),
            "float16": (32, 8, torch.float16, 2, False),
            "float16_carried": (32, 8, torch.float16, 2, True),
            "flagship_f32_B8": (512, 8, f32, 2, True),
            "flagship_f32_B64": (512, 64, f32, 2, True),
            "flagship_bf16_B64": (512, 64, torch.bfloat16, 2, True)}[case]


def _lstm_fused_with_grad(H, B, dtype, layers, carried, dev, S=3, I=16):
    """network.lstm_fused on `dev` and the gradients of a fixed loss in the
    inputs, every parameter and (when carried) the state; the same numbers
    on either device."""
    gen = torch.Generator().manual_seed(H * 1000 + B)
    p = network.init_lstm_params(gen, I, H, layers, "LN", device="cpu")
    p = network.LSTMParams(*(
        tuple(w.to(dev, dtype).requires_grad_() for w in f)
        if isinstance(f, tuple) else f.to(dev, dtype).requires_grad_()
        for f in p))
    x = torch.randn(S, B, I, generator=gen).to(dev, dtype).requires_grad_()
    state = None
    if carried:
        state = tuple((0.5 * torch.randn(layers, B, H, generator=gen))
                      .to(dev, dtype).requires_grad_() for _ in range(2))
    y, (h, c) = network.lstm_fused(p, x, state)
    _layer_loss(y.float(), h.float(), c.float()).backward()
    leaves = [x, *p.wx, *p.wh, p.bias, p.ln_gamma_x, p.ln_beta_x,
              p.ln_gamma_h, p.ln_beta_h, *(state or ())]
    return [y, h, c, *(t.grad for t in leaves)]


@pytest.mark.parametrize("case", [
    "H30_B4", "H30_B64", "past_forward", "past_v2", "past_v1", "float16",
    "float16_carried", "flagship_f32_B8", "flagship_f32_B64",
    "flagship_bf16_B64"])
def test_lstm_fused_routes_what_the_kernels_cannot_take(cuda, case):
    """lstm_fused with a gradient gives the CPU's answer on the card where
    the kernels cannot take a layer -- H % 4 != 0 under V1 (B=4) and V2
    (B=64), the first widths past the forward's and each backward's
    shared-memory plan, float16 streams -- and takes the recurrent path
    there (the route counter); the flagship H=512 takes the kernels.
    float16 runs the recurrent path on both devices, as the JAX op routes
    it: with a zero state the first step's h-side LayerNorm has zero
    variance, and its backward, -0.5 * (var + eps)^-1.5, overflows float16
    on both devices and in JAX alike, so the NaNs must sit in the same
    places.  Tolerances: float32 rtol 1e-4, atol 1e-4 + 1e-5 * max|want|
    (the recurrent path against the kernels' plain versions on the CPU:
    other summation orders); float16 and bf16 1e-2 and 5e-2 of max|want|
    (each op rounds to the stream type in another order on the two
    devices)."""
    H, B, dtype, layers, carried = _route_case(case, cuda)
    network.reset_route_counts()
    kernels.reset_launch_counts()
    got = _lstm_fused_with_grad(H, B, dtype, layers, carried, cuda)
    torch.cuda.synchronize()
    routes = dict(network.lstm_fused.routes)
    counts = kernels.launch_counts()
    want = _lstm_fused_with_grad(H, B, dtype, layers, carried,
                                 torch.device("cpu"))
    if case.startswith("flagship"):
        assert routes == {"kernel": layers, "recurrent": 0}, routes
        tag = "_bf16" if dtype == torch.bfloat16 else ""
        assert counts["lstm_layer_fused" + tag] == layers
    else:
        assert routes == {"kernel": 0, "recurrent": layers}, routes
        assert sum(counts.values()) == 0, counts
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == dtype, i
        g, w = g.detach().float().cpu(), w.detach().float()
        finite = w[torch.isfinite(w)]
        scale = float(finite.abs().max()) if finite.numel() else 0.0
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=RTOL,
                                       atol=ATOL + 1e-5 * scale,
                                       msg=f"{case} output {i}")
        else:
            rel = 1e-2 if dtype == torch.float16 else 5e-2
            torch.testing.assert_close(g, w, rtol=0, atol=rel * scale,
                                       equal_nan=True,
                                       msg=f"{case} output {i}")


# ---------------------------------------------------------------------------
# The host data plane on the card: padding, sample_batch, the episodic A2C
# step and the checkpoint round trip.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("tag", list(chip_smoke.PAD_MODES))
def test_padding_on_the_card_equals_the_cpu_bitwise(cuda, ndim, tag):
    """numpy inputs (host pack, one transfer) and CUDA inputs (packed on
    the card) give the CPU's batches, masks and shapes bit for bit, and
    UnPadding gives back every input (chip_smoke.padding_leg)."""
    rng = np.random.default_rng(60 + ndim)
    xs = [rng.standard_normal(tuple(int(d) for d in rng.integers(2, 9, ndim)),
                              dtype=np.float32) for _ in range(23)]
    leg = chip_smoke.padding_leg(ndim, xs, chip_smoke.PAD_MODES[tag], cuda)
    assert leg["buckets"] >= 1


@pytest.mark.parametrize("dtype", [np.int32, np.float64])
def test_padding_of_other_dtypes_on_the_card_equals_the_cpu(cuda, dtype):
    rng = np.random.default_rng(70)
    xs = [(10 * rng.standard_normal(int(n))).astype(dtype)
          for n in rng.integers(2, 30, 17)]
    want = ops.Padding1D(xs, group=3, group_mode="oracle", device="cpu")
    for items in (xs, [torch.from_numpy(a).to(cuda) for a in xs]):
        got = ops.Padding1D(items, group=3, group_mode="oracle",
                            device=cuda)
        chip_smoke.check_padded("padding", got, want, 3)


def test_sample_batch_on_the_card_equals_the_cpu(cuda):
    out = chip_smoke.data_leg(np.random.default_rng(71), cuda)
    assert out["fields"]["ragged_f32_mask"][0] == "torch.bool"


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.int64])
def test_64_bit_card_inputs_land_narrowed(cuda, ndim, dtype):
    """float64 and int64 CUDA items, packed on the card (ops) or read back
    to the host (origin), give float32 and int32 batches and masks, the
    bits of the host route from numpy."""
    rng = np.random.default_rng(80 + ndim)
    xs = [np.round(4 * rng.standard_normal(
        tuple(int(d) for d in rng.integers(2, 7, ndim))), 3)
        for _ in range(11)]
    xs = [a.astype(np.int64) if dtype == torch.int64 else a for a in xs]
    narrow = {torch.float64: torch.float32, torch.int64: torch.int32}[dtype]
    pad = f"Padding{ndim}D"
    want = getattr(ops, pad)(xs, value=3, device="cpu")
    assert want[0].dtype == want[1].dtype == narrow
    on_card = [torch.from_numpy(a).to(cuda) for a in xs]
    for mod in (ops, chip_smoke.origin):
        got = getattr(mod, pad)(on_card, value=3, device=cuda)
        assert got[0].device.type == "cuda"
        chip_smoke.check_padded(f"{mod.__name__} {pad}", got, want, 1)


def test_sample_batch_of_64_bit_fields_takes_the_vtrace_kernels(cuda):
    """float64 and int64 trajectories arrive float32 and int32, and
    ops.vtrace_error on the batch launches kernels 2 and 3
    (chip_smoke.data_leg_64_bit)."""
    m = chip_smoke.hostdata_modules()
    trajs = chip_smoke.data_trajectories(np.random.default_rng(74))
    out = chip_smoke.data_leg_64_bit(m.data, trajs, cuda)
    assert out["dtypes"]["action"] == "torch.int32"


SHARDED_TAG = "SHARDED_SCAN "
# Runs this file's __main__ (a worker of a spawned world) in a rank process.
RUN_THIS_FILE = ("import runpy; runpy.run_path('tests/test_torch_gpu.py', "
                 "run_name='__main__')")


def _sharded_scan_worker(workdir, rank: int, world: int) -> int:
    """One rank of test_time_sharded_scan_on_two_ranks_on_the_card."""
    import hashlib
    import json

    import torch.distributed as dist

    from di_hpc_tpu_torch import parallel

    parallel.initialize(f"file://{workdir}/store", world, rank)
    mesh = parallel.make_mesh({"time": world})
    g = torch.Generator(device=mesh.device).manual_seed(91)
    a = torch.randn(1000, 33, generator=g, device=mesh.device)
    b = torch.rand(1000, 33, generator=g, device=mesh.device) * 1.98 - 0.99
    kernels.reset_launch_counts()
    y = parallel.linear_recurrence_reverse_sharded(a, b, mesh)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["linear_scan"]
    err = chip_smoke.compare("sharded scan", [y], [
        ops.linear_recurrence_reverse(a, b, method="scan")])
    print(SHARDED_TAG + json.dumps({
        "launches": launches, "err": err, "device": str(y.device),
        "backend": dist.get_backend(),
        "digest": hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()}),
        flush=True)
    dist.destroy_process_group()
    return 0


def test_time_sharded_scan_on_two_ranks_on_the_card(cuda, tmp_path):
    """A gloo world of 2 processes on the one card:
    linear_recurrence_reverse_sharded at T=1000, B=33, each rank's time
    chunk on kernel 6, against the unsharded op; both ranks' bits equal.
    The world is killed at chip_smoke.PAR_TIMEOUT_S."""
    import json

    outs = chip_smoke.spawn_world(["-c", RUN_THIS_FILE, "scan",
                                   str(tmp_path)], 2,
                                  chip_smoke.PAR_TIMEOUT_S)
    reports = [json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith(SHARDED_TAG))
                          [len(SHARDED_TAG):]) for out in outs]
    assert [r["launches"] for r in reports] == [1, 1]
    assert {r["backend"] for r in reports} == {"gloo"}
    assert reports[0]["digest"] == reports[1]["digest"]


def test_episodic_step_on_the_card_matches_the_cpu(cuda):
    """One step of the episodic A2C: loss, gradients and the Adam update
    against the same step on the CPU; one launch of kernels 8 and 6 per
    bucket."""
    episodes = chip_smoke.episodic_episodes(np.random.default_rng(72), 1)[0]
    cpu = torch.device("cpu")
    p, opt = chip_smoke.episodic_setup(cuda)
    ref_p, ref_opt = chip_smoke.episodic_setup(cpu)
    kernels.reset_launch_counts()
    loss, grads, sizes = chip_smoke.episodic_step(p, opt, episodes, cuda)
    counts = kernels.launch_counts()
    assert counts["lambda_returns"] == counts["linear_scan"] == len(sizes)
    r_loss, r_grads, r_sizes = chip_smoke.episodic_step(ref_p, ref_opt,
                                                        episodes, cpu)
    assert sizes == r_sizes
    np.testing.assert_allclose(loss, r_loss, rtol=RTOL, atol=ATOL)
    for k in r_grads:
        chip_smoke.compare(k, [grads[k]], [r_grads[k]], atol=0.0,
                           atol_rel=chip_smoke.GRAD_ATOL_REL)
    chip_smoke.check_adam_params("episodic", dict(p.named_parameters()),
                                 dict(ref_p.named_parameters()), [r_grads],
                                 chip_smoke.EPISODIC_LR, 1)


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    from di_hpc_tpu_torch import utils
    from di_hpc_tpu_torch.examples import impala_actor_learner
    from di_hpc_tpu_torch.utils.checkpoint import tree_flatten

    params, opt, train = impala_actor_learner.init_learner(cuda)
    rng = np.random.default_rng(73)
    f = lambda *s: torch.from_numpy(rng.standard_normal(
        s, dtype=np.float32)).to(cuda)
    train(params, models.TrainBatch(
        f(17, 8, 16), torch.from_numpy(rng.integers(0, 4, (16, 8))).to(cuda),
        f(16, 8), f(16, 8, 4)))
    tree = (params, opt.state_dict())
    utils.save_pytree(tmp_path / "ckpt", tree)
    loaded = utils.load_pytree(
        tmp_path / "ckpt",
        (impala_actor_learner.init_learner(cuda)[0], opt.state_dict()))
    got, _ = tree_flatten(loaded)
    want, _ = tree_flatten(tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, torch.Tensor):
            assert g.device == w.device and chip_smoke.bitwise_equal(g, w)
        else:
            assert g == w


SHARDED_STEP_TAG = "SHARDED_STEP "


def _sharded_step_worker(workdir, rank: int, world: int) -> int:
    """One rank of test_sharded_train_step_on_two_ranks_on_the_card."""
    import json

    import torch.distributed as dist

    from di_hpc_tpu_torch import entry, parallel
    from di_hpc_tpu_torch.examples import impala_training

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parallel.initialize(f"file://{workdir}/store", world, rank)
    mesh = parallel.make_mesh({"data": world, "model": 1})
    cfg = impala_training.CFG
    params = models.init_actor_critic(cfg, torch.Generator().manual_seed(5),
                                      "cpu")
    arrays = models.to_numpy_params(params)
    batch = impala_training.synthetic_batch(
        torch.Generator().manual_seed(6), 16, 64, cfg.obs_dim,
        cfg.action_dim, mesh.device)
    tally = entry.LaunchTally()
    results, checks = entry.sharded_train_steps(
        cfg, arrays, [batch], mesh, tally=tally,
        tolerance=chip_smoke.MC_F32_TOLERANCE)
    print(SHARDED_STEP_TAG + json.dumps({
        "launches": tally.launches, "routes": tally.routes,
        "backend": dist.get_backend(), "digest": entry.digest(results),
        "worst_grad": max(v["grad"]["max_err_over_max"]
                          for k, v in checks["step0"].items()
                          if k != "metrics")}), flush=True)
    dist.destroy_process_group()
    return 0


def test_sharded_train_step_on_two_ranks_on_the_card(cuda, tmp_path):
    """A gloo world of 2 processes on the one card: one
    models.make_sharded_train_step step of impala_training's model (H=128)
    at a global B=64, 32 rows per rank (V1), against the unsharded step
    (entry.sharded_train_steps, phase multichip's float32 bounds); both
    ranks launch kernels 1, 5, 2 and 3, every layer takes the kernels, and
    both ranks hold the same bits."""
    import json

    outs = chip_smoke.spawn_world(["-c", RUN_THIS_FILE, "step",
                                   str(tmp_path)], 2,
                                  chip_smoke.PAR_TIMEOUT_S)
    reports = [json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith(SHARDED_STEP_TAG))
                          [len(SHARDED_STEP_TAG):]) for out in outs]
    for r in reports:
        assert r["backend"] == "gloo"
        assert r["routes"] == {"kernel": 2, "recurrent": 0}
        for name in ("lstm_layer_fused", "lstm_layer_bwd_v1",
                     "vtrace_losses", "vtrace_returns_adv"):
            assert r["launches"][name] >= 1, (name, r["launches"])
        assert r["launches"]["lstm_layer_bwd_v2"] == 0
    assert reports[0]["digest"] == reports[1]["digest"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [4, 8])
def test_layer_route_takes_the_dryrun_shards(cuda, B, dtype):
    """The multichip dryrun's train legs run 4 (8 ranks) or 8 (4 ranks)
    rows per rank at H=64: network.layer_route sends both to the kernels,
    with a gradient (V1), in both dtypes."""
    assert network.layer_route(B, 64, dtype, True, _smem_limit(cuda)) == \
        "kernel"


def test_sample_batch_with_a_mesh_of_one_is_the_unsharded_call(cuda):
    """sample_batch(mesh=) in a world of one (no process group) lands on
    the mesh's card with the unsharded call's bits and dtypes."""
    from di_hpc_tpu_torch import data, parallel

    trajs = chip_smoke.data_trajectories(np.random.default_rng(75))
    bufs = [data.TrajectoryBuffer(capacity=len(trajs)) for _ in range(2)]
    for buf in bufs:
        for t in trajs:
            buf.add(t)
    mesh = parallel.make_mesh()
    assert mesh.device.type == "cuda"
    got = bufs[0].sample_batch(chip_smoke.DATA_B, mesh=mesh)
    want = bufs[1].sample_batch(chip_smoke.DATA_B, device=cuda)
    assert list(got) == list(want)
    for k in want:
        assert got[k].device == want[k].device and \
            chip_smoke.bitwise_equal(got[k], want[k]), k


def test_kernel_spans_count_the_launches(cuda):
    """Under torch.profiler, one make_train_step step at B=64 opens one
    `dihpc.kernel.<name>` range per launch that `launch_counts()` counts
    and one `dihpc.lstm.layer.kernel` range per layer that
    `lstm_fused.routes` counts on the kernels' route; the backward's ranges
    lie on the autograd engine's thread, not the caller's, and every launch
    range holds the runtime call of a kernel that ran on the card."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    cfg = models.ActorCriticConfig(obs_dim=24, hidden_size=128, num_layers=2,
                                   action_dim=16)
    gen = torch.Generator(device=cuda).manual_seed(21)
    params = models.init_actor_critic(cfg, torch.Generator().manual_seed(21),
                                      device=cuda)
    T, B = 8, 64
    batch = models.TrainBatch(
        torch.randn(T + 1, B, 24, generator=gen, device=cuda),
        torch.randint(0, 16, (T, B), generator=gen, device=cuda),
        torch.randn(T, B, generator=gen, device=cuda),
        torch.randn(T, B, 16, generator=gen, device=cuda))
    step = models.make_train_step(
        cfg, torch.optim.Adam(params.parameters(), lr=1e-3))
    step(params, batch)
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    network.reset_route_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, batch)
        torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert network.lstm_fused.routes == {"kernel": 2, "recurrent": 0}
    counted = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    assert counted == {"lstm_layer_fused": 2, "lstm_layer_bwd_v2": 2,
                       "vtrace_losses": 1, "vtrace_returns_adv": 1,
                       "categorical_fwd": 2, "categorical_bwd": 1}
    events = prof.profiler.kineto_results.events()
    on_card = lambda e: str(e.device_type()).endswith("CUDA")
    layers = Counter(e.name() for e in events if not on_card(e)
                     and e.name().startswith("dihpc.lstm.layer."))
    assert layers == {"dihpc.lstm.layer.kernel": 2,
                      "dihpc.lstm.layer.kernel.bwd": 2}
    spans = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
             for e in events if not on_card(e)
             and e.name().startswith("dihpc.kernel.")]
    assert Counter(n.removeprefix("dihpc.kernel.") for n, *_ in spans) == \
        counted
    threads = lambda name: {t for n, _, _, t in spans if n == name}
    assert threads("dihpc.kernel.lstm_layer_fused").isdisjoint(
        threads("dihpc.kernel.lstm_layer_bwd_v2"))
    ran = {e.correlation_id() for e in events if on_card(e)}
    calls = [(e.start_ns(), e.start_thread_id()) for e in events
             if not on_card(e) and e.name().startswith("cu")
             and e.correlation_id() in ran]
    for name, s, e, thread in spans:
        assert any(t == thread and s <= at <= e for at, t in calls), name



# --------------------------------------------------------- categorical ----

CATEGORICAL_N = (1, 9, 18, 127, 128, 1000, 4096)


def _categorical_inputs(seed, N, dtype, act_dtype, dev):
    """(7, 5, N) logits -- 35 rows, a CTA of 32 rows and a partial one --
    of `dtype` with masks: a taken action at exactly -1e9 (the one-hot term
    stays), one at -3e9 and one at -inf (no one-hot term), a row of -inf,
    rows with -1e9 and -3e9 masks and rows with -inf masks; actions of
    `act_dtype`."""
    rng = np.random.default_rng(seed)
    x = 3 * rng.standard_normal((7, 5, N)).astype(np.float32)
    a = rng.integers(0, N, (7, 5))
    x[0, 0, a[0, 0]] = -1e9
    x[0, 1, a[0, 1]] = -3e9
    x[0, 2, a[0, 2]] = -np.inf
    x[0, 3, :] = -np.inf
    x[1, :, ::2] = -1e9
    x[2, :, 1::3] = -3e9
    x[3, :, ::3] = -np.inf
    return (torch.from_numpy(x).to(dev, dtype),
            torch.from_numpy(a).to(dev, act_dtype))


def _categorical_calls(x, a, w):
    """lp, entropy and logp of the behaviour side through ops.logp_entropy
    and ops.logp, then both Functions' gradients: logp_entropy's with a
    dense glp (w) and an entropy gradient broadcast from one value (a
    sum's), logp's with a glp broadcast from one value."""
    xt = x.detach().clone().requires_grad_() if x.is_contiguous() else \
        x.detach().requires_grad_()
    lp, ent = ops.logp_entropy(xt, a)
    lp_b = ops.logp(xt, a)
    (dx,) = torch.autograd.grad((lp * w).sum() + 0.25 * ent.sum(), xt)
    (dx_b,) = torch.autograd.grad(lp_b.sum(), xt)
    return [lp.detach(), ent.detach(), lp_b.detach(), dx, dx_b]


def _categorical_plain(x, a, w):
    """What _categorical_calls gives, from the plain body called directly
    on the same card tensors."""
    lp, ent, lse = kernels.categorical_fwd_plain(x, a, True)
    lp_b, _, lse_b = kernels.categorical_fwd_plain(x, a, False)
    rows = x.shape[:-1]
    dx = kernels.categorical_bwd_plain(x, a, lse, ent, w,
                                       torch.full(rows, 0.25, device=x.device))
    dx_b = kernels.categorical_bwd_plain(x, a, lse_b, None,
                                         torch.ones(rows, device=x.device),
                                         None)
    return [lp, ent, lp_b, dx, dx_b]


def _assert_categorical_close(got, want):
    names = ("lp", "ent", "lp_b", "dx", "dx_b")
    for name, g, h in zip(names, got, want):
        assert g.dtype == h.dtype and torch.isfinite(g).all(), name
        if g.dtype in (torch.bfloat16, torch.float16):
            torch.testing.assert_close(g.float(), h.float(), rtol=1e-2,
                                       atol=1e-5, msg=name)
        else:
            torch.testing.assert_close(g, h, rtol=RTOL, atol=ATOL, msg=name)


@pytest.mark.parametrize("act_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", CATEGORICAL_N)
def test_categorical_kernels_match_plain(cuda, N, dtype, act_dtype):
    """ops.logp_entropy and ops.logp on the card (the kernels) against the
    plain body called directly on the same card tensors: lp, entropy and
    both Functions' gradients, at N with one chunk, several and a ragged
    one, 4-wide and 1-wide loads, masked, -inf and masked-taken logits and
    broadcast incoming gradients; each kernel's launches one up a call
    (two forwards, two backwards); every result the same bits on a second
    run.  float32 outputs at RTOL/ATOL; bf16 (and float16) gradients
    within 1e-2 relative (one rounding of nearly equal float32 values) and
    1e-5 absolute."""
    x, a = _categorical_inputs(40 + N, N, dtype, act_dtype, cuda)
    w = torch.from_numpy(np.random.default_rng(N).standard_normal(
        (7, 5)).astype(np.float32)).to(cuda)
    runs = []
    for _ in range(2):
        before = kernels.launch_counts()
        runs.append(_categorical_calls(x, a, w))
        after = kernels.launch_counts()
        assert {k: after[k] - before[k] for k in after
                if after[k] != before[k]} == {"categorical_fwd": 2,
                                              "categorical_bwd": 2}
    torch.cuda.synchronize()
    got, again = runs
    for i, (g, h) in enumerate(zip(got, again)):
        assert torch.equal(g, h), f"output {i}: repeated runs differ"
    _assert_categorical_close(got, _categorical_plain(x, a, w))
    # Taken actions below the clamp get no one-hot term (and p = 0); one at
    # exactly -1e9 beside unmasked logits (N > 1) keeps it: its gradient is
    # glp there.
    dx, dx_b = got[3].float(), got[4].float()
    for row in (1, 2):
        col = int(a[0, row])
        assert float(dx[0, row, col]) == 0.0 == float(dx_b[0, row, col])
    if N > 1:
        col = int(a[0, 0])
        assert float(dx_b[0, 0, col]) == 1.0
        assert float(dx[0, 0, col]) == float(w[0, 0].to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_categorical_kernels_read_unaligned_logits(cuda, dtype):
    """Logits whose start is off a 4-element boundary (a contiguous view at
    an offset of one element) take the kernels with 1-wide loads and give
    the plain body's results."""
    from di_hpc_tpu_torch.kernels.categorical import load_width

    x, a = _categorical_inputs(77, 128, dtype, torch.int64, cuda)
    buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and load_width(
        128, view.data_ptr(), view.element_size()) == 1
    w = torch.ones((7, 5), device=cuda)
    before = kernels.launch_counts()["categorical_fwd"]
    got = _categorical_calls(view, a, w)
    assert kernels.launch_counts()["categorical_fwd"] == before + 2
    _assert_categorical_close(got, _categorical_plain(x, a, w))


@pytest.mark.parametrize("case", ["float16", "float64", "strided", "int16",
                                  "uint8"])
def test_categorical_other_inputs_take_the_kernels_on_card(cuda, case):
    """float16 and float64 logits (cast to float32), strided logits (made
    contiguous) and int16 or uint8 actions (cast to int64) take the
    kernels too: each call launches them, the results are the plain
    body's on the same tensors and the gradient has the logits' dtype and
    shape.  The kernels' wrappers themselves raise on these inputs."""
    x, a = _categorical_inputs(78, 12, torch.float32, torch.int64, cuda)
    logits, actions = {
        "float16": (x.half(), a), "float64": (x.double(), a),
        "strided": (x.transpose(0, 1), a.t()),
        "int16": (x, a.to(torch.int16)), "uint8": (x, a.to(torch.uint8)),
    }[case]
    w = torch.from_numpy(np.random.default_rng(78).standard_normal(
        actions.shape).astype(np.float32)).to(cuda)
    before = kernels.launch_counts()
    got = _categorical_calls(logits, actions, w)
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {"categorical_fwd": 2,
                                          "categorical_bwd": 2}
    for dx in got[3:]:
        assert dx.dtype == logits.dtype and dx.shape == logits.shape
    _assert_categorical_close(got, _categorical_plain(logits, actions, w))
    error = {"float16": (TypeError, "float32 or bfloat16 logits"),
             "float64": (TypeError, "float32 or bfloat16 logits"),
             "strided": (ValueError, "logits must be contiguous"),
             "int16": (TypeError, "int32 or int64 actions"),
             "uint8": (TypeError, "int32 or int64 actions")}[case]
    with pytest.raises(error[0], match=error[1]):
        kernels.categorical_fwd(logits, actions)


def test_categorical_wrapper_checks_on_card(cuda):
    """The kernels' wrappers raise on actions on another device than the
    logits and on an incoming gradient on the CPU."""
    x, a = _categorical_inputs(79, 12, torch.float32, torch.int64, cuda)
    with pytest.raises(ValueError, match="all inputs must lie"):
        kernels.categorical_fwd(x, a.cpu())
    lp, ent, lse = kernels.categorical_fwd(x, a)
    with pytest.raises(ValueError, match="glp is on cpu"):
        kernels.categorical_bwd(x, a, lse, ent, lp.cpu(), ent)


if __name__ == "__main__":
    import sys

    worker = {"scan": _sharded_scan_worker,
              "step": _sharded_step_worker}[sys.argv[1]]
    sys.exit(worker(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])))
