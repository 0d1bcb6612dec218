"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs, the LSTM layer's autograd.Function against
autograd through the plain forward, the forward/serving path, one training
step and the GAE and TD(lambda) ops on the card against the same calls on
the CPU; the full-plane kernels (the linear recurrence, UPGO) against their
plain versions, the scan entry points, ops.upgo_loss and the scatter
connection on the card against the CPU, and one step of chip_smoke.py's
AlphaStar trainer on the card against the CPU.

Every test here is marked `gpu` and skips without a card (decided in the
`cuda` fixture, never at import).  This file imports no JAX, so it also
runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerance: rtol=1e-4, atol=1e-4.  Both sides are float32 without TF32;
they differ in summation order (the kernel's k-loop and warp sums against
cuBLAS and PyTorch's reduction trees) and in FMA contraction, carried
through the recurrences.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from di_hpc_tpu_torch import kernels, models, network, ops

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


# B = 13 and 17 are not multiples of the kernel's 8-row block; S = 1 is the
# serving step; H = 96 is no power of two; norm=False drops both LNs.
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


@pytest.mark.parametrize("T,B", [(36, 136), (37, 9)])
def test_vtrace_kernels_match_plain(cuda, T, B):
    is_w, lp, reward, value = _vtrace_inputs(9, T, B, cuda)
    got = kernels.vtrace_losses(is_w, lp, reward, value, *CLIPS)
    again = kernels.vtrace_losses(is_w, lp, reward, value, *CLIPS)
    want = kernels.vtrace_losses_plain(is_w, lp, reward, value, *CLIPS)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)              # no atomics: bitwise repeatable
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    got = kernels.vtrace_returns_adv(is_w, reward, value, *CLIPS)
    want = kernels.vtrace_returns_adv_plain(is_w, reward, value, *CLIPS)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


def test_cuda_wrappers_raise_on_what_they_cannot_take(cuda):
    args = _layer_inputs(10, 2, 3, 16, cuda)
    with pytest.raises(TypeError, match="float32 only"):
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
                      "upgo_loss": 0}
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


# B = 13 and 17 leave a ragged last block of the 8-row CTAs; H = 96 is no
# power of two; norm=False drops both LNs; the last case is the train
# step's width (S = T+1 = 33, B = 256 for V2, 32 for V1).
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
    """Per-CTA partial sums reduced by torch.sum, no float atomics."""
    args = _bwd_inputs(14, 9, 88, 128, cuda)
    with torch.no_grad():
        first = kernels.lstm_layer_bwd_v2(*args)
        second = kernels.lstm_layer_bwd_v2(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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
        with pytest.raises(TypeError, match="float32 only"):
            fn(value.double(), reward.double(), *SCAN_ARGS[name])
        with pytest.raises(ValueError, match="must be contiguous"):
            fn(value, reward.t().contiguous().t(), *SCAN_ARGS[name])
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
    """One step of chip_smoke.py's AlphaStar trainer (the example's
    configuration, greedy selection) on the card against the CPU: the
    launches of its path, the metrics, every gradient, and the parameters by
    the Adam rule of chip_smoke.check_adam_params."""
    rng = np.random.default_rng(33)
    arrays = chip_smoke.alphastar_arrays(rng, **chip_smoke.AS_CFG)
    batches = chip_smoke.alphastar_batches(rng, 1, **chip_smoke.AS_CFG)

    def step(dev):
        p, opt, (batch,) = chip_smoke.alphastar_setup(
            arrays, batches, dev, **chip_smoke.AS_CFG)
        return (*chip_smoke.alphastar_step(p, opt, batch),
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
                                 chip_smoke.AS_LR, 1)


def test_full_plane_wrappers_raise_on_what_they_cannot_take(cuda):
    a, b, rhos, lp, reward, value = _full_plane_inputs(34, 6, 40, cuda)
    with pytest.raises(TypeError, match="float32 only"):
        kernels.linear_scan(a.double(), b.double())
    with pytest.raises(ValueError, match="all inputs must lie"):
        kernels.linear_scan(a, b.cpu())
    with pytest.raises(ValueError, match=r"a must be \(T, B\)"):
        kernels.linear_scan(a[..., None], b[..., None])
    with pytest.raises(ValueError, match=r"value must be \(7, 40\)"):
        kernels.upgo_advantages(rhos, reward, value[:-1])
    with pytest.raises(ValueError, match="must be contiguous"):
        kernels.upgo_loss(rhos, lp.t().contiguous().t(), reward, value)
    with pytest.raises(TypeError, match="float32 only"):
        kernels.upgo_loss(rhos, lp.double(), reward, value)
