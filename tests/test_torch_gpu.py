"""The port's CUDA kernels on the card, each against its plain PyTorch
version on the same inputs, and the forward/serving path on the card
against the same calls on the CPU.

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

from di_hpc_tpu_torch import kernels, models, ops

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
    with pytest.raises(NotImplementedError, match="training slice"):
        kernels.lstm_layer_fused(args[0].clone().requires_grad_(), *args[1:])
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
    assert counts == {"lstm_layer_fused": 4, "vtrace_losses": 1,
                      "vtrace_returns_adv": 1}
    for i, (g, w) in enumerate(zip(got, want)):
        torch.testing.assert_close(g.cpu(), w, rtol=RTOL, atol=ATOL,
                                   msg=f"output {i}")
