"""The port's categorical head and V-trace loss (di_hpc_tpu_torch.ops and
.origin) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides; the JAX
V-trace op runs its Pallas kernels in interpret mode.  Tolerances: rtol=1e-4,
atol=1e-5, as the JAX package's own op tests use -- float32 on both sides,
differing only in the order of sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import di_hpc_tpu.pallas_kernels.linear_scan as ls
from di_hpc_tpu import ops as jax_ops
from di_hpc_tpu import origin as jax_origin
from di_hpc_tpu.pallas_kernels import rl_scans as jax_rl_scans

from di_hpc_tpu_torch import ops, origin

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture
def interpret():
    ls.INTERPRET = True
    jax.clear_caches()          # no trace cached by an earlier test's mode
    yield
    ls.INTERPRET = False


def _vtrace_np(seed, T, B, N, weight=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    w = {None: None, "TB": rng.uniform(0, 2, (T, B)).astype(np.float32),
         "B": rng.uniform(0, 2, (B,)).astype(np.float32)}[weight]
    return (f(T, B, N), f(T, B, N), rng.integers(0, N, (T, B)),
            f(T + 1, B), f(T, B), w)


def _to_torch(arrays, requires_grad=()):
    out = []
    for i, a in enumerate(arrays):
        t = None if a is None else torch.from_numpy(np.asarray(a))
        if i in requires_grad:
            t.requires_grad_()
        out.append(t)
    return out


def _masked_logits():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 9)).astype(np.float32)
    x[0, [1, 4]] = -np.inf           # -inf masks
    x[1, 2] = -1e9                   # a mask at exactly the clamp
    x[2, :] = -np.inf                # every action masked
    x[3, 0] = -np.inf                # taken action masked (action 0 below)
    x[4, 3] = 1e4                    # extreme logit
    actions = np.array([1, 2, 5, 0, 3, 8])
    return x, actions


def test_logp_entropy_matches_jax_with_masks():
    x, a = _masked_logits()
    want_lp, want_ent = jax_ops.logp_entropy(jnp.asarray(x), jnp.asarray(a))
    got_lp, got_ent = ops.logp_entropy(torch.from_numpy(x), torch.from_numpy(a))
    assert torch.isfinite(got_lp).all() and torch.isfinite(got_ent).all()
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_ent.numpy(), np.asarray(want_ent),
                               rtol=RTOL, atol=ATOL)
    got = ops.logp(torch.from_numpy(x), torch.from_numpy(a))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_ops.logp(jnp.asarray(x), jnp.asarray(a))),
        rtol=RTOL, atol=ATOL)


def test_categorical_head_matches_oracles_unmasked():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 5, 7)).astype(np.float32)
    a = rng.integers(0, 7, (4, 5))
    lp, ent = ops.logp_entropy(torch.from_numpy(x), torch.from_numpy(a))
    np.testing.assert_allclose(
        lp.numpy(), np.asarray(jax_origin.ppo.categorical_log_prob(
            jnp.asarray(x), jnp.asarray(a))), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ent.numpy(), origin.categorical_entropy(torch.from_numpy(x)).numpy(),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        origin.categorical_log_prob(torch.from_numpy(x),
                                    torch.from_numpy(a)).numpy(),
        lp.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weight", [None, "TB", "B"])
def test_vtrace_error_matches_jax(interpret, monkeypatch, weight):
    """T=36, B=136 as in the JAX kernel tests; non-default clips exercise
    the three min(IS, clip) planes.  Unit weight routes through the
    loss-fused kernel on both sides, a weight through the returns/advantage
    kernel."""
    T, B, N = 36, 136, 5
    data = _vtrace_np(2, T, B, N, weight)
    args = (0.98, 0.9, 1.1, 0.8, 1.3)
    spied = "vtrace_losses_pallas" if weight is None \
        else "vtrace_returns_adv_pallas"
    calls = []
    real = getattr(jax_rl_scans, spied)
    monkeypatch.setattr(jax_rl_scans, spied,
                        lambda *a: calls.append(1) or real(*a))
    want = jax_ops.vtrace_error(
        jax_ops.vtrace_data(*(None if a is None else jnp.asarray(a)
                              for a in data)), *args)
    assert calls                  # the JAX side really ran its kernel
    got = ops.vtrace_error(ops.vtrace_data(*_to_torch(data)), *args)
    np.testing.assert_allclose([float(x) for x in got],
                               [float(x) for x in want], rtol=RTOL, atol=ATOL)
    oracle = origin.vtrace_error(origin.vtrace_data(*_to_torch(data)), *args)
    np.testing.assert_allclose([float(x) for x in got],
                               [float(x) for x in oracle], rtol=RTOL,
                               atol=ATOL)


def test_origin_vtrace_matches_jax_oracle():
    T, B, N = 9, 7, 4
    data = _vtrace_np(3, T, B, N, "TB")
    want = jax_origin.vtrace_error(
        jax_origin.vtrace_data(*map(jnp.asarray, data)), 0.9, 0.8)
    got = origin.vtrace_error(origin.vtrace_data(*_to_torch(data)), 0.9, 0.8)
    np.testing.assert_allclose([float(x) for x in got],
                               [float(x) for x in want], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weight", [None, "TB"])
def test_vtrace_error_gradients_on_cpu_match_jax(interpret, weight):
    """On the CPU the plain versions keep autograd with the V-trace
    stop-gradient contract: the target logits and value[:-1] get gradients,
    the behaviour logits and value[T] none."""
    T, B, N = 12, 24, 6
    data = _vtrace_np(4, T, B, N, weight)

    def jax_total(to, v):
        d = list(map(lambda a: None if a is None else jnp.asarray(a), data))
        d[0], d[3] = to, v
        l = jax_ops.vtrace_error(jax_ops.vtrace_data(*d))
        return l.policy_loss + 0.5 * l.value_loss - 0.01 * l.entropy_loss

    want_to, want_v = jax.grad(jax_total, argnums=(0, 1))(
        jnp.asarray(data[0]), jnp.asarray(data[3]))
    t = _to_torch(data, requires_grad=(0, 1, 3))
    l = ops.vtrace_error(ops.vtrace_data(*t))
    (l.policy_loss + 0.5 * l.value_loss - 0.01 * l.entropy_loss).backward()
    np.testing.assert_allclose(t[0].grad.numpy(), np.asarray(want_to),
                               rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(t[3].grad.numpy(), np.asarray(want_v),
                               rtol=RTOL, atol=1e-7)
    assert t[1].grad is None or float(t[1].grad.abs().max()) == 0.0
    assert float(t[3].grad[-1].abs().max()) == 0.0


def test_vtrace_validation_names_the_op():
    T, B, N = 4, 3, 5
    to, bo, act, val, rew, _ = _to_torch(_vtrace_np(5, T, B, N))
    with pytest.raises(ValueError, match="vtrace_error: value must have"):
        ops.vtrace_error(ops.vtrace_data(to, bo, act, val[:-1], rew, None))
    with pytest.raises(ValueError, match="vtrace_error: behaviour_output"):
        ops.vtrace_error(ops.vtrace_data(to, bo[:, :, :-1], act, val, rew,
                                         None))
    with pytest.raises(ValueError, match="vtrace_error: action must be an "
                                         "integer"):
        ops.vtrace_error(ops.vtrace_data(to, bo, act.float(), val, rew, None))
    with pytest.raises(ValueError, match="vtrace_error: reward must have"):
        ops.vtrace_error(ops.vtrace_data(to, bo, act, val, rew[:, :2], None))
    with pytest.raises(ValueError, match="vtrace_error: weight must have"):
        ops.vtrace_error(ops.vtrace_data(to, bo, act, val, rew,
                                         torch.ones(T + 1, B)))


def test_vtrace_wrapper_class():
    T, B, N = 5, 4, 3
    data = _to_torch(_vtrace_np(6, T, B, N))
    vt = ops.VTrace(T, B, N)
    got = vt(*data[:5])
    want = ops.vtrace_error(ops.vtrace_data(*data))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="VTrace: target_output"):
        ops.VTrace(T, B, N + 1)(*data[:5])
