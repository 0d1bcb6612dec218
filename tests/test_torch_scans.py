"""The port's scan family (di_hpc_tpu_torch: the GAE, lambda-returns and
TD(lambda) kernels' plain versions, the scan core, ops.gae, ops.td and the
origin oracles) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides; the JAX
side runs its Pallas kernels in interpret mode.  Tolerances: rtol=1e-4,
atol=1e-5, as the JAX package's own op tests use -- float32 on both sides,
differing only in the order of operations (the JAX kernels compose the
recurrence by log-depth doubling, the port's plain versions walk it
sequentially).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import di_hpc_tpu.pallas_kernels.linear_scan as ls
from di_hpc_tpu import ops as jax_ops
from di_hpc_tpu import origin as jax_origin
from di_hpc_tpu.ops import scan as jax_scan
from di_hpc_tpu.pallas_kernels import rl_scans as jax_rl_scans

from di_hpc_tpu_torch import kernels, ops, origin
from di_hpc_tpu_torch.kernels import rl_scans as port_rl_scans

RTOL, ATOL = 1e-4, 1e-5
GAMMA_LAMBDA = {"gae": (0.99, 0.97), "lambda_returns": (0.9, 0.8),
                "td_lambda_loss": (0.95, 0.7), "td_lambda_err": (0.9, 0.8)}


@pytest.fixture
def interpret():
    ls.INTERPRET = True
    jax.clear_caches()          # no trace cached by an earlier test's mode
    yield
    ls.INTERPRET = False


def _value_reward(seed, T, B, extra=()):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T + 1, B, *extra)).astype(np.float32),
            rng.standard_normal((T, B, *extra)).astype(np.float32))


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=msg)


def _jax_kernel(name, v, r, gamma, lambda_):
    """The JAX package's Pallas kernel (interpret mode) for `name`."""
    if name == "gae":
        return jax_rl_scans.gae_fused_pallas(v, r, gamma, lambda_)
    if name == "lambda_returns":
        return jax_rl_scans.lambda_returns_pallas(v, r, gamma, lambda_)
    if name == "td_lambda_loss":
        return jax_rl_scans.td_lambda_loss_pallas(v, r, gamma, lambda_)
    return jax_rl_scans._tdl_err_impl(v, r, gamma, lambda_)


# T = 1 leaves one step; T = 130 and B = 13, 200 are no multiples of the
# JAX kernel's 128-lane block (its ragged-lane masking) or of the port
# kernel's 32-column block.
@pytest.mark.parametrize("T,B", [(1, 13), (64, 200), (130, 13)])
@pytest.mark.parametrize("name", list(GAMMA_LAMBDA))
def test_plain_versions_match_jax_kernels(interpret, name, T, B):
    v, r = _value_reward(T * 1000 + B, T, B)
    gamma, lambda_ = GAMMA_LAMBDA[name]
    want = _jax_kernel(name, jnp.asarray(v), jnp.asarray(r), gamma, lambda_)
    plain = getattr(kernels, name + "_plain")
    _close(plain(torch.from_numpy(v), torch.from_numpy(r), gamma, lambda_),
           want, name)
    # The wrapper runs the plain version on CPU tensors, launching nothing.
    kernels.reset_launch_counts()
    got = getattr(kernels, name)(torch.from_numpy(v), torch.from_numpy(r),
                                 gamma, lambda_)
    _close(got, want, name + " wrapper")
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("T,B", [(1, 13), (130, 200)])
def test_td_lambda_loss_gradient_matches_jax(interpret, T, B):
    """The Function's recompute backward against jax.grad through
    td_lambda_loss_pallas: d value[:-1] = -e/TB, zeros for value[T] and the
    rewards."""
    v, r = _value_reward(7, T, B)
    gamma, lambda_ = GAMMA_LAMBDA["td_lambda_loss"]
    want_v, want_r = jax.grad(
        lambda a, b: 3.0 * jax_rl_scans.td_lambda_loss_pallas(
            a, b, gamma, lambda_), argnums=(0, 1))(jnp.asarray(v),
                                                   jnp.asarray(r))
    vt, rt = (torch.from_numpy(a).requires_grad_() for a in (v, r))
    (3.0 * kernels.td_lambda_loss(vt, rt, gamma, lambda_)).backward()
    _close(vt.grad, want_v, "dvalue")
    _close(rt.grad, want_r, "dreward")
    assert float(vt.grad[-1].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["gae", "lambda_returns"])
def test_recurrence_targets_have_zero_gradient(name):
    v, r = (torch.from_numpy(a).requires_grad_()
            for a in _value_reward(8, 5, 4))
    out = getattr(kernels, name)(v, r, *GAMMA_LAMBDA[name])
    out.sum().backward()
    assert float(v.grad.abs().max()) == 0.0
    assert float(r.grad.abs().max()) == 0.0


# ------------------------------------------------------------- scan core --

def _ab(seed, T, B, b_shape):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((T, B)).astype(np.float32)
    b = rng.uniform(0.5, 1.0, b_shape).astype(np.float32)
    return a, b


@pytest.mark.parametrize("y_end", [0.0, 1.5, "tensor"])
@pytest.mark.parametrize("method", ["scan", "associative"])
@pytest.mark.parametrize("direction", ["reverse", "forward"])
def test_linear_recurrence_matches_jax(direction, method, y_end):
    """Full-plane b for the reverse recurrence, a (T, 1) b broadcast for the
    forward one; a zero, a scalar and a (B,) boundary value.  T = 37 is no
    power of two, so the doubling ends on a partial step."""
    T, B = 37, 6
    b_shape = (T, B) if direction == "reverse" else (T, 1)
    a, b = _ab(len(direction) + len(method), T, B, b_shape)
    y = (np.linspace(-1, 1, B).astype(np.float32) if y_end == "tensor"
         else y_end)
    jfn = getattr(jax_scan, f"linear_recurrence_{direction}")
    pfn = getattr(ops, f"linear_recurrence_{direction}")
    want = jfn(jnp.asarray(a), jnp.asarray(b), jnp.asarray(y)
               if y_end == "tensor" else y, method="scan")
    got = pfn(torch.from_numpy(a), torch.from_numpy(b),
              torch.from_numpy(y) if y_end == "tensor" else y, method=method)
    _close(got, want)


@pytest.mark.parametrize("method", ["scan", "associative"])
def test_linear_recurrence_gradients_match_jax(method):
    T, B = 11, 3
    a, b = _ab(9, T, B, (T, B))
    w = np.random.default_rng(10).standard_normal((T, B)).astype(np.float32)

    def jloss(a_, b_):
        return jnp.sum(jax_ops.linear_recurrence_reverse(
            a_, b_, 0.5, method="associative") * w)

    want_a, want_b = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a),
                                                      jnp.asarray(b))
    at, bt = (torch.from_numpy(x).requires_grad_() for x in (a, b))
    (ops.linear_recurrence_reverse(at, bt, 0.5, method=method)
     * torch.from_numpy(w)).sum().backward()
    _close(at.grad, want_a, "da")
    _close(bt.grad, want_b, "db")


def test_linear_recurrence_method_choice():
    a, b = (torch.from_numpy(x) for x in _ab(11, 5, 2, (5, 2)))
    assert torch.equal(ops.linear_recurrence_reverse(a, b, method="auto"),
                       ops.linear_recurrence_reverse(a, b,
                                                     method="associative"))
    with pytest.raises(NotImplementedError, match="kernel 6"):
        ops.linear_recurrence_forward(a, b, method="pallas")
    with pytest.raises(ValueError, match="unknown method"):
        ops.linear_recurrence_reverse(a, b, method="bogus")


@pytest.mark.parametrize("T,lambda_", [(1, 0.97), (1, 1.0), (40, 1.0),
                                       (300, 0.95)])
def test_gae_denominators_match_jax(T, lambda_):
    want = jax_ops.gae_denominators(T, lambda_)
    got = ops.gae_denominators(T, lambda_, device="cpu")
    assert got.shape == (T,) and got.dtype == torch.float32
    _close(got, want)


# ------------------------------------------------------------------- ops --

@pytest.mark.parametrize("method", ["auto", "associative", "scan"])
def test_gae_matches_jax(interpret, monkeypatch, method):
    """"auto" takes the kernel on both sides (the plain version here, the
    Pallas kernel in interpret mode there); the other methods the scan
    core.  Both are held against the oracles too."""
    T, B = 33, 20
    v, r = _value_reward(12, T, B)
    jax_calls, port_calls = [], []
    real_j = jax_rl_scans.gae_fused_pallas
    monkeypatch.setattr(jax_rl_scans, "gae_fused_pallas",
                        lambda *a: jax_calls.append(1) or real_j(*a))
    real_p = port_rl_scans.gae_plain
    monkeypatch.setattr(port_rl_scans, "gae_plain",
                        lambda *a: port_calls.append(1) or real_p(*a))
    want = jax_ops.gae(jax_ops.gae_data(jnp.asarray(v), jnp.asarray(r)),
                       0.98, 0.9, method=method)
    got = ops.gae(ops.gae_data(torch.from_numpy(v), torch.from_numpy(r)),
                  0.98, 0.9, method=method)
    assert bool(jax_calls) == bool(port_calls) == (method == "auto")
    assert not got.requires_grad
    _close(got, want)
    _close(got, jax_origin.gae(jax_origin.gae_data(jnp.asarray(v),
                                                   jnp.asarray(r)), 0.98,
                               0.9))
    _close(origin.gae(origin.gae_data(torch.from_numpy(v),
                                      torch.from_numpy(r)), 0.98, 0.9), want)


def test_gae_on_three_axes_takes_the_scan_core():
    """A (T+1, B, 2) value is no 2-D kernel input: both sides take the scan
    core."""
    v, r = _value_reward(13, 9, 4, extra=(2,))
    want = jax_ops.gae(jax_ops.gae_data(jnp.asarray(v), jnp.asarray(r)))
    got = ops.gae(ops.gae_data(torch.from_numpy(v), torch.from_numpy(r)))
    _close(got, want)


def test_gae_wrapper_class_and_validation():
    T, B = 6, 5
    v, r = (torch.from_numpy(a) for a in _value_reward(14, T, B))
    assert torch.equal(ops.GAE(T, B)(v, r, 0.9, 0.8),
                       ops.gae(ops.gae_data(v, r), 0.9, 0.8))
    with pytest.raises(ValueError, match="GAE: value"):
        ops.GAE(T, B + 1)(v, r)
    with pytest.raises(ValueError, match="gae: value must have"):
        ops.gae(ops.gae_data(v[:-1], r))


def _weight(kind, T, B):
    rng = np.random.default_rng(15)
    return {None: None, "B": rng.uniform(0, 2, B).astype(np.float32),
            "TB": rng.uniform(0, 2, (T, B)).astype(np.float32)}[kind]


@pytest.mark.parametrize("method", ["auto", "scan"])
@pytest.mark.parametrize("weight", [None, "B", "TB"])
def test_td_lambda_error_matches_jax(interpret, monkeypatch, weight, method):
    """Value and gradient in value.  Under "auto" unit weight takes the
    loss-fused kernel and a weight the returns kernel, on both sides; "scan"
    takes the scan core.  A (B,) weight broadcasts over time as in the
    origin."""
    T, B = 40, 24
    v, r = _value_reward(16, T, B)
    w = _weight(weight, T, B)
    spied = "td_lambda_loss_pallas" if weight is None \
        else "lambda_returns_pallas"
    calls = []
    real = getattr(jax_rl_scans, spied)
    monkeypatch.setattr(jax_rl_scans, spied,
                        lambda *a: calls.append(1) or real(*a))

    def jax_loss(v_):
        return jax_ops.td_lambda_error(jax_ops.td_lambda_data(
            v_, jnp.asarray(r), None if w is None else jnp.asarray(w)),
            0.95, 0.75, method=method)

    want, want_g = jax.value_and_grad(jax_loss)(jnp.asarray(v))
    assert bool(calls) == (method == "auto")
    vt = torch.from_numpy(v).requires_grad_()
    got = ops.td_lambda_error(ops.td_lambda_data(
        vt, torch.from_numpy(r), None if w is None else torch.from_numpy(w)),
        0.95, 0.75, method=method)
    got.backward()
    _close(got, want, "loss")
    _close(vt.grad, want_g, "dvalue")
    oracle = origin.td_lambda_error(origin.td_lambda_data(
        torch.from_numpy(v), torch.from_numpy(r),
        None if w is None else torch.from_numpy(w)), 0.95, 0.75)
    _close(oracle, want, "oracle")


def test_td_lambda_wrapper_class_and_validation():
    T, B = 5, 3
    v, r = (torch.from_numpy(a) for a in _value_reward(17, T, B))
    w = torch.ones(B)
    assert torch.equal(ops.TDLambda(T, B)(v, r, w),
                       ops.td_lambda_error(ops.td_lambda_data(v, r, w)))
    with pytest.raises(ValueError, match="TDLambda: reward"):
        ops.TDLambda(T, B)(v, r[:-1])
    with pytest.raises(ValueError, match="td_lambda_error: weight must"):
        ops.td_lambda_error(ops.td_lambda_data(v, r, torch.ones(T + 1, B)))


# --------------------------------------------------------------- origin --

@pytest.mark.parametrize("coeffs", ["scalar", "plane"])
def test_origin_lambda_returns_match_jax(coeffs):
    """The oracles' lambda-returns with scalar and per-step (T, B) gammas
    and lambdas, and the ops' scan-core form."""
    T, B = 12, 5
    v, r = _value_reward(18, T, B)
    rng = np.random.default_rng(19)
    g, lam = ((0.9, 0.8) if coeffs == "scalar" else
              (rng.uniform(0.8, 1, (T, B)).astype(np.float32),
               rng.uniform(0, 1, (T, B)).astype(np.float32)))
    conv = (lambda x: x) if coeffs == "scalar" else jnp.asarray
    want = jax_origin.generalized_lambda_returns(
        jnp.asarray(v), jnp.asarray(r), conv(g), conv(lam))
    tconv = (lambda x: x) if coeffs == "scalar" else torch.from_numpy
    args = (torch.from_numpy(v), torch.from_numpy(r), tconv(g), tconv(lam))
    _close(origin.generalized_lambda_returns(*args), want, "origin")
    for method in ("scan", "associative"):
        _close(ops.generalized_lambda_returns(*args, method=method), want,
               method)
    _close(origin.multistep_forward_view(args[0][1:], *args[1:]),
           jax_origin.multistep_forward_view(jnp.asarray(v)[1:],
                                             jnp.asarray(r), conv(g),
                                             conv(lam)))


@pytest.mark.parametrize("T,lambda_", [(1, 0.97), (25, 1.0)])
def test_origin_gae_matches_jax(T, lambda_):
    v, r = _value_reward(20, T, 7)
    want = jax_origin.gae(jax_origin.gae_data(jnp.asarray(v),
                                              jnp.asarray(r)), 0.99, lambda_)
    _close(origin.gae(origin.gae_data(torch.from_numpy(v),
                                      torch.from_numpy(r)), 0.99, lambda_),
           want)
