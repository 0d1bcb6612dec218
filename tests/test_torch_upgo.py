"""The port's full-plane scans (di_hpc_tpu_torch: the plain versions of the
linear-recurrence kernel and the two UPGO kernels, the scan core's "pallas"
method, ops.upgo_returns, ops.upgo_loss, UPGO and the origin oracles)
against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both sides; the JAX
side runs its Pallas kernels in interpret mode.  Tolerances: rtol=1e-4,
atol=1e-5, as the JAX package's own op tests use -- float32 on both sides,
differing only in the order of operations (the JAX kernels compose the
recurrence by chunked log-depth doubling, the port's plain versions walk it
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
from di_hpc_tpu.pallas_kernels import rl_scans as jax_rl_scans

from di_hpc_tpu_torch import kernels, ops, origin
from di_hpc_tpu_torch.kernels import rl_scans as port_rl_scans

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def interpret():
    """Pallas interpret mode for the whole module: each kernel shape is
    traced once, and no trace of another mode is reused."""
    ls.INTERPRET = True
    jax.clear_caches()
    yield
    ls.INTERPRET = False
    jax.clear_caches()


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=msg)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _upgo_inputs(seed, T, B, N=None):
    """rhos, reward (T, B), value (T+1, B), lp (T, B) and, with N, logits
    (T, B, N) and actions (T, B)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    out = {"rhos": np.exp(0.2 * f(T, B)), "reward": f(T, B),
           "value": f(T + 1, B), "lp": -np.abs(f(T, B))}
    if N is not None:
        out["logits"] = f(T, B, N)
        out["action"] = rng.integers(0, N, (T, B))
    return out


# ---------------------------------------------------------------- kernel 6 --

# T = 1 leaves one step; T = 128 takes the JAX kernel's two-level chunked
# composition (T % 64 == 0, T > 64), T = 37 and 130 its flat doubling; B = 6
# and 300 are ragged against its lane block and the port's 32-column block.
@pytest.mark.parametrize("boundary", ["zero", "scalar", "vector"])
@pytest.mark.parametrize("direction", ["reverse", "forward"])
@pytest.mark.parametrize("B", [1, 6, 300])
@pytest.mark.parametrize("T", [1, 37, 128, 130])
def test_linear_scan_plain_matches_pallas(interpret, T, B, direction,
                                          boundary):
    rng = np.random.default_rng(T * 1000 + B)
    a = rng.standard_normal((T, B)).astype(np.float32)
    b = rng.uniform(0.5, 1.0, (T, B)).astype(np.float32)
    y = {"zero": 0.0, "scalar": 0.7,
         "vector": rng.standard_normal(B).astype(np.float32)}[boundary]
    jy = jnp.asarray(y) if boundary == "vector" else y
    ty = torch.from_numpy(y) if boundary == "vector" else y
    want = getattr(ls, f"linear_scan_{direction}_pallas")(
        jnp.asarray(a), jnp.asarray(b), jy)
    at, bt = _t(a, b)
    kernels.reset_launch_counts()
    _close(getattr(kernels, f"linear_scan_{direction}")(at, bt, ty), want,
           "kernel wrapper")
    # The scan core's "pallas" method reaches the same plain version.
    _close(getattr(ops, f"linear_recurrence_{direction}")(
        at, bt, ty, method="pallas"), want, "scan core")
    assert set(kernels.launch_counts().values()) == {0}


def test_pallas_method_is_forward_only():
    """JAX's "pallas" method fails to linearize; the port's raises for
    inputs that need a gradient, and runs where none is needed."""
    a, b = (torch.rand(5, 3) for _ in range(2))
    a.requires_grad_()
    with pytest.raises(ValueError, match="forward-only kernel"):
        ops.linear_recurrence_reverse(a, b, method="pallas")
    with torch.no_grad():
        got = ops.linear_recurrence_reverse(a, b, method="pallas")
    assert torch.equal(got, kernels.linear_scan_plain(a.detach(), b))
    # "auto" on CPU tensors resolves to the differentiable "associative".
    ops.linear_recurrence_forward(a, b).sum().backward()
    assert a.grad is not None


# ------------------------------------------------------- kernels 11 and 12 --

@pytest.mark.parametrize("B", [1, 6, 300])
@pytest.mark.parametrize("T", [1, 37, 128, 130])
def test_upgo_plain_versions_match_pallas(interpret, T, B):
    x = _upgo_inputs(T * 1000 + B + 1, T, B)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    rhos, reward, value, lp = _t(x["rhos"], x["reward"], x["value"], x["lp"])
    kernels.reset_launch_counts()
    _close(kernels.upgo_advantages(rhos, reward, value),
           jax_rl_scans.upgo_advantages_pallas(j["rhos"], j["reward"],
                                               j["value"]), "advantages")
    _close(kernels.upgo_loss(rhos, lp, reward, value),
           jax_rl_scans.upgo_loss_pallas(j["rhos"], j["lp"], j["reward"],
                                         j["value"]), "loss")
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("T,B", [(1, 13), (130, 200)])
def test_upgo_loss_gradient_matches_pallas(interpret, T, B):
    """The Function's recompute backward against jax.grad through
    upgo_loss_pallas: d lp = -adv/TB, zeros for rhos, reward and value."""
    x = _upgo_inputs(40, T, B)
    names = ("rhos", "lp", "reward", "value")
    want = jax.grad(lambda *a: 3.0 * jax_rl_scans.upgo_loss_pallas(*a),
                    argnums=(0, 1, 2, 3))(*(jnp.asarray(x[k]) for k in names))
    args = [torch.from_numpy(x[k]).requires_grad_() for k in names]
    (3.0 * kernels.upgo_loss(*args)).backward()
    for name, t, w in zip(names, args, want):
        _close(t.grad, w, name)
    for t in (args[0], args[2], args[3]):
        assert float(t.grad.abs().max()) == 0.0


def test_upgo_ties_break_as_in_jax(interpret):
    """Integer-valued inputs make exact ties r_{t+1} + V_{t+2} = V_{t+1} and
    every sum exact: the plain version, the Pallas kernel, the ops path and
    the oracle agree bitwise, which a single flipped decision (a whole V
    term) would break."""
    rng = np.random.default_rng(41)
    T, B = 50, 40
    reward = rng.integers(-2, 3, (T, B)).astype(np.float32)
    value = rng.integers(-2, 3, (T + 1, B)).astype(np.float32)
    rhos = rng.choice([0.5, 1.0], (T, B)).astype(np.float32)
    ties = (reward[1:] + value[2:]) == value[1:-1]
    assert ties.sum() > 100
    want = np.asarray(jax_rl_scans.upgo_advantages_pallas(
        *map(jnp.asarray, (rhos, reward, value))))
    np.testing.assert_array_equal(
        kernels.upgo_advantages(*_t(rhos, reward, value)).numpy(), want)
    ret = np.asarray(jax_origin.upgo_returns(jnp.asarray(reward),
                                             jnp.asarray(value)))
    np.testing.assert_array_equal(rhos * (ret - value[:-1]), want)
    for method in ("scan", "associative", "pallas"):
        got = ops.upgo_returns(*_t(reward, value), method=method)
        np.testing.assert_array_equal(got.numpy(), ret, err_msg=method)
    np.testing.assert_array_equal(
        origin.upgo_returns(*_t(reward, value)).numpy(), ret)


def test_upgo_targets_have_zero_gradient():
    """rhos, rewards and values feed the detached advantage only: zeros
    through the kernel wrappers, the fused op and the composed op."""
    x = _upgo_inputs(42, 9, 4, N=5)
    rhos, reward, value, lp = (torch.from_numpy(x[k]).requires_grad_()
                               for k in ("rhos", "reward", "value", "lp"))
    kernels.upgo_advantages(rhos, reward, value).sum().backward()
    kernels.upgo_loss(rhos, lp, reward, value).backward()
    for method in ("auto", "scan"):
        ops.upgo_loss(torch.from_numpy(x["logits"]).requires_grad_(), rhos,
                      torch.from_numpy(x["action"]), reward, value,
                      method=method).backward()
    for t in (rhos, reward, value):
        assert float(t.grad.abs().max()) == 0.0
    assert float(lp.grad.abs().max()) > 0.0


# ---------------------------------------------------------------- the ops --

@pytest.mark.parametrize("method", ["auto", "scan", "associative", "pallas"])
def test_upgo_returns_matches_jax(interpret, method):
    x = _upgo_inputs(43, 33, 20)
    want = jax_ops.upgo_returns(jnp.asarray(x["reward"]),
                                jnp.asarray(x["value"]), method=method)
    got = ops.upgo_returns(*_t(x["reward"], x["value"]), method=method)
    _close(got, want)
    _close(origin.upgo_returns(*_t(x["reward"], x["value"])), want, "oracle")


@pytest.mark.parametrize("T", [1, 24])
@pytest.mark.parametrize("method", ["auto", "scan", "associative"])
def test_upgo_loss_matches_jax(interpret, monkeypatch, method, T):
    """Value and gradient in target_output.  Under "auto" both sides take
    the loss-fused kernel (the plain version here, the Pallas kernel in
    interpret mode there); the other methods compose the returns on the
    scan core."""
    jax.clear_caches()          # the spy must see the trace
    B, N = 20, 6
    x = _upgo_inputs(44 + T, T, B, N)
    jax_calls, port_calls = [], []
    real_j = jax_rl_scans.upgo_loss_pallas
    monkeypatch.setattr(jax_rl_scans, "upgo_loss_pallas",
                        lambda *a: jax_calls.append(1) or real_j(*a))
    real_p = port_rl_scans.upgo_loss_plain
    monkeypatch.setattr(port_rl_scans, "upgo_loss_plain",
                        lambda *a: port_calls.append(1) or real_p(*a))
    args = [jnp.asarray(x[k]) for k in ("rhos", "action", "reward", "value")]
    want, want_g = jax.value_and_grad(
        lambda lg: jax_ops.upgo_loss(lg, *args, method=method))(
        jnp.asarray(x["logits"]))
    logits = torch.from_numpy(x["logits"]).requires_grad_()
    rest = _t(*(x[k] for k in ("rhos", "action", "reward", "value")))
    got = ops.upgo_loss(logits, *rest, method=method)
    got.backward()
    assert bool(jax_calls) == bool(port_calls) == (method == "auto")
    _close(got, want, "loss")
    _close(logits.grad, want_g, "dlogits")


def test_origin_upgo_matches_jax():
    """tb_cross_entropy, upgo_returns and upgo_loss (value and gradient in
    the logits) of the oracles."""
    x = _upgo_inputs(45, 23, 5, N=7)
    j = {k: jnp.asarray(v) for k, v in x.items()}
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    _close(origin.tb_cross_entropy(t["logits"], t["action"]),
           jax_origin.tb_cross_entropy(j["logits"], j["action"]), "ce")
    _close(origin.upgo_returns(t["reward"], t["value"]),
           jax_origin.upgo_returns(j["reward"], j["value"]), "returns")
    want, want_g = jax.value_and_grad(lambda lg: jax_origin.upgo_loss(
        lg, j["rhos"], j["action"], j["reward"], j["value"]))(j["logits"])
    logits = t["logits"].clone().requires_grad_()
    got = origin.upgo_loss(logits, t["rhos"], t["action"], t["reward"],
                           t["value"])
    got.backward()
    _close(got, want, "loss")
    _close(logits.grad, want_g, "dlogits")


def test_upgo_wrapper_class():
    x = _upgo_inputs(46, 6, 4, N=3)
    args = _t(*(x[k] for k in ("logits", "rhos", "action", "reward",
                               "value")))
    assert torch.equal(ops.UPGO(6, 4, 3)(*args), ops.upgo_loss(*args))
    with pytest.raises(ValueError, match="UPGO: target_output"):
        ops.UPGO(6, 4, 2)(*args)
    with pytest.raises(ValueError, match="UPGO: bootstrap_values"):
        ops.UPGO(6, 4, 3)(*args[:4], args[4][:-1])


def _bad_upgo_args(case, x):
    """The five upgo_loss arguments with one made wrong."""
    args = {k: x[k] for k in ("logits", "rhos", "action", "reward", "value")}
    if case == "rhos":
        args["rhos"] = args["rhos"][:-1]
    elif case == "rewards":
        args["reward"] = args["reward"][:, :-1]
    elif case == "bootstrap_values":
        args["value"] = args["value"][:-1]
    elif case == "float_action":
        args["action"] = args["action"].astype(np.float32)
    elif case == "logits":
        args["logits"] = args["logits"][:, :-1]
    return list(args.values())


@pytest.mark.parametrize("case", ["rhos", "rewards", "bootstrap_values",
                                  "float_action", "logits"])
def test_check_upgo_errors_match_jax(case):
    """check_upgo raises a ValueError naming the op, with the JAX package's
    message."""
    x = _upgo_inputs(47, 5, 3, N=4)
    bad = _bad_upgo_args(case, x)
    with pytest.raises(ValueError) as jax_err:
        jax_ops.upgo_loss(*map(jnp.asarray, bad))
    with pytest.raises(ValueError) as port_err:
        ops.upgo_loss(*_t(*bad))
    assert str(port_err.value).startswith("upgo_loss: ")
    if case == "float_action":
        # check_categorical names the framework's type: "integer array; got
        # dtype float32" there, "integer tensor; got dtype torch.float32"
        # here.
        for err in (jax_err, port_err):
            assert "upgo_loss: action must be an integer" in str(err.value)
    else:
        assert str(port_err.value) == str(jax_err.value)
