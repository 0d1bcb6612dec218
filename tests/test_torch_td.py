"""The port's batch-bound TD family (di_hpc_tpu_torch: the 13 TD names of
origin, the 14 of ops, check_nstep, and one step of chip_smoke.py's R2D2
learner) against the JAX package's, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both
sides.  The JAX side runs under `jax.default_matmul_precision("float32")`,
so both sides compute in full float32.  Tolerances: rtol=1e-4, atol=1e-5,
as the JAX package's own op tests use; gradients that sum over the batch
also get 1e-4 times the tensor's largest entry (chip_smoke.GRAD_ATOL_REL).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from di_hpc_tpu import ops as jax_ops
from di_hpc_tpu import origin as jax_origin

from di_hpc_tpu_torch import kernels, models, ops, origin

RTOL, ATOL = 1e-4, 1e-5

OPS_NAMES = ["q_nstep_td_error", "q_nstep_td_error_with_rescale",
             "dist_nstep_td_error", "qrdqn_nstep_td_error",
             "iqn_nstep_td_error", "q_nstep_td_data", "dist_nstep_td_data",
             "qrdqn_nstep_td_data", "iqn_nstep_td_data", "QNStepTD",
             "QNStepTDRescale", "DistNStepTD", "QRDQNNStepTDError",
             "IQNNStepTDError"]
ORIGIN_NAMES = ["value_transform", "value_inv_transform", "nstep_return",
                "nstep_return_data", "q_nstep_td_data", "q_nstep_td_error",
                "q_nstep_td_error_with_rescale", "dist_nstep_td_data",
                "dist_nstep_td_error", "qrdqn_nstep_td_data",
                "qrdqn_nstep_td_error", "iqn_nstep_td_data",
                "iqn_nstep_td_error"]
# (port module, JAX module) of each side.
SIDES = {"origin": (origin, jax_origin), "ops": (ops, jax_ops)}


def _close(got, want, msg="", atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=atol,
                               err_msg=msg)


def _grad_close(got, want, msg=""):
    atol = ATOL + chip_smoke.GRAD_ATOL_REL * float(np.abs(want).max())
    _close(got, want, msg, atol=atol)


def _both(arrays):
    """The numpy arrays as (torch tensors, JAX arrays), None kept."""
    t = {k: None if v is None else torch.from_numpy(np.asarray(v))
         for k, v in arrays.items()}
    j = {k: None if v is None else jnp.asarray(v) for k, v in arrays.items()}
    return t, j


def _common(rng, B, N, nstep, weight):
    return {"action": rng.integers(0, N, (B,)),
            "next_n_action": rng.integers(0, N, (B,)),
            "reward": rng.standard_normal((nstep, B), dtype=np.float32),
            "done": (rng.uniform(0, 1, (B,)) > 0.5).astype(np.float32),
            "weight": (rng.uniform(0.5, 1.5, weight).astype(np.float32)
                       if weight else None)}


def _q_arrays(seed, B=9, N=5, nstep=3, weight=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return {"q": f(B, N), "next_n_q": f(B, N),
            **_common(rng, B, N, nstep, weight)}


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _dist_arrays(seed, B=6, N=4, n_atom=11, nstep=2, weight=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    c = _common(rng, B, N, nstep, weight)
    return {"dist": _softmax(f(B, N, n_atom)),
            "next_n_dist": _softmax(f(B, N, n_atom)),
            "act": c.pop("action"), "next_n_act": c.pop("next_n_action"),
            **c}


def _qr_arrays(seed, B=5, N=3, tau=7, nstep=2, weight=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return {"q": f(B, N, tau), "next_n_q": f(B, N, tau),
            **_common(rng, B, N, nstep, weight),
            "tau": ((np.arange(tau) + 0.5) / tau).astype(np.float32)}


def _iqn_arrays(seed, tau=5, tau_prime=6, B=4, N=3, nstep=2, weight=None):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)
    return {"q": f(tau, B, N), "next_n_q": f(tau_prime, B, N),
            **_common(rng, B, N, nstep, weight),
            "replay_quantiles": rng.uniform(0, 1, (tau, B)).astype(
                np.float32)}


def _run(port_fn, jax_fn, tuple_name, arrays, grad_of, port_mod, jax_mod,
         *args, **kwargs):
    """The op on both sides: (port loss, per-sample errors, d loss / d
    grad_of) and JAX's, the JAX gradient by jax.grad."""
    t, j = _both(arrays)
    leaf = t[grad_of].clone().requires_grad_(True)
    loss, per = port_fn(getattr(port_mod, tuple_name)(
        **{**t, grad_of: leaf}), *args, **kwargs)
    loss.backward()

    def jloss(x):
        return jax_fn(getattr(jax_mod, tuple_name)(**{**j, grad_of: x}),
                      *args, **kwargs)

    with jax.default_matmul_precision("float32"):
        j_loss, j_per = jloss(j[grad_of])
        j_grad = jax.grad(lambda x: jloss(x)[0])(j[grad_of])
    return (loss, per, leaf.grad), (j_loss, j_per, j_grad)


def _check(got, want, name):
    for g, w, what in zip(got, want, ("loss", "per-sample", "grad")):
        if what == "grad":
            _grad_close(g, w, f"{name} {what}")
        else:
            _close(g, w, f"{name} {what}")


# ---------------------------------------------------------------------------
# names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("side,names", [("ops", OPS_NAMES),
                                        ("origin", ORIGIN_NAMES)])
def test_td_names_are_exported_as_in_jax(side, names):
    port, jx = SIDES[side]
    for name in names:
        assert hasattr(jx, name), name
        assert hasattr(port, name), name
    if side == "ops":
        assert set(ops.td.__all__) == set(jax_ops.td.__all__)


# ---------------------------------------------------------------------------
# value rescale and n-step return
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [None, 0.1])
def test_value_transforms_match_jax(eps):
    x = np.random.default_rng(1).standard_normal(257).astype(np.float32) * 20
    kw = {} if eps is None else {"eps": eps}
    for name in ("value_transform", "value_inv_transform"):
        got = getattr(origin, name)(torch.from_numpy(x), **kw)
        _close(got, getattr(jax_origin, name)(jnp.asarray(x), **kw), name)
        assert getattr(ops, name) is getattr(origin, name)


@pytest.mark.parametrize("nstep", [1, 3])
def test_nstep_return_matches_jax(nstep):
    rng = np.random.default_rng(2)
    arrays = {"reward": rng.standard_normal((nstep, 7), dtype=np.float32),
              "next_value": rng.standard_normal(7, dtype=np.float32),
              "done": rng.uniform(0, 1, 7) > 0.5}
    t, j = _both(arrays)
    got = origin.nstep_return(origin.nstep_return_data(**t), 0.95, nstep)
    want = jax_origin.nstep_return(jax_origin.nstep_return_data(**j), 0.95,
                                   nstep)
    _close(got, want)
    assert ops.nstep_return is origin.nstep_return
    assert ops.nstep_return_data is origin.nstep_return_data


# ---------------------------------------------------------------------------
# q_nstep and its rescaled form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight", [None, 9])
@pytest.mark.parametrize("fn", ["q_nstep_td_error",
                                "q_nstep_td_error_with_rescale"])
@pytest.mark.parametrize("side", ["origin", "ops"])
def test_q_nstep_matches_jax(side, fn, weight):
    """The loss, the per-sample errors and the gradient in q (only the taken
    actions' entries), the target detached."""
    port, jx = SIDES[side]
    got, want = _run(getattr(port, fn), getattr(jx, fn), "q_nstep_td_data",
                     _q_arrays(3, weight=weight), "q", port, jx, 0.95, 3)
    _check(got, want, f"{side}.{fn}")
    mask = torch.zeros_like(got[2], dtype=torch.bool)
    mask[torch.arange(9), torch.from_numpy(_q_arrays(3)["action"])] = True
    assert float(got[2][~mask].abs().max()) == 0.0


def test_q_nstep_criterion_and_transforms_can_be_overridden():
    """A Huber criterion for q_nstep, and value_transform with another eps
    (and its inverse) for the rescaled form, on both sides."""
    def huber(xp):
        return lambda p, t: xp.where(abs(p - t) < 1, 0.5 * (p - t) ** 2,
                                     abs(p - t) - 0.5)

    t, j = _both(_q_arrays(4, weight=9))
    port_huber = huber(torch)
    jax_huber = huber(jnp)
    loss, per = ops.q_nstep_td_error(ops.q_nstep_td_data(**t), 0.9, 3,
                                     criterion=port_huber)
    j_loss, j_per = jax_ops.q_nstep_td_error(
        jax_ops.q_nstep_td_data(**j), 0.9, 3, criterion=jax_huber)
    _close(loss, j_loss, "huber loss")
    _close(per, j_per, "huber per-sample")

    def port_trans(x):
        return origin.value_transform(x, 0.1)

    def port_inv(x):
        return origin.value_inv_transform(x, 0.1)

    def jax_trans(x):
        return jax_origin.value_transform(x, 0.1)

    def jax_inv(x):
        return jax_origin.value_inv_transform(x, 0.1)

    for side, (port, jx) in SIDES.items():
        loss, per = port.q_nstep_td_error_with_rescale(
            port.q_nstep_td_data(**t), 0.9, 3, port_huber, port_trans,
            port_inv)
        j_loss, j_per = jx.q_nstep_td_error_with_rescale(
            jx.q_nstep_td_data(**j), 0.9, 3, jax_huber, jax_trans, jax_inv)
        _close(loss, j_loss, f"{side} rescale loss")
        _close(per, j_per, f"{side} rescale per-sample")


# ---------------------------------------------------------------------------
# C51
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weight", [None, 6, (6, 1)])
@pytest.mark.parametrize("side", ["origin", "ops"])
def test_dist_nstep_matches_jax(side, weight):
    """The loss, the per-sample cross-entropies and the gradient in dist; a
    (B,) weight is expanded to a column, a (B, 1) one taken as it is."""
    port, jx = SIDES[side]
    got, want = _run(port.dist_nstep_td_error, jx.dist_nstep_td_error,
                     "dist_nstep_td_data", _dist_arrays(5, weight=weight),
                     "dist", port, jx, 0.95, -5.0, 5.0, 11, 2)
    _check(got, want, f"{side}.dist_nstep_td_error")


@pytest.mark.parametrize("side", ["origin", "ops"])
def test_dist_nstep_integer_landing_drops_mass(side):
    """A target that lands exactly on an atom (l == u) gets both weights
    zero, on both sides: the mass is dropped, as in the reference
    (tests/test_td.py::test_dist_nstep_integer_landing_drops_mass)."""
    port, jx = SIDES[side]
    B, N, n_atom = 1, 1, 5
    ndist = np.zeros((B, N, n_atom), np.float32)
    ndist[0, 0, 2] = 1.0
    arrays = {"dist": np.full((B, N, n_atom), 0.2, np.float32),
              "next_n_dist": ndist, "act": np.zeros(B, np.int64),
              "next_n_act": np.zeros(B, np.int64),
              "reward": np.zeros((1, B), np.float32),
              "done": np.ones(B, np.float32), "weight": None}
    got, want = _run(port.dist_nstep_td_error, jx.dist_nstep_td_error,
                     "dist_nstep_td_data", arrays, "dist", port, jx, 0.9,
                     -2.0, 2.0, n_atom, 1)
    assert float(got[1][0].detach()) == float(want[1][0]) == 0.0
    assert float(got[2].abs().max()) == 0.0


@pytest.mark.parametrize("seed", range(6))
def test_dist_dense_projection_equals_the_scatter(seed):
    """ops' dense projection against origin's scatter-add, both the port's,
    across random shapes, supports, nsteps, weights and dones (some with
    every sample done, whose targets land on the reward)."""
    rng = np.random.default_rng(100 + seed)
    B, N = int(rng.integers(2, 17)), int(rng.integers(2, 9))
    n_atom, nstep = int(rng.integers(2, 41)), int(rng.integers(1, 5))
    v_min = float(-rng.uniform(1, 10))
    v_max = float(rng.uniform(1, 10))
    arrays = _dist_arrays(200 + seed, B, N, n_atom, nstep,
                          weight=B if seed % 2 else None)
    if seed == 0:
        arrays["done"][:] = 1.0
        arrays["reward"] = np.round(arrays["reward"])
    t, _ = _both(arrays)
    got = ops.dist_nstep_td_error(ops.dist_nstep_td_data(**t), 0.9, v_min,
                                  v_max, n_atom, nstep)
    want = origin.dist_nstep_td_error(origin.dist_nstep_td_data(**t), 0.9,
                                      v_min, v_max, n_atom, nstep)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# QR-DQN and IQN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value_gamma", [False, True])
@pytest.mark.parametrize("tau_layout", ["(tau,)", "(1, tau, 1)"])
@pytest.mark.parametrize("side", ["origin", "ops"])
def test_qrdqn_matches_jax(side, tau_layout, value_gamma):
    """The (B, 1, tau) targets broadcast against the (B, tau, 1)
    predictions into the (B, tau, tau) pairwise loss; the quantiles broadcast
    along the targets' axis, (tau,), or the predictions', (1, tau, 1)."""
    port, jx = SIDES[side]
    arrays = _qr_arrays(6, weight=5)
    if tau_layout != "(tau,)":
        arrays["tau"] = arrays["tau"][None, :, None]
    kw = {}
    if value_gamma:
        vg = np.random.default_rng(7).uniform(0.5, 1.0, 5).astype(np.float32)
        kw = {"value_gamma": vg}
    t_kw = {k: torch.from_numpy(v) for k, v in kw.items()}
    j_kw = {k: jnp.asarray(v) for k, v in kw.items()}
    t, j = _both(arrays)
    leaf = t["q"].clone().requires_grad_(True)
    loss, per = port.qrdqn_nstep_td_error(
        port.qrdqn_nstep_td_data(**{**t, "q": leaf}), 0.95, 2, **t_kw)
    loss.backward()
    jloss = lambda q: jx.qrdqn_nstep_td_error(
        jx.qrdqn_nstep_td_data(**{**j, "q": q}), 0.95, 2, **j_kw)
    with jax.default_matmul_precision("float32"):
        j_loss, j_per = jloss(j["q"])
        j_grad = jax.grad(lambda q: jloss(q)[0])(j["q"])
    assert tuple(per.shape) == (5,)
    _check((loss, per, leaf.grad), (j_loss, j_per, j_grad),
           f"{side}.qrdqn {tau_layout}")


@pytest.mark.parametrize("value_gamma", [False, True])
@pytest.mark.parametrize("rq_layout", ["(tau, B)", "(tau, B, 1)", "flat"])
@pytest.mark.parametrize("side", ["origin", "ops"])
def test_iqn_matches_jax(side, rq_layout, value_gamma):
    """IQN on the (tau, B, N) layout; replay_quantiles in any layout with
    tau * B elements; value_gamma given or gamma^nstep."""
    port, jx = SIDES[side]
    arrays = _iqn_arrays(8, weight=4)
    rq = arrays["replay_quantiles"]
    arrays["replay_quantiles"] = {"(tau, B)": rq, "(tau, B, 1)": rq[..., None],
                                  "flat": rq.reshape(-1)}[rq_layout]
    kw = {"kappa": 0.9}
    if value_gamma:
        kw["value_gamma"] = np.random.default_rng(9).uniform(
            0.5, 1.0, 4).astype(np.float32)
    t_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    j_kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    t, j = _both(arrays)
    leaf = t["q"].clone().requires_grad_(True)
    loss, per = port.iqn_nstep_td_error(
        port.iqn_nstep_td_data(**{**t, "q": leaf}), 0.95, 2, **t_kw)
    loss.backward()
    jloss = lambda q: jx.iqn_nstep_td_error(
        jx.iqn_nstep_td_data(**{**j, "q": q}), 0.95, 2, **j_kw)
    with jax.default_matmul_precision("float32"):
        j_loss, j_per = jloss(j["q"])
        j_grad = jax.grad(lambda q: jloss(q)[0])(j["q"])
    _check((loss, per, leaf.grad), (j_loss, j_per, j_grad),
           f"{side}.iqn {rq_layout}")


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _wrapper_calls(value_gamma):
    """(name, constructor arguments, numpy call arguments, keyword
    arguments) of each wrapper; T is the n-step horizon."""
    B, N, T, tau, n_atom = 8, 4, 3, 5, 11
    q = _q_arrays(10, B, N, T)
    d = _dist_arrays(11, B, N, n_atom, T)
    qr = _qr_arrays(12, B, N, tau, T)
    iq = _iqn_arrays(13, tau, tau + 1, B, N, T)
    vg = np.random.default_rng(14).uniform(0.5, 1.0, B).astype(np.float32)
    extra = {"value_gamma": vg} if value_gamma else {}
    order = ("action", "next_n_action", "reward", "done")
    return [
        ("QNStepTD", (T, B, N), [q["q"], q["next_n_q"],
                                 *(q[k] for k in order)], {"gamma": 0.95}),
        ("QNStepTDRescale", (T, B, N), [q["q"], q["next_n_q"],
                                        *(q[k] for k in order)],
         {"gamma": 0.95}),
        ("DistNStepTD", (T, B, N, n_atom),
         [d["dist"], d["next_n_dist"], d["act"], d["next_n_act"],
          d["reward"], d["done"]], {"gamma": 0.95, "v_min": -5.0,
                                    "v_max": 5.0}),
        ("QRDQNNStepTDError", (tau, T, B, N),
         [qr["q"], qr["next_n_q"], *(qr[k] for k in order), qr["tau"]],
         {"gamma": 0.95, **extra}),
        ("IQNNStepTDError", (tau, tau + 1, T, B, N),
         [iq["q"], iq["next_n_q"], *(iq[k] for k in order),
          iq["replay_quantiles"]], {"gamma": 0.95, "kappa": 0.9, **extra})]


@pytest.mark.parametrize("index,value_gamma", [
    (0, False), (1, False), (2, False), (3, False), (3, True), (4, False),
    (4, True)])
def test_td_wrappers_match_jax(index, value_gamma):
    """Each wrapper against JAX's; QR-DQN's and IQN's value_gamma given or
    defaulted to gamma^T per sample."""
    name, ctor, args, kw = _wrapper_calls(value_gamma)[index]
    t_args = [torch.from_numpy(np.asarray(a)) for a in args]
    j_args = [jnp.asarray(a) for a in args]
    t_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    j_kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()}
    loss, per = getattr(ops, name)(*ctor)(*t_args, **t_kw)
    with jax.default_matmul_precision("float32"):
        j_loss, j_per = getattr(jax_ops, name)(*ctor)(*j_args, **j_kw)
    _close(loss, j_loss, f"{name} loss")
    _close(per, j_per, f"{name} per-sample")


def test_td_wrappers_refuse_a_wrong_shape():
    name, ctor, args, kw = _wrapper_calls(False)[0]
    t_args = [torch.from_numpy(np.asarray(a)) for a in args]
    with pytest.raises(ValueError, match="QNStepTD: q must be"):
        ops.QNStepTD(ctor[0], ctor[1] + 1, ctor[2])(*t_args, **kw)


# ---------------------------------------------------------------------------
# check_nstep
# ---------------------------------------------------------------------------

_B, _N = 4, 5


def _z(*s):
    return np.zeros(s, np.float32)


def _zi(*s):
    return np.zeros(s, np.int64)


# (op, its data tuple, the tuple's fields, keyword arguments): the cases of
# tests/test_validation.py:58-97, then the other checks of check_nstep.
VALIDATION_CASES = {
    "q_nstep reward nstep": (
        "q_nstep_td_error", "q_nstep_td_data",
        (_z(_B, _N), _z(_B, _N), _zi(_B), _zi(_B), _z(2, _B), _z(_B), None),
        {"gamma": 0.99, "nstep": 3}),
    "rescale action shape": (
        "q_nstep_td_error_with_rescale", "q_nstep_td_data",
        (_z(_B, _N), _z(_B, _N), _zi(_B + 1), _zi(_B), _z(1, _B), _z(_B),
         None), {"gamma": 0.99}),
    "dist n_atom": (
        "dist_nstep_td_error", "dist_nstep_td_data",
        (_z(_B, _N, 11), _z(_B, _N, 11), _zi(_B), _zi(_B), _z(1, _B),
         _z(_B), None),
        {"gamma": 0.99, "v_min": -5.0, "v_max": 5.0, "n_atom": 21}),
    "qrdqn rank": (
        "qrdqn_nstep_td_error", "qrdqn_nstep_td_data",
        (_z(_B, _N), _z(_B, _N), _zi(_B), _zi(_B), _z(1, _B), _z(_B), _z(3),
         None), {"gamma": 0.99}),
    "iqn replay_quantiles": (
        "iqn_nstep_td_error", "iqn_nstep_td_data",
        (_z(3, _B, _N), _z(3, _B, _N), _zi(_B), _zi(_B), _z(1, _B), _z(_B),
         _z(4, _B), None), {"gamma": 0.99}),
    "next_n_q rank": (
        "q_nstep_td_error", "q_nstep_td_data",
        (_z(_B, _N), _z(_B, _N, 1), _zi(_B), _zi(_B), _z(1, _B), _z(_B),
         None), {"gamma": 0.99}),
    "float action": (
        "q_nstep_td_error", "q_nstep_td_data",
        (_z(_B, _N), _z(_B, _N), _z(_B), _zi(_B), _z(1, _B), _z(_B), None),
        {"gamma": 0.99}),
    "done shape": (
        "q_nstep_td_error", "q_nstep_td_data",
        (_z(_B, _N), _z(_B, _N), _zi(_B), _zi(_B), _z(1, _B), _z(_B, 1),
         None), {"gamma": 0.99}),
    "column weight": (
        "q_nstep_td_error", "q_nstep_td_data",
        (_z(_B, _N), _z(_B, _N), _zi(_B), _zi(_B), _z(1, _B), _z(_B),
         _z(_B, 1)), {"gamma": 0.99}),
    "dist weight": (
        "dist_nstep_td_error", "dist_nstep_td_data",
        (_z(_B, _N, 11), _z(_B, _N, 11), _zi(_B), _zi(_B), _z(1, _B),
         _z(_B), _z(_B, 2)),
        {"gamma": 0.99, "v_min": -5.0, "v_max": 5.0, "n_atom": 11}),
    "iqn batch axis": (
        "iqn_nstep_td_error", "iqn_nstep_td_data",
        (_z(3, _B, _N), _z(3, _B, _N), _zi(3), _zi(_B), _z(1, _B), _z(_B),
         _z(3, _B), None), {"gamma": 0.99}),
}


@pytest.mark.parametrize("case", list(VALIDATION_CASES))
def test_check_nstep_raises_with_the_jax_message(case):
    """A malformed call raises a ValueError that names the op and the
    argument, with the JAX package's message word for word (the integer
    check names each side's dtype)."""
    op, tuple_name, fields, kw = VALIDATION_CASES[case]
    with pytest.raises(ValueError) as jax_err:
        getattr(jax_ops, op)(getattr(jax_origin, tuple_name)(
            *(None if f is None else jnp.asarray(f) for f in fields)), **kw)
    with pytest.raises(ValueError) as port_err:
        getattr(ops, op)(getattr(origin, tuple_name)(
            *(None if f is None else torch.from_numpy(f) for f in fields)),
            **kw)
    want, got = str(jax_err.value), str(port_err.value)
    assert got.startswith(f"{op}: ")
    if case == "float action":
        assert got == f"{op}: action must be an integer tensor; got " \
                      f"torch.float32"
        assert want.startswith(f"{op}: action must be an integer array")
    else:
        assert got == want


def test_check_nstep_admits_a_column_weight_for_dist_only():
    """dist_nstep_td_error takes a (B, 1) weight and expands a (B,) one;
    q_nstep refuses (B, 1) (it would broadcast to a (B, B) mean)."""
    fields = (_z(_B, _N, 11), _z(_B, _N, 11), _zi(_B), _zi(_B), _z(1, _B),
              _z(_B), np.ones((_B, 1), np.float32))
    ops.dist_nstep_td_error(ops.dist_nstep_td_data(
        *(torch.from_numpy(f) for f in fields)), 0.99, -5.0, 5.0, 11)
    _, _, case_fields, _ = VALIDATION_CASES["column weight"]
    with pytest.raises(ValueError, match="weight must have shape"):
        ops.q_nstep_td_error(ops.q_nstep_td_data(
            *(None if f is None else torch.from_numpy(f)
              for f in case_fields)), 0.99)


# ---------------------------------------------------------------------------
# the R2D2 learner
# ---------------------------------------------------------------------------

def _r2d2_example():
    """examples/r2d2_training.py as a module (R2D2Params and q_values)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "r2d2_training.py")
    spec = importlib.util.spec_from_file_location("r2d2_training", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


R2D2_SMALL = {"S": 8, "burn_in": 2, "B": 4, "obs_dim": 16, "hidden": 16,
              "actions": 8, "nstep": 2, "layers": 1, "gamma": 0.99}


def _jax_r2d2_params(example, arrays):
    j = lambda a: jnp.asarray(a)
    lstm = jax_origin.LSTMParams(
        *(tuple(map(j, f)) if isinstance(f, tuple) else j(f)
          for f in arrays.lstm))
    return example.R2D2Params(j(arrays.embed_w), j(arrays.embed_b), lstm,
                              j(arrays.q_w), j(arrays.q_b))


def _jax_r2d2_step(example, params, target_params, batch, S, burn_in, nstep,
                   gamma, **_):
    """The example's train_step (:64-128) on a given replay sample, with
    optax.adam(1e-3): (loss, grads, updated params, priorities)."""
    W = S - burn_in - nstep
    obs, act, reward = batch["obs"], batch["act"], batch["reward"]
    done, weight = batch["done"], batch["weight"]
    stored = (batch["stored_h"], batch["stored_c"])
    q_values = example.q_values
    _, bi_state = q_values(params, obs[:burn_in], stored)
    bi_state = jax.lax.stop_gradient(bi_state)
    _, bi_state_t = q_values(target_params, obs[:burn_in], stored)
    q_tgt, _ = q_values(target_params, obs[burn_in:], bi_state_t)
    q_sel, _ = q_values(params, obs[burn_in:], bi_state)
    next_act = jnp.argmax(jax.lax.stop_gradient(q_sel), axis=-1)

    def loss_fn(p):
        q, _ = q_values(p, obs[burn_in:burn_in + W], bi_state)

        def one_step(q_t, next_q_t, a_t, na_t, r_win, d_t):
            return jax_ops.q_nstep_td_error_with_rescale(
                jax_origin.q_nstep_td_data(q_t, next_q_t, a_t, na_t, r_win,
                                           d_t, weight),
                gamma=gamma, nstep=nstep)

        r_wins = jnp.stack([reward[burn_in + t: burn_in + t + nstep]
                            for t in range(W)])
        d_raw = jnp.stack([done[burn_in + t: burn_in + t + nstep]
                           for t in range(W)])
        d_wins = d_raw.any(axis=1)
        alive = jnp.cumprod(1.0 - d_raw.astype(r_wins.dtype), axis=1)
        alive = jnp.concatenate([jnp.ones_like(alive[:, :1]),
                                 alive[:, :-1]], axis=1)
        r_wins = r_wins * alive
        losses, td = jax.vmap(one_step)(
            q, q_tgt[nstep:nstep + W], act[burn_in:burn_in + W],
            next_act[nstep:nstep + W], r_wins, d_wins)
        return jnp.mean(losses), td

    (loss, td), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    opt = optax.adam(1e-3)
    updates, _ = opt.update(grads, opt.init(params), params)
    per_seq = jnp.abs(td)
    priorities = (0.9 * jnp.max(per_seq, axis=0)
                  + 0.1 * jnp.mean(per_seq, axis=0))
    return loss, grads, optax.apply_updates(params, updates), priorities


def _port_names(arrays_tree):
    """The port module's parameter names of the R2D2Params fields, in the
    order jax.tree_util flattens them."""
    names = ["embed_w", "embed_b"]
    names += [f"lstm.wx.{i}" for i in range(len(arrays_tree.lstm.wx))]
    names += [f"lstm.wh.{i}" for i in range(len(arrays_tree.lstm.wh))]
    names += ["lstm.bias", "lstm.ln_gamma_x", "lstm.ln_beta_x",
              "lstm.ln_gamma_h", "lstm.ln_beta_h", "q_w", "q_b"]
    return names


def test_r2d2_params_carry_over_and_back():
    arrays = chip_smoke.r2d2_arrays(np.random.default_rng(15), **R2D2_SMALL)
    p = models.from_jax_params(arrays, device="cpu")
    assert isinstance(p, models.R2D2Params)
    back = models.to_numpy_params(p)
    assert isinstance(back, models.R2D2Arrays)
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(arrays)):
        np.testing.assert_array_equal(got, want)
    assert sorted(k for k, _ in p.named_parameters()) == sorted(
        _port_names(arrays))


def test_r2d2_step_matches_jax():
    """One step of chip_smoke.py's R2D2 learner (burn-in without gradient,
    double-DQN argmax, the masked reward windows,
    ops.q_nstep_td_error_with_rescale over the window, torch.optim.Adam(1e-3))
    at S=8, burn-in 2, B=4, H=16, nstep 2 against the example's step on the
    JAX package with optax.adam(1e-3), from the same numpy weights and
    replay sample: the loss, every gradient, the updated parameters and the
    priorities."""
    cfg = R2D2_SMALL
    rng = np.random.default_rng(16)
    arrays = chip_smoke.r2d2_arrays(rng, **cfg)
    batch = chip_smoke.r2d2_batches(rng, 1, **cfg)[0]
    example = _r2d2_example()
    jp = _jax_r2d2_params(example, arrays)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        want_loss, want_g, want_p, want_prio = _jax_r2d2_step(
            example, jp, jp, jb, **cfg)

    kernels.reset_launch_counts()
    p, target_p, opt, (x,) = chip_smoke.r2d2_setup(arrays, [batch],
                                                   torch.device("cpu"))
    metrics, got_g, _, _ = chip_smoke.r2d2_step(p, target_p, opt, x,
                                                cfg=cfg)
    assert set(kernels.launch_counts().values()) == {0}   # CPU: plain only
    _close(metrics["loss"], want_loss, "loss")
    _close(metrics["priorities"], want_prio, "priorities")
    names = _port_names(arrays)
    want_g = dict(zip(names, jax.tree_util.tree_leaves(want_g)))
    want_p = dict(zip(names, jax.tree_util.tree_leaves(want_p)))
    assert set(want_g) == set(got_g)
    for k, w in want_g.items():
        _grad_close(got_g[k], w, f"grad {k}")
    chip_smoke.check_adam_params(
        "r2d2", dict(p.named_parameters()),
        {k: torch.from_numpy(np.array(v)) for k, v in want_p.items()},
        [{k: torch.from_numpy(np.array(v)) for k, v in want_g.items()}],
        chip_smoke.R2D2_LR, 1)
