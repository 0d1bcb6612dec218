"""The port's categorical head and V-trace loss (di_hpc_tpu_torch.ops and
.origin) against the JAX package's, on the CPU; and the head's route on
the CPU (the plain body, no launch) and its kernels' wrappers where the
CPU can check them (shapes, signatures, load width, incoming-gradient
steps).

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


def test_categorical_gradients_match_jax_with_masks():
    """The stash-free backward of logp_entropy and logp against the JAX
    package's custom VJPs, with -inf masks, a mask at exactly -1e9 (the
    clamp is the identity there, so the one-hot term stays), a taken action
    at -inf and one at -3e9 (strictly below the clamp: no one-hot term), a
    fully masked row and an extreme logit."""
    x, a = _masked_logits()
    x[5, 8] = -3e9                   # taken action below the clamp
    rng = np.random.default_rng(7)
    glp, gent = (rng.standard_normal(6).astype(np.float32) for _ in range(2))

    def jax_both(z):
        lp_, ent_ = jax_ops.logp_entropy(z, jnp.asarray(a))
        return jnp.sum(lp_ * glp) + jnp.sum(ent_ * gent)

    want = np.asarray(jax.grad(jax_both)(jnp.asarray(x)))
    want_lp = np.asarray(jax.grad(lambda z: jnp.sum(
        jax_ops.logp(z, jnp.asarray(a)) * glp))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    lp, ent = ops.logp_entropy(xt, torch.from_numpy(a))
    (lp * torch.from_numpy(glp) + ent * torch.from_numpy(gent)).sum().backward()
    got = xt.grad.numpy()
    xt.grad = None
    (ops.logp(xt, torch.from_numpy(a)) * torch.from_numpy(glp)).sum().backward()
    for name, g, w in (("logp_entropy", got, want),
                       ("logp", xt.grad.numpy(), want_lp)):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=name)
    assert got[5, 8] == 0.0 and got[3, 0] == 0.0      # masked taken actions
    assert got[1, 2] != 0.0 or glp[1] == 0.0           # -1e9 keeps its term


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.float64])
@pytest.mark.parametrize("fn", ["logp_entropy", "logp"])
def test_categorical_cpu_calls_take_the_plain_route(fn, dtype):
    """CPU logits of any float dtype run the plain body (no kernel launch):
    outputs and gradients bitwise those of kernels.categorical_fwd_plain
    and categorical_bwd_plain."""
    from di_hpc_tpu_torch import kernels

    x, a = _masked_logits()
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    at = torch.from_numpy(a)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 6)).astype(np.float32))
    kernels.reset_launch_counts()
    out = getattr(ops, fn)(xt, at)
    assert set(kernels.launch_counts().values()) == {0}
    with_ent = fn == "logp_entropy"
    out = out if with_ent else (out,)
    (dx,) = torch.autograd.grad(out, xt, tuple(g[:len(out)]))
    assert set(kernels.launch_counts().values()) == {0}
    lp, ent, lse = kernels.categorical_fwd_plain(xt.detach(), at, with_ent)
    want_dx = kernels.categorical_bwd_plain(
        xt.detach(), at, lse, ent, g[0], g[1] if with_ent else None)
    wants = (lp, ent) if with_ent else (lp,)
    for got, want in zip((*out, dx), (*wants, want_dx)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert dx.dtype == dtype


@pytest.mark.parametrize("dtype,act_dtype,strided,want,want_act", [
    (torch.float32, torch.int32, False, torch.float32, torch.int32),
    (torch.bfloat16, torch.int64, False, torch.bfloat16, torch.int64),
    (torch.float16, torch.int64, False, torch.float32, torch.int64),
    (torch.float64, torch.int16, False, torch.float32, torch.int64),
    (torch.float32, torch.uint8, True, torch.float32, torch.int64),
    (torch.bfloat16, torch.int32, True, torch.bfloat16, torch.int32)])
def test_categorical_kernel_inputs(dtype, act_dtype, strided, want,
                                   want_act):
    """What the card's route hands the kernels: float32 or bfloat16 logits
    as they are and any other dtype as float32, always contiguous, with the
    same values; int32 or int64 actions as they are, any other as int64."""
    from di_hpc_tpu_torch.ops.categorical import _kernel_inputs

    x, a = _masked_logits()
    logits = torch.from_numpy(x).to(dtype)
    if strided:
        logits = torch.cat([logits, logits], dim=-1)[..., :x.shape[-1]]
    actions = torch.from_numpy(a).to(act_dtype)
    got, got_a = _kernel_inputs(logits, actions)
    assert got.dtype == want and got.is_contiguous()
    assert got_a.dtype == want_act and torch.equal(got_a.long(),
                                                   actions.long())
    assert torch.equal(got.float(), logits.float())


@pytest.mark.parametrize("name", ["categorical_fwd_f32",
                                  "categorical_fwd_bf16",
                                  "categorical_bwd_f32",
                                  "categorical_bwd_bf16"])
def test_categorical_kernels_are_exported_and_counted(name):
    """Each C entry point of csrc/categorical.cu has its ctypes signature
    (pointers, the int64 row count, the stream last) and its wrapper is
    counted by launch_counts()."""
    import ctypes

    from di_hpc_tpu_torch import kernels
    from di_hpc_tpu_torch.kernels import _build

    restype, argtypes = _build._SIGNATURES[name]
    assert restype is ctypes.c_int and argtypes[-1] is ctypes.c_void_p
    assert argtypes.count(ctypes.c_longlong) == 1
    assert len(argtypes) == (10 if "fwd" in name else 14)
    wrapper = name.rsplit("_", 1)[0]
    assert getattr(kernels, wrapper) in kernels.KERNEL_WRAPPERS
    assert kernels.launch_counts()[wrapper] == \
        getattr(kernels, wrapper).launches


@pytest.mark.parametrize("case", ["actions_rows", "actions_rank",
                                  "scalar_logits", "empty_row",
                                  "no_rows", "ent_without_gent"])
def test_categorical_wrappers_raise_on_shapes_they_do_not_take(case):
    """The kernels' wrappers check shapes on either device: actions shaped
    like the logits' rows, logits (..., N) with N >= 1 and a row, and ent
    and gent together."""
    from di_hpc_tpu_torch import kernels

    x = torch.zeros(3, 4, 5)
    a = torch.zeros(3, 4, dtype=torch.int64)
    lse = torch.zeros(3, 4)
    calls = {
        "actions_rows": lambda: kernels.categorical_fwd(x, a[:2]),
        "actions_rank": lambda: kernels.categorical_bwd(
            x, a[..., None], lse, None, lse, None),
        "scalar_logits": lambda: kernels.categorical_fwd(
            torch.tensor(1.0), torch.tensor(0)),
        "empty_row": lambda: kernels.categorical_fwd(
            torch.zeros(3, 0), torch.zeros(3, dtype=torch.int64)),
        "no_rows": lambda: kernels.categorical_bwd(
            torch.zeros(0, 5), torch.zeros(0, dtype=torch.int64),
            torch.zeros(0), None, torch.zeros(0), None),
        "ent_without_gent": lambda: kernels.categorical_bwd(
            x, a, lse, lse, lse, None)}
    match = "ent and gent" if case == "ent_without_gent" else \
        "actions must be" if case.startswith("actions") else "logits must be"
    with pytest.raises(ValueError, match=match):
        calls[case]()


@pytest.mark.parametrize("N,offset,dtype,want", [
    (128, 0, torch.float32, 4), (1000, 0, torch.float32, 4),
    (127, 0, torch.float32, 1), (9, 0, torch.bfloat16, 1),
    (128, 1, torch.float32, 1), (128, 2, torch.float32, 1),
    (128, 4, torch.float32, 4), (128, 2, torch.bfloat16, 1),
    (128, 4, torch.bfloat16, 4)])
def test_categorical_load_width(N, offset, dtype, want):
    """A lane reads 4 logits where N % 4 == 0 and the logits start on a
    4-element boundary (16 bytes of float32, 8 of bf16), else 1."""
    from di_hpc_tpu_torch.kernels.categorical import load_width

    base = torch.zeros(2 * N + 8, dtype=dtype)[offset:]
    assert load_width(N, base.data_ptr(), base.element_size()) == want


@pytest.mark.parametrize("kind,step", [("mean", 1), ("sum", 0),
                                       ("dense", 1), ("transposed", 1),
                                       ("row_broadcast", 1)])
def test_categorical_row_gradient_steps(kind, step):
    """An incoming gradient that is one value over every row (a sum's) is
    read in place with step 0; any other (a mean's, which autograd makes
    dense) becomes a dense float32 plane of the logits' rows, equal to the
    gradient."""
    from di_hpc_tpu_torch.kernels.categorical import row_gradient

    logits = torch.zeros(4, 6, 3)
    lp = torch.zeros(4, 6, requires_grad=True)
    rng = torch.Generator().manual_seed(5)
    w = torch.randn(6, 4, generator=rng)
    loss = {"mean": lambda: lp.mean(), "sum": lambda: lp.sum(),
            "dense": lambda: (lp * w.t().contiguous()).sum(),
            "transposed": lambda: (lp * w.t()).sum(),
            "row_broadcast": lambda: (lp * w[:1, :].t()).sum()}[kind]()
    (g,) = torch.autograd.grad(loss, lp)
    got, got_step = row_gradient("categorical_bwd", "glp", g, logits)
    assert got_step == step and got.dtype == torch.float32
    if step == 1:
        assert got.is_contiguous() and torch.equal(got, g)
    else:
        assert torch.equal(got.expand(4, 6), g) and \
            got.stride() == (0, 0)


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


def _vtrace_rank3_np(seed, T, B, E, N, weighted):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    w = rng.uniform(0, 2, (T, B, E)).astype(np.float32) if weighted else None
    return (f(T, B, E, N), f(T, B, E, N), rng.integers(0, N, (T, B, E)),
            f(T + 1, B, E), f(T, B, E), w)


def _vtrace_losses_and_grads(data, **kw):
    """JAX's and the port's vtrace_error on `data`: the three losses and the
    gradients of policy + 0.5 * value - 0.01 * entropy in the target logits
    and the value, as numpy arrays."""
    def jax_total(to, v):
        d = [None if a is None else jnp.asarray(a) for a in data]
        d[0], d[3] = to, v
        l = jax_ops.vtrace_error(jax_ops.vtrace_data(*d), **kw)
        return l.policy_loss + 0.5 * l.value_loss - 0.01 * l.entropy_loss, l

    (_, jl), jg = jax.value_and_grad(jax_total, argnums=(0, 1), has_aux=True)(
        jnp.asarray(data[0]), jnp.asarray(data[3]))
    t = _to_torch(data, requires_grad=(0, 3))
    tl = ops.vtrace_error(ops.vtrace_data(*t), **kw)
    (tl.policy_loss + 0.5 * tl.value_loss - 0.01 * tl.entropy_loss).backward()
    return ([np.asarray(x) for x in (*jl, *jg)],
            [x.detach().numpy() for x in (*tl, t[0].grad, t[3].grad)])


@pytest.mark.parametrize("weighted", [False, True])
def test_vtrace_error_rank3_matches_jax(weighted):
    """(T, B, E) inputs: the kernels take (T, B) planes only, so both sides
    compose the scan core (ops/vtrace.py's fused_kernels_ok gate): the
    losses and the gradients in the target logits and the value."""
    data = _vtrace_rank3_np(7, 5, 3, 2, 4, weighted)
    want, got = _vtrace_losses_and_grads(data)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7,
                                   err_msg=f"output {i}")


@pytest.mark.parametrize("method", ["auto", "scan", "associative", "pallas"])
@pytest.mark.parametrize("weight", [None, "TB"])
def test_vtrace_error_methods_match_jax(interpret, monkeypatch, method,
                                        weight):
    """Every method at rank 2: "auto" and "pallas" take the kernels
    (vtrace_losses with unit weight, vtrace_returns_adv with a weight; their
    plain versions on the CPU), "scan" and "associative" compose the scan
    core with that method; losses and gradients match JAX's."""
    from di_hpc_tpu_torch.ops import vtrace as port_vtrace
    calls = []
    for name in ("vtrace_losses", "vtrace_returns_adv"):
        real = getattr(port_vtrace, name)
        monkeypatch.setattr(port_vtrace, name,
                            lambda *a, _r=real: calls.append(1) or _r(*a))
    data = _vtrace_np(8, 9, 6, 5, weight)
    want, got = _vtrace_losses_and_grads(data, method=method)
    assert bool(calls) == (method in ("auto", "pallas"))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=1e-7,
                                   err_msg=f"output {i}")
