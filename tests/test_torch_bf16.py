"""The bf16 leg of the port on the CPU against the JAX package: the LSTM
layer kernels' plain bf16 versions against JAX's bf16 Pallas kernels in
interpret mode (forward with and without the stash, the V2 and V1
backward), `network.lstm_fused(remat=True)` and the mixed-dtype routing
against JAX's recurrent path, one `make_train_step(compute_dtype=bf16)`
step with Adam against JAX's, and `from_jax_params` of a bf16 tree.

Inputs are made with numpy from a seed, rounded to bf16 once and handed to
both sides.  JAX takes its layer kernel on the CPU only in interpret mode at
H % 128 == 0 and S >= 8, hence H = 128, S = 9, and B = 64 (V2) or 8 (V1).

Tolerances, each against the largest |entry| of the JAX tensor:
  - BF16_REL = 1e-2 for the layer kernels' outputs and gradients: both
    sides compute the same float32 values up to summation order and round
    to bf16 at the same points; a value near a rounding boundary can round
    the other way (one bf16 ulp, 2^-8 relative) and later steps carry it
    (measured: at most 4.4e-3);
  - the train step: metrics within 2e-3, gradients within 5e-2.  Outside
    the kernel's explicit casts (the embedding bias, relu, the heads, the
    bf16 GEMMs' outputs) XLA on the CPU keeps excess precision across fused
    bf16 ops while PyTorch rounds every op's output, so the two differ by
    about one bf16 ulp there, and the bias gradients sum (T+1)*B such rows
    with cancellation (measured: 2.1e-4 and 3.5e-2);
  - the bf16 recurrent path (remat): its bf16 LayerNorm, gates and state
    update round at every op on both sides, at other points, and the
    recurrence amplifies that as it amplifies the bf16 rounding itself
    (JAX's own bf16 path is 6.3e-2 from its float32 path at this shape):
    the bounds JAX's bf16 LSTM test uses, 0.15 on outputs and 0.25 on
    gradients (tests/test_pallas_fused.py:376-397);
  - float32 (remat and the mixed-dtype forward): rtol=1e-4, atol=1e-5, as
    the JAX package's own tests use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import di_hpc_tpu.pallas_kernels.linear_scan as ls
from di_hpc_tpu.models import actor_critic_lstm as jax_ac
from di_hpc_tpu.network import lstm as jax_network_lstm
from di_hpc_tpu.origin.rnn import LSTMParams as JaxLSTMParams
from di_hpc_tpu.pallas_kernels import lstm_cell as jax_lstm_cell

from di_hpc_tpu_torch import kernels, models, network
from di_hpc_tpu_torch.network import lstm as port_network_lstm

BF16_REL = 1e-2
RTOL, ATOL = 1e-4, 1e-5
S, H = 9, 128
CFG = dict(obs_dim=20, hidden_size=H, num_layers=2, action_dim=16)


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


def _f32(x) -> np.ndarray:
    """A JAX array or a torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(arrays, jdt=jnp.bfloat16):
    """The arrays rounded to jdt once: (JAX arrays, torch tensors)."""
    j = [jnp.asarray(a, jdt) for a in arrays]
    tdt = torch.bfloat16 if jdt == jnp.bfloat16 else torch.float32
    return j, [torch.tensor(_f32(a)).to(tdt) for a in j]


def _jax_leaf(tree, name):
    """The leaf of a JAX params tree at a port parameter's dotted name."""
    for part in name.split("."):
        tree = tree[int(part)] if part.isdigit() else getattr(tree, part)
    return np.asarray(tree)


def _close_to_max(got, want, rel, name):
    got, want = _f32(got), _f32(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=name)


def _layer_arrays(seed, B):
    rng = np.random.default_rng(seed)
    G = 4 * H
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return [f(S, B, G), 0.1 * f(H, G), 1 + 0.1 * f(G), 0.1 * f(G),
            1 + 0.1 * f(G), 0.1 * f(G), 0.1 * f(G), f(B, H), f(B, H)]


@pytest.mark.parametrize("stash", [True, False])
@pytest.mark.parametrize("B", [64, 8])
def test_bf16_layer_forward_matches_jax_kernel(interpret, f32_matmuls, stash,
                                               B):
    """kernels.lstm_layer_stash / lstm_layer_fused (the plain bf16
    versions) against JAX's bf16 _layer_kernel, with and without the
    stash: every output bf16 and within BF16_REL."""
    j, t = _pair(_layer_arrays(0, B))
    want = jax_lstm_cell._layer_impl(*j, True, stash=stash)
    want = want if stash else (want[0], want[2], want[3])
    got = (kernels.lstm_layer_stash(*t) if stash
           else kernels.lstm_layer_fused(*t))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        _close_to_max(g, w, BF16_REL, f"output {i}")


# B = 64 takes the V2 backward on both sides, B = 8 the V1 backward.
@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("B", [64, 8])
def test_bf16_layer_backward_matches_jax_vjp(interpret, f32_matmuls, B,
                                             norm):
    """The 9 gradients of the bf16 layer (stash forward, then V2 or V1 and
    the sequence-wide sums) against jax.vjp of JAX's lstm_layer_fused, each
    in its input's dtype (bf16) and within BF16_REL."""
    rng = np.random.default_rng(1)
    j, t = _pair(_layer_arrays(2, B))
    jct, tct = _pair([rng.standard_normal(s).astype(np.float32)
                      for s in ((S, B, H), (B, H), (B, H))])
    _, vjp = jax.vjp(lambda *a: jax_lstm_cell.lstm_layer_fused(*a, norm), *j)
    want = vjp(tuple(jct))
    t = [x.requires_grad_() for x in t]
    kernels.reset_launch_counts()
    got = torch.autograd.grad(kernels.lstm_layer_fused(*t, norm=norm), t,
                              tct)
    assert set(kernels.launch_counts().values()) == {0}   # CPU: plain only
    names = ("dgxp", "dwh", "dglnx", "dblnx", "dgln", "dbln", "dbias", "dh0",
             "dc0")
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        _close_to_max(g, w, BF16_REL, name)


def _np_lstm_params(seed, I, L, norm=True, hidden=32):
    rng = np.random.default_rng(seed)
    g = np.sqrt(1.0 / hidden)
    u = lambda *s: rng.uniform(-g, g, s).astype(np.float32)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)
    G = 4 * hidden
    dims = [I] + [hidden] * L
    ln = ((1 + 0.1 * n(L, G), 0.1 * n(L, G), 1 + 0.1 * n(L, G),
           0.1 * n(L, G)) if norm else (None,) * 4)
    return JaxLSTMParams(tuple(u(dims[l], G) for l in range(L)),
                         tuple(u(hidden, G) for _ in range(L)), u(L, G), *ln)


def _lstm_fused_both(norm, param_dtype, input_dtype, remat):
    """lstm_fused and the gradients of a fixed loss in every parameter, the
    inputs and the state, on both sides (S=6, B=4, I=12, H=32, L=2):
    (JAX's, the port's), each a list [y, h, c, *param grads, dx, dh0, dc0]
    (parameter grads in the port's named_parameters order)."""
    S_, B, I, L = 6, 4, 12, 2
    p = _np_lstm_params(3, I, L, norm == "LN")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((S_, B, I)).astype(np.float32)
    state = [rng.standard_normal((L, B, 32)).astype(np.float32)
             for _ in range(2)]
    # A loss of O(1) gradients, the scale the float32 atol is meant for.
    ct = 0.1 * rng.standard_normal((S_, B, 32)).astype(np.float32)
    jp = jax.tree.map(lambda a: jnp.asarray(a, param_dtype), p)
    (jx, *jstate), (tx, *tstate) = _pair([x, *state], input_dtype)

    def jax_loss(params, xx, st):
        y, (h, c) = jax_network_lstm.lstm_fused(params, xx, st, norm,
                                                remat=remat)
        f = lambda a: a.astype(jnp.float32)
        return (f(y) * ct).sum() + 0.1 * (f(h).sum() + f(c).sum()), (y, h, c)

    (_, jout), jg = jax.value_and_grad(jax_loss, argnums=(0, 1, 2),
                                       has_aux=True)(jp, jx, tuple(jstate))
    mod = models.from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tx, *tstate = (a.requires_grad_() for a in (tx, *tstate))
    y, (h, c) = network.lstm_fused(mod.params(), tx, tuple(tstate), norm,
                                   remat=remat)
    ((y.float() * torch.from_numpy(ct)).sum()
     + 0.1 * (h.float().sum() + c.float().sum())).backward()

    names = [n for n, _ in mod.named_parameters()]
    want = [*jout, *(_jax_leaf(jg[0], n) for n in names), jg[1], *jg[2]]
    got = [y, h, c, *(q.grad for _, q in mod.named_parameters()), tx.grad,
           *(s.grad for s in tstate)]
    return want, got, ["y", "h", "c", *names, "dx", "dh0", "dc0"]


@pytest.fixture
def no_layer_kernel(monkeypatch):
    """Makes the layer kernel's wrapper raise inside network.lstm_fused, to
    show that a call took the recurrent path."""
    def refuse(*args, **kwargs):
        raise AssertionError("the layer kernel was called")
    monkeypatch.setattr(port_network_lstm, "lstm_layer_fused", refuse)


@pytest.mark.parametrize("norm", ["LN", None])
def test_lstm_fused_remat_matches_jax_f32(f32_matmuls, no_layer_kernel,
                                          norm):
    want, got, names = _lstm_fused_both(norm, jnp.float32, jnp.float32, True)
    for name, g, w in zip(names, got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("norm", ["LN", None])
def test_lstm_fused_remat_matches_jax_bf16(f32_matmuls, no_layer_kernel,
                                           norm):
    """bf16 params and inputs with remat: the recurrent path in bf16 on
    both sides, every output and gradient bf16, within 0.15 (outputs) and
    0.25 (gradients) of the largest |entry|."""
    want, got, names = _lstm_fused_both(norm, jnp.bfloat16, jnp.bfloat16,
                                        True)
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, name
        _close_to_max(g, w, 0.15 if i < 3 else 0.25, name)


def test_mixed_dtypes_take_the_recurrent_path(f32_matmuls, no_layer_kernel):
    """bf16 parameters with float32 inputs (Wh's dtype differs from the
    projection's): the recurrent path, with no remat, on both sides, in
    float32 as JAX promotes it; each parameter gradient comes back bf16.
    The outputs and the input/state gradients at the float32 tolerance,
    the parameter gradients (rounded to bf16 at the end) within
    BF16_REL."""
    want, got, names = _lstm_fused_both("LN", jnp.bfloat16, jnp.float32,
                                        False)
    n_params = len(names) - 6
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), name
        if 3 <= i < 3 + n_params:
            assert g.dtype == torch.bfloat16, name
            _close_to_max(g, w, BF16_REL, name)
        else:
            np.testing.assert_allclose(_f32(g), _f32(w), rtol=RTOL,
                                       atol=ATOL, err_msg=name)


def test_matching_dtypes_without_remat_take_the_kernel(monkeypatch):
    """remat=False with Wh in the projection's dtype calls the layer kernel
    (here its plain version), in float32 and in bf16; remat=True does
    not."""
    calls = []
    real = port_network_lstm.lstm_layer_fused
    monkeypatch.setattr(port_network_lstm, "lstm_layer_fused",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    for dt in (torch.float32, torch.bfloat16):
        mod = models.from_jax_params(_np_lstm_params(5, 12, 2), device="cpu")
        p = network.LSTMParams(*(
            tuple(w.to(dt) for w in f) if isinstance(f, tuple)
            else f.to(dt) for f in mod.params()))
        x = torch.randn(4, 3, 12, generator=torch.Generator().manual_seed(6))
        y, _ = network.lstm_fused(p, x.to(dt))
        assert y.dtype == dt
        network.lstm_fused(p, x.to(dt), remat=True)
    assert calls == [torch.float32] * 2 + [torch.bfloat16] * 2


def _np_ac_params(seed):
    """JAX ActorCriticParams of numpy arrays, every field non-trivial."""
    rng = np.random.default_rng(seed)
    O, L, A = CFG["obs_dim"], CFG["num_layers"], CFG["action_dim"]
    n = lambda s, *shape: (s * rng.standard_normal(shape)).astype(np.float32)
    g = 1 / np.sqrt(H)
    lstm = JaxLSTMParams(tuple(n(g, H, 4 * H) for _ in range(L)),
                         tuple(n(g, H, 4 * H) for _ in range(L)),
                         n(g, L, 4 * H), 1 + n(0.1, L, 4 * H),
                         n(0.1, L, 4 * H), 1 + n(0.1, L, 4 * H),
                         n(0.1, L, 4 * H))
    return jax_ac.ActorCriticParams(n(1 / np.sqrt(O), O, H), n(0.1, H), lstm,
                                    n(g, H, A), n(0.1, A), n(g, H, 1),
                                    n(0.1, 1))


# B = 64 routes the LSTM backward through V2 on both sides, B = 8 through V1.
@pytest.mark.parametrize("B", [64, 8])
def test_bf16_train_step_matches_jax(interpret, f32_matmuls, B):
    """One make_train_step(compute_dtype=torch.bfloat16) step with
    Adam(lr=1e-3) against JAX's make_train_step(compute_dtype=jnp.bfloat16)
    with optax.adam(1e-3): the metrics (float32) within 2e-3, every float32
    master gradient within 5e-2 of its largest |entry|, and the updated
    parameters.  Adam's first step moves an entry by lr * g / (|g| + eps),
    so where |g| is above 1e-3 of its tensor's largest entry the parameters
    agree to 2e-6, and elsewhere to 2 * lr."""
    T = S - 1
    rng = np.random.default_rng(20)
    A, O = CFG["action_dim"], CFG["obs_dim"]
    batch_np = (rng.standard_normal((T + 1, B, O)).astype(np.float32),
                rng.integers(0, A, (T, B)),
                rng.standard_normal((T, B)).astype(np.float32),
                rng.standard_normal((T, B, A)).astype(np.float32))
    p = _np_ac_params(21)
    grads = []
    adam = optax.adam(1e-3)

    def update(g, state, params=None):
        grads.append(g)
        return adam.update(g, state, params)

    opt = optax.GradientTransformation(adam.init, update)
    jparams = jax.tree.map(jnp.asarray, p)
    jnew, _, jm = jax_ac.make_train_step(
        jax_ac.ActorCriticConfig(**CFG), opt, compute_dtype=jnp.bfloat16)(
        jparams, opt.init(jparams),
        jax_ac.TrainBatch(*map(jnp.asarray, batch_np)))

    mod = models.from_jax_params(p, device="cpu")
    step = models.make_train_step(
        models.ActorCriticConfig(**CFG),
        torch.optim.Adam(mod.parameters(), lr=1e-3),
        compute_dtype=torch.bfloat16)
    kernels.reset_launch_counts()
    tm = step(mod, models.TrainBatch(*map(torch.from_numpy, batch_np)))
    assert set(kernels.launch_counts().values()) == {0}   # CPU: plain only

    for k in ("total_loss", "policy_loss", "value_loss", "entropy"):
        assert tm[k].dtype == torch.float32
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-3,
                                   atol=2e-3, err_msg=k)
    for name, param in mod.named_parameters():
        assert param.dtype == param.grad.dtype == torch.float32, name
        jg, jp_old, jp_new = (_jax_leaf(t, name)
                              for t in (grads[0], jparams, jnew))
        _close_to_max(param.grad, jg, 5e-2, f"grad {name}")
        got = param.detach().numpy()
        big = np.abs(jg) > 1e-3 * np.abs(jg).max()
        np.testing.assert_allclose(got[big], jp_new[big], rtol=0, atol=2e-6,
                                   err_msg=f"param {name}")
        assert np.all(np.abs(got - jp_old) <= 2e-3 + 1e-6), name


def test_bf16_forward_and_serving_step_run_on_bf16_params():
    """actor_critic_forward and actor_step with bf16 parameters: bf16
    logits, values and state; the serving step samples from the float32
    softmax of its bf16 logits, so a seed reproduces the actions."""
    mod = models.from_jax_params(_np_ac_params(22), device="cpu")
    mod = mod.to(torch.bfloat16)
    rng = np.random.default_rng(23)
    B = 5
    obs = torch.from_numpy(rng.standard_normal(
        (S, B, CFG["obs_dim"])).astype(np.float32)).bfloat16()
    logits, value, (h, c) = models.actor_critic_forward(mod, obs)
    assert logits.dtype == value.dtype == h.dtype == c.dtype == torch.bfloat16
    assert logits.shape == (S, B, CFG["action_dim"]) and value.shape == (S, B)
    state = (torch.zeros(2, B, H), torch.zeros(2, B, H))
    run = lambda seed: models.actor_step(
        mod, obs[0], state, torch.Generator().manual_seed(seed))
    action, step_logits, step_value, new_state = run(0)
    assert step_logits.dtype == step_value.dtype == torch.bfloat16
    assert all(s.dtype == torch.bfloat16 for s in new_state)
    torch.testing.assert_close(step_logits, logits[0], rtol=0, atol=0)
    assert torch.equal(action, run(0)[0])


def test_from_jax_params_carries_a_bf16_tree():
    """A bf16 JAX tree loads as bf16 tensors with the same bits; a float32
    tree stays float32."""
    p = _np_ac_params(24)
    tree16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    mod16 = models.from_jax_params(jax.tree.map(np.asarray, tree16),
                                   device="cpu")
    mod32 = models.from_jax_params(p, device="cpu")
    for (name, t16), (_, t32) in zip(mod16.named_parameters(),
                                     mod32.named_parameters()):
        assert t16.dtype == torch.bfloat16 and t32.dtype == torch.float32
        want = _jax_leaf(tree16, name)
        np.testing.assert_array_equal(t16.detach().float().numpy(),
                                      want.astype(np.float32), err_msg=name)
        np.testing.assert_array_equal(t32.detach().numpy(),
                                      _jax_leaf(p, name), err_msg=name)
