"""The whole slice on the CPU: the port's LN-LSTM actor-critic forward,
serving step, V-trace loss and training step against the JAX package's,
with weights carried over by models.from_jax_params.

The JAX side runs its Pallas kernels in interpret mode under float32
matmuls (the unroll is S = T+1 = 9 >= 8 at H = 128, so the forward reaches
the LSTM layer kernel; the serving step at S = 1 takes JAX's scan path).
Tolerances: rtol=1e-4, atol=1e-5, as the JAX package's own tests use --
float32 on both sides, differing only in the order of sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import di_hpc_tpu.pallas_kernels.linear_scan as ls
from di_hpc_tpu import ops as jax_ops
from di_hpc_tpu.models import actor_critic_lstm as jax_ac
from di_hpc_tpu.origin.rnn import LSTMParams as JaxLSTMParams

from di_hpc_tpu_torch import kernels, models, ops

RTOL, ATOL = 1e-4, 1e-5
CFG = dict(obs_dim=20, hidden_size=128, num_layers=2, action_dim=16)


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


def _np_params(seed):
    """JAX ActorCriticParams of numpy arrays, every field non-trivial."""
    rng = np.random.default_rng(seed)
    O, H, L, A = (CFG[k] for k in ("obs_dim", "hidden_size", "num_layers",
                                   "action_dim"))
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


def _jnp(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=name)


def test_convert_roundtrip():
    p = _np_params(0)
    mod = models.from_jax_params(p, device="cpu")
    assert isinstance(mod, models.ActorCriticParams)
    back = models.to_numpy_params(mod)
    assert back._fields == jax_ac.ActorCriticParams._fields
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("weight", [False, True])
def test_forward_then_vtrace_matches_jax(interpret, f32_matmuls, weight):
    T, B = 8, 3
    rng = np.random.default_rng(1)
    A = CFG["action_dim"]
    obs = rng.standard_normal((T + 1, B, CFG["obs_dim"])).astype(np.float32)
    state = tuple(rng.standard_normal((2, CFG["num_layers"], B,
                                       CFG["hidden_size"]))
                  .astype(np.float32))
    blogits = rng.standard_normal((T, B, A)).astype(np.float32)
    actions = rng.integers(0, A, (T, B))
    rewards = rng.standard_normal((T, B)).astype(np.float32)
    w = rng.uniform(0, 2, (T, B)).astype(np.float32) if weight else None
    p = _np_params(2)

    jl, jv, (jh, jc) = jax_ac.actor_critic_forward(
        _jnp(p), jnp.asarray(obs), _jnp(state))
    jloss = jax_ops.vtrace_error(jax_ops.vtrace_data(
        jl[:T], jnp.asarray(blogits), jnp.asarray(actions), jv,
        jnp.asarray(rewards), None if w is None else jnp.asarray(w)))

    mod = models.from_jax_params(p, device="cpu")
    kernels.reset_launch_counts()
    tl, tv, (th, tc) = models.actor_critic_forward(
        mod, torch.from_numpy(obs), tuple(map(torch.from_numpy, state)))
    tloss = ops.vtrace_error(ops.vtrace_data(
        tl[:T], torch.from_numpy(blogits), torch.from_numpy(actions), tv,
        torch.from_numpy(rewards), None if w is None else torch.from_numpy(w)))
    assert set(kernels.launch_counts().values()) == {0}   # CPU: plain only

    assert tl.shape == (T + 1, B, A) and tv.shape == (T + 1, B)
    for name, g, wnt in (("logits", tl, jl), ("value", tv, jv),
                         ("h", th, jh), ("c", tc, jc)):
        _close(g, wnt, name)
    for name, g, wnt in zip(("policy", "value", "entropy"), tloss, jloss):
        _close(g, wnt, name + "_loss")


def test_actor_step_matches_jax_over_carried_state(f32_matmuls):
    """Logits, value and state after each of three serving steps, the state
    carried from call to call on both sides.  The caller's state tensors are
    left as they were."""
    B = 4
    rng = np.random.default_rng(3)
    p = _np_params(4)
    mod = models.from_jax_params(p, device="cpu")
    L, H = CFG["num_layers"], CFG["hidden_size"]
    jstate = (jnp.zeros((L, B, H)), jnp.zeros((L, B, H)))
    tstate = (torch.zeros(L, B, H), torch.zeros(L, B, H))
    gen = torch.Generator().manual_seed(0)
    for i in range(3):
        obs = rng.standard_normal((B, CFG["obs_dim"])).astype(np.float32)
        _, jl, jv, jstate = jax_ac.actor_step(
            _jnp(p), jnp.asarray(obs), jstate, jax.random.PRNGKey(i))
        before = tuple(s.clone() for s in tstate)
        a, tl, tv, new = models.actor_step(mod, torch.from_numpy(obs),
                                           tstate, gen)
        assert all(torch.equal(s, b) for s, b in zip(tstate, before))
        tstate = new
        assert a.shape == (B,) and a.dtype == torch.int64
        assert int(a.min()) >= 0 and int(a.max()) < CFG["action_dim"]
        assert not tl.requires_grad
        _close(tl, jl, f"logits step {i}")
        _close(tv, jv, f"value step {i}")
        _close(tstate[0], jstate[0], f"h step {i}")
        _close(tstate[1], jstate[1], f"c step {i}")


def test_actor_step_samples_the_policy_distribution():
    """Sampling is checked by its distribution: 4096 rows share one
    observation and state, so each row draws from the same categorical; a
    chi-square statistic over the 16 actions (15 degrees of freedom) stays
    below 37.7, the 0.999 quantile.  The generator is seeded, so the test
    is deterministic."""
    B, A = 4096, CFG["action_dim"]
    mod = models.from_jax_params(_np_params(5), device="cpu")
    obs = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, CFG["obs_dim"])).astype(np.float32)).expand(B, -1).contiguous()
    state = tuple(torch.zeros(CFG["num_layers"], B, CFG["hidden_size"])
                  for _ in range(2))
    gen = torch.Generator().manual_seed(7)
    action, logits, _, _ = models.actor_step(mod, obs, state, gen)
    probs = torch.softmax(logits[0].double(), -1).numpy()
    counts = np.bincount(action.numpy(), minlength=A)
    chi2 = float(np.sum((counts - B * probs) ** 2 / (B * probs)))
    assert chi2 < 37.7, (chi2, counts, B * probs)
    again, _, _, _ = models.actor_step(mod, obs, state,
                                       torch.Generator().manual_seed(7))
    assert torch.equal(action, again)


def test_init_actor_critic_is_seeded_and_shaped():
    cfg = models.ActorCriticConfig(**CFG)
    make = lambda: models.init_actor_critic(
        cfg, torch.Generator().manual_seed(11), device="cpu")
    a, b = make(), make()
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    H, A = CFG["hidden_size"], CFG["action_dim"]
    assert a.embed_w.shape == (CFG["obs_dim"], H)
    assert a.policy_w.shape == (H, A) and a.value_w.shape == (H, 1)
    assert a.lstm.wh[0].shape == (H, 4 * H) and len(a.lstm.wx) == 2
    assert int(torch.count_nonzero(a.embed_b.detach())) == 0
    batch = models.TrainBatch(torch.zeros(3, 2, CFG["obs_dim"]),
                              torch.zeros(2, 2, dtype=torch.long),
                              torch.zeros(2, 2), torch.zeros(2, 2, A))
    logits, value, _ = models.actor_critic_forward(a, batch.obs)
    assert logits.shape == (3, 2, A) and value.shape == (3, 2)


def _recording(inner, grads):
    """An optax transformation that records the gradients it is given."""
    def update(g, state, params=None):
        grads.append(g)
        return inner.update(g, state, params)
    return optax.GradientTransformation(inner.init, update)


# B = 3 routes the LSTM backward through V1 on both sides, B = 64 through V2.
@pytest.mark.parametrize("B", [3, 64])
def test_train_step_matches_jax(interpret, f32_matmuls, B):
    """One make_train_step step with Adam(lr=1e-3) against the JAX step with
    optax.adam(1e-3), from the same weights and batch: the metrics and every
    gradient at rtol=1e-4, atol=1e-5, and the updated parameters.  Adam's
    first step moves an entry by lr * g / (|g| + eps), so an entry whose
    gradient lies at the noise floor may move either way: the updated
    parameters are held to 1e-6 where |g| > 1e-4 (ten times the gradient
    atol) and to 2 * lr elsewhere."""
    T = 8
    rng = np.random.default_rng(20)
    A, O = CFG["action_dim"], CFG["obs_dim"]
    batch_np = (rng.standard_normal((T + 1, B, O)).astype(np.float32),
                rng.integers(0, A, (T, B)),
                rng.standard_normal((T, B)).astype(np.float32),
                rng.standard_normal((T, B, A)).astype(np.float32))
    p = _np_params(21)
    cfg_j = jax_ac.ActorCriticConfig(**CFG)
    grads = []
    opt = _recording(optax.adam(1e-3), grads)
    jparams = _jnp(p)
    jnew, _, jm = jax_ac.make_train_step(cfg_j, opt)(
        jparams, opt.init(jparams),
        jax_ac.TrainBatch(*map(jnp.asarray, batch_np)))

    mod = models.from_jax_params(p, device="cpu")
    step = models.make_train_step(models.ActorCriticConfig(**CFG),
                                  torch.optim.Adam(mod.parameters(), lr=1e-3))
    kernels.reset_launch_counts()
    tm = step(mod, models.TrainBatch(*map(torch.from_numpy, batch_np)))
    assert set(kernels.launch_counts().values()) == {0}   # CPU: plain only

    for k in ("total_loss", "policy_loss", "value_loss", "entropy"):
        _close(tm[k], jm[k], k)
    for name, param in mod.named_parameters():
        jg, jp_old, jp_new = (_jax_leaf(t, name)
                              for t in (grads[0], jparams, jnew))
        np.testing.assert_allclose(param.grad.numpy(), jg, rtol=RTOL,
                                   atol=ATOL, err_msg=f"grad {name}")
        got, big = param.detach().numpy(), np.abs(jg) > 1e-4
        np.testing.assert_allclose(got[big], jp_new[big], rtol=0, atol=1e-6,
                                   err_msg=f"param {name}")
        assert np.all(np.abs(got - jp_old) <= 2e-3 + 1e-6), name


def _jax_leaf(tree, name):
    """The leaf of a JAX ActorCriticParams tree at a port parameter's name
    ("embed_w", "lstm.wx.0", ...)."""
    for part in name.split("."):
        tree = tree[int(part)] if part.isdigit() else getattr(tree, part)
    return np.asarray(tree)


def test_train_step_refuses_bf16_compute():
    """compute_dtype=torch.bfloat16 is no longer refused: it builds the
    mixed-precision step, whose parameters, gradients and metrics stay
    float32 (tests/test_torch_bf16.py holds it against JAX's)."""
    cfg = models.ActorCriticConfig(**CFG)
    params = models.init_actor_critic(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
    opt = torch.optim.Adam(params.parameters(), lr=1e-3)
    step = models.make_train_step(cfg, opt, compute_dtype=torch.bfloat16)
    B, T, A = 2, 2, CFG["action_dim"]
    metrics = step(params, models.TrainBatch(
        torch.randn(T + 1, B, CFG["obs_dim"],
                    generator=torch.Generator().manual_seed(1)),
        torch.zeros(T, B, dtype=torch.long), torch.ones(T, B),
        torch.zeros(T, B, A)))
    assert all(m.dtype == torch.float32 and torch.isfinite(m)
               for m in metrics.values())
    assert all(p.dtype == p.grad.dtype == torch.float32
               for p in params.parameters())
