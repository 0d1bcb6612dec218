"""The port's examples (di_hpc_tpu_torch.examples) on the CPU: one step of
the episodic A2C against the same composition built from the JAX package's
ops (examples/episodic_a2c_padding.py:92-137) on the same episodes and
weights, and the actor-learner loop for two learner steps.

Tolerance: rtol=1e-4, atol=1e-5, as the JAX package's own op tests use;
gradients, which sum over the buckets' rows, also get 1e-4 times the
tensor's largest entry (chip_smoke.GRAD_ATOL_REL).  JAX runs under
`jax.default_matmul_precision("float32")`.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from di_hpc_tpu import ops as jax_ops
from di_hpc_tpu.ops.categorical import logp_entropy as jax_logp_entropy

from di_hpc_tpu_torch.examples import episodic_a2c_padding as episodic
from di_hpc_tpu_torch.examples import impala_actor_learner

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
GAMMA, LAMBDA, GROUP = 0.99, 0.95, 3


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_bucket_loss(p, obs, act, rew, mask):
    """The JAX example's per-bucket loss (its bucket_loss_and_grad)."""
    h = jnp.tanh(obs @ p.w1 + p.b1)
    value = h @ p.w_v
    logits = h[:-1] @ p.w_pi
    value = value * jnp.concatenate([mask, jnp.zeros_like(mask[:1])])
    v_loss = jax_ops.td_lambda_error(
        jax_ops.td_lambda_data(value, rew, mask), GAMMA, LAMBDA)
    returns = jax_ops.generalized_lambda_returns(value, rew, GAMMA, LAMBDA)
    adv = jax.lax.stop_gradient(returns - value[:-1])
    lp, ent = jax_logp_entropy(logits, act)
    denom = jnp.maximum(jnp.sum(mask), 1.0)
    pg = -jnp.sum(lp * adv * mask) / denom
    ent_loss = jnp.sum(ent * mask) / denom
    return pg + 0.5 * v_loss - 0.01 * ent_loss


def _jax_step(jex, params, episodes):
    """The JAX example's step body: oracle bucketing, per-bucket value and
    gradient, the batch-weighted combine.  Returns (loss, grads)."""
    episodes = sorted(episodes, key=lambda e: len(e[2]))
    lengths = [np.zeros((len(e[2]),), np.float32) for e in episodes]
    group_shape, group_idx = jax_ops.oracle_split_group(lengths, GROUP)
    total = 0.0
    grads_acc = jax.tree.map(jnp.zeros_like, params)
    for g in range(len(group_shape)):
        bucket = episodes[group_idx[g]:group_idx[g + 1]]
        T = -(-group_shape[g][0] // 8) * 8
        Bq = -(-len(bucket) // 4) * 4
        obs, act, rew, mask = jex.pad_bucket(bucket, T, Bq)
        loss, grads = jax.jit(jax.value_and_grad(_jax_bucket_loss))(
            params, obs, act, rew, mask)
        w = len(bucket) / len(episodes)
        grads_acc = jax.tree.map(lambda a, b: a + w * b, grads_acc, grads)
        total += float(loss) * w
    return total, grads_acc


def test_episodic_step_matches_the_jax_composition():
    jex = _jax_example("episodic_a2c_padding")
    j_params = jex.init_params(jax.random.PRNGKey(3), 16, 64, 6)
    episodes = jex.make_episodes(np.random.default_rng(4), 24, 16, 6, 8, 40)
    assert [e[1].tolist() for e in episodes] == [
        e[1].tolist() for e in episodic.make_episodes(
            np.random.default_rng(4), 24, 16, 6, 8, 40)]
    with jax.default_matmul_precision("float32"):
        want_loss, want_grads = _jax_step(jex, j_params, episodes)

    params = episodic.Params(*(torch.tensor(np.asarray(a))
                               for a in j_params))
    opt = torch.optim.Adam(params.parameters(), lr=1e-3)
    loss, grads, sizes = episodic.train_step(params, opt, episodes, GROUP,
                                             GAMMA, LAMBDA, device="cpu")
    assert len(sizes) == GROUP and sum(b for _, b in sizes) == 24
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL, atol=ATOL)
    for name in want_grads._fields:
        want = np.asarray(getattr(want_grads, name))
        atol = ATOL + chip_smoke.GRAD_ATOL_REL * float(np.abs(want).max())
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=RTOL,
                                   atol=atol, err_msg=name)
    # The step applied its combined gradient once.
    assert all(torch.isfinite(p).all() for p in params.parameters())
    assert not torch.equal(params.w1.detach(),
                           torch.tensor(np.asarray(j_params.w1)))


def test_actor_learner_runs_two_steps_on_the_cpu():
    losses = []
    params = impala_actor_learner.run(
        steps=2, device="cpu",
        on_step=lambda i, p, batch, metrics: losses.append(
            {k: float(v) for k, v in metrics.items()}))
    assert len(losses) == 2
    assert all(np.isfinite(v) for m in losses for v in m.values())
    assert all(torch.isfinite(p).all() for p in params.parameters())


def test_actor_learner_raises_a_dead_actor(monkeypatch):
    """An exception in the actor thread reaches the learner when its wait
    for a batch times out."""
    def broken_step(self, actions):
        raise FloatingPointError("env broke")

    monkeypatch.setattr(impala_actor_learner.ToyEnv, "step", broken_step)
    monkeypatch.setattr(impala_actor_learner, "SAMPLE_TIMEOUT_S", 0.5)
    with pytest.raises(RuntimeError, match="actor thread died") as info:
        impala_actor_learner.run(steps=1, T=4, env_batch=4, learn_batch=4,
                                 device="cpu")
    assert isinstance(info.value.__cause__, FloatingPointError)
