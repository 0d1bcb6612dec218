"""The port's PPO (di_hpc_tpu_torch.ops.ppo_error, ppo_error_with_logp_old,
PPO and the origin oracle) and one iteration of the on-policy trainer of
di_hpc_tpu_torch.examples.ppo_training, which chip_smoke.py drives (GAE ->
logp_old -> epochs of the PPO loss -> Adam), against the JAX package's, on
the CPU.

Inputs are made with numpy from a seed and handed to both sides; the JAX
GAE kernel runs in interpret mode.  Tolerances: rtol=1e-4, atol=1e-5, as
the JAX package's own op tests use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
import di_hpc_tpu.pallas_kernels.linear_scan as ls
from di_hpc_tpu import ops as jax_ops
from di_hpc_tpu import origin as jax_origin

from di_hpc_tpu_torch import kernels, ops, origin
from di_hpc_tpu_torch.examples import ppo_training as ppo

RTOL, ATOL = 1e-4, 1e-5
PPO_NAMES = ("policy_loss", "value_loss", "entropy_loss", "approx_kl",
             "clipfrac")


@pytest.fixture
def interpret():
    ls.INTERPRET = True
    jax.clear_caches()          # no trace cached by an earlier test's mode
    yield
    ls.INTERPRET = False


def _ppo_np(seed, B=64, N=9, weight=False):
    """logit_new, logit_old, action, value_new, value_old, adv, return_,
    weight: the old logits and values far enough from the new ones that
    the ratio and the value leave the clip range for some samples."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    ln, vo = f(B, N), f(B)
    return (ln, ln + 0.4 * f(B, N), rng.integers(0, N, B),
            vo + 0.3 * f(B), vo, f(B), f(B),
            rng.uniform(0, 2, B).astype(np.float32) if weight else None)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


def _total(loss):
    return loss[0] + 0.5 * loss[1] - 0.01 * loss[2]


@pytest.mark.parametrize("weight", [False, True])
@pytest.mark.parametrize("dual_clip", [None, 2.0])
@pytest.mark.parametrize("use_value_clip", [True, False])
@pytest.mark.parametrize("fast", [False, True])
def test_ppo_matches_jax(fast, use_value_clip, dual_clip, weight):
    """Losses, ppo_info and the gradients of the example's total loss in
    logit_new and value_new; the full path (ppo_error) is also held against
    the origin oracle."""
    ln, lo, act, vn, vo, adv, ret, w = _ppo_np(1, weight=weight)
    args = (0.2, use_value_clip, dual_clip)
    jw = None if w is None else jnp.asarray(w)
    jlo = jax_ops.logp(jnp.asarray(lo), jnp.asarray(act)) if fast \
        else jnp.asarray(lo)

    def jax_loss(ln_, vn_):
        fn, data = ((jax_ops.ppo_error_with_logp_old, jax_ops.ppo_fast_data)
                    if fast else (jax_ops.ppo_error, jax_ops.ppo_data))
        loss, info = fn(data(ln_, jlo, jnp.asarray(act), vn_,
                             jnp.asarray(vo), jnp.asarray(adv),
                             jnp.asarray(ret), jw), *args)
        return _total(loss), (loss, info)

    (_, (want, want_info)), (want_dl, want_dv) = jax.value_and_grad(
        jax_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(ln),
                                                 jnp.asarray(vn))

    tl, tv = (torch.from_numpy(x).requires_grad_() for x in (ln, vn))
    t = lambda x: None if x is None else torch.from_numpy(x)
    if fast:
        loss, info = ops.ppo_error_with_logp_old(ops.ppo_fast_data(
            tl, ops.logp(t(lo), t(act)), t(act), tv, t(vo), t(adv), t(ret),
            t(w)), *args)
    else:
        loss, info = ops.ppo_error(ops.ppo_data(
            tl, t(lo), t(act), tv, t(vo), t(adv), t(ret), t(w)), *args)
    _total(loss).backward()
    for name, g, wv in zip(PPO_NAMES, (*loss, *info),
                           (*want, *want_info)):
        _close(g, wv, name)
    assert not info.approx_kl.requires_grad
    assert not info.clipfrac.requires_grad
    assert 0.0 < float(info.clipfrac) < 1.0
    _close(tl.grad, want_dl, "d logit_new")
    _close(tv.grad, want_dv, "d value_new")
    if not fast:
        oracle, oracle_info = origin.ppo_error(origin.ppo_data(
            t(ln), t(lo), t(act), t(vn), t(vo), t(adv), t(ret), t(w)), *args)
        for name, g, wv in zip(PPO_NAMES, (*oracle, *oracle_info),
                               (*want, *want_info)):
            _close(g, wv, "oracle " + name)


def test_origin_ppo_matches_jax_oracle():
    data = _ppo_np(2, weight=True)
    want_loss, want_info = jax_origin.ppo_error(
        jax_origin.ppo_data(*map(jnp.asarray, data)), 0.15, True, 3.0)
    got_loss, got_info = origin.ppo_error(
        origin.ppo_data(*map(torch.from_numpy, data)), 0.15, True, 3.0)
    for name, g, w in zip(PPO_NAMES, (*got_loss, *got_info),
                          (*want_loss, *want_info)):
        _close(g, w, name)


# (op, field index, replacement, message) for each check of check_ppo and
# check_ppo_fast.
BAD_INPUTS = [
    ("ppo_error", 1, lambda x: x[:, :-1], "logit_old .* must match"),
    ("ppo_error", 2, lambda x: x.float(), "action must be an integer"),
    ("ppo_error", 2, lambda x: x[:-1], "logit_new must be action.shape"),
    ("ppo_error", 3, lambda x: x[:-1], "value_new must have shape"),
    ("ppo_error", 5, lambda x: x[:, None], "adv must have shape"),
    ("ppo_error", 7, lambda x: torch.ones(3), "weight must have shape"),
    ("ppo_error_with_logp_old", 1, lambda x: x[:-1],
     "logp_old must have shape"),
    ("ppo_error_with_logp_old", 6, lambda x: x[:-2],
     "return_ must have shape"),
]


@pytest.mark.parametrize("op,index,bad,match", BAD_INPUTS)
def test_ppo_validation_names_the_op(op, index, bad, match):
    fields = list(map(lambda x: None if x is None else torch.from_numpy(x),
                      _ppo_np(3, B=6, N=4)))
    if op == "ppo_error_with_logp_old":
        fields[1] = ops.logp(fields[1], fields[2])
    fields[index] = bad(fields[index] if fields[index] is not None
                        else fields[3])
    fn, data = ((ops.ppo_error, ops.ppo_data) if op == "ppo_error"
                else (ops.ppo_error_with_logp_old, ops.ppo_fast_data))
    with pytest.raises(ValueError, match=f"{op}: {match}"):
        fn(data(*fields))


@pytest.mark.parametrize("dual_clip", [1.0, 0.5])
def test_dual_clip_must_exceed_one(dual_clip):
    data = ops.ppo_data(*map(lambda x: None if x is None
                             else torch.from_numpy(x), _ppo_np(4, B=5, N=3)))
    for fn in (ops.ppo_error, origin.ppo_error):
        with pytest.raises(AssertionError, match="greater than 1.0"):
            fn(data, dual_clip=dual_clip)


def test_ppo_wrapper_class():
    fields = [None if x is None else torch.from_numpy(x)
              for x in _ppo_np(5, B=8, N=5)]
    got = ops.PPO(8, 5)(*fields[:7], dual_clip=2.0)
    want = ops.ppo_error(ops.ppo_data(*fields), dual_clip=2.0)
    for g, w in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="PPO: logit_new"):
        ops.PPO(8, 6)(*fields[:7])


# ------------------------------------------- one iteration of the trainer --

CFG = {"obs_dim": 8, "hidden": 16, "actions": 6, "T": 5, "B": 7}
EPOCHS = 2


def _jax_iteration(params, rollout, epochs, lr):
    """examples/ppo_training.py's collect and update on the JAX package's
    ops, with the rollout's numpy Gumbel noise picking the actions: each
    epoch's metrics and gradients, and the updated parameters."""
    obs, reward, gumbel = map(jnp.asarray, rollout)
    T = reward.shape[0]

    def forward(p, x):
        h = jnp.tanh(x @ p["w1"] + p["b1"])
        return h @ p["policy_w"] + p["policy_b"], (h @ p["value_w"]
                                                   + p["value_b"])[..., 0]

    logits, value = forward(params, obs)
    action = jnp.argmax(logits[:T] + gumbel, axis=-1)
    adv = jax_ops.gae(jax_origin.gae_data(value, reward), gamma=0.99,
                      lambda_=0.95)
    batch = dict(obs=obs[:T], action=action,
                 logp_old=jax_ops.logp(logits[:T], action),
                 value_old=value[:T], adv=adv, return_=adv + value[:T])
    flat = lambda x: x.reshape((-1,) + x.shape[2:])

    def loss_fn(p):
        lg, v = forward(p, batch["obs"])
        (pol, vl, ent), (kl, frac) = jax_ops.ppo_error_with_logp_old(
            jax_ops.ppo_fast_data(flat(lg), flat(batch["logp_old"]),
                                  flat(batch["action"]), flat(v),
                                  flat(batch["value_old"]), flat(batch["adv"]),
                                  flat(batch["return_"]), None),
            clip_ratio=0.2, use_value_clip=True, dual_clip=None)
        total = pol + 0.5 * vl - 0.01 * ent
        return total, dict(total=total, policy=pol, value=vl, entropy=ent,
                           approx_kl=kl, clipfrac=frac)

    opt = optax.adam(lr)
    state = opt.init(params)
    log = []
    for _ in range(epochs):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        log.append((metrics, grads))
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return log, params, batch


def test_ppo_iteration_matches_jax(interpret):
    """One iteration of the example module's trainer (GAE -> logp_old -> 2
    epochs of ppo_error_with_logp_old -> torch.optim.Adam) against the same
    composition of JAX ops with optax.adam: the batch (actions, advantages,
    returns, logp_old), each epoch's metrics and gradients at rtol=1e-4,
    atol=1e-5, and the updated parameters by the train step's Adam rule
    (1e-6 where |g| > 1e-4 at every step, else 2 * lr per step)."""
    rng = np.random.default_rng(6)
    arrays = chip_smoke.ppo_params(rng, **CFG)
    rollout = chip_smoke.ppo_rollouts(rng, 1, **CFG)[0]
    want_log, want_p, want_batch = _jax_iteration(
        {k: jnp.asarray(v) for k, v in arrays.items()}, rollout, EPOCHS,
        ppo.LR)

    cpu = torch.device("cpu")
    p, opt, rollouts = chip_smoke.ppo_setup(arrays, [rollout], cpu)
    batch = ppo.collect(p, *rollouts[0])
    assert torch.equal(batch["action"],
                       torch.tensor(np.asarray(want_batch["action"])))
    for k in ("logp_old", "value_old", "adv", "return_"):
        _close(batch[k], want_batch[k], k)

    kernels.reset_launch_counts()
    p, opt, rollouts = chip_smoke.ppo_setup(arrays, [rollout], cpu)
    log = ppo.iteration(p, opt, rollouts[0], EPOCHS)
    assert set(kernels.launch_counts().values()) == {0}  # CPU: plain only
    for i, ((m, g), (wm, wg)) in enumerate(zip(log, want_log)):
        for k in wm:
            _close(m[k], wm[k], f"epoch {i} {k}")
        for k in wg:
            _close(g[k], wg[k], f"epoch {i} grad {k}")
    chip_smoke.check_adam_params(
        "ppo", dict(p.named_parameters()),
        {k: torch.tensor(np.asarray(v)) for k, v in want_p.items()},
        [{k: torch.tensor(np.asarray(v)) for k, v in wg.items()}
         for _, wg in want_log], ppo.LR, EPOCHS)
