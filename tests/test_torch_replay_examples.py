"""The port's last five examples as modules (di_hpc_tpu_torch.examples:
c51_training, quantile_dqn_training, ppo_training, alphastar_policy_training,
r2d2_training) against the JAX package's, on the CPU: one step each of C51,
QR-DQN and IQN against the same step rebuilt from the JAX example's own
network functions (q_dist, qr_quantiles, iqn_quantiles), the JAX ops and
optax.adam; the target-refresh schedule of the C51, QR-DQN, IQN and R2D2
loops against the JAX loops' rules; the weight carry-over of the new
parameter trees (and the TypeError for a tree of no known kind); the
AlphaStar loss sampling its selections with a generator; and each module's
main() at tests/test_examples.py's small sizes.

The same numpy weights and batches go to both sides; JAX runs under
`jax.default_matmul_precision("float32")`.  The JAX step takes the port's
double-DQN action, and the port's argmax is held against JAX's own up to
near ties (chip_smoke.argmax_near_ties).  Tolerance: rtol=1e-4, atol=1e-5,
as the JAX package's own op tests use; gradients, which sum over the batch,
also get 1e-4 times the tensor's largest entry (chip_smoke.GRAD_ATOL_REL);
the updated parameters by chip_smoke.check_adam_params.
"""

import copy
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from di_hpc_tpu import ops as jax_ops
from di_hpc_tpu import origin as jax_origin

from di_hpc_tpu_torch import kernels, models
from di_hpc_tpu_torch.examples import alphastar_policy_training as alphastar
from di_hpc_tpu_torch.examples import c51_training as c51
from di_hpc_tpu_torch.examples import ppo_training as ppo
from di_hpc_tpu_torch.examples import quantile_dqn_training as qdqn
from di_hpc_tpu_torch.examples import r2d2_training as r2d2

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5

C51_SMALL = {"B": 16, "obs_dim": 8, "hidden": 16, "actions": 4, "n_atom": 11,
             "nstep": 3, "v_min": -10.0, "v_max": 10.0}
QR_SMALL = {"B": 12, "obs_dim": 6, "hidden": 16, "actions": 4, "n_tau": 8,
            "nstep": 3, "gamma": 0.99}
IQN_SMALL = {"B": 12, "obs_dim": 6, "hidden": 16, "actions": 4, "n_tau": 8,
             "n_tau_prime": 9, "n_cos": 16, "nstep": 3, "gamma": 0.99,
             "kappa": 1.0}


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _close(got, want, msg, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=atol, err_msg=msg)


def _batch_np(seed, B, obs_dim, actions, nstep, n_tau=None, n_tau_prime=None,
              **_):
    """A numpy batch of the examples' fields (the JAX examples' draws)."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((B, obs_dim), dtype=np.float32)
    batch = {"obs": obs,
             "next_obs": obs + 0.3 * rng.standard_normal((B, obs_dim),
                                                         dtype=np.float32),
             "act": rng.integers(0, actions, (B,)).astype(np.int32),
             "reward": 0.1 * rng.standard_normal((nstep, B),
                                                 dtype=np.float32),
             "done": rng.uniform(0, 1, (B,)) > 0.9,
             "weight": np.ones(B, np.float32)}
    if n_tau_prime is not None:          # IQN's sampled levels
        batch["levels"] = rng.uniform(0, 1, (n_tau, B)).astype(np.float32)
        batch["levels_prime"] = rng.uniform(
            0, 1, (n_tau_prime, B)).astype(np.float32)
    return batch


def _jax_step(loss_fn, params, lr):
    """value_and_grad of loss_fn and one optax.adam(lr) update: (loss, td,
    grads, updated params)."""
    (loss, td), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    opt = optax.adam(lr)
    updates, _ = opt.update(grads, opt.init(params), params)
    return loss, td, grads, optax.apply_updates(params, updates)


def _jax_c51(jex, p, b, next_act, B, actions, n_atom, nstep, v_min, v_max,
             **_):
    """examples/c51_training.py:59-84 on a given batch, the target net the
    online one (step 0), the loss on next_act: (the target's expected
    values, loss, td, grads, updated params)."""
    next_dist = jex.q_dist(p, b["next_obs"], actions, n_atom)
    next_q = jnp.einsum("bna,a->bn", next_dist,
                        jnp.linspace(v_min, v_max, n_atom))

    def loss_fn(q):
        return jax_ops.dist_nstep_td_error(
            jax_origin.dist_nstep_td_data(
                jex.q_dist(q, b["obs"], actions, n_atom), next_dist,
                b["act"], next_act, b["reward"], b["done"], b["weight"]),
            gamma=0.99, v_min=v_min, v_max=v_max, n_atom=n_atom, nstep=nstep)

    return (next_q, *_jax_step(loss_fn, p, c51.LR))


def _jax_qrdqn(jex, p, b, next_act, actions, n_tau, nstep, gamma, **_):
    """examples/quantile_dqn_training.py:96-117 on a given batch, as
    _jax_c51."""
    tau_hat = (jnp.arange(n_tau) + 0.5) / n_tau
    next_q = jex.qr_quantiles(p, b["next_obs"], actions, n_tau)

    def loss_fn(q):
        return jax_ops.qrdqn_nstep_td_error(
            jax_origin.qrdqn_nstep_td_data(
                jex.qr_quantiles(q, b["obs"], actions, n_tau), next_q,
                b["act"], next_act, b["reward"], b["done"], tau_hat, None),
            gamma=gamma, nstep=nstep)

    return (jnp.mean(next_q, axis=-1), *_jax_step(loss_fn, p, qdqn.LR))


def _jax_iqn(jex, p, b, next_act, n_cos, nstep, gamma, kappa, **_):
    """examples/quantile_dqn_training.py:138-164 on a given batch, as
    _jax_c51."""
    next_q = jex.iqn_quantiles(p, b["next_obs"], b["levels_prime"], n_cos)

    def loss_fn(q):
        return jax_ops.iqn_nstep_td_error(
            jax_origin.iqn_nstep_td_data(
                jex.iqn_quantiles(q, b["obs"], b["levels"], n_cos), next_q,
                b["act"], next_act, b["reward"], b["done"], b["levels"],
                None),
            gamma=gamma, nstep=nstep, kappa=kappa)

    return (jnp.mean(next_q, axis=0), *_jax_step(loss_fn, p, qdqn.LR))


# name -> (JAX example, its params tuple, the port's init, step, the JAX
# step, config)
_LEARNERS = {
    "c51": ("c51_training", "QParams",
            lambda g, c: c51.init_params(g, c["obs_dim"], c["hidden"],
                                         c["actions"], c["n_atom"], "cpu"),
            lambda p, t, o, b, c: c51.train_step(
                p, t, o, b, c["n_atom"], c["nstep"], c["v_min"], c["v_max"]),
            _jax_c51, C51_SMALL),
    "qrdqn": ("quantile_dqn_training", "QRParams",
              lambda g, c: qdqn.init_qr(g, c["obs_dim"], c["hidden"],
                                        c["actions"], c["n_tau"], "cpu"),
              lambda p, t, o, b, c: qdqn.qrdqn_step(
                  p, t, o, b, c["n_tau"], c["nstep"], c["gamma"]),
              _jax_qrdqn, QR_SMALL),
    "iqn": ("quantile_dqn_training", "IQNParams",
            lambda g, c: qdqn.init_iqn(g, c["obs_dim"], c["hidden"],
                                       c["actions"], c["n_cos"], "cpu"),
            lambda p, t, o, b, c: qdqn.iqn_step(
                p, t, o, b, c["n_cos"], c["nstep"], c["gamma"], c["kappa"]),
            _jax_iqn, IQN_SMALL),
}


@pytest.mark.parametrize("name", list(_LEARNERS))
def test_replay_step_matches_jax(name):
    """One step of the port's trainer (its own double-DQN argmax, the op,
    torch.optim.Adam(1e-3)) against the same step rebuilt from the JAX
    example's network and the JAX op with optax.adam(1e-3), from the same
    numpy weights and batch: the argmax up to near ties, the loss, the TD
    errors, every gradient and the updated parameters."""
    example, tuple_name, init, step, jax_step, cfg = _LEARNERS[name]
    jex = _jax_example(example)
    arrays = models.to_numpy_params(init(torch.Generator().manual_seed(7),
                                         cfg))
    batch = _batch_np(8, **cfg)

    kernels.reset_launch_counts()
    p = models.from_jax_params(arrays, device="cpu")
    target = copy.deepcopy(p)
    opt = torch.optim.Adam(p.parameters(), lr=1e-3)
    metrics, grads, next_q, next_act = step(
        p, target, opt, {k: torch.from_numpy(np.asarray(v))
                         for k, v in batch.items()}, cfg)
    assert set(kernels.launch_counts().values()) == {0}   # CPU: plain only

    jp = getattr(jex, tuple_name)(*map(jnp.asarray, arrays))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        want_q, loss, td, want_g, want_p = jax_step(
            jex, jp, jb, jnp.asarray(next_act.numpy()), **cfg)
    want_q = torch.from_numpy(np.array(want_q))
    _close(next_q, want_q, "next q")
    chip_smoke.argmax_near_ties(next_q, want_q, next_act,
                                want_q.argmax(dim=-1), name=name)
    _close(metrics["loss"], loss, "loss")
    _close(metrics["td"], td, "td")
    fields = type(arrays)._fields
    want_g = dict(zip(fields, want_g))
    assert set(grads) == set(fields)
    for k, w in want_g.items():
        atol = ATOL + chip_smoke.GRAD_ATOL_REL * float(jnp.abs(w).max())
        _close(grads[k], w, f"grad {k}", atol=atol)
    chip_smoke.check_adam_params(
        name, dict(p.named_parameters()),
        {k: torch.from_numpy(np.array(v)) for k, v in zip(fields, want_p)},
        [{k: torch.from_numpy(np.array(v)) for k, v in want_g.items()}],
        1e-3, 1)


# --------------------------------------------------- the target refreshes --

K = 3   # target_update_every; k + 1 steps are run


def _c51_rule(i, k):
    """examples/c51_training.py:92-93: target_params = params after step m
    when (m + 1) % k == 0.  The step whose parameters (taken before it) the
    target holds at step i."""
    return max([m + 1 for m in range(i) if (m + 1) % k == 0], default=0)


def _before_rule(i, k):
    """examples/quantile_dqn_training.py:121-122 and :168-169,
    examples/r2d2_training.py:144-145: target_params = params before step
    j when j % k == 0."""
    return max(j for j in range(i + 1) if j % k == 0)


# name -> (module, its step's name, the JAX loop's rule, a small main())
_SCHEDULES = {
    "c51": (c51, "train_step", _c51_rule,
            lambda: c51.main(steps=K + 1, B=8, obs_dim=6, hidden=8,
                             n_atom=11, target_update_every=K,
                             device="cpu")),
    "qrdqn": (qdqn, "qrdqn_step", _before_rule,
              lambda: qdqn.main(steps=K + 1, B=8, obs_dim=6, hidden=8,
                                n_tau=4, target_update_every=K,
                                algo="qrdqn", device="cpu")),
    "iqn": (qdqn, "iqn_step", _before_rule,
            lambda: qdqn.main(steps=K + 1, B=8, obs_dim=6, hidden=8,
                              n_tau=4, n_tau_prime=5, n_cos=8,
                              target_update_every=K, algo="iqn",
                              device="cpu")),
    "r2d2": (r2d2, "train_step", _before_rule,
             lambda: r2d2.main(steps=K + 1, S=8, burn_in=2, B=4, hidden=8,
                               nstep=2, target_update_every=K,
                               device="cpu")),
}


@pytest.mark.parametrize("name", list(_SCHEDULES))
def test_target_refresh_schedule_follows_the_jax_loop(name, monkeypatch):
    """Over k + 1 steps the target net each step sees holds exactly the
    online parameters from before the step the JAX loop's rule names, and
    is a copy: between refreshes it stays put while the online net moves."""
    module, step_name, rule, run = _SCHEDULES[name]
    real_step = getattr(module, step_name)
    seen = []

    def recording_step(params, target_params, *args, **kwargs):
        seen.append((copy.deepcopy(params.state_dict()),
                     copy.deepcopy(target_params.state_dict())))
        return real_step(params, target_params, *args, **kwargs)

    monkeypatch.setattr(module, step_name, recording_step)
    run()
    assert len(seen) == K + 1
    same = lambda a, b: all(torch.equal(a[k], b[k]) for k in a)
    for i, (_, target) in enumerate(seen):
        j = rule(i, K)
        assert same(target, seen[j][0]), (i, j)
        if j != i:
            assert not same(target, seen[i][0]), i


# ------------------------------------------------------ weight carry-over --

_TREES = {
    "c51": ("c51_training",
            lambda j: j.init_params(jax.random.PRNGKey(1), 6, 8, 3, 5)),
    "qrdqn": ("quantile_dqn_training",
              lambda j: j.init_qr(jax.random.PRNGKey(2), 6, 8, 3, 4)),
    "iqn": ("quantile_dqn_training",
            lambda j: j.init_iqn(jax.random.PRNGKey(3), 6, 8, 3, 10)),
    "ppo": ("ppo_training",
            lambda j: j.init_params(jax.random.PRNGKey(4), 6, 8, 3)),
}
_KINDS = {"c51": (models.QParams, models.QArrays),
          "qrdqn": (models.QParams, models.QArrays),
          "iqn": (models.IQNParams, models.IQNArrays),
          "ppo": (models.PPOParams, models.PPOArrays)}


@pytest.mark.parametrize("name", list(_TREES))
def test_example_params_carry_over_and_back(name):
    """The JAX example's own init, as numpy arrays, -> the port's module
    (parameters named by the tuple's fields) -> numpy, bit for bit."""
    example, init = _TREES[name]
    tree = jax.tree.map(np.asarray, init(_jax_example(example)))
    module_cls, arrays_cls = _KINDS[name]
    p = models.from_jax_params(tree, device="cpu")
    assert type(p) is module_cls
    assert [k for k, _ in p.named_parameters()] == list(tree._fields)
    back = models.to_numpy_params(p)
    assert type(back) is arrays_cls
    for g, w in zip(back, tree):
        np.testing.assert_array_equal(g, w)


def test_a_tree_of_no_known_kind_raises_type_error():
    """The episodic A2C example's Params (w1, b1, w_pi, w_v) is no tree of
    the port's: it is refused by name, not sent to LSTMWeights."""
    jex = _jax_example("episodic_a2c_padding")
    tree = jax.tree.map(np.asarray, jex.init_params(jax.random.PRNGKey(0),
                                                    4, 8, 3))
    with pytest.raises(TypeError, match=r"w1', 'b1', 'w_pi', 'w_v'"):
        models.from_jax_params(tree, device="cpu")


# ----------------------------------------------------------------- AlphaStar --

def test_alphastar_loss_samples_valid_selections_with_a_generator():
    """With a generator the selection head samples: every selection is an
    entity of its row or the row's "end" sentinel (entity_num), no entity
    twice before "end", the sentinel repeated after it; the loss is finite
    and has a gradient; another seed samples other selections."""
    cfg = {"T": 4, "B": 6, "M": 10, "De": 5, "N": 8, "H": 4, "W": 4,
           "F": 6, "Hc": 16, "A": 5, "Hs": 8}
    S = 7
    gen = torch.Generator().manual_seed(0)
    p = alphastar.init_params(gen, cfg["De"], cfg["N"], cfg["H"], cfg["W"],
                              cfg["F"], cfg["Hc"], cfg["A"], cfg["Hs"],
                              "cpu")
    x = alphastar.synthetic_batch(gen, cfg["T"], cfg["B"], cfg["M"],
                                  cfg["De"], cfg["H"], cfg["W"], cfg["A"],
                                  "cpu")
    picks = []
    for seed in (1, 2):
        total, metrics, selected = alphastar.alphastar_loss(
            p, x, cfg["H"], cfg["W"], S, torch.Generator().manual_seed(seed))
        assert selected.shape == (S, cfg["B"])
        assert torch.isfinite(total)
        for b in range(cfg["B"]):
            row, end = selected[:, b].tolist(), int(x["entity_num"][b])
            assert all(0 <= s <= end for s in row)
            first = row.index(end) if end in row else S
            assert len(set(row[:first])) == first
            assert all(s == end for s in row[first:])
        picks.append(selected)
    total.backward()
    assert all(q.grad is not None and torch.isfinite(q.grad).all()
               for q in p.parameters())
    assert not torch.equal(*picks)


# ------------------------------------------------------------- the mains --

# tests/test_examples.py's small sizes.
_MAINS = {
    "c51_training": lambda: c51.main(steps=4, B=32, device="cpu"),
    "quantile_dqn_training": lambda: qdqn.main(
        steps=3, B=16, n_tau=8, n_tau_prime=9, n_cos=16, device="cpu"),
    "ppo_training": lambda: ppo.main(steps=2, epochs=2, T=8, B=16,
                                     device="cpu"),
    "alphastar_policy_training": lambda: alphastar.main(
        steps=2, T=6, B=4, M=16, Hc=128, max_selections=4, device="cpu"),
    "r2d2_training": lambda: r2d2.main(steps=3, S=12, burn_in=3, B=8,
                                       hidden=32, nstep=2, device="cpu"),
}


@pytest.mark.parametrize("name", list(_MAINS))
def test_example_main_runs_on_the_cpu(name):
    kernels.reset_launch_counts()
    out = _MAINS[name]()
    assert set(kernels.launch_counts().values()) == {0}   # CPU: plain only
    nets = out.values() if isinstance(out, dict) else [out]
    for net in nets:
        assert all(torch.isfinite(q).all() for q in net.parameters())
