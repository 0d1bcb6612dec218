"""The port's AlphaStar pieces (di_hpc_tpu_torch: the scatter connection and
its oracle, the policy-head helpers, the entity-selection head, the weight
carry-over, and one step of the AlphaStar trainer of
di_hpc_tpu_torch.examples.alphastar_policy_training, as chip_smoke.py drives
it) against the JAX package's, on the CPU.

Inputs and weights are made with numpy from a seed and handed to both
sides.  The JAX side runs its products under
`jax.default_matmul_precision("float32")`, as tests/test_scatter.py does, so
both sides compute in full float32.  Tolerances: rtol=1e-4, atol=1e-5, as
the JAX package's own op tests use; gradients that sum over the batch also
get 1e-4 times the tensor's largest entry (chip_smoke.GRAD_ATOL_REL).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from di_hpc_tpu import models as jax_models
from di_hpc_tpu import network as jax_network
from di_hpc_tpu import ops as jax_ops
from di_hpc_tpu import origin as jax_origin
from di_hpc_tpu.ops.categorical import logp as jax_logp

from di_hpc_tpu_torch import kernels, models, network, origin
from di_hpc_tpu_torch.examples import alphastar_policy_training as alphastar

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want, msg="", atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=atol,
                               err_msg=msg)


def _scatter_inputs(seed, B, M, N, H, W, out_of_range=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, M, N)).astype(np.float32)
    loc = np.stack([rng.integers(0, H, (B, M)), rng.integers(0, W, (B, M))],
                   axis=-1).astype(np.int32)
    loc[0, 1] = loc[0, 0]                   # a collision by construction
    if out_of_range:
        loc[0, 2] = (H, 0)                  # cell H*W: past the map
        loc[1, 3] = (H + 2, W - 1)
    return x, loc


def _np_scatter(x, H, W, loc, mode):
    B, M, N = x.shape
    out = np.zeros((B, N, H, W), x.dtype)
    for b in range(B):
        for m in range(M):
            y, xx = int(loc[b, m, 0]), int(loc[b, m, 1])
            if mode == "add":
                out[b, :, y, xx] += x[b, m]
            else:
                out[b, :, y, xx] = x[b, m]       # last writer wins
    return out


# -------------------------------------------------------------- scatter --

@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("mode", ["add", "cover"])
def test_scatter_connection_matches_jax(mode, out_of_range):
    """Forward and the custom backward (every entity reads the output
    gradient at its own cell; an out-of-range entity writes nothing and
    gets zero) against the JAX package's one-hot path."""
    B, M, N, H, W = 3, 40, 5, 4, 4          # M >> H*W forces collisions
    x, loc = _scatter_inputs(1, B, M, N, H, W, out_of_range)
    gout = np.random.default_rng(2).standard_normal((B, N, H, W)).astype(
        np.float32)
    with jax.default_matmul_precision("float32"):
        want, want_g = jax.value_and_grad(
            lambda x_: jnp.sum(jax_network.scatter_connection(
                x_, (H, W), jnp.asarray(loc), mode) * gout),
            )(jnp.asarray(x))
        want_out = jax_network.scatter_connection(jnp.asarray(x), (H, W),
                                                  jnp.asarray(loc), mode)
    xt = torch.from_numpy(x).requires_grad_()
    out = network.scatter_connection(xt, (H, W), torch.from_numpy(loc), mode)
    (out * torch.from_numpy(gout)).sum().backward()
    _close(out, want_out, "out")
    _close(xt.grad, want_g, "dx")
    if out_of_range:
        assert float(xt.grad[0, 2].abs().max()) == 0.0
        assert float(xt.grad[1, 3].abs().max()) == 0.0


@pytest.mark.parametrize("mode", ["add", "cover"])
def test_origin_scatter_connection_matches_jax(mode):
    """The oracle against the JAX oracle and a numpy loop (sequential
    writes: the last writer wins in cover mode)."""
    B, M, N, H, W = 3, 40, 5, 4, 4
    x, loc = _scatter_inputs(3, B, M, N, H, W)
    want = jax_origin.scatter_connection(jnp.asarray(x), (H, W),
                                         jnp.asarray(loc), mode)
    got = origin.scatter_connection(torch.from_numpy(x), (H, W),
                                    torch.from_numpy(loc), mode)
    _close(got, want)
    _close(got, _np_scatter(x, H, W, loc, mode), "numpy")
    _close(origin.ScatterConnection(mode)(torch.from_numpy(x), (H, W),
                                          torch.from_numpy(loc)), want)


def test_scatter_cover_backward_is_not_autograd_through_the_forward():
    """Colliding entities all read the winner's cell gradient (the JAX
    package's VJP), where autograd through the forward would give it to the
    winner only."""
    x, loc = _scatter_inputs(4, 1, 3, 2, 2, 2)
    loc[0] = [(0, 0), (0, 0), (1, 1)]
    xt = torch.from_numpy(x).requires_grad_()
    network.scatter_connection(xt, (2, 2), torch.from_numpy(loc),
                               "cover").sum().backward()
    assert torch.equal(xt.grad, torch.ones_like(xt))


def test_scatter_connection_wrapper_and_validation():
    x, loc = (torch.from_numpy(a) for a in _scatter_inputs(5, 2, 5, 3, 4, 4))
    sc = network.ScatterConnection("add")
    assert sc(x, (4, 4), loc).shape == (2, 3, 4, 4)
    assert torch.equal(sc(x, [4, 4], loc),
                       network.scatter_connection(x, (4, 4), loc, "add"))
    with pytest.raises(ValueError, match="scatter_connection: x must be"):
        network.scatter_connection(x[0], (4, 4), loc)
    with pytest.raises(ValueError, match="location must have shape"):
        network.scatter_connection(x, (4, 4), loc[:, :-1])
    with pytest.raises(ValueError, match="integer tensor"):
        network.scatter_connection(x, (4, 4), loc.float())
    with pytest.raises(ValueError, match="scatter_type must be"):
        network.scatter_connection(x, (4, 4), loc, "max")


# ------------------------------------------------------ policy-head ops --

def test_update_ae_matches_jax():
    """The end flag (sample == entity_num) adds nothing; ragged entity_num."""
    rng = np.random.default_rng(6)
    B, M, D = 5, 7, 4
    ae = rng.standard_normal((B, D)).astype(np.float32)
    keys = rng.standard_normal((B, M, D)).astype(np.float32)
    entity_num = np.array([7, 3, 5, 7, 1], np.int32)
    sample = np.array([2, 3, 0, 6, 1], np.int32)      # rows 1 and 4 end
    want = jax_models.update_ae(*map(jnp.asarray, (ae, keys, sample,
                                                   entity_num)))
    got = models.update_ae(*(torch.from_numpy(a) for a in
                             (ae, keys, sample, entity_num)))
    _close(got, want)
    _close(got[[1, 4]], ae[[1, 4]], "end rows unchanged")


def test_lstm_activation_matches_jax():
    """torch's i, f, g, o gate order, as the JAX helper."""
    rng = np.random.default_rng(7)
    B, H = 4, 6
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    args = (f(B, 4 * H), f(B, 4 * H), f(4 * H), f(B, H), f(B, H))
    want = jax_models.lstm_activation(*map(jnp.asarray, args))
    got = models.lstm_activation(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        _close(g, w)


def test_pre_sample_matches_jax():
    rng = np.random.default_rng(8)
    B, M, H = 3, 9, 5
    mat = rng.standard_normal((B, M, H)).astype(np.float32)
    vec = rng.standard_normal((B, H)).astype(np.float32)
    mask = rng.uniform(size=(B, M)) > 0.3
    with jax.default_matmul_precision("float32"):
        want = jax_models.pre_sample(*map(jnp.asarray, (mat, vec, mask)))
    got = models.pre_sample(*(torch.from_numpy(a) for a in (mat, vec, mask)))
    _close(got, want)


# ---------------------------------------------------- entity selection --

def _selection_setup(seed, B=4, M=6, Dk=8, H=5):
    """numpy head weights (init_entity_selection's scales), keys, mask,
    ragged entity_num, initial embedding and state."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    arrays = models.EntitySelectionArrays(
        f(Dk, 4 * H) / np.sqrt(Dk), f(H, 4 * H) / np.sqrt(H),
        0.1 * f(4 * H), f(H, Dk) / np.sqrt(H))
    mask = np.ones((B, M), bool)
    mask[0, 1] = False
    entity_num = np.array([M, 3, M - 2, 1][:B], np.int32)
    return (arrays, f(B, M, Dk), mask, entity_num, f(B, Dk),
            (np.zeros((B, H), np.float32), np.zeros((B, H), np.float32)))


@pytest.mark.parametrize("S", [1, 6])
def test_select_entities_greedy_matches_jax(S):
    """Greedy selection with ragged entity_num and a masked entity: the
    same picks, logits, state and final embedding as the JAX head."""
    arrays, keys, mask, entity_num, ae0, state = _selection_setup(9)
    jparams = jax_models.EntitySelectionParams(*map(jnp.asarray, arrays))
    with jax.default_matmul_precision("float32"):
        want = jax_models.select_entities(
            jparams, jnp.asarray(keys), jnp.asarray(mask),
            jnp.asarray(entity_num), jnp.asarray(ae0),
            tuple(map(jnp.asarray, state)), S)
    params = models.from_jax_params(arrays, device="cpu")
    got = models.select_entities(
        params, torch.from_numpy(keys), torch.from_numpy(mask),
        torch.from_numpy(entity_num), torch.from_numpy(ae0),
        tuple(torch.from_numpy(s) for s in state), S)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int32
    _close(got[1], want[1], "logits")
    for g, w in zip(got[2], want[2]):
        _close(g, w, "state")
    _close(got[3], want[3], "ae")


def test_select_entities_sampled_masks_and_ends():
    """Sampling with a generator: picks of real, selectable entities only,
    each at most once, and the sentinel forever after a row ends."""
    arrays, keys, mask, entity_num, ae0, state = _selection_setup(10)
    params = models.from_jax_params(arrays, device="cpu")
    S = 7
    selected, logits, _, _ = models.select_entities(
        params, torch.from_numpy(keys), torch.from_numpy(mask),
        torch.from_numpy(entity_num), torch.from_numpy(ae0),
        tuple(torch.from_numpy(s) for s in state), S,
        generator=torch.Generator().manual_seed(0))
    assert selected.shape == (S, 4) and logits.shape == (S, 4, 7)
    for b, n in enumerate(entity_num):
        picks, ended = [], False
        for s in selected[:, b].tolist():
            if ended:
                assert s == n
            elif s == n:
                ended = True
            else:
                assert s < n and mask[b, s]
                picks.append(s)
        assert len(picks) == len(set(picks))


def test_init_entity_selection_shapes():
    p = models.init_entity_selection(torch.Generator().manual_seed(0), 8, 5,
                                     3, device="cpu")
    assert [tuple(t.shape) for t in p.parameters()] == [(8, 20), (5, 20),
                                                        (20,), (5, 3)]
    assert float(p.bias.detach().abs().max()) == 0.0


def test_weight_carry_over_round_trips():
    """numpy tuples -> modules -> numpy tuples, for the selection head and
    the AlphaStar example's Params (its LSTM core through the existing
    conversion)."""
    arrays = chip_smoke.alphastar_arrays(np.random.default_rng(11),
                                         **chip_smoke.AS_CFG)
    back = models.to_numpy_params(models.from_jax_params(arrays,
                                                         device="cpu"))
    flat = lambda t: jax.tree_util.tree_leaves(t)
    assert type(back) is models.AlphaStarArrays
    assert type(back.sel) is models.EntitySelectionArrays
    for g, w in zip(flat(back), flat(arrays)):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------ the AlphaStar train step --

def _jax_params(arrays):
    """The numpy arrays as the JAX example's pytree (its LSTM core as the
    JAX package's LSTMParams, its head as EntitySelectionParams)."""
    j = lambda a: jnp.asarray(a)
    return {"ent_w": j(arrays.ent_w), "ent_b": j(arrays.ent_b),
            "spatial_w": j(arrays.spatial_w),
            "core": jax_network.LSTMParams(
                *(tuple(map(j, f)) if isinstance(f, tuple) else j(f)
                  for f in arrays.core)),
            "act_w": j(arrays.act_w), "val_w": j(arrays.val_w),
            "ae_w": j(arrays.ae_w),
            "sel": jax_models.EntitySelectionParams(*map(j, arrays.sel))}


def _jax_loss(p, x, H, W, S):
    """examples/alphastar_policy_training.py:82-129 on a given batch, with
    greedy selection (rng=None)."""
    T1, B, M, _ = x["ent_feats"].shape
    N = p["ent_w"].shape[1]
    emb = jnp.tanh(x["ent_feats"] @ p["ent_w"] + p["ent_b"])
    spatial = jax_network.scatter_connection(
        emb.reshape(T1 * B, M, N), (H, W),
        x["locations"].reshape(T1 * B, M, 2), "add")
    spatial = spatial.reshape(T1, B, N * H * W) @ p["spatial_w"]
    core_in = jnp.concatenate([jnp.mean(emb, axis=2), jnp.tanh(spatial)],
                              axis=-1)
    y, _ = jax_network.lstm_fused(p["core"], core_in, None, "LN")
    value = y @ p["val_w"]
    logits = y[:-1] @ p["act_w"]
    actions, rewards = x["actions"], x["rewards"]
    vt = jax_ops.vtrace_error(jax_origin.vtrace_data(
        logits, x["behaviour"], actions, value, rewards, None))
    logp_b = jax.lax.stop_gradient(jax_logp(x["behaviour"], actions))
    rhos = jnp.minimum(jnp.exp(jax.lax.stop_gradient(jax_logp(
        logits, actions)) - logp_b), 1.0)
    upgo = jax_ops.upgo_loss(logits, rhos, actions, rewards, value)
    ae0 = jnp.tanh(y[-1] @ p["ae_w"])
    Hs = p["sel"].w_hh.shape[0]
    entity_num = x["entity_num"]
    selected, sel_logits, _, _ = jax_models.select_entities(
        p["sel"], emb[-1], jnp.ones((B, M), bool), entity_num, ae0,
        (jnp.zeros((B, Hs)), jnp.zeros((B, Hs))), S)
    is_end = selected == entity_num[None, :]
    after_end = (jnp.cumsum(is_end.astype(jnp.int32), axis=0) - is_end) > 0
    sel_logp = jnp.where(after_end, 0.0, jax_logp(sel_logits, selected))
    adv = jax.lax.stop_gradient(jnp.sum(rewards, 0) - value[0])
    sel_loss = -jnp.mean(adv * jnp.sum(sel_logp, axis=0))
    total = (vt.policy_loss + 0.5 * vt.value_loss - 0.01 * vt.entropy_loss
             + 0.2 * upgo + 0.1 * sel_loss)
    return total, {"total": total, "pg": vt.policy_loss,
                   "value": vt.value_loss, "upgo": upgo, "select": sel_loss}


def _port_name(path):
    """A JAX pytree path -> the port module's parameter name."""
    keys = [str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
            for k in path]
    return ".".join(keys)


def test_alphastar_step_matches_jax():
    """One step of the example module's AlphaStar trainer (the example's
    configuration, greedy selection, torch.optim.Adam(3e-4)) against the
    same composition of JAX functions with optax.adam(3e-4), from the same
    numpy weights and batch: the metrics, every gradient, and the updated
    parameters by the train step's Adam rule."""
    cfg = chip_smoke.AS_CFG
    rng = np.random.default_rng(12)
    arrays = chip_smoke.alphastar_arrays(rng, **cfg)
    batch = chip_smoke.alphastar_batches(rng, 1, **cfg)[0]

    jp = _jax_params(arrays)
    jx = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("float32"):
        (_, want_m), want_g = jax.value_and_grad(
            lambda p: _jax_loss(p, jx, cfg["H"], cfg["W"],
                                chip_smoke.AS_SELECTIONS), has_aux=True)(jp)
    opt = optax.adam(alphastar.LR)
    updates, _ = opt.update(want_g, opt.init(jp), jp)
    want_p = optax.apply_updates(jp, updates)

    kernels.reset_launch_counts()
    p, opt, (x,) = chip_smoke.alphastar_setup(arrays, [batch],
                                              torch.device("cpu"))
    got_m, got_g = alphastar.train_step(p, opt, x, **chip_smoke.AS_STEP)
    got_p = dict(p.named_parameters())
    assert set(kernels.launch_counts().values()) == {0}   # CPU: plain only
    for k in want_m:
        _close(got_m[k], want_m[k], k)
    named = lambda tree: {_port_name(path): leaf for path, leaf in
                          jax.tree_util.tree_flatten_with_path(tree)[0]}
    want_g, want_p = named(want_g), named(want_p)
    assert set(want_g) == set(got_g)
    for k, w in want_g.items():
        atol = ATOL + chip_smoke.GRAD_ATOL_REL * float(jnp.abs(w).max())
        _close(got_g[k], w, f"grad {k}", atol=atol)
    chip_smoke.check_adam_params(
        "alphastar", got_p,
        {k: torch.from_numpy(np.array(v)) for k, v in want_p.items()},
        [{k: torch.from_numpy(np.array(v)) for k, v in want_g.items()}],
        alphastar.LR, 1)
