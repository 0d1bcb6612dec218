"""Entry points of the port, the counterpart of the JAX package's
__graft_entry__.py:

 - `entry()`: the flagship model's forward and its example arguments at
   the JAX entry's tiny setup (T=16, B=32, obs 64, hidden 128, 2 layers,
   32 actions);
 - `dryrun_multichip(n)`: the data x model sharded V-trace train step in a
   world of n ranks, with the eleven other legs of JAX's dryrun, each held
   against the unsharded port op on the rank's own device.

Parameters and batches come from a seeded torch.Generator or numpy on the
CPU and are moved to `device`.

    python -m di_hpc_tpu_torch.entry N [--device cpu]
"""

from __future__ import annotations

import copy
import hashlib
import json
import math
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from . import network, ops, parallel
from .kernels import _build, launch_counts
from .models import (
    ActorCriticArrays, ActorCriticConfig, ActorCriticParams, TrainBatch,
    actor_critic_forward, actor_critic_shardings, from_jax_params,
    init_actor_critic, make_sharded_train_step, make_train_step,
)
from .origin.rnn import LSTMParams
from .parallel._comm import reduce
from .parallel.mesh import sharding_leaves
from .utils.checkpoint import tree_flatten

__all__ = ["entry", "dryrun_multichip"]


def _tiny_setup(T=8, B=16, obs_dim=32, hidden=64, layers=2, actions=16,
                device="cuda", seed=0):
    """(cfg, params, TrainBatch) with random weights and batch."""
    cfg = ActorCriticConfig(obs_dim, hidden, layers, actions)
    gen = torch.Generator().manual_seed(seed)
    params = init_actor_critic(cfg, gen, device)
    batch = TrainBatch(
        obs=torch.randn((T + 1, B, obs_dim), generator=gen).to(device),
        actions=torch.randint(0, actions, (T, B), generator=gen).to(device),
        rewards=torch.randn((T, B), generator=gen).to(device),
        behaviour_logits=torch.randn((T, B, actions),
                                     generator=gen).to(device),
    )
    return cfg, params, batch


def entry(device="cuda"):
    """(fn, example_args): the flagship forward `fn(params, obs) -> (logits,
    value)` and (params, obs (17, 32, 64)) on `device`."""
    cfg, params, batch = _tiny_setup(T=16, B=32, obs_dim=64, hidden=128,
                                     layers=2, actions=32, device=device)

    def forward(params, obs):
        logits, value, state = actor_critic_forward(params, obs, None,
                                                    cfg.norm_type)
        return logits, value

    return forward, (params, batch.obs)


# ------------------------------------------------- the train step legs ----

LR = 1e-3   # optax.adam(1e-3), as the JAX dryrun's optimizer

# The sharded step against the unsharded port step, both from the same
# parameters and Adam state.  float32: the same function up to the order of
# the sums over the batch (each rank's shard, then the ranks in rank order),
# so the metrics at rtol 1e-4, atol 1e-5, and the gradients also at 1e-4 of
# the leaf's largest |entry|, since an entry is a sum over (T+1)*B rows.
# bf16: the bf16 train step's bounds in tests/test_torch_bf16.py (metrics
# 2e-3, gradients 5e-2 of the leaf's largest |entry|): a bf16 value near a
# rounding boundary can round the other way on the two sides.  The new
# parameters, every step: within one Adam step of the old ones, and within
# PARAM_ATOL of Adam's update from the same state by the gathered sharded
# gradient (each rank's optimizer on its own shards is Adam on the whole).
# At the first step also within PARAM_ATOL of the unsharded step's where
# |grad| exceeds GRAD_BIG of the leaf's largest and the gradient's own
# bound: Adam's first step moves an entry by lr in the direction of its
# gradient's sign, whatever its size, so an entry whose gradient lies
# within the gradient check's bound of zero may move either way on the two
# sides (in bf16 each rank's gradient GEMM rounds its shard's sum to bf16
# before the sum over the ranks, where the unsharded step rounds the whole
# sum once).  Later steps divide by the moments, and a gradient's error
# within its bound moves the update by a part of lr, so there the
# unsharded step's parameters are not held tighter than one Adam step.
TRAIN_TOLERANCE = {
    None: {"metrics": {"rtol": 1e-4, "atol": 1e-5},
           "grads": {"rtol": 1e-4, "atol": 1e-5, "atol_rel": 1e-4}},
    torch.bfloat16: {"metrics": {"rtol": 2e-3, "atol": 2e-3},
                     "grads": {"rtol": 0.0, "atol": 0.0, "atol_rel": 5e-2}},
}
PARAM_ATOL = 2e-6
GRAD_BIG = 1e-3


def check_close(name, got, want, rtol=0.0, atol=0.0, atol_rel=0.0) -> dict:
    """The largest |got - want| (and over max|want|); raises where |got -
    want| > atol + atol_rel * max|want| + rtol * |want|."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{name}: shape {tuple(g.shape)} vs "
                             f"{tuple(w.shape)} or non-finite values")
    d = (g - w).abs()
    scale = float(w.abs().max()) if w.numel() else 0.0
    err = float(d.max()) if d.numel() else 0.0
    if not bool((d <= atol + atol_rel * scale + rtol * w.abs()).all()):
        raise AssertionError(f"{name}: max |got - want| {err} outside "
                             f"rtol={rtol}, atol={atol} + {atol_rel} * "
                             f"max|want| ({scale})")
    return {"max_abs_err": err, "max_err_over_max": err / max(scale, 1e-30)}


def adam_step_bound(lr: float, betas, t: int) -> float:
    """The largest |update| of Adam's t-th step: lr * |m_hat| / sqrt(v_hat)
    is at most lr * (1 - b1) / (1 - b1^t) * sqrt((1 - b2^t) / (1 - b2) *
    sum_{j<t} (b1^2 / b2)^j) (Cauchy-Schwarz over the moments' sums); lr
    at t = 1."""
    b1, b2 = betas
    q = b1 * b1 / b2
    return lr * (1 - b1) / (1 - b1 ** t) * math.sqrt(
        (1 - b2 ** t) / (1 - b2) * sum(q ** j for j in range(t)))


def _named(tree) -> dict:
    """name -> tensor of an ActorCriticArrays of tensors, by the module's
    parameter names ("embed_w", "lstm.wx.0", ...)."""
    leaves, rebuild = tree_flatten(tree)
    module = ActorCriticParams(*rebuild([t.detach() for t in leaves]))
    return {k: v.detach() for k, v in module.named_parameters()}


def arrays_from_named(x: dict, prefix: str, num_layers: int
                      ) -> ActorCriticArrays:
    """The ActorCriticArrays of numpy arrays stored under `prefix + name`."""
    get = lambda name: x[prefix + name]
    layers = range(num_layers)
    lstm = LSTMParams(tuple(get(f"lstm.wx.{l}") for l in layers),
                      tuple(get(f"lstm.wh.{l}") for l in layers),
                      get("lstm.bias"), get("lstm.ln_gamma_x"),
                      get("lstm.ln_beta_x"), get("lstm.ln_gamma_h"),
                      get("lstm.ln_beta_h"))
    return ActorCriticArrays(get("embed_w"), get("embed_b"), lstm,
                             get("policy_w"), get("policy_b"),
                             get("value_w"), get("value_b"))


class LaunchTally:
    """Kernel launches and LSTM layer routes of the calls run through it."""

    def __init__(self):
        self.launches, self.routes = {}, {}

    def __call__(self, fn, *args):
        launches, routes = launch_counts(), dict(network.lstm_fused.routes)
        out = fn(*args)
        for total, now, before in (
                (self.launches, launch_counts(), launches),
                (self.routes, network.lstm_fused.routes, routes)):
            for k in now:
                total[k] = total.get(k, 0) + now[k] - before[k]
        return out


def _load_sharded_state(ref, ref_opt, params, opt, shardings) -> None:
    """The unsharded reference takes the sharded step's parameters and Adam
    state, gathered."""
    with torch.no_grad():
        full = parallel.gather_params(params.params(), shardings)
        for q, p, v, sh in zip(tree_flatten(ref.params())[0],
                               tree_flatten(params.params())[0],
                               tree_flatten(full)[0],
                               sharding_leaves(shardings)):
            q.copy_(v)
            st = opt.state[p]
            ref_opt.state[q] = {
                "step": st["step"].clone(),
                **{k: parallel.gather_params(st[k], sh).clone()
                   for k in ("exp_avg", "exp_avg_sq")}}


def sharded_train_steps(cfg, arrays, batches, mesh, compute_dtype=None,
                        lr=LR, tally=None, tolerance=None, name="train"):
    """`len(batches)` steps of models.make_sharded_train_step over `mesh`
    (the placement of actor_critic_shardings, Adam(lr)) from the global
    parameters `arrays` (numpy ActorCriticArrays) on the global TrainBatches
    `batches` (on mesh.device), each step held against models.
    make_train_step on the whole batch, started from the same parameters
    and Adam state: the metrics, the gathered gradients and the gathered new
    parameters, at `tolerance` (default TRAIN_TOLERANCE[compute_dtype];
    the parameters by PARAM_ATOL and the Adam step bound).  The sharded
    calls run through `tally`.  Returns (results, checks): results maps
    "step{i}/{metrics,grad,param}/{name}" to numpy arrays, the global values
    every rank must hold bit for bit."""
    tol = tolerance or TRAIN_TOLERANCE[compute_dtype]
    tally = tally or LaunchTally()
    dev = mesh.device
    shardings = actor_critic_shardings(mesh, cfg.num_layers)
    params = ActorCriticParams(*parallel.shard_params(
        from_jax_params(arrays, device=dev).params(), shardings))
    opt = torch.optim.Adam(params.parameters(), lr=lr)
    step = make_sharded_train_step(cfg, opt, mesh,
                                   compute_dtype=compute_dtype)
    ref = from_jax_params(arrays, device=dev)
    ref_opt = torch.optim.Adam(ref.parameters(), lr=lr)
    ref_step = make_train_step(cfg, ref_opt, compute_dtype=compute_dtype)
    results, checks = {}, {}
    for i, batch in enumerate(batches):
        if i:
            _load_sharded_state(ref, ref_opt, params, opt, shardings)
        old = {k: p.detach().clone() for k, p in ref.named_parameters()}
        adam = [q.detach().clone() for q in ref.parameters()]
        adam_opt = torch.optim.Adam(adam, lr=lr)
        adam_opt.load_state_dict(copy.deepcopy(ref_opt.state_dict()))
        want = ref_step(ref, batch)
        local = parallel.shard_batch_pytree(mesh, batch,
                                            TrainBatch(1, 1, 1, 1))
        got = tally(step, params, local)
        with torch.no_grad():
            leaves, rebuild = tree_flatten(params.params())
            grads = _named(parallel.gather_params(
                rebuild([p.grad for p in leaves]), shardings))
            new = _named(parallel.gather_params(params.params(), shardings))
        want_p = {k: p.detach() for k, p in ref.named_parameters()}
        want_g = {k: p.grad for k, p in ref.named_parameters()}
        for q, k in zip(adam, want_p):      # ref.parameters()'s order
            q.grad = grads[k].clone()
        adam_opt.step()
        adam_p = dict(zip(want_p, adam))
        t = int(opt.state[next(iter(params.parameters()))]["step"])
        bound = adam_step_bound(lr, opt.param_groups[0]["betas"], t) + 1e-6
        tag = f"step{i}"
        where = f"{name} {tag}"
        checks[tag] = {"metrics": {k: check_close(
            f"{where} {k}", got[k], want[k], **tol["metrics"]) for k in want}}
        for leaf in want_g:
            g_err = check_close(f"{where} grad {leaf}", grads[leaf],
                                want_g[leaf], **tol["grads"])
            moved = float((new[leaf] - old[leaf]).abs().max())
            if moved > bound:
                raise AssertionError(f"{where} param {leaf}: moved {moved}, "
                                     f"more than one Adam step ({bound})")
            checks[tag][leaf] = {
                "grad": g_err, "param_moved": moved,
                "param_vs_adam": check_close(
                    f"{where} param {leaf} against Adam's update by the "
                    f"gathered gradient", new[leaf], adam_p[leaf],
                    atol=PARAM_ATOL)}
            if i == 0:
                w_g = want_g[leaf].abs()
                big = w_g > max(GRAD_BIG, tol["grads"]["atol_rel"]) * \
                    w_g.max()
                checks[tag][leaf]["param_big_grad"] = check_close(
                    f"{where} param {leaf} where |grad| is big",
                    new[leaf][big], want_p[leaf][big], atol=PARAM_ATOL)
        for k, v in got.items():
            results[f"{tag}/metrics/{k}"] = v
        for k in grads:
            results[f"{tag}/grad/{k}"] = grads[k]
            results[f"{tag}/param/{k}"] = new[k]
    return {k: v.detach().cpu().numpy() for k, v in results.items()}, checks


# ------------------------------------------------------- the dryrun ----

DRYRUN_TAG = "DRYRUN_RANK "
# A world that has not finished by then is killed and the dryrun fails.
DRYRUN_TIMEOUT_S = 600

# The legs after the two train steps, in JAX's order, and the tolerance of
# each against the unsharded op (__graft_entry__.py's).
LEG_TOLERANCE = {
    "sp_scan(time=2)": {"rtol": 1e-5, "atol": 1e-5},
    "vtrace_time_sharded": {"rtol": 1e-4, "atol": 1e-5},
    "gae_time_sharded": {"rtol": 1e-4, "atol": 1e-5},
    "td_lambda_time_sharded": {"rtol": 1e-4, "atol": 1e-5},
    "upgo_time_sharded": {"rtol": 1e-4, "atol": 1e-5},
    "c51_batch_sharded": {"rtol": 1e-5, "atol": 1e-6},
    "qrdqn_batch_sharded": {"rtol": 1e-5, "atol": 1e-6},
    "iqn_batch_sharded": {"rtol": 1e-5, "atol": 1e-6},
    "scatter_batch_sharded": {"rtol": 1e-5, "atol": 1e-6},
    "grouped_padding_sharded": {"rtol": 1e-4},
}
# The distributional legs' sizes (__graft_entry__.py:232-297).
TD_B, TD_N, TD_ATOMS, TD_NSTEP, TD_TAU, TD_TAU_PRIME = 16, 6, 11, 3, 5, 6
SCATTER = {"B": 16, "M": 12, "N": 6, "H": 4, "W": 4}


def dryrun_inputs(seed: int = 0) -> dict:
    """Every leg's global inputs as numpy arrays, made from `seed`: the
    tiny setup's parameters ("param/<name>") and batch ("batch/<field>")
    and the other legs' tensors at the JAX dryrun's shapes."""
    cfg, params, batch = _tiny_setup(device="cpu", seed=seed)
    x = {"cfg": np.array(cfg[:4], np.int64)}
    x.update({f"param/{k}": v.detach().numpy()
              for k, v in params.named_parameters()})
    x.update({f"batch/{k}": v.numpy() for k, v in batch._asdict().items()})
    rng = np.random.default_rng(seed + 1)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    u = lambda *s: rng.uniform(0.0, 1.0, s).astype(np.float32)
    i = lambda n, *s: rng.integers(0, n, s).astype(np.int32)

    def softmax(z):
        e = np.exp(z - z.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    B, N, n = TD_B, TD_N, TD_NSTEP
    x.update({
        "sp/a": f(16, 8), "sp/b": u(16, 8),
        "vt/target": f(16, 8, 6), "vt/behaviour": f(16, 8, 6),
        "vt/action": i(6, 16, 8), "vt/value": f(17, 8), "vt/reward": f(16, 8),
        "scan/value": f(17, 8), "scan/reward": f(16, 8),
        "upgo/target": f(16, 8, 6),
        "upgo/rhos": np.exp(0.1 * f(16, 8)).astype(np.float32),
        "c51/dist": softmax(f(B, N, TD_ATOMS)),
        "c51/next_dist": softmax(f(B, N, TD_ATOMS)),
        "c51/act": i(N, B), "c51/next_act": i(N, B), "c51/reward": f(n, B),
        "c51/done": u(B) > 0.8,
        "qr/q": f(B, N, TD_TAU), "qr/next_q": f(B, N, TD_TAU),
        "qr/act": i(N, B), "qr/next_act": i(N, B), "qr/reward": f(n, B),
        "qr/done": (u(B) > 0.8).astype(np.float32),
        "qr/tau": ((np.arange(TD_TAU, dtype=np.float32) + 0.5)
                   / TD_TAU)[None, :, None],
        "iqn/q": f(TD_TAU, B, N), "iqn/next_q": f(TD_TAU_PRIME, B, N),
        "iqn/act": i(N, B), "iqn/next_act": i(N, B), "iqn/reward": f(n, B),
        "iqn/done": (u(B) > 0.8).astype(np.float32),
        "iqn/quantiles": u(TD_TAU, B),
        "scatter/x": f(SCATTER["B"], SCATTER["M"], SCATTER["N"]),
        "scatter/loc": np.stack(
            [i(SCATTER["H"], SCATTER["B"], SCATTER["M"]),
             i(SCATTER["W"], SCATTER["B"], SCATTER["M"])], -1)})
    return x


def _ragged(dev) -> list:
    """The grouped-padding leg's episodes, made as JAX makes them
    (__graft_entry__.py:319-321)."""
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.standard_normal(int(n)).astype(np.float32))
            .to(dev) for n in rng.integers(8, 64, size=16)]


def _leg_calls(t: dict, mesh, sp_mesh) -> dict:
    """name -> (the sharded call, the unsharded op), each giving a tuple
    of tensors: the legs after the train steps, in JAX's order."""
    P, dev = parallel, mesh.device
    calls = {}
    if sp_mesh is not None:
        vt = ops.vtrace_data(t["vt/target"], t["vt/behaviour"],
                             t["vt/action"], t["vt/value"], t["vt/reward"],
                             None)
        v, r = t["scan/value"], t["scan/reward"]
        upgo = (t["upgo/target"], t["upgo/rhos"], t["vt/action"], r, v)
        calls.update({
            "sp_scan(time=2)": (
                lambda: (P.linear_recurrence_reverse_sharded(
                    t["sp/a"], t["sp/b"], sp_mesh, time_axis="time",
                    batch_axis="data"),),
                lambda: (ops.linear_recurrence_reverse(t["sp/a"],
                                                       t["sp/b"]),)),
            "vtrace_time_sharded": (
                lambda: tuple(P.vtrace_error_time_sharded(vt, sp_mesh)),
                lambda: tuple(ops.vtrace_error(vt))),
            "gae_time_sharded": (
                lambda: (P.gae_time_sharded(v, r, sp_mesh),),
                lambda: (ops.gae(ops.gae_data(v, r)),)),
            "td_lambda_time_sharded": (
                lambda: (P.td_lambda_error_time_sharded(v, r, None,
                                                        sp_mesh),),
                lambda: (ops.td_lambda_error(ops.td_lambda_data(v, r,
                                                                None)),)),
            "upgo_time_sharded": (
                lambda: (P.upgo_loss_time_sharded(*upgo, sp_mesh),),
                lambda: (ops.upgo_loss(*upgo),))})

    c51 = ops.dist_nstep_td_data(
        t["c51/dist"], t["c51/next_dist"], t["c51/act"], t["c51/next_act"],
        t["c51/reward"], t["c51/done"], None)
    c51_args = (0.95, -5.0, 5.0, TD_ATOMS, TD_NSTEP)
    qr = ops.qrdqn_nstep_td_data(
        t["qr/q"], t["qr/next_q"], t["qr/act"], t["qr/next_act"],
        t["qr/reward"], t["qr/done"], t["qr/tau"], None)
    iqn = ops.iqn_nstep_td_data(
        t["iqn/q"], t["iqn/next_q"], t["iqn/act"], t["iqn/next_act"],
        t["iqn/reward"], t["iqn/done"], t["iqn/quantiles"], None)
    dp_c51 = P.data_parallel(ops.dist_nstep_td_error, mesh,
                             ops.dist_nstep_td_data(0, 0, 0, 0, 1, 0, None))
    dp_qr = P.data_parallel(ops.qrdqn_nstep_td_error, mesh,
                            ops.qrdqn_nstep_td_data(0, 0, 0, 0, 1, 0, -1,
                                                    None))
    dp_iqn = P.data_parallel(ops.iqn_nstep_td_error, mesh,
                             ops.iqn_nstep_td_data(1, 1, 0, 0, 1, 0, 1,
                                                   None))
    S = SCATTER

    def scatter(sharded: bool):
        x = t["scatter/x"].clone().requires_grad_()
        xs, loc = x, t["scatter/loc"]
        if sharded:
            xs, loc = P.shard_batch_pytree(mesh, (x, loc), batch_dims=0)
        loss = torch.sum(network.scatter_connection(
            xs, (S["H"], S["W"]), loc, "add") ** 2)
        if sharded:     # a sum over the batch: each shard's sum, summed
            loss = reduce(loss, mesh, "data", "sum")
        (grad,) = torch.autograd.grad(loss, x)
        return loss.detach(), grad

    def grouped_padding():
        padded, masks, _ = ops.Padding1D(_ragged(dev), group=2,
                                         group_mode="oracle", device=dev)
        total = torch.zeros((), device=dev)
        n_data = mesh.shape["data"]
        for p, m in zip(padded, masks):
            # Each bucket's rows rounded up to a multiple of the data axis
            # (zero rows, masked out), so that the batch tiles the mesh.
            pad_b = (-p.shape[0]) % n_data
            p = torch.cat([p, p.new_zeros((pad_b,) + p.shape[1:])])
            m = torch.cat([m, m.new_zeros((pad_b,) + m.shape[1:])])
            p_sh, m_sh = P.shard_batch_pytree(mesh, (p, m), batch_dims=0)
            total = total + reduce(torch.sum(p_sh * m_sh), mesh, "data",
                                   "sum")
        return (total,)

    calls.update({
        "c51_batch_sharded": (
            lambda: tuple(dp_c51(c51, *c51_args)),
            lambda: tuple(ops.dist_nstep_td_error(c51, *c51_args))),
        "qrdqn_batch_sharded": (
            lambda: (dp_qr(qr, 0.95, TD_NSTEP)[0],),
            lambda: (ops.qrdqn_nstep_td_error(qr, 0.95, TD_NSTEP)[0],)),
        "iqn_batch_sharded": (
            lambda: (dp_iqn(iqn, 0.95, TD_NSTEP, kappa=0.9)[0],),
            lambda: (ops.iqn_nstep_td_error(iqn, 0.95, TD_NSTEP,
                                            kappa=0.9)[0],)),
        "scatter_batch_sharded": (lambda: scatter(True),
                                  lambda: scatter(False)),
        "grouped_padding_sharded": (
            grouped_padding,
            lambda: (sum(torch.sum(r) for r in _ragged(dev)),))})
    return calls


def _model_axis_size(n_devices: int) -> int:
    """JAX's factoring of n into (data, model): the 4H gate dimension is
    tensor-parallel over 2 ranks when n is even and at least 4."""
    return 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1


def dryrun_meshes(n_devices: int):
    """(mesh, sp_mesh) of the dryrun over this world's n_devices ranks:
    {"data": n // model, "model": model}, and {"time": 2, "data": n // 2}
    for an even n (else None)."""
    model = _model_axis_size(n_devices)
    mesh = parallel.make_mesh({"data": n_devices // model, "model": model})
    sp_mesh = (parallel.make_mesh({"time": 2, "data": n_devices // 2})
               if n_devices % 2 == 0 else None)
    return mesh, sp_mesh


def run_legs(x: dict, mesh, sp_mesh):
    """One rank's dryrun on its meshes (dryrun_meshes): every leg on this
    rank's device, each against the unsharded op.  Returns (results: leg
    outputs, metrics, gathered gradients and new parameters as numpy, the
    same on every rank; report: meshes, the sharded calls' kernel launches
    and LSTM routes, each leg's errors, rank 0's line)."""
    n_devices = math.prod(mesh.shape.values())
    dev = mesh.device
    cfg = ActorCriticConfig(*(int(v) for v in x["cfg"]))
    arrays = arrays_from_named(x, "param/", cfg.num_layers)
    batch = TrainBatch(*(torch.from_numpy(x[f"batch/{k}"]).to(dev)
                         for k in TrainBatch._fields))
    tally = LaunchTally()
    results, checks = {}, {}
    for leg, dtype in (("train_step_sharded", None),
                       ("train_step_bf16_sharded", torch.bfloat16)):
        res, chk = sharded_train_steps(cfg, arrays, [batch], mesh, dtype,
                                       tally=tally, name=leg)
        results.update({f"{leg}/{k[len('step0/'):]}": v
                        for k, v in res.items()})
        checks[leg] = chk["step0"]
    t = {k: torch.from_numpy(v).to(dev) for k, v in x.items()
         if k.split("/")[0] in ("sp", "vt", "scan", "upgo", "c51", "qr",
                                "iqn", "scatter")}
    calls = _leg_calls(t, mesh, sp_mesh)
    for name, (sharded, plain) in calls.items():
        want = plain()
        got = tally(sharded)
        checks[name] = {"max_abs_err": max(
            check_close(f"{name}[{i}]", g, w, **LEG_TOLERANCE[name])[
                "max_abs_err"] for i, (g, w) in enumerate(zip(got, want)))}
        for i, g in enumerate(got):
            results[f"{name}/{i}"] = g.detach().cpu().numpy()
    total = float(results["train_step_sharded/metrics/total_loss"])
    line = (f"dryrun_multichip({n_devices}) OK: mesh={dict(mesh.shape)} "
            f"total_loss={total:.4f} "
            + " ".join(f"{name}=OK" for name in
                       ["train_step_bf16_sharded", *calls]))
    report = {"mesh": mesh.shape,
              "sp_mesh": sp_mesh.shape if sp_mesh is not None else None,
              "device": str(dev), "launches": tally.launches,
              "lstm_routes": tally.routes, "checks": checks, "line": line}
    return results, report


def digest(results: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(results):
        h.update(k.encode())
        h.update(np.ascontiguousarray(results[k]).tobytes())
    return h.hexdigest()


def _rank_main(workdir: str, rank: int, world: int) -> int:
    """One rank of run_world: the legs twice (the second run must give the
    first's bits), the results written to rank{rank}.npz and the report
    printed on one line after DRYRUN_TAG."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs accumulate in float32, as the TPU's do.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    work = Path(workdir)
    parallel.initialize(f"file://{work / 'store'}", world, rank)
    x = dict(np.load(work / "inputs.npz"))
    meshes = dryrun_meshes(world)
    results, report = run_legs(x, *meshes)
    again, _ = run_legs(x, *meshes)
    differ = [k for k in results
              if results[k].tobytes() != again[k].tobytes()]
    if differ:
        raise AssertionError(f"rank {rank}: a second run gave other bits: "
                             f"{differ}")
    np.savez(work / f"rank{rank}.npz", **results)
    report.update(rank=rank, world=world, digest=digest(results),
                  backend=dist.get_backend() if dist.is_initialized()
                  else None)
    print(DRYRUN_TAG + json.dumps(report), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def run_world(n_devices: int, device, inputs: dict, workdir) -> list:
    """Runs the dryrun's legs on `inputs` (dryrun_inputs' keys) in a world
    of n_devices rank processes, as parallel.initialize sets it up: NCCL
    when the cards cover the world, else gloo with the ranks sharing the
    cards; on the CPU (gloo, no card visible) only for device="cpu".  Each
    rank writes its results to `workdir`/rank{r}.npz.  Returns the ranks'
    reports, after checking that every rank's results have rank 0's bits."""
    workdir = Path(workdir)
    np.savez(workdir / "inputs.npz", **inputs)
    env = None
    if str(device) == "cpu":
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
               "OMP_NUM_THREADS": "1"}
    else:
        _build.library()    # built once here; the ranks only load it
    outs = parallel.spawn_world(
        ["-m", "di_hpc_tpu_torch.entry", "--rank", str(workdir)], n_devices,
        DRYRUN_TIMEOUT_S, env=env)
    reports = [json.loads(next(ln for ln in out.splitlines()
                               if ln.startswith(DRYRUN_TAG))
                          [len(DRYRUN_TAG):]) for out in outs]
    differ = [r["rank"] for r in reports if r["digest"] !=
              reports[0]["digest"]]
    if differ:
        raise AssertionError(f"dryrun_multichip: ranks {differ} hold other "
                             f"results than rank 0's bits")
    return reports


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """The JAX dryrun (__graft_entry__.py:51-343) in a world of n_devices
    rank processes: the data x model sharded V-trace train step (mesh
    {"data": n // model, "model": model}, model = 2 for an even n >= 4;
    models.make_sharded_train_step) in float32 and in bf16 mixed
    precision, each held against the unsharded port step (metrics,
    gradients, new parameters), where JAX checks only that the loss is not
    NaN; then, for an even n, the time-sharded scan and four losses on a
    {"time": 2, "data": n // 2} mesh, and C51, QR-DQN, IQN, the scatter
    connection (with its gradient) and grouped padding sharded over the
    batch, each against the unsharded op at the JAX dryrun's tolerance.
    Every rank's results must equal rank 0's bit for bit, and a second run
    the first.

    JAX fakes n devices in one process; here each rank is a process
    (run_world).  The ranks run on the cards; there is no fallback to the
    CPU, which takes `device="cpu"`.  Prints rank 0's line, JAX's
    `dryrun_multichip(n) OK: mesh={...} total_loss=... <leg>=OK ...`, and
    returns every rank's report."""
    if str(device) != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device is visible; "
                           "pass device='cpu' for a world of CPU processes")
    with tempfile.TemporaryDirectory() as tmp:
        reports = run_world(n_devices, device, dryrun_inputs(), tmp)
    print(reports[0]["line"], flush=True)
    return reports


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(_rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4])))
    import argparse

    parser = argparse.ArgumentParser(
        description="The sharded train step and the other legs of the JAX "
                    "dryrun in a world of N rank processes.")
    parser.add_argument("n", type=int, nargs="?", default=8)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    dryrun_multichip(args.n, args.device)
