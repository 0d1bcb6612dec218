"""The port's parallel layer (di_hpc_tpu_torch.parallel, on torch.distributed
with gloo) against the JAX package's unsharded ops, on the CPU: the
counterparts of tests/test_parallel.py and tests/test_multihost.py.

Inputs are made with numpy from a seed in the pytest process and written
to a file.  One world of 8 processes (the JAX tests' 8-device mesh) runs
every case of tests/test_parallel.py, and worlds of 2 and 4 processes run
the multi-host case; each world is spawned once per module, each rank
writes its results, and the tests compare them here.  The workers run this
file as a script and import no JAX.  Every rank's result must equal rank
0's bit for bit (the collectives reduce in rank order), and a second run
of each case in the same world the first.

Tolerances are the JAX tests' own: rtol 1e-4, atol 1e-5 for the scans and
planes and their gradients; rtol 1e-5 for the global means (and atol 1e-7
for the data-parallel gradient); rtol 1e-4, atol 1e-6 for the time-sharded
V-trace gradients.  The gradients through the sharded recurrences are held
against jax.grad of JAX's sharded functions on a mesh of the same shape
(under jax.jit, which this JAX needs to differentiate a shard_map).  The port sums its shards' means in another order than JAX's
one-device mean.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
# A world that has not finished by then is killed and its tests fail.
JOIN_TIMEOUT_S = 300


# ------------------------------------------------------------- inputs ----

def _inputs() -> dict:
    rng = np.random.default_rng(1234)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s).astype(np.float32)
    i = lambda n, *s: rng.integers(0, n, s).astype(np.int32)
    x = {"splits_a": f(48, 16), "splits_b": u(-0.99, 0.99, 48, 16),
         "scan_a": f(64, 16), "scan_b": u(-0.99, 0.99, 64, 16),
         "gae_value": f(129, 8), "gae_reward": f(128, 8),
         "td_value": f(65, 16), "td_reward": f(64, 16),
         "td_weight": u(0.3, 2.0, 16),
         "vt_to": f(32, 8, 6), "vt_bo": f(32, 8, 6), "vt_act": i(6, 32, 8),
         "vt_value": f(33, 8), "vt_reward": f(32, 8),
         "upgo_to": f(40, 6, 5), "upgo_rhos": np.exp(0.2 * f(40, 6)),
         "upgo_act": i(5, 40, 6), "upgo_rew": f(40, 6),
         "upgo_value": f(41, 6),
         "dp_to": f(16, 32, 6), "dp_bo": f(16, 32, 6), "dp_act": i(6, 16, 32),
         "dp_value": f(17, 32), "dp_reward": f(16, 32),
         "ppo_ln": f(64, 10), "ppo_lo": f(64, 10), "ppo_act": i(10, 64),
         "ppo_vn": f(64), "ppo_vo": f(64), "ppo_adv": f(64), "ppo_ret": f(64),
         "q": f(64, 10), "nq": f(64, 10), "q_rew": f(3, 64),
         "q_done": (rng.uniform(size=64) > 0.5).astype(np.float32),
         "g_to": f(8, 16, 5), "g_bo": f(8, 16, 5), "g_act": i(5, 8, 16),
         "g_value": f(9, 16), "g_reward": f(8, 16),
         "scan_w": f(64, 16)}
    return x


def _multihost_inputs(n: int) -> dict:
    """test_multihost.py's global batch: T=6, 4 columns per process, N=5."""
    rng = np.random.default_rng(0)
    T, B, N = 6, 4 * n, 5
    return {"to": rng.standard_normal((T, B, N)).astype(np.float32),
            "bo": rng.standard_normal((T, B, N)).astype(np.float32),
            "act": rng.integers(0, N, size=(T, B)).astype(np.int32),
            "value": rng.standard_normal((T + 1, B)).astype(np.float32),
            "reward": rng.standard_normal((T, B)).astype(np.float32)}


# ------------------------------------------- the workers' cases (no JAX) ----

def _np(out) -> dict:
    return {k: np.asarray(v.detach().numpy() if isinstance(v, torch.Tensor)
                          else v) for k, v in out.items()}


def _world8_cases(P, ops, x):
    """name -> () -> {key: array}, each case of tests/test_parallel.py."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    meshes = {}

    def mesh(**sizes):
        key = tuple(sizes.items())
        if key not in meshes:
            meshes[key] = P.make_mesh(sizes)
        return meshes[key]

    def mesh_construction():
        return {"default": json.dumps(P.make_mesh().shape),
                "inferred": json.dumps(
                    P.make_mesh({"time": 4, "data": -1}).shape)}

    def splits(tshards):
        return lambda: {"y": P.linear_recurrence_reverse_sharded(
            t["splits_a"], t["splits_b"],
            mesh(time=tshards, data=8 // tshards), time_axis="time",
            batch_axis="data" if tshards < 8 else None)}

    def scan(direction):
        fn = (P.linear_recurrence_reverse_sharded if direction == "rev"
              else P.linear_recurrence_forward_sharded)
        return lambda: {"y": fn(t["scan_a"], t["scan_b"],
                                mesh(time=4, data=2), time_axis="time",
                                batch_axis="data")}

    def scan_grad(direction):
        fn = (P.linear_recurrence_reverse_sharded if direction == "rev"
              else P.linear_recurrence_forward_sharded)

        def case():
            a = t["scan_a"].clone().requires_grad_()
            b = t["scan_b"].clone().requires_grad_()
            y = fn(a, b, mesh(time=4, data=2), time_axis="time",
                   batch_axis="data")
            ga, gb = torch.autograd.grad((y * t["scan_w"]).sum(), (a, b))
            return {"a": ga, "b": gb}
        return case

    def lambda_grad():
        value = t["td_value"].clone().requires_grad_()
        reward = t["td_reward"].clone().requires_grad_()
        ret = P.lambda_returns_time_sharded(
            value, reward, mesh(time=4, data=2), 0.9, 0.8, batch_axis="data")
        gv, gr = torch.autograd.grad((ret * t["scan_w"]).sum(),
                                     (value, reward))
        return {"value": gv, "reward": gr}

    def vtrace_grads():
        to, value, reward = (t[k].clone().requires_grad_()
                             for k in ("vt_to", "vt_value", "vt_reward"))
        losses = P.vtrace_error_time_sharded(ops.vtrace_data(
            to, t["vt_bo"], t["vt_act"], value, reward, None),
            mesh(time=4, data=2), batch_axis="data")
        total = (losses.policy_loss + 0.5 * losses.value_loss
                 - 0.01 * losses.entropy_loss)
        g = torch.autograd.grad(total, (to, value, reward))
        return dict(zip(("to", "value", "reward"), g))

    def gae():
        return {"adv": P.gae_time_sharded(t["gae_value"], t["gae_reward"],
                                          mesh(time=8))}

    def td_lambda():
        return {"loss": P.td_lambda_error_time_sharded(
            t["td_value"], t["td_reward"], t["td_weight"],
            mesh(time=4, data=2), 0.9, 0.8, batch_axis="data")}

    def vtrace():
        m = mesh(time=4, data=2)
        got = P.vtrace_error_time_sharded(ops.vtrace_data(
            t["vt_to"], t["vt_bo"], t["vt_act"], t["vt_value"],
            t["vt_reward"], None), m, batch_axis="data")
        to = t["vt_to"].clone().requires_grad_()
        loss = P.vtrace_error_time_sharded(ops.vtrace_data(
            to, t["vt_bo"], t["vt_act"], t["vt_value"], t["vt_reward"],
            None), m).policy_loss
        (grad,) = torch.autograd.grad(loss, to)
        return {"losses": torch.stack(tuple(got)), "grad": grad}

    def upgo():
        return {"loss": P.upgo_loss_time_sharded(
            t["upgo_to"], t["upgo_rhos"], t["upgo_act"], t["upgo_rew"],
            t["upgo_value"], mesh(time=8))}

    def dp_vtrace():
        dp = P.data_parallel(ops.vtrace_error, mesh(data=8),
                             ops.vtrace_data(1, 1, 1, 1, 1, None))
        return {"losses": torch.stack(tuple(dp(ops.vtrace_data(
            t["dp_to"], t["dp_bo"], t["dp_act"], t["dp_value"],
            t["dp_reward"], None))))}

    def dp_ppo_td():
        m = mesh(data=8)
        dp = P.data_parallel(ops.ppo_error, m,
                             ops.ppo_data(0, 0, 0, 0, 0, 0, 0, None))
        loss, info = dp(ops.ppo_data(
            t["ppo_ln"], t["ppo_lo"], t["ppo_act"], t["ppo_vn"], t["ppo_vo"],
            t["ppo_adv"], t["ppo_ret"], None))
        dp_td = P.data_parallel(ops.q_nstep_td_error, m,
                                ops.q_nstep_td_data(0, 0, 0, 0, 1, 0, None))
        td, per_sample = dp_td(ops.q_nstep_td_data(
            t["q"], t["nq"], t["ppo_act"], t["ppo_act"], t["q_rew"],
            t["q_done"], None), 0.95, 3)
        return {"ppo": torch.stack(tuple(loss) + tuple(info)), "td": td,
                "td_per_sample": per_sample}

    def sharded_grad():
        dp = P.data_parallel(ops.vtrace_error, mesh(data=8),
                             ops.vtrace_data(1, 1, 1, 1, 1, None))
        to = t["g_to"].clone().requires_grad_()
        losses = dp(ops.vtrace_data(to, t["g_bo"], t["g_act"], t["g_value"],
                                    t["g_reward"], None))
        (grad,) = torch.autograd.grad(losses.policy_loss + losses.value_loss,
                                      to)
        return {"grad": grad}

    def reduce():
        from di_hpc_tpu_torch.parallel import _comm

        m = mesh(data=8)
        x = torch.tensor(0.1 * (1 + m.axis_index("data")),
                         requires_grad=True)
        total = _comm.reduce(x, m, "data", "sum")
        mean = _comm.reduce(x, m, "data", "mean")
        (grad,) = torch.autograd.grad(total + mean, x)
        return {"sum": total, "mean": mean, "grad": grad}

    def value_errors():
        out = {}
        try:
            P.linear_recurrence_reverse_sharded(
                t["scan_a"][:50], t["scan_b"][:50], mesh(time=4, data=2))
        except ValueError as e:
            out["time"] = str(e)
        dp = P.data_parallel(ops.vtrace_error, mesh(data=8),
                             ops.vtrace_data(1, 1, 1, 1, 1, None))
        try:
            dp(ops.vtrace_data(*(t[k][:, :30] for k in (
                "dp_to", "dp_bo", "dp_act", "dp_value", "dp_reward")), None))
        except ValueError as e:
            out["batch"] = str(e)
        return out

    return {"mesh_construction": mesh_construction,
            **{f"splits{n}": splits(n) for n in (2, 4, 8)},
            "scan_rev": scan("rev"), "scan_fwd": scan("fwd"), "gae": gae,
            "scan_grad_rev": scan_grad("rev"),
            "scan_grad_fwd": scan_grad("fwd"), "lambda_grad": lambda_grad,
            "vtrace_grads": vtrace_grads,
            "td_lambda": td_lambda, "vtrace": vtrace, "upgo": upgo,
            "dp_vtrace": dp_vtrace, "dp_ppo_td": dp_ppo_td,
            "sharded_grad": sharded_grad, "reduce": reduce,
            "value_errors": value_errors}


def _multihost_case(P, ops, x, rank, world):
    """test_multihost.py's worker: each rank holds its 4 columns, assembles
    the global batch and takes the data-parallel V-trace."""
    mesh = P.make_mesh()
    cols = slice(rank * 4, (rank + 1) * 4)

    def put(v, bdim):
        spec = [None] * v.ndim
        spec[bdim] = "data"
        local = v[:, cols] if bdim == 1 else v[cols]
        return P.global_batch_from_host_local(mesh, spec, local)

    data = ops.vtrace_data(put(x["to"], 1), put(x["bo"], 1),
                           put(x["act"], 1), put(x["value"], 1),
                           put(x["reward"], 1), None)
    dp = P.data_parallel(ops.vtrace_error, mesh,
                         ops.vtrace_data(1, 1, 1, 1, 1, None))
    return {"multihost": lambda: {
        "losses": torch.stack(tuple(dp(data))),
        **{f"global_{k}": v for k, v in zip(
            ("to", "bo", "act", "value", "reward"), data[:5])}}}


def _worker(workdir: Path, rank: int, world: int) -> None:
    import torch.distributed as dist

    from di_hpc_tpu_torch import ops, parallel

    parallel.initialize(f"file://{workdir / 'store'}", world, rank)
    x = dict(np.load(workdir / "inputs.npz"))
    cases = (_world8_cases(parallel, ops, x) if world == 8
             else _multihost_case(parallel, ops, x, rank, world))
    results = {}
    for name, case in cases.items():
        first, again = _np(case()), _np(case())
        for k in first:
            results[f"{name}/{k}"] = first[k]
            results[f"{name}/{k}/again"] = again[k]
    np.savez(workdir / f"rank{rank}.npz", **results)
    dist.destroy_process_group()


# ------------------------------------------------------------ fixtures ----

def _spawn_world(world: int, workdir: Path, inputs: dict) -> list:
    """Runs `world` workers on this file on the CPU; returns each rank's
    results.  The world is killed at JOIN_TIMEOUT_S."""
    np.savez(workdir / "inputs.npz", **inputs)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    chip_smoke.spawn_world([__file__, str(workdir)], world, JOIN_TIMEOUT_S,
                           env=env)
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    x = _inputs()
    return x, _spawn_world(8, tmp_path_factory.mktemp("world8"), x)


@pytest.fixture(scope="module", params=[2, 4])
def multihost(request, tmp_path_factory):
    x = _multihost_inputs(request.param)
    workdir = tmp_path_factory.mktemp(f"world{request.param}")
    return request.param, x, _spawn_world(request.param, workdir, x)


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported in the pytest process only."""
    import jax
    import jax.numpy as jnp

    from di_hpc_tpu import ops, origin, parallel
    return jax, jnp, ops, origin, parallel


def _agreed(ranks, key):
    """Rank 0's result, after checking that every rank and the second run
    of the case give the same bits."""
    want = ranks[0][key]
    for r, res in enumerate(ranks):
        for k in (key, key + "/again"):
            got = res[k]
            assert got.dtype == want.dtype and got.shape == want.shape, (r, k)
            assert got.tobytes() == want.tobytes(), f"rank {r}: {k}"
    return want


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# --------------------------------------- tests/test_parallel.py's cases ----

def test_mesh_construction(world8):
    _, ranks = world8
    assert json.loads(str(_agreed(ranks, "mesh_construction/default"))) == \
        {"data": 8}
    assert json.loads(str(_agreed(ranks, "mesh_construction/inferred"))) \
        == {"time": 4, "data": 2}


@pytest.mark.parametrize("tshards", [2, 4, 8])
def test_time_sharded_scan_splits(tshards, world8, jx):
    x, ranks = world8
    ops = jx[2]
    ref = ops.linear_recurrence_reverse(x["splits_a"], x["splits_b"],
                                        method="scan")
    _close(_agreed(ranks, f"splits{tshards}/y"), ref, 1e-4, 1e-5)


@pytest.mark.parametrize("direction", ["rev", "fwd"])
def test_time_sharded_scan(direction, world8, jx):
    x, ranks = world8
    ops = jx[2]
    fn = (ops.linear_recurrence_reverse if direction == "rev"
          else ops.linear_recurrence_forward)
    ref = fn(x["scan_a"], x["scan_b"], method="scan")
    _close(_agreed(ranks, f"scan_{direction}/y"), ref, 1e-4, 1e-5)


def _jax_mesh(jparallel):
    return jparallel.make_mesh({"time": 4, "data": 2})


@pytest.mark.parametrize("direction", ["rev", "fwd"])
def test_time_sharded_scan_gradient(direction, world8, jx):
    """Gradients in a and b through the sharded recurrence on a (time 4,
    data 2) mesh equal jax.grad of JAX's sharded recurrence on the same
    mesh: every rank's chunk map reaches the ranks before (after) it."""
    x, ranks = world8
    jax, jnp, _, _, jparallel = jx
    fn = (jparallel.linear_recurrence_reverse_sharded if direction == "rev"
          else jparallel.linear_recurrence_forward_sharded)
    m = _jax_mesh(jparallel)
    want = jax.jit(jax.grad(lambda a, b: jnp.sum(fn(
        a, b, m, time_axis="time", batch_axis="data") * x["scan_w"]),
        argnums=(0, 1)))(x["scan_a"], x["scan_b"])
    for k, w in zip("ab", want):
        _close(_agreed(ranks, f"scan_grad_{direction}/{k}"), w, 1e-4, 1e-5)


def test_lambda_returns_time_sharded_gradient(world8, jx):
    """lambda_returns_time_sharded's gradients in value (whose T+1 rows
    overlap the chunks by one) and reward, against jax.grad of JAX's."""
    x, ranks = world8
    jax, jnp, _, _, jparallel = jx
    m = _jax_mesh(jparallel)
    want = jax.jit(jax.grad(lambda v, r: jnp.sum(
        jparallel.lambda_returns_time_sharded(
            v, r, m, 0.9, 0.8, batch_axis="data") * x["scan_w"]),
        argnums=(0, 1)))(x["td_value"], x["td_reward"])
    for k, w in zip(("value", "reward"), want):
        _close(_agreed(ranks, f"lambda_grad/{k}"), w, 1e-4, 1e-5)


def test_vtrace_time_sharded_gradients(world8, jx):
    """The time- and batch-sharded V-trace's gradients in the target
    logits, value and reward (through the returns and the shifted
    return_{t+1} of the next chunk) against jax.grad of JAX's."""
    x, ranks = world8
    jax, _, ops, _, jparallel = jx
    m = _jax_mesh(jparallel)

    def total(to, value, reward):
        l = jparallel.vtrace_error_time_sharded(ops.vtrace_data(
            to, x["vt_bo"], x["vt_act"], value, reward, None), m,
            batch_axis="data")
        return l.policy_loss + 0.5 * l.value_loss - 0.01 * l.entropy_loss

    want = jax.jit(jax.grad(total, argnums=(0, 1, 2)))(
        x["vt_to"], x["vt_value"], x["vt_reward"])
    for k, w in zip(("to", "value", "reward"), want):
        assert np.abs(np.asarray(w)).max() > 0, k
        _close(_agreed(ranks, f"vtrace_grads/{k}"), w, 1e-4, 1e-6)


def test_gae_time_sharded(world8, jx):
    x, ranks = world8
    origin = jx[3]
    ref = origin.gae(origin.gae_data(x["gae_value"], x["gae_reward"]))
    _close(_agreed(ranks, "gae/adv"), ref, 1e-4, 1e-5)


def test_td_lambda_time_sharded(world8, jx):
    x, ranks = world8
    origin = jx[3]
    ref = origin.td_lambda_error(origin.td_lambda_data(
        x["td_value"], x["td_reward"], x["td_weight"]), 0.9, 0.8)
    _close(_agreed(ranks, "td_lambda/loss"), float(ref), 1e-5)


def test_vtrace_time_sharded(world8, jx):
    x, ranks = world8
    jax, _, ops, origin, _ = jx
    data = ops.vtrace_data(x["vt_to"], x["vt_bo"], x["vt_act"], x["vt_value"],
                           x["vt_reward"], None)
    ref = origin.vtrace_error(data)
    _close(_agreed(ranks, "vtrace/losses"), [float(r) for r in ref], 1e-4)
    g_ref = jax.grad(lambda t: origin.vtrace_error(ops.vtrace_data(
        t, x["vt_bo"], x["vt_act"], x["vt_value"], x["vt_reward"],
        None)).policy_loss)(x["vt_to"])
    _close(_agreed(ranks, "vtrace/grad"), g_ref, 1e-4, 1e-6)


def test_upgo_time_sharded(world8, jx):
    x, ranks = world8
    origin = jx[3]
    ref = origin.upgo_loss(x["upgo_to"], x["upgo_rhos"], x["upgo_act"],
                           x["upgo_rew"], x["upgo_value"])
    _close(_agreed(ranks, "upgo/loss"), float(ref), 1e-4)


def test_data_parallel_vtrace_global_mean(world8, jx):
    x, ranks = world8
    ops = jx[2]
    ref = ops.vtrace_error(ops.vtrace_data(
        x["dp_to"], x["dp_bo"], x["dp_act"], x["dp_value"], x["dp_reward"],
        None))
    _close(_agreed(ranks, "dp_vtrace/losses"), [float(r) for r in ref], 1e-5)


def test_data_parallel_ppo_and_td(world8, jx):
    x, ranks = world8
    ops = jx[2]
    ref_l, ref_i = ops.ppo_error(ops.ppo_data(
        x["ppo_ln"], x["ppo_lo"], x["ppo_act"], x["ppo_vn"], x["ppo_vo"],
        x["ppo_adv"], x["ppo_ret"], None))
    _close(_agreed(ranks, "dp_ppo_td/ppo")[:3], [float(v) for v in ref_l],
           1e-5)
    # The PPO info (approx_kl, clipfrac), global means as well.
    _close(_agreed(ranks, "dp_ppo_td/ppo")[3:], [float(v) for v in ref_i],
           1e-5, 1e-7)
    ref = ops.q_nstep_td_error(ops.q_nstep_td_data(
        x["q"], x["nq"], x["ppo_act"], x["ppo_act"], x["q_rew"],
        x["q_done"], None), 0.95, 3)
    _close(_agreed(ranks, "dp_ppo_td/td"), float(ref[0]), 1e-5)
    _close(_agreed(ranks, "dp_ppo_td/td_per_sample"), ref[1], 1e-5)


def test_sharded_grad_matches(world8, jx):
    """Gradients through a batch-sharded vtrace equal single-device grads,
    on every rank, for the whole global target_output."""
    x, ranks = world8
    jax, _, ops, _, _ = jx

    def total(to_):
        l = ops.vtrace_error(ops.vtrace_data(
            to_, x["g_bo"], x["g_act"], x["g_value"], x["g_reward"], None))
        return l.policy_loss + l.value_loss

    _close(_agreed(ranks, "sharded_grad/grad"), jax.grad(total)(x["g_to"]),
           1e-5, 1e-7)


# ------------------------------------ tests/test_multihost.py's case ----

def test_multi_process_data_parallel_vtrace(multihost, jx):
    """2 and 4 processes: every process reproduces the single-process
    global-batch result, and the assembled global batch is the original."""
    n, x, ranks = multihost
    ops = jx[2]
    for k in ("to", "bo", "act", "value", "reward"):
        assert _agreed(ranks, f"multihost/global_{k}").tobytes() == \
            x[k].tobytes(), k
    ref = ops.vtrace_error(ops.vtrace_data(
        x["to"], x["bo"], x["act"], x["value"], x["reward"], None))
    _close(_agreed(ranks, "multihost/losses"), [float(r) for r in ref], 1e-4)


# ------------------------------------------------- the port's own cases ----

def test_world_of_one_is_the_unsharded_op():
    """With no process group, make_mesh() is a world of one on the CPU and
    data_parallel(ops.vtrace_error) gives ops.vtrace_error's bits, and its
    gradient's."""
    import torch.distributed as dist

    from di_hpc_tpu_torch import ops, parallel

    assert not dist.is_initialized()
    mesh = parallel.make_mesh()
    assert mesh.shape == {"data": 1} and mesh.device.type == "cpu"
    x = _inputs()
    t = [torch.from_numpy(x[k]) for k in ("dp_to", "dp_bo", "dp_act",
                                          "dp_value", "dp_reward")]
    dp = parallel.data_parallel(ops.vtrace_error, mesh,
                                ops.vtrace_data(1, 1, 1, 1, 1, None))
    grads = []
    for fn in (dp, ops.vtrace_error):
        to = t[0].clone().requires_grad_()
        losses = fn(ops.vtrace_data(to, *t[1:], None))
        grads.append((torch.stack(tuple(losses)).detach(), torch.autograd.grad(
            losses.policy_loss + losses.value_loss, to)[0]))
    for got, want in zip(*grads):
        assert got.numpy().tobytes() == want.numpy().tobytes()


def test_reductions_sum_in_rank_order(world8):
    """The collective helper's sum and mean of one float32 scalar per rank
    (0.1 * (rank + 1)): every rank gets the rank-order sum's bits, and the
    gradient hands each rank 1 (sum) and 1/8 (mean)."""
    _, ranks = world8
    total = np.float32(0.1)
    for r in range(2, 9):
        total = np.float32(total + np.float32(0.1 * r))
    assert _agreed(ranks, "reduce/sum").tobytes() == total.tobytes()
    assert _agreed(ranks, "reduce/mean").tobytes() == \
        np.float32(total / np.float32(8)).tobytes()
    assert float(_agreed(ranks, "reduce/grad")) == 1.125


def test_errors_match_jax_word_for_word(world8, jx):
    """make_mesh's messages equal JAX's asserts' (as ValueError); an axis
    that does not divide T, or a batch that does not tile the data axis,
    raise ValueError in every rank."""
    jax, _, _, _, jparallel = jx
    from di_hpc_tpu_torch import parallel

    one = jax.devices()[:1]
    for sizes in ({"data": 3}, {"a": -1, "b": -1}, {"time": 2, "data": -1}):
        with pytest.raises(AssertionError) as want:
            jparallel.make_mesh(sizes, devices=one)
        with pytest.raises(ValueError) as got:
            parallel.make_mesh(sizes)
        assert str(got.value) == str(want.value)
    _, ranks = world8
    assert "50 does not tile the 'time' axis of size 4" in str(
        _agreed(ranks, "value_errors/time"))
    assert "30 does not tile the 'data' axis of size 8" in str(
        _agreed(ranks, "value_errors/batch"))


def test_shardings_match_jax_specs(jx):
    """lstm_param_shardings, batch_sharding and replicated against JAX's
    specs, leaf for leaf; each leaf's placements shard dim 1 on the model
    axis and replicate on the others."""
    from torch.distributed.tensor import Replicate, Shard

    from di_hpc_tpu_torch import parallel

    jparallel = jx[4]
    jmesh = jparallel.make_mesh({"data": 4, "model": 2})
    mesh = parallel.make_mesh({"data": 1, "model": 1})
    want = jparallel.lstm_param_shardings(jmesh, 3)
    got = parallel.lstm_param_shardings(mesh, 3)
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for g, w in zip(got, want):
        gl, wl = (list(g), list(w)) if isinstance(w, tuple) else ([g], [w])
        assert len(gl) == len(wl) == (3 if isinstance(w, tuple) else 1)
        for gs, ws in zip(gl, wl):
            assert gs.spec == tuple(ws.spec) == (None, "model")
            assert gs.placements == (Replicate(), Shard(1))
    for args in ((1, 3), (0, 2)):
        assert parallel.batch_sharding(mesh, *args).spec == \
            tuple(jparallel.batch_sharding(jmesh, *args).spec)
    assert parallel.replicated(mesh).spec == \
        tuple(jparallel.replicated(jmesh).spec)
    assert parallel.replicated(mesh).placements == (Replicate(), Replicate())


if __name__ == "__main__":
    _worker(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
