"""The port's multichip dryrun (di_hpc_tpu_torch.entry.dryrun_multichip),
its sharded train step (models.make_sharded_train_step), the sharded data
plane (TrajectoryBuffer.sample_batch(mesh=)) and the two IMPALA examples
that use them, on the CPU in worlds of gloo processes, against the JAX
package.

Inputs are made with numpy from a seed in the pytest process and written
to a file; each world is spawned once per module and killed at its
deadline.  The world of 8 (data 4 x model 2, the JAX dryrun's mesh) runs
the dryrun's own rank processes (entry.run_world) on the JAX dryrun's
parameters and batch (__graft_entry__._tiny_setup) and on the port's
numpy inputs for the other legs; each rank checks every leg against the
unsharded port op, runs the legs twice and writes its results.  The worlds
of 2 and 4 run this file as a script.  Workers import no JAX.

Tolerances (JAX_TOLERANCE):
  - the f32 train step against JAX's make_train_step jitted with the
    dryrun's shardings on the 8 CPU devices, under
    jax.default_matmul_precision("float32"): metrics and gradients at
    rtol 1e-4, atol 1e-5; the new parameters within 2e-6 where |grad| >
    1e-3 of the leaf's largest, else within one Adam step (lr) of the old
    (entry.PARAM_ATOL, GRAD_BIG): Adam's first step moves an entry by lr
    in the direction of its gradient's sign, so an entry whose gradient
    lies at the noise floor may move either way on the two sides;
  - the bf16 train step: metrics within 2e-3, the bf16 train step's bound
    in tests/test_torch_bf16.py.  Its gradients within 0.25 of the leaf's
    largest |entry|, the bound JAX's own bf16 LSTM test holds its bf16
    recurrent path to (tests/test_pallas_fused.py:397), which
    tests/test_torch_bf16.py uses between the two packages' different bf16
    paths: at the dryrun's H=64 JAX's LSTM takes its recurrent path (its
    kernel needs H % 128 == 0), which rounds every op to bf16, where the
    port's kernel keeps its state in float32 (measured: at most 8.1e-2 of
    the leaf's largest, embed_b).  The new parameters within 2e-6 where
    |grad| exceeds that bound, within one Adam step elsewhere;
  - the impala_training step against the JAX example's: float32 as the
    dryrun's; bf16 with JAX's layer kernel in interpret mode (H = 128),
    so both sides take a kernel path: the bf16 train step's bounds, 2e-3
    on the metrics and 5e-2 of the leaf's largest on the gradients
    (entry.TRAIN_TOLERANCE);
  - the other ten legs against JAX's unsharded ops at __graft_entry__.py's
    tolerances (entry.LEG_TOLERANCE).
Every rank's results must equal rank 0's bit for bit, and the second run
of the legs the first.
"""

import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from di_hpc_tpu_torch import entry  # noqa: E402

# A world that has not finished by then is killed and its tests fail.
JOIN_TIMEOUT_S = 300
LEGS = list(entry.LEG_TOLERANCE)
TRAIN_LEGS = {"train_step_sharded": None,
              "train_step_bf16_sharded": "bfloat16"}
STEPS = 3       # sharded against unsharded steps in the world of 4
# Against JAX: metrics (rtol, atol), gradients (rtol, atol, atol relative
# to the leaf's largest |entry|); the module docstring says why.
JAX_TOLERANCE = {None: {"metrics": (1e-4, 1e-5), "grads": (1e-4, 1e-5, 0.0)},
                 "bfloat16": {"metrics": (2e-3, 2e-3),
                              "grads": (0.0, 0.0, 0.25)}}
B_SAMPLE = 8    # the sample_batch global batch in the world of 2


# ------------------------------------------------------------- inputs ----

def _trajectories(rng, n):
    """Actor-learner-like trajectories with float64 and int64 fields."""
    return [{"obs": rng.standard_normal((5, 3)),
             "action": rng.integers(0, 4, 4),
             "reward": rng.standard_normal(4),
             "logits": rng.standard_normal((4, 4)).astype(np.float32)}
            for _ in range(n)]


def _world2_inputs() -> dict:
    rng = np.random.default_rng(7)
    return {f"traj{i}/{k}": v for i, t in enumerate(
        _trajectories(rng, B_SAMPLE)) for k, v in t.items()}


def _world4_inputs() -> dict:
    """The tiny setup's parameters and STEPS global batches."""
    x = entry.dryrun_inputs(seed=3)
    rng = np.random.default_rng(4)
    T, B, O, A = 8, 16, 32, 16
    for s in range(STEPS):
        x.update({f"step{s}/obs": rng.standard_normal(
            (T + 1, B, O)).astype(np.float32),
            f"step{s}/actions": rng.integers(0, A, (T, B)).astype(np.int32),
            f"step{s}/rewards": rng.standard_normal((T, B)).astype(
                np.float32),
            f"step{s}/behaviour_logits": rng.standard_normal(
                (T, B, A)).astype(np.float32)})
    return x


# ------------------------------------------- the workers' cases (no JAX) ----

def _world2_case(x, rank, world) -> dict:
    """sample_batch(mesh=), two actor-learner steps and two steps of the
    impala_training example with the mesh branches taken."""
    from di_hpc_tpu_torch import data, parallel
    from di_hpc_tpu_torch.examples import impala_actor_learner, impala_training

    mesh = parallel.make_mesh()
    out = {"mesh_data": np.array(mesh.shape["data"])}
    share = B_SAMPLE // world
    buf = data.TrajectoryBuffer(capacity=2 * B_SAMPLE)
    for i in range(rank * share, (rank + 1) * share):
        buf.add({k: x[f"traj{i}/{k}"] for k in
                 ("obs", "action", "reward", "logits")})
    for k, v in buf.sample_batch(B_SAMPLE, mesh=mesh, timeout=5.0).items():
        out[f"shard/{k}"] = v.numpy()
        out[f"dtype/{k}"] = np.array(str(v.dtype))
    out["left"] = np.array(len(buf))
    buf.add({k: x[f"traj0/{k}"] for k in ("obs", "action", "reward",
                                            "logits")})
    try:
        buf.sample_batch(3, mesh=mesh, timeout=1.0)
    except ValueError as e:
        out["error"] = np.array(str(e))
    out["left_after_error"] = np.array(len(buf))

    params = impala_actor_learner.run(steps=2, device="cpu")
    for k, v in params.state_dict().items():
        out[f"learner/{k}"] = v.numpy()
    params, metrics = impala_training.main(steps=2, T=4, B=4, device="cpu")
    for k, v in params.state_dict().items():
        out[f"training/{k}"] = v.numpy()
    for k, v in metrics.items():
        out[f"training_metrics/{k}"] = v.numpy()
    return out


def _world4_case(x, rank, world) -> dict:
    """STEPS sharded steps on a data 2 x model 2 mesh, each against the
    unsharded port step (entry.sharded_train_steps raises outside the
    tolerance), in f32 and bf16."""
    from di_hpc_tpu_torch import models, parallel

    mesh = parallel.make_mesh({"data": 2, "model": 2})
    cfg = models.ActorCriticConfig(*(int(v) for v in x["cfg"]))
    arrays = entry.arrays_from_named(x, "param/", cfg.num_layers)
    batches = [models.TrainBatch(*(torch.from_numpy(x[f"step{s}/{k}"])
                                   for k in models.TrainBatch._fields))
               for s in range(STEPS)]
    out = {}
    for tag, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        results, checks = entry.sharded_train_steps(cfg, arrays, batches,
                                                    mesh, dtype)
        out.update({f"{tag}/{k}": v for k, v in results.items()})
        out[f"{tag}/steps_checked"] = np.array(len(checks))
    return out


def _worker(workdir: Path, rank: int, world: int) -> None:
    import torch.distributed as dist

    from di_hpc_tpu_torch import parallel

    parallel.initialize(f"file://{workdir / 'store'}", world, rank)
    x = dict(np.load(workdir / "inputs.npz"))
    case = _world2_case if world == 2 else _world4_case
    np.savez(workdir / f"rank{rank}.npz", **case(x, rank, world))
    dist.destroy_process_group()


# ------------------------------------------------------------ fixtures ----

def _spawn(world: int, workdir: Path, inputs: dict) -> list:
    from di_hpc_tpu_torch import parallel

    np.savez(workdir / "inputs.npz", **inputs)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    parallel.spawn_world([__file__, str(workdir)], world, JOIN_TIMEOUT_S,
                         env=env)
    return [dict(np.load(workdir / f"rank{r}.npz")) for r in range(world)]


def _jax_leaf(tree, name):
    """The leaf of a JAX params tree at a port parameter's dotted name."""
    for part in name.split("."):
        tree = tree[int(part)] if part.isdigit() else getattr(tree, part)
    return np.asarray(tree)


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported in the pytest process only."""
    import jax
    import jax.numpy as jnp

    from di_hpc_tpu import network, ops, origin
    import __graft_entry__
    return jax, jnp, ops, origin, network, __graft_entry__


@pytest.fixture(scope="module")
def world8(jx, tmp_path_factory):
    """The dryrun's world of 8 on the JAX dryrun's parameters and batch:
    (inputs, the ranks' reports, the ranks' results)."""
    jax, graft = jx[0], jx[5]
    _, jparams, jbatch = graft._tiny_setup(jax)
    x = entry.dryrun_inputs()
    for k in [k for k in x if k.startswith("param/")]:
        x[k] = _jax_leaf(jparams, k[len("param/"):])
    for k in jbatch._fields:
        x[f"batch/{k}"] = np.asarray(getattr(jbatch, k))
    workdir = tmp_path_factory.mktemp("dryrun8")
    reports = entry.run_world(8, "cpu", x, workdir)
    ranks = [dict(np.load(workdir / f"rank{r}.npz")) for r in range(8)]
    return x, jparams, reports, ranks


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    x = _world2_inputs()
    return x, _spawn(2, tmp_path_factory.mktemp("world2"), x)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    x = _world4_inputs()
    return x, _spawn(4, tmp_path_factory.mktemp("world4"), x)


def _agreed(ranks, key):
    """Rank 0's result, after checking that every rank has its bits."""
    want = ranks[0][key]
    for r, res in enumerate(ranks):
        got = res[key]
        assert got.dtype == want.dtype and got.shape == want.shape, (r, key)
        assert got.tobytes() == want.tobytes(), f"rank {r}: {key}"
    return want


def _close(got, want, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# ------------------------------------------------------- the world of 8 ----

def test_dryrun_line_and_meshes(world8):
    """Rank 0's line is JAX's, every leg in JAX's order; the ranks ran on
    gloo CPU processes on the dryrun's two meshes."""
    _, _, reports, _ = world8
    line = reports[0]["line"]
    assert line.startswith("dryrun_multichip(8) OK: mesh={'data': 4, "
                           "'model': 2} total_loss=")
    assert line.split()[7:] == [f"{leg}=OK" for leg in
                                ["train_step_bf16_sharded", *LEGS]]
    for r, rep in enumerate(reports):
        assert rep["rank"] == r and rep["backend"] == "gloo"
        assert rep["device"] == "cpu"
        assert rep["sp_mesh"] == {"time": 2, "data": 4}
        assert rep["lstm_routes"] == {"kernel": 2 * 2, "recurrent": 0}


def test_ranks_agree_bitwise(world8):
    """Every rank holds rank 0's bits for every result (the dryrun also
    checked that a second run of the legs gave the first's bits)."""
    _, _, reports, ranks = world8
    assert {rep["digest"] for rep in reports} == {reports[0]["digest"]}
    assert set(ranks[0]) == set(ranks[-1])
    for key in ranks[0]:
        _agreed(ranks, key)


def _jax_sharded_step(jx, jparams, x, compute_dtype):
    """JAX's make_train_step jitted with the dryrun's shardings on the 8 CPU
    devices, optax.adam(1e-3): (metrics, grads, new params)."""
    jax, jnp = jx[0], jx[1]
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from di_hpc_tpu.models import make_train_step
    from di_hpc_tpu.models.actor_critic_lstm import (
        ActorCriticConfig, ActorCriticParams, TrainBatch)
    from di_hpc_tpu.parallel import lstm_param_shardings, make_mesh

    mesh = make_mesh({"data": 4, "model": 2}, devices=jax.devices()[:8])
    ns = lambda *spec: NamedSharding(mesh, P(*spec))
    param_sh = ActorCriticParams(
        embed_w=ns(), embed_b=ns(), lstm=lstm_param_shardings(mesh, 2),
        policy_w=ns(None, "model"), policy_b=ns("model"), value_w=ns(),
        value_b=ns())
    batch_sh = TrainBatch(*(ns(None, "data"),) * 4)
    adam = optax.adam(entry.LR)

    def update(g, state, params=None):     # keeps the gradients
        updates, adam_state = adam.update(g, state[0], params)
        return updates, (adam_state, g)

    opt = optax.GradientTransformation(
        lambda p: (adam.init(p), jax.tree.map(jnp.zeros_like, p)), update)
    cfg = ActorCriticConfig(*(int(v) for v in x["cfg"]))
    batch = TrainBatch(*(jnp.asarray(x[f"batch/{k}"])
                         for k in TrainBatch._fields))
    with jax.default_matmul_precision("float32"):
        params = jax.device_put(jparams, param_sh)
        step = jax.jit(make_train_step(cfg, opt,
                                       compute_dtype=compute_dtype))
        new, (_, grads), metrics = step(params, opt.init(params),
                                        jax.device_put(batch, batch_sh))
    return metrics, grads, new


@pytest.mark.parametrize("leg", list(TRAIN_LEGS))
def test_sharded_train_step_matches_jax(leg, world8, jx):
    """The sharded train step's metrics, gathered gradients and new
    parameters against JAX's sharded step on the same parameters and
    batch, at the module docstring's tolerances."""
    jnp = jx[1]
    x, jparams, _, ranks = world8
    dtype = TRAIN_LEGS[leg]
    metrics, grads, new = _jax_sharded_step(
        jx, jparams, x, getattr(jnp, dtype) if dtype else None)
    tol = JAX_TOLERANCE[dtype]
    for k in ("total_loss", "policy_loss", "value_loss", "entropy"):
        _close(_agreed(ranks, f"{leg}/metrics/{k}"), metrics[k],
               *tol["metrics"])
    names = [k[len("param/"):] for k in x if k.startswith("param/")]
    assert len(names) == 15         # 2 LN-LSTM layers
    rtol, atol, rel = tol["grads"]
    for name in names:
        want_g = _jax_leaf(grads, name)
        scale = float(np.abs(want_g).max())
        _close(_agreed(ranks, f"{leg}/grad/{name}"), want_g, rtol,
               atol + rel * scale)
        got = _agreed(ranks, f"{leg}/param/{name}")
        want = _jax_leaf(new, name)
        big = np.abs(want_g) > max(entry.GRAD_BIG, rel) * scale
        assert big.any(), name
        _close(got[big], want[big], atol=entry.PARAM_ATOL)
        old = x[f"param/{name}"]
        assert np.abs(got - old).max() <= entry.LR + 1e-6, name


def _jax_leg(jx, x, leg):
    """JAX's unsharded op of a dryrun leg on the same numpy inputs."""
    jax, jnp, ops, origin, network, _ = jx
    a = lambda k: jnp.asarray(x[k])
    vt = origin.vtrace_data(a("vt/target"), a("vt/behaviour"),
                            a("vt/action"), a("vt/value"), a("vt/reward"),
                            None)
    v, r = a("scan/value"), a("scan/reward")
    S = entry.SCATTER
    if leg == "sp_scan(time=2)":
        return (ops.linear_recurrence_reverse(a("sp/a"), a("sp/b")),)
    if leg == "vtrace_time_sharded":
        return tuple(ops.vtrace_error(vt))
    if leg == "gae_time_sharded":
        return (ops.gae(origin.gae_data(v, r)),)
    if leg == "td_lambda_time_sharded":
        return (ops.td_lambda_error(origin.td_lambda_data(v, r, None)),)
    if leg == "upgo_time_sharded":
        return (ops.upgo_loss(a("upgo/target"), a("upgo/rhos"),
                              a("vt/action"), r, v),)
    if leg == "c51_batch_sharded":
        return tuple(ops.dist_nstep_td_error(origin.dist_nstep_td_data(
            *(a(f"c51/{k}") for k in ("dist", "next_dist", "act",
                                      "next_act", "reward", "done")),
            None), 0.95, -5.0, 5.0, entry.TD_ATOMS, entry.TD_NSTEP))
    if leg == "qrdqn_batch_sharded":
        return (ops.qrdqn_nstep_td_error(origin.qrdqn_nstep_td_data(
            *(a(f"qr/{k}") for k in ("q", "next_q", "act", "next_act",
                                     "reward", "done", "tau")), None),
            0.95, entry.TD_NSTEP)[0],)
    if leg == "iqn_batch_sharded":
        return (ops.iqn_nstep_td_error(origin.iqn_nstep_td_data(
            *(a(f"iqn/{k}") for k in ("q", "next_q", "act", "next_act",
                                      "reward", "done", "quantiles")),
            None), 0.95, entry.TD_NSTEP, kappa=0.9)[0],)
    if leg == "scatter_batch_sharded":
        loc = a("scatter/loc")
        return jax.value_and_grad(lambda s: jnp.sum(network.scatter_connection(
            s, (S["H"], S["W"]), loc, "add") ** 2))(a("scatter/x"))
    assert leg == "grouped_padding_sharded"
    rng = np.random.default_rng(0)
    ragged = [jnp.asarray(rng.standard_normal(int(n)), jnp.float32)
              for n in rng.integers(8, 64, size=16)]
    return (float(sum(jnp.sum(q) for q in ragged)),)


@pytest.mark.parametrize("leg", LEGS)
def test_dryrun_leg_matches_jax(leg, world8, jx):
    """Each of the ten op legs (every rank's outputs, rank 0's bits)
    against JAX's unsharded op on the same inputs."""
    x, _, _, ranks = world8
    want = _jax_leg(jx, x, leg)
    tol = entry.LEG_TOLERANCE[leg]
    for i, w in enumerate(want):
        _close(_agreed(ranks, f"{leg}/{i}"), w, **tol)
    assert f"{leg}/{len(want)}" not in ranks[0]


def test_dryrun_refuses_a_missing_card():
    """No fallback to the CPU: without a card the dryrun raises unless it
    is asked for CPU processes."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.dryrun_multichip(2)


# ------------------------------------------------------- the world of 2 ----

def test_sample_batch_shards_concatenate_to_the_global_batch(world2):
    """Each rank pops its share of the global batch from its own buffer;
    the shards, concatenated in rank order along dim 1, are the
    single-process batch of the same trajectories, in JAX's transfer
    dtypes."""
    from di_hpc_tpu_torch import data

    x, ranks = world2
    trajs = [{k: x[f"traj{i}/{k}"] for k in ("obs", "action", "reward",
                                             "logits")}
             for i in range(B_SAMPLE)]
    buf = data.TrajectoryBuffer(capacity=B_SAMPLE)
    for t in trajs:
        buf.add(t)
    want = buf.sample_batch(B_SAMPLE, device="cpu")
    for k, w in want.items():
        got = np.concatenate([res[f"shard/{k}"] for res in ranks], axis=1)
        assert got.dtype == w.numpy().dtype, k
        assert got.tobytes() == w.numpy().tobytes(), k
        assert all(str(res[f"dtype/{k}"]) == str(w.dtype) for res in ranks)
    assert {str(res["dtype/reward"]) for res in ranks} == {"torch.float32"}
    assert {str(res["dtype/action"]) for res in ranks} == {"torch.int32"}
    assert [int(res["left"]) for res in ranks] == [0, 0]


def test_sample_batch_refuses_a_batch_that_does_not_tile(world2):
    _, ranks = world2
    for res in ranks:
        assert str(res["error"]) == (
            "TrajectoryBuffer.sample_batch: batch_size 3 does not tile the "
            "'data' axis of size 2")
        assert int(res["left_after_error"]) == 1    # nothing was popped


@pytest.mark.parametrize("example", ["learner", "training"])
def test_examples_mesh_branch_keeps_ranks_bitwise_equal(example, world2):
    """Two learner steps of impala_actor_learner and two steps of
    impala_training in a world of 2 take the sharded step over
    make_mesh(); every rank's parameters stay bitwise equal, finite, and
    moved."""
    _, ranks = world2
    assert [int(res["mesh_data"]) for res in ranks] == [2, 2]
    keys = [k for k in ranks[0] if k.startswith(f"{example}/")]
    assert len(keys) == {"learner": 13, "training": 15}[example]  # 1, 2 layers
    for k in keys + [k for k in ranks[0]
                     if k.startswith(f"{example}_metrics/")]:
        assert np.isfinite(_agreed(ranks, k)).all(), k


# ------------------------------------------------------- the world of 4 ----

@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_sharded_step_tracks_the_unsharded_step(tag, world4):
    """STEPS steps on a data 2 x model 2 mesh, each held against the
    unsharded port step from the same parameters and Adam state inside the
    ranks (entry.sharded_train_steps); every rank's gathered results agree
    bitwise."""
    _, ranks = world4
    assert {int(res[f"{tag}/steps_checked"]) for res in ranks} == {STEPS}
    for s in range(STEPS):
        total = _agreed(ranks, f"{tag}/step{s}/metrics/total_loss")
        assert np.isfinite(total)
        for k in ranks[0]:
            if k.startswith(f"{tag}/step{s}/"):
                _agreed(ranks, k)


# ------------------------------------------- impala_training against JAX ----

def _jax_example(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def interpret_if(request):
    """JAX's Pallas kernels in interpret mode for the bf16 case."""
    import jax

    import di_hpc_tpu.pallas_kernels.linear_scan as ls

    ls.INTERPRET = request.param
    jax.clear_caches()          # no trace cached by an earlier test's mode
    yield request.param
    ls.INTERPRET = False


@pytest.mark.parametrize("interpret_if", [False, True], indirect=True,
                         ids=["f32", "bf16"])
def test_impala_training_step_matches_the_jax_example(interpret_if, jx):
    """One step of the port's impala_training composition (its config,
    Adam(3e-4), make_step) against the JAX example's jitted step on the
    same parameters (init_actor_critic(PRNGKey(0))) and the same numpy
    batch (the example's scales), at the module docstring's tolerances."""
    jax, jnp = jx[0], jx[1]
    bf16 = interpret_if
    import optax

    from di_hpc_tpu.models import TrainBatch as JaxBatch
    from di_hpc_tpu.models import init_actor_critic as jax_init
    from di_hpc_tpu.models import make_train_step as jax_make_step
    from di_hpc_tpu_torch import models
    from di_hpc_tpu_torch.examples import impala_training as port

    jex = _jax_example("impala_training")
    cfg = port.CFG
    assert (cfg.obs_dim, cfg.hidden_size, cfg.num_layers, cfg.action_dim) \
        == (64, 128, 2, 16) and port.LR == 3e-4
    jparams = jax_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(11)
    T, B = 8, 4
    batch = (rng.standard_normal((T + 1, B, 64)).astype(np.float32),
             rng.integers(0, 16, (T, B)).astype(np.int32),
             0.1 * rng.standard_normal((T, B)).astype(np.float32),
             0.5 * rng.standard_normal((T, B, 16)).astype(np.float32))
    adam = optax.adam(port.LR)
    grads = []

    def update(g, state, params=None):
        grads.append(g)
        return adam.update(g, state, params)

    opt = optax.GradientTransformation(adam.init, update)
    dtype = jnp.bfloat16 if bf16 else None
    with jax.default_matmul_precision("float32"):
        jnew, _, jm = jax_make_step(cfg, opt, compute_dtype=dtype)(
            jparams, opt.init(jparams), JaxBatch(*map(jnp.asarray, batch)))
    assert jex.synthetic_batch(jax.random.PRNGKey(1), T, B, 64, 16) \
        .obs.shape == batch[0].shape

    arrays = jax.tree.map(np.asarray, jparams)
    params, step = port.make_step(
        models.from_jax_params(arrays, device="cpu"), bf16)
    tm = step(params, models.TrainBatch(*map(torch.from_numpy, batch)))
    if bf16:
        t = entry.TRAIN_TOLERANCE[torch.bfloat16]
        tol = {"metrics": tuple(t["metrics"].values()),
               "grads": tuple(t["grads"].values())}
    else:
        tol = JAX_TOLERANCE[None]
    for k in jm:
        _close(float(tm[k]), float(jm[k]), *tol["metrics"])
    rtol, atol, rel = tol["grads"]
    for name, p in params.named_parameters():
        jg = _jax_leaf(grads[0], name)
        scale = float(np.abs(jg).max())
        _close(p.grad.numpy(), jg, rtol, atol + rel * scale)
        big = np.abs(jg) > max(entry.GRAD_BIG, rel) * scale
        _close(p.detach().numpy()[big], _jax_leaf(jnew, name)[big],
               atol=entry.PARAM_ATOL)
        assert np.abs(p.detach().numpy() - _jax_leaf(jparams, name)).max() \
            <= port.LR + 1e-6


def test_impala_training_main_runs_on_the_cpu():
    """main() in a world of one (mesh None): finite metrics, moved
    parameters, in f32 and bf16."""
    from di_hpc_tpu_torch.examples import impala_training

    for bf16 in (False, True):
        params, metrics = impala_training.main(steps=2, T=4, B=4, bf16=bf16,
                                               device="cpu")
        assert all(np.isfinite(float(v)) for v in metrics.values())
        assert all(torch.isfinite(p).all() for p in params.parameters())


if __name__ == "__main__":
    _worker(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
