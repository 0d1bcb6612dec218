"""The port's trajectory data plane (di_hpc_tpu_torch.data) against the JAX
package's data module, on the CPU: the counterparts of tests/test_data.py.

Trajectories are made with numpy from a seed and handed to both sides; the
port's batches land on device="cpu".  Tolerance: none -- stacking and
padding copy, so the batches must be equal bit for bit, in JAX's dtypes
(float64 and int64 narrowed to float32 and int32, masks bool), and the
error messages word for word.
"""

import threading

import numpy as np
import pytest
import torch

from di_hpc_tpu import data as jax_data

from di_hpc_tpu_torch import data, parallel


def _traj(rng, T=8, obs=4):
    return {
        "obs": rng.standard_normal((T, obs)).astype(np.float32),
        "action": rng.integers(0, 5, size=(T,)).astype(np.int32),
        "reward": rng.standard_normal((T,)).astype(np.float32),
    }


def _ragged_trajs():
    return [
        {"reward": np.arange(3, dtype=np.float32),
         "action": np.arange(3, dtype=np.int32),
         "obs": np.ones((4, 2), np.float32)},
        {"reward": np.arange(5, dtype=np.float32),
         "action": np.arange(5, dtype=np.int32),
         "obs": np.ones((6, 2), np.float32) * 2},
    ]


def _same_batch(got, want):
    """A port batch (tensors or numpy) equals a JAX one (jax or numpy
    arrays): the same keys, dtypes and bits."""
    assert list(got) == list(want)
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype)
        assert np.array_equal(g, w), k


def _both_buffers(capacity, trajs):
    port, ref = data.TrajectoryBuffer(capacity), jax_data.TrajectoryBuffer(
        capacity)
    for t in trajs:
        port.add(t)
        ref.add(t)
    return port, ref


@pytest.mark.parametrize("time_major", [True, False])
def test_stack_matches_jax(time_major):
    rng = np.random.default_rng(0)
    trajs = [_traj(rng) for _ in range(3)]
    out = data.stack_trajectories(trajs, time_major=time_major)
    _same_batch(out, jax_data.stack_trajectories(trajs,
                                                 time_major=time_major))
    if time_major:
        assert out["obs"].shape == (8, 3, 4)
        np.testing.assert_array_equal(out["obs"][:, 1], trajs[1]["obs"])


def test_fifo_pop_order_matches_jax():
    rng = np.random.default_rng(1)
    trajs = [_traj(rng) for _ in range(6)]
    port, ref = _both_buffers(16, trajs)
    batch = port.sample_batch(4, device="cpu")
    _same_batch(batch, ref.sample_batch(4))
    assert len(port) == 2
    np.testing.assert_array_equal(batch["obs"][:, 3].numpy(), trajs[3]["obs"])
    assert batch["action"].dtype == torch.int32


def test_replay_sampling_takes_jax_indices_for_one_seed():
    rng = np.random.default_rng(2)
    port, ref = _both_buffers(8, [_traj(rng) for _ in range(5)])
    batch = port.sample_batch(10, pop=False, rng=np.random.default_rng(3),
                              device="cpu")
    _same_batch(batch, ref.sample_batch(10, pop=False,
                                        rng=np.random.default_rng(3)))
    assert batch["obs"].shape[1] == 10
    assert len(port) == 5


def test_timeout():
    buf = data.TrajectoryBuffer(capacity=4)
    with pytest.raises(TimeoutError, match="only 0/2 trajectories"):
        buf.sample_batch(2, timeout=0.05, device="cpu")


def test_capacity_evicts_oldest():
    rng = np.random.default_rng(4)
    trajs = [_traj(rng) for _ in range(5)]
    port, ref = _both_buffers(3, trajs)
    assert len(port) == 3
    batch = port.sample_batch(1, device="cpu")
    _same_batch(batch, ref.sample_batch(1))
    np.testing.assert_array_equal(batch["obs"][:, 0].numpy(), trajs[2]["obs"])


def test_collector_thread_feeds_learner():
    rng = np.random.default_rng(5)
    buf = data.TrajectoryBuffer(capacity=32)
    trajs = [_traj(rng) for _ in range(8)]

    def collect():
        for t in trajs:
            buf.add(t)

    t = threading.Thread(target=collect, daemon=True)
    t.start()
    batch = buf.sample_batch(8, timeout=5.0, device="cpu")
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert batch["obs"].shape == (8, 8, 4)
    _same_batch(batch, jax_data.stack_trajectories(trajs))


def test_stack_ragged_pads_and_masks_as_jax():
    """Ragged float32 fields take the C pack, int32 ones the numpy pack;
    both pad with zeros and add a bool mask, as the JAX package does."""
    out = data.stack_trajectories(_ragged_trajs(), time_major=True)
    _same_batch(out, jax_data.stack_trajectories(_ragged_trajs(),
                                                 time_major=True))
    assert out["reward_mask"].dtype == np.bool_
    np.testing.assert_array_equal(out["reward_mask"][:, 0],
                                  [True] * 3 + [False] * 2)
    np.testing.assert_array_equal(out["action"][:, 0], [0, 1, 2, 0, 0])
    assert out["obs_mask"][:, 0].sum() == 4 * 2
    # sample_batch moves each field as it is: masks become torch.bool.
    port, ref = _both_buffers(4, _ragged_trajs())
    batch = port.sample_batch(2, device="cpu")
    _same_batch(batch, ref.sample_batch(2))
    assert batch["obs_mask"].dtype == torch.bool


@pytest.mark.parametrize("trajs", [
    [{"x": np.zeros((3,), np.float32)}, {"x": np.zeros((3, 2), np.float32)}],
    [{"x": np.zeros((2, 2, 2, 2), np.float32)},
     {"x": np.zeros((3, 2, 2, 2), np.float32)}],
    [{"x": np.zeros((3,), np.float32), "x_mask": np.zeros((3,))},
     {"x": np.zeros((4,), np.float32), "x_mask": np.zeros((3,))}],
])
def test_stack_errors_word_for_word(trajs):
    with pytest.raises(ValueError) as want:
        jax_data.stack_trajectories(trajs)
    with pytest.raises(ValueError) as got:
        data.stack_trajectories(trajs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("pop", [True, False])
def test_64_bit_fields_land_as_jax_narrows_them(pop):
    """float64 fields land as float32 and int64 ones as int32, ragged
    fields too (their masks bool), as JAX's transfer gives them: the same
    dtypes and bits, FIFO and replay."""
    rng = np.random.default_rng(8)
    trajs = [{"r": np.arange(4.0) + i, "a": np.arange(4) + i,
              "obs": rng.standard_normal((4, 3)),
              "ragged": rng.standard_normal(int(rng.integers(2, 6))),
              "ragged_i": rng.integers(0, 9, int(rng.integers(2, 6)))}
             for i in range(5)]
    assert trajs[0]["r"].dtype == np.float64 and \
        trajs[0]["a"].dtype == np.int64
    port, ref = _both_buffers(8, trajs)
    got = port.sample_batch(4, pop=pop, rng=np.random.default_rng(2),
                            device="cpu")
    want = ref.sample_batch(4, pop=pop, rng=np.random.default_rng(2))
    _same_batch(got, want)
    assert {k: v.dtype for k, v in got.items()} == {
        "r": torch.float32, "a": torch.int32, "obs": torch.float32,
        "ragged": torch.float32, "ragged_mask": torch.bool,
        "ragged_i": torch.int32, "ragged_i_mask": torch.bool}


def test_mesh_is_not_supported_yet():
    """The mesh= branch, which this test once showed to be missing, in a
    world of one (no process group): the batch lands on the mesh's device
    (the CPU here, whatever `device` says) with the unsharded call's bits,
    and the same trajectories are popped.  Worlds of two ranks:
    tests/test_torch_multichip.py."""
    rng = np.random.default_rng(6)
    trajs = [_traj(rng) for _ in range(4)]
    bufs = [data.TrajectoryBuffer(capacity=8) for _ in range(2)]
    for buf in bufs:
        for t in trajs:
            buf.add(t)
    mesh = parallel.make_mesh(devices=["cpu"])
    got = bufs[0].sample_batch(2, mesh=mesh, device="cuda")
    want = bufs[1].sample_batch(2, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].device.type == "cpu" and got[k].dtype == want[k].dtype
        assert got[k].numpy().tobytes() == want[k].numpy().tobytes(), k
    assert len(bufs[0]) == len(bufs[1]) == 2
