"""Host-side trajectory data plane for the actor-learner loop, the
counterpart of the JAX package's data.py.

 - `TrajectoryBuffer`: a bounded FIFO of per-trajectory field dicts (numpy,
   host memory), thread-safe for a collector thread and a learner thread;
 - `sample_batch`: assembles (T, B) time-major batches from fixed-length
   trajectories and moves each field to the learner's device in one
   transfer;
 - `stack_trajectories`: pure host numpy; ragged float32 fields take the C
   host core's pack (csrc/host/hostcore.c), other dtypes a numpy pack.

With a mesh (`mesh=`), a rank is one process with a buffer of its own, as
a host is in a JAX multi-host run: it pops its share of the global batch
and returns it as its shard of the batch dimension.
"""

from __future__ import annotations

import collections
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .parallel.mesh import DATA_AXIS
from .utils.native import native_pack_padded_f32
from .utils.transfer import to_device

__all__ = ["TrajectoryBuffer", "stack_trajectories"]


def _host_pad_nd(arrs):
    """Zero-pad a ragged list of same-rank numpy arrays to the per-dim max.

    Host-only (returns numpy): float32 inputs take the C ragged pack (one
    memcpy per contiguous row); everything else a per-array numpy
    slice-assign.  Returns (padded (B, ...), bool mask).
    """
    max_shape = [max(dims) for dims in zip(*(a.shape for a in arrs))]
    if all(a.dtype == np.float32 for a in arrs):
        out, m = native_pack_padded_f32(
            [np.ascontiguousarray(a) for a in arrs], max_shape, 0.0)
        return out, m != 0
    out = np.zeros((len(arrs), *max_shape), dtype=arrs[0].dtype)
    mask = np.zeros((len(arrs), *max_shape), dtype=bool)
    for i, a in enumerate(arrs):
        sl = (i,) + tuple(slice(0, d) for d in a.shape)
        out[sl] = a
        mask[sl] = True
    return out, mask


def stack_trajectories(trajs: Sequence[Dict[str, np.ndarray]],
                       time_major: bool = True) -> Dict[str, np.ndarray]:
    """Stack trajectory dicts into batched arrays.

    Each trajectory maps field -> (T, ...) array; output maps field ->
    (T, B, ...) (time-major, the layout every loss op expects) or (B, T, ...).

    RAGGED fields (per-trajectory shapes differ) are zero-padded to the
    per-dimension max (C pack for f32, numpy otherwise) and an extra
    boolean ``<field>_mask`` entry of the same layout marks the real
    elements: feed it as the op's `weight` to keep padded steps out of the
    losses.

    Pure host code: it runs on collector and learner threads and touches
    no device.
    """
    out = {}
    for k in trajs[0]:
        arrs = [np.asarray(t[k]) for t in trajs]
        if len({a.shape for a in arrs}) == 1:
            stacked = np.stack(arrs, axis=0)                  # (B, T, ...)
            mask = None
        else:
            nd = arrs[0].ndim
            if not (1 <= nd <= 3 and all(a.ndim == nd for a in arrs)):
                raise ValueError(
                    f"stack_trajectories: ragged field {k!r} must be 1-3D "
                    f"with a consistent rank; got "
                    f"{sorted({a.ndim for a in arrs})}-D")
            if k + "_mask" in trajs[0]:
                raise ValueError(
                    f"stack_trajectories: ragged field {k!r} needs the key "
                    f"{k + '_mask'!r} for its padding mask, but the "
                    f"trajectories already contain a field by that name")
            stacked, mask = _host_pad_nd(arrs)
        if time_major:
            stacked = np.swapaxes(stacked, 0, 1)
            if mask is not None:
                mask = np.swapaxes(mask, 0, 1)
        out[k] = np.ascontiguousarray(stacked)
        if mask is not None:
            out[k + "_mask"] = np.ascontiguousarray(mask)
    return out


class TrajectoryBuffer:
    """Bounded FIFO of trajectories with batched device sampling."""

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise ValueError(f"TrajectoryBuffer: capacity must be positive, "
                             f"got {capacity}")
        self._dq: collections.deque = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)

    def __len__(self):
        with self._lock:
            return len(self._dq)

    def add(self, trajectory: Dict[str, np.ndarray]) -> None:
        """Collector side: push one trajectory (field -> (T, ...) array)."""
        with self._not_empty:
            self._dq.append(trajectory)
            self._not_empty.notify()

    def sample_batch(
        self,
        batch_size: int,
        mesh=None,
        axis: str = DATA_AXIS,
        rng: Optional[np.random.Generator] = None,
        pop: bool = True,
        timeout: Optional[float] = None,
        device="cuda",
    ) -> Dict[str, torch.Tensor]:
        """Learner side: assemble a (T, B, ...) batch on `device`.

        FIFO order when `pop` (on-policy, IMPALA-style), waiting up to
        `timeout` seconds for `batch_size` trajectories; uniform sampling
        with replacement otherwise (replay-style), with `rng.integers` as
        the JAX package samples.  Each field is one transfer, in the dtype
        the JAX package's transfer gives it: float64 lands as float32, int64
        as int32, the rest in numpy's dtype (masks are torch.bool;
        utils.transfer).

        With a `mesh` (parallel.make_mesh), `batch_size` is the global
        batch: this rank takes `batch_size // mesh.shape[axis]`
        trajectories from its own buffer and returns them on `mesh.device`
        as its shard of dim 1 (the global batch is the ranks' shares in
        rank order), ready for models.make_sharded_train_step; JAX's places
        one host's global batch sharded over the axis.  ValueError when
        `batch_size` does not tile the axis.  In a world of one this is the
        unsharded call on `mesh.device`.
        """
        if mesh is not None:
            batch_size = self._share(batch_size, mesh, axis)
            device = mesh.device
        with self._not_empty:
            if pop:
                ok = self._not_empty.wait_for(
                    lambda: len(self._dq) >= batch_size, timeout=timeout)
                if not ok:
                    raise TimeoutError(
                        f"only {len(self._dq)}/{batch_size} trajectories available")
                trajs = [self._dq.popleft() for _ in range(batch_size)]
            else:
                if not self._dq:
                    raise ValueError("buffer empty")
                rng = rng or np.random.default_rng()
                idx = rng.integers(0, len(self._dq), size=batch_size)
                trajs = [self._dq[int(i)] for i in idx]

        host = stack_trajectories(trajs, time_major=True)
        return {k: to_device(v, device) for k, v in host.items()}

    @staticmethod
    def _share(batch_size: int, mesh, axis: str) -> int:
        k = mesh.axis_size(axis)
        if batch_size % k:
            raise ValueError(
                f"TrajectoryBuffer.sample_batch: batch_size {batch_size} "
                f"does not tile the {axis!r} axis of size {k}")
        return batch_size // k
