"""Rank meshes and sharding helpers, the counterpart of the JAX package's
parallel/mesh.py.

A JAX mesh spans devices and GSPMD inserts the collectives.  Here a mesh
spans the ranks of the default process group (one device each; see
parallel.initialize), its named axes come from a
`torch.distributed.device_mesh.DeviceMesh`, and every collective is
explicit (parallel._comm).  The functions of the package keep JAX's
contract: every rank passes the same global tensors, computes on its own
shard (found from its coordinates on the mesh) and gets the global result
back.  With no process group initialized, `make_mesh` builds a world of
one on the caller's device, where every collective is the identity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.checkpoint import tree_flatten

__all__ = ["DATA_AXIS", "TIME_AXIS", "MODEL_AXIS", "Mesh", "NamedSharding",
           "make_mesh", "batch_sharding", "shard_batch_pytree", "replicated",
           "shard_params", "gather_params"]

DATA_AXIS = "data"
TIME_AXIS = "time"
MODEL_AXIS = "model"


class Mesh:
    """Named axes over the ranks of the default process group.

    `shape` maps each axis name to its size, as JAX's `Mesh.shape` does;
    `device` is this rank's device.  `axis_index(name)` is this rank's
    coordinate along an axis (JAX's `jax.lax.axis_index` inside a
    `shard_map`) and `group(name)` the process group of the ranks that
    differ from this one only along it; both come from `device_mesh`, which
    a world of one does not have.
    """

    def __init__(self, axis_sizes: dict, device, device_mesh=None):
        self.shape = dict(axis_sizes)
        self.axis_names = tuple(self.shape)
        self.device = torch.device(device)
        self.device_mesh = device_mesh

    def axis_size(self, name: str) -> int:
        if name not in self.shape:
            raise ValueError(f"mesh axis {name!r} is not one of "
                             f"{self.axis_names}")
        return self.shape[name]

    def axis_index(self, name: str) -> int:
        if self.axis_size(name) == 1:
            return 0
        return self.device_mesh.get_local_rank(name)

    def group(self, name: str):
        return self.device_mesh.get_group(name)


class NamedSharding(NamedTuple):
    """A tensor's placement on a mesh: `spec[d]` names the mesh axis that
    dimension d is sharded over (None: not sharded; dimensions past the
    spec are not sharded), as `jax.sharding.NamedSharding(mesh,
    PartitionSpec(*spec))` does."""

    mesh: Mesh
    spec: tuple

    @property
    def placements(self) -> tuple:
        """The `torch.distributed.tensor` placements, one per mesh axis:
        Shard(d) on the axis that dimension d is sharded over, Replicate()
        on every other axis."""
        from torch.distributed.tensor import Replicate, Shard

        dims = {axis: d for d, axis in enumerate(self.spec) if axis}
        return tuple(Shard(dims[name]) if name in dims else Replicate()
                     for name in self.mesh.axis_names)


def _default_device(rank: int) -> torch.device:
    """Rank `rank`'s card (`cuda:{rank % device_count}`), else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def make_mesh(axis_sizes: Optional[dict] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a mesh from {axis_name: size}.  A single -1 size is inferred.

    Default: all ranks on a single 'data' axis.  The mesh spans the ranks
    of the default process group, or this process alone when none is
    initialized.  `devices` gives each rank's device in rank order (default:
    each rank's card, `cuda:{rank % device_count}`, else the CPU).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    devices = list(devices if devices is not None
                   else (_default_device(r) for r in range(world)))
    n = len(devices)
    if n != world:
        raise ValueError(f"make_mesh: {n} devices for a world of {world} "
                         f"ranks")
    if not axis_sizes:
        axis_sizes = {DATA_AXIS: n}
    names = tuple(axis_sizes.keys())
    sizes = list(axis_sizes.values())
    n_infer = sizes.count(-1)
    if n_infer > 1:
        raise ValueError("at most one axis size may be -1")
    if n_infer:
        known = (int(np.prod([s for s in sizes if s != -1]))
                 if len(sizes) > 1 else 1)
        if n % known:
            raise ValueError(str((n, axis_sizes)))
        sizes[sizes.index(-1)] = n // known
    total = int(np.prod(sizes))
    if total != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} != {n} devices")
    device = torch.device(devices[rank])
    device_mesh = None
    if world > 1:
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(device.type, tuple(sizes),
                                       mesh_dim_names=names)
    return Mesh(dict(zip(names, sizes)), device, device_mesh)


def batch_sharding(mesh: Mesh, batch_dim: int, ndim: int,
                   axis: str = DATA_AXIS) -> NamedSharding:
    """The placement of `axis` on dimension `batch_dim` of a rank-`ndim`
    tensor, replicated elsewhere."""
    spec = [None] * ndim
    spec[batch_dim] = axis
    return NamedSharding(mesh, tuple(spec))


def shard_batch_pytree(mesh: Mesh, tree, batch_dims, axis: str = DATA_AXIS):
    """This rank's shard of every leaf of a pytree of global tensors.

    `batch_dims` is a pytree with the same structure as `tree` (or a single
    int applied to every leaf) giving the dimension to shard over `axis`; a
    batch_dim of -1 replicates that leaf (it is returned as it is).  None
    entries must match in both trees (they are structure, not leaves).  A
    shard's gradient flows back to the global leaf: its backward gathers
    every rank's shard gradient along the dimension.  Raises ValueError for
    a dimension that does not tile the axis.
    """
    from ._comm import shard

    leaves, rebuild = tree_flatten(tree)
    dims = ([batch_dims] * len(leaves) if isinstance(batch_dims, int)
            else tree_flatten(batch_dims)[0])
    if len(dims) != len(leaves):
        raise ValueError(f"shard_batch_pytree: {len(dims)} batch dims for "
                         f"{len(leaves)} leaves")
    return rebuild([leaf if d == -1 else
                    shard(torch.as_tensor(leaf), mesh, axis, d)
                    for leaf, d in zip(leaves, dims)])


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def sharding_leaves(shardings) -> list:
    """The NamedShardings of a sharding tree, in tree_flatten's leaf order
    (a NamedSharding is a leaf, though it is a tuple)."""
    if isinstance(shardings, NamedSharding):
        return [shardings]
    if shardings is None:
        return []
    return [leaf for child in shardings for leaf in sharding_leaves(child)]


def _with_specs(tree, shardings):
    leaves, rebuild = tree_flatten(tree)
    specs = sharding_leaves(shardings)
    if len(specs) != len(leaves):
        raise ValueError(f"{len(specs)} shardings for {len(leaves)} leaves")
    return leaves, rebuild, specs


def _sharded_dims(sharding: NamedSharding):
    return [(d, axis) for d, axis in enumerate(sharding.spec) if axis]


def shard_params(tree, shardings):
    """This rank's shards of a tree of global tensors (NamedTuples and
    tuples, as utils.checkpoint.tree_flatten walks them), placed as
    `jax.device_put(tree, shardings)` places them: every dimension that a
    leaf's NamedSharding names an axis for is cut to this rank's piece
    along that axis.  `shardings` has the tree's structure, a NamedSharding
    per leaf.  The shards are new tensors, detached from the tree; a
    replicated leaf comes back as a copy.  Raises ValueError for a
    dimension that does not tile its axis."""
    from ._comm import shard

    leaves, rebuild, specs = _with_specs(tree, shardings)
    out = []
    with torch.no_grad():
        for leaf, sh in zip(leaves, specs):
            x = torch.as_tensor(leaf)
            for d, axis in _sharded_dims(sh):
                x = shard(x, sh.mesh, axis, d)
            out.append(x.detach().clone())
    return rebuild(out)


def gather_params(tree, shardings):
    """The global tree from every rank's shards, `shard_params`' inverse:
    each sharded dimension all-gathered over its axis in rank order.  The
    gathers are differentiable: a leaf's gradient comes back as this
    rank's slice of the global leaf's (every rank computes the same
    function of the whole)."""
    from ._comm import all_gather

    leaves, rebuild, specs = _with_specs(tree, shardings)
    out = []
    for leaf, sh in zip(leaves, specs):
        for d, axis in _sharded_dims(sh):
            leaf = all_gather(leaf, sh.mesh, axis, d)
        out.append(leaf)
    return rebuild(out)
