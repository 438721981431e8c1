"""Meshes of ranks for the sharded paths, over `torch.distributed`.

Counterpart of `bls12_381_tpu/parallel/mesh.py`.  A mesh is PyTorch's own
`DeviceMesh` over the whole initialised world: a 1-D ("x",) mesh or a 2-D
("host", "x") mesh laid out host-major (rank = host * chips_per_host + x),
so that the inner axis holds one host's ranks.  Batches shard over all
axes, the rank's shard index being its rank; reductions run inner axis
first, so that one partial value per host crosses the outer axis.

The caller initialises the process group (`torchrun`, or a spawn that calls
`init_process_group`).  Nothing here initialises one: without a group, or
with a world of another size than the mesh, `make_mesh` raises.  The JAX
package's fallback to virtual CPU devices has no counterpart.

Every rank passes the same global inputs; a sharded function takes its
rank's shard of the last (batch) axis and returns its result replicated on
every rank.  Collectives move one contiguous tensor each: the callers pack
a point or an Fp12 value into one tensor first.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..limbs import resolve_device
from ..utils import scans


def _world_size() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "bls12_381_torch.parallel: no process group is initialised; "
            "call torch.distributed.init_process_group first (torchrun or a "
            "spawn)")
    return dist.get_world_size()


def _mesh(shape: tuple[int, ...], names: tuple[str, ...]) -> DeviceMesh:
    n = math.prod(shape)
    world = _world_size()
    if n != world:
        raise RuntimeError(
            f"bls12_381_torch.parallel: a mesh of {n} ranks needs a world of "
            f"{n} ranks, the process group has {world}")
    # the ranks' default device type; the collectives below route by each
    # tensor's own device
    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, axis: str = "x") -> DeviceMesh:
    """1-D mesh of n_devices ranks (default: the world)."""
    n = _world_size() if n_devices is None else n_devices
    return _mesh((n,), (axis,))


def make_mesh_2d(n_hosts: int, chips_per_host: int,
                 axes: tuple[str, str] = ("host", "x")) -> DeviceMesh:
    """[n_hosts, chips_per_host] mesh: the outer axis spans hosts, the inner
    one each host's ranks (ranks host-major, as torchrun numbers them)."""
    return _mesh((n_hosts, chips_per_host), tuple(axes))


def batch_axes(mesh: DeviceMesh) -> tuple[str, ...]:
    """All mesh axis names: a batch shards over the whole mesh."""
    return tuple(mesh.mesh_dim_names)


def reduce_axes_inner_first(mesh: DeviceMesh) -> tuple[str, ...]:
    """Reduction order: innermost axis first, the host axis last."""
    return tuple(reversed(mesh.mesh_dim_names))


def shard_size(mesh: DeviceMesh, batch: int) -> int:
    """Lanes per rank of a batch sharded over the whole mesh."""
    if batch % mesh.size():
        raise ValueError(f"a batch of {batch} does not shard evenly over "
                         f"{mesh.size()} ranks")
    return batch // mesh.size()


def shard_batch(mesh: DeviceMesh, arr, axis_name=None):
    """This rank's shard of the last axis of a tensor, or of every tensor of
    a nested tuple (views).  The batch shards over all mesh axes (None), or
    over one axis name or a tuple of them, the first one major, as the JAX
    package's NamedSharding lays it out: the shard index is the rank's
    coordinate along those axes, and the ranks along the other axes hold the
    same shard.  Over all axes of a host-major mesh the index is the rank."""
    names = batch_axes(mesh) if axis_name is None else (
        (axis_name,) if isinstance(axis_name, str) else tuple(axis_name))
    dims = list(mesh.mesh_dim_names)
    if not names or any(a not in dims for a in names) \
            or len(set(names)) != len(names):
        raise ValueError(f"shard_batch: axis_name {axis_name!r} does not "
                         f"name distinct axes of the mesh {tuple(dims)}")
    coord = dict(zip(dims, mesh.get_coordinate()))
    size = dict(zip(dims, mesh.mesh.shape))
    n_shards, index = 1, 0
    for a in names:
        n_shards, index = n_shards * size[a], index * size[a] + coord[a]
    batch = scans.tree_leaves(arr)[0].shape[-1]
    if batch % n_shards:
        raise ValueError(f"a batch of {batch} does not shard evenly over "
                         f"{n_shards} ranks")
    b = batch // n_shards
    start = index * b
    return scans.tree_map(lambda t: t[..., start:start + b], arr)


def replicate(mesh: DeviceMesh, tree):
    """Every tensor of a nested tuple as the mesh's first rank holds it:
    a broadcast along each axis, inner axis first (rank (h, 0) gives its
    host, then rank (0, x) its column)."""
    coord = tuple(mesh.get_coordinate())

    def bcast(t):
        t = t.contiguous().clone()
        for dim in reversed(range(mesh.ndim)):
            src = coord[:dim] + (0,) + coord[dim + 1:]
            dist.broadcast(t, src=int(mesh.mesh[src]),
                           group=mesh.get_group(dim))
        return t

    return scans.tree_map(bcast, tree)


def rank_device(device="cuda") -> torch.device:
    """The rank's device: "cuda" without an index is the rank's card,
    cuda:{rank % device_count}; any other device as `limbs.resolve_device`
    gives it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


def _all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """t from every rank of the group, in rank order: one all_gather of the
    contiguous tensor.  Gloo takes CUDA tensors here (and in
    all_to_all_single) but not in all_gather_into_tensor's stacked form, so
    the list form serves both backends."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def all_gather_axis(mesh: DeviceMesh, t: torch.Tensor,
                    axis: str) -> torch.Tensor:
    """t from every rank along one mesh axis, stacked on a new last axis in
    rank order (a batch of the axis's size, for a reduction)."""
    return torch.stack(_all_gather(t, mesh.get_group(axis)), dim=-1)


def gather_batch(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The whole batch from every rank's shard, concatenated along `dim` in
    rank order: one all_gather over the world (which every mesh spans)."""
    return torch.cat(_all_gather(t), dim=dim)


def all_to_all(t: torch.Tensor) -> torch.Tensor:
    """Chunk r of t's leading axis (one chunk per rank) goes to rank r; the
    result holds the chunks received, in rank order.  One
    all_to_all_single over the world (which every mesh spans)."""
    t = t.contiguous()  # before empty_like, which keeps a view's strides
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t)
    return out
