"""Device meshes and the collectives of the sharded solvers.

The JAX package runs one process over N devices and lets GSPMD insert the
collectives.  Here the counterpart is one rank per device over
``torch.distributed``: every rank calls the solver with the whole input,
works on its own shard of bins or frames, and meets the other ranks only
at the collectives of this module:

  * :func:`shard_sum` all-reduces a partial sum over the sharded dimension,
    at every reduction over the sharded axis inside the loop;
  * :func:`shard_max` all-reduces a partial maximum (ProxLaplaceIVA's
    spectral norm over bin shards, once at init);
  * :func:`shard_gather` all-gathers a sharded tensor along its axis, once
    after the loop (the output and the published attributes), and inside
    the loop only where a solver must see a field whole (GaussIDLMA's
    variance network in bins mode, and callbacks).

Each helper counts its collectives on itself (``shard_sum.launches`` and
``shard_max.launches`` the all-reduces, ``shard_gather.launches`` the
all-gathers), as the kernel wrappers count their launches;
:func:`collective_counts` reads them.
Tensors go to the backend as they are, on the card too: NCCL's collectives
run on the card, and gloo takes CUDA tensors in both collectives.
"""

import torch
import torch.distributed as dist


def make_mesh(n_devices=None, axis_name="bins", device_type=None):
    """A 1-D :class:`~torch.distributed.device_mesh.DeviceMesh` named
    ``axis_name`` over the initialised process group (``n_devices``, if
    given, must be its world size; ``device_type`` ``None`` means
    ``"cuda"``)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError("make_mesh: {} devices asked, the process group has {} ranks".format(n_devices, world))
    return init_device_mesh(device_type or "cuda", (world,), mesh_dim_names=(axis_name,))


def mesh_axis(mesh, axis_name=None):
    """The mesh dimension that shards: ``axis_name``, else ``"tp"`` where the
    mesh has one, else its last dimension (the JAX runtime's rule)."""
    names = mesh.mesh_dim_names
    if axis_name is None:
        return "tp" if "tp" in names else names[-1]
    if axis_name not in names:
        raise ValueError("mesh has no dimension {!r} (it has {})".format(axis_name, names))
    return axis_name


def mesh_device(mesh):
    """This rank's device on ``mesh``: the CPU, or the card of the mesh's
    device type at this rank's local index."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    module = getattr(torch, mesh.device_type)
    return torch.device(mesh.device_type, dist.get_rank() % module.device_count())


def shard_bounds(length, mesh, axis_name):
    """``(start, stop)`` of this rank's equal shard of ``length``."""
    size = mesh.size(mesh.mesh_dim_names.index(axis_name))
    index = mesh.get_local_rank(axis_name)
    step = length // size
    return index * step, (index + 1) * step


def take_shard(value, axis, bounds):
    """``value`` (a tensor or an array) cut to ``bounds`` along ``axis``."""
    index = [slice(None)] * value.ndim
    index[axis % value.ndim] = slice(*bounds)
    return value[tuple(index)]


def shard_spectrogram(X, mesh, axis_name="bins"):
    """This rank's shard of ``X (n_channels, n_bins, n_frames)`` along the
    bins, zero-padded to a multiple of the mesh dimension, on the rank's
    device; returns ``(shard, n_bins)`` with the true bin count.

    The JAX function returns one array sharded over every device; here each
    rank holds its own piece and returns that."""
    size = mesh.size(mesh.mesh_dim_names.index(axis_name))
    X = torch.as_tensor(X)
    n_bins = X.shape[1]
    pad = (-n_bins) % size
    if pad:
        X = torch.cat([X, X.new_zeros((X.shape[0], pad, X.shape[2]))], dim=1)
    shard = take_shard(X, 1, shard_bounds(X.shape[1], mesh, axis_name))
    return shard.to(mesh_device(mesh)).contiguous(), n_bins


def all_reduce_sum(x, group):
    """``x`` summed over the ranks of ``group`` (a new tensor; counted as
    one all-reduce)."""
    shard_sum.launches += 1
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, group=group)
    return y


def all_reduce_max(x, group):
    """The elementwise maximum of ``x`` over the ranks of ``group``, a real
    tensor (a new tensor; counted as one all-reduce)."""
    shard_max.launches += 1
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_gather_cat(x, axis, group):
    """The ranks' ``x`` concatenated along ``axis`` in rank order (counted
    as one all-gather)."""
    shard_gather.launches += 1
    y = x.detach().contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, dim=axis)


def shard_sum(x, solver, mode=None):
    """``x`` summed over the shards of ``solver``'s sharded dimension when
    the solver runs sharded in ``mode`` (``"bins"`` for a sum over bins,
    ``"frames"`` for a sum over frames, ``None`` for a sum over both), and
    ``x`` itself otherwise."""
    group = solver._shard_group(mode)
    return x if group is None else all_reduce_sum(x, group)


def shard_max(x, solver, mode=None):
    """The maximum of ``x`` over the shards of ``solver``'s sharded
    dimension when it runs sharded in ``mode``, and ``x`` itself
    otherwise."""
    group = solver._shard_group(mode)
    return x if group is None else all_reduce_max(x, group)


def shard_gather(x, axis, solver):
    """The whole of a tensor that ``solver`` holds sharded along ``axis``
    (``x`` itself when it runs unsharded)."""
    group = solver._shard_group()
    return x if group is None else all_gather_cat(x, axis, group)


shard_sum.launches = 0
shard_max.launches = 0
shard_gather.launches = 0


def collective_counts():
    """``{"all_reduce": n, "all_gather": n}`` since the counters were last
    set to 0."""
    return {"all_reduce": shard_sum.launches + shard_max.launches, "all_gather": shard_gather.launches}


def reset_collective_counts():
    shard_sum.launches = shard_max.launches = shard_gather.launches = 0
