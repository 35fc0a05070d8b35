"""Process groups, the device mesh and data-parallel placement (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/parallel/mesh.py``.  The JAX
package builds one ``jax.sharding.Mesh`` over every device and lets XLA
place the collectives; here, as in the reference's DDP
(the reference's ``train.py:43-58``), one process drives one device, the
processes join a ``torch.distributed`` process group, and the mesh is a
``DeviceMesh`` over their ranks with the dimensions ``("data", "model")``,
row-major: the ranks of one model group are consecutive.  The ``model``
dimension carries tensor parallelism (``parallel/tp.py``) or spatial
partitioning (``parallel/sp.py``) where it is larger than 1.

The backend: NCCL where every rank has a card of its own; gloo on the CPU
and where several ranks share a card (NCCL refuses two ranks on one GPU),
as the JAX package picks gloo for CPU collectives.  The choice is printed.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from pytorch_object_detection_tpu_torch.parallel.collectives import broadcast_, group_of

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device: Optional[str] = None) -> bool:
    """Join this process to the process group; ``True`` where there is one.

    With ``coordinator`` (``host:port``, or an init URL such as
    ``file:///path``): ``init_process_group`` on ``tcp://<coordinator>``
    with ``num_processes`` ranks as ``process_id``.  Without one, ``env://``
    where a launcher (``torchrun``) set ``RANK`` and ``WORLD_SIZE``; else
    one process and nothing to do (``False``).  ``device`` (``"cuda"`` or
    ``"cpu"``; the card where there is one) is where this rank computes:
    on the card it takes ``cuda:<LOCAL_RANK mod cards>``.  The backend
    follows the module docstring's rule, counting the ranks that share this
    host as ``LOCAL_WORLD_SIZE`` where a launcher set it, else all of them.
    Calling it again in a process that has a group does nothing and
    returns ``True``.
    """
    if dist.is_initialized():
        return True
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator launch needs num_processes and process_id")
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        world, rank = int(num_processes), int(process_id)
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init_method, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        return False
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device == "cuda":
        cards = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % cards)
        why = (f"{local_world} ranks on {cards} card(s) of this host" if local_world <= cards else
               f"{local_world} ranks share {cards} card(s): NCCL takes one rank a card")
        chosen = "nccl" if local_world <= cards else "gloo"
    else:
        why, chosen = "CPU ranks", "gloo"
    dist.init_process_group(chosen, init_method=init_method, world_size=world, rank=rank)
    print(f"initialize_distributed: rank {rank} of {world}, backend {chosen} ({why}), device "
          f"{rank_device(device)}", flush=True)
    return True


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: the current card, or the CPU."""
    return torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda" else torch.device("cpu")


def create_mesh(devices: Optional[Sequence[int]] = None, data_parallel: int = -1, model_parallel: int = 1,
                device_type: Optional[str] = None):
    """A ``DeviceMesh`` over the ranks ``devices`` (all of the group's by
    default), shaped ``(data_parallel, model_parallel)`` with the dimension
    names ``(DATA_AXIS, MODEL_AXIS)``; ``data_parallel`` defaults to every
    rank, divided by ``model_parallel``: rank ``d * model_parallel + m``
    sits at ``(d, m)``, so each model group is ``model_parallel``
    consecutive ranks.  ``device_type``: ``"cuda"`` where there is a card,
    else ``"cpu"``.  Needs the process group (:func:`initialize_distributed`;
    a world of one rank is a group too).  Every rank of the group calls it
    (it makes the dimensions' groups)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call initialize_distributed(...) first")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    if data_parallel == -1:
        data_parallel = len(ranks) // model_parallel
    if model_parallel < 1 or data_parallel * model_parallel != len(ranks):
        raise ValueError(f"data_parallel {data_parallel} x model_parallel {model_parallel} != {len(ranks)} ranks")
    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(data_parallel, model_parallel)
    if model_parallel == 1:
        mesh = DeviceMesh(device_type, grid, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    else:
        # the dimensions' groups on the default group's backend: DeviceMesh would give a CUDA mesh NCCL groups,
        # which refuse two ranks on one card (gloo's use here)
        mesh = DeviceMesh(device_type, grid, mesh_dim_names=(DATA_AXIS, MODEL_AXIS), _init_backend=False)
        backend = dist.get_backend()
        mesh._podt_dims = {DATA_AXIS: dist.new_subgroups_by_enumeration(grid.T.tolist(), backend=backend)[0],
                           MODEL_AXIS: dist.new_subgroups_by_enumeration(grid.tolist(), backend=backend)[0]}
    mesh._podt_group = None if ranks == list(range(dist.get_world_size())) else dist.new_group(ranks)
    return mesh


def data_group(mesh=None):
    """The process group of ``mesh``'s data dimension (a ``DeviceMesh`` of
    :func:`create_mesh`, or a process group); for ``None`` the default
    group where this process has one, else ``None`` (one process).  A mesh
    in a process without a group raises ``RuntimeError``, anything else
    ``TypeError``."""
    from torch.distributed.device_mesh import DeviceMesh

    if mesh is None:
        return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs this process in a process group: initialize_distributed(...), then "
                           "create_mesh()")
    if isinstance(mesh, (DeviceMesh, dist.ProcessGroup)):
        return group_of(mesh)
    raise TypeError(f"mesh must be a DeviceMesh (create_mesh) or a process group; got {type(mesh).__name__}")


def model_group(mesh):
    """The process group of ``mesh``'s model dimension (the ranks that
    share one data shard: tensor parallelism's channel shards or spatial
    partitioning's row bands)."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (create_mesh); got {type(mesh).__name__}")
    return group_of(mesh, MODEL_AXIS)


def mesh_group(mesh):
    """The process group of every rank of ``mesh``: the default group where
    the mesh spans the world (:func:`create_mesh`'s default), else the
    group of its ranks (:func:`create_mesh` makes it)."""
    group = getattr(mesh, "_podt_group", None)
    return dist.group.WORLD if group is None else group


def model_parallel_size(mesh) -> int:
    """The size of ``mesh``'s model dimension (1 for ``None`` or a process group)."""
    return int(mesh.mesh.shape[1]) if hasattr(mesh, "mesh_dim_names") else 1


def shard_batch(mesh, batch):
    """This rank's shard of the batch on its device.  As the JAX function's
    multi-process meaning (the reference's DDP: the batch size is per
    rank), each rank's local batch IS its shard of the global batch: a
    tensor or numpy array, or a tuple of them, goes to the rank's device."""
    device = rank_device(mesh.device_type)

    def put(x):
        return torch.as_tensor(x).to(device, non_blocking=True)

    return tuple(put(x) for x in batch) if isinstance(batch, tuple) else put(batch)


def replicate_state(mesh, state):
    """Every rank's state made rank 0's (of the mesh's data group; of the
    whole mesh where its model dimension is above 1): the weights and
    buffers, the optimizer's state and the step of a ``TrainState``, or
    the weights and buffers of a module; returned.  Every rank must hold
    the same structure (the same model, the same checkpoint restored): the
    optimizer state's layout is checked first."""
    group = mesh_group(mesh) if model_parallel_size(mesh) > 1 else data_group(mesh)
    model = getattr(state, "model", state)
    tensors = [p.data for p in model.parameters()] + list(model.buffers())
    optimizer = getattr(state, "optimizer", None)
    if optimizer is not None:
        params = [p for g in optimizer.param_groups for p in g["params"]]
        layout = [sorted((k, tuple(v.shape), str(v.dtype)) for k, v in optimizer.state[p].items()
                         if torch.is_tensor(v)) for p in params]
        theirs = [layout, int(state.step)]
        dist.broadcast_object_list(theirs, src=dist.get_global_rank(group, 0), group=group)
        if theirs[0] != layout:
            raise ValueError("the ranks hold optimizer states of another layout: restore the same checkpoint on "
                             "every rank before replicate_state")
        state.step = theirs[1]
        tensors += [v for p in params for _, v in sorted(optimizer.state[p].items()) if torch.is_tensor(v)]
    broadcast_(tensors, group)
    return state
