"""Process groups, the device mesh and data-parallel placement (PyTorch).

Counterpart of ``pytorch_object_detection_tpu/parallel/mesh.py``.  The JAX
package builds one ``jax.sharding.Mesh`` over every device and lets XLA
place the collectives; here, as in the reference's DDP
(the reference's ``train.py:43-58``), one process drives one device, the
processes join a ``torch.distributed`` process group, and the mesh is a
``DeviceMesh`` over their ranks with the dimensions ``("data", "model")``.
The ``model`` dimension stays 1: tensor parallelism and spatial
partitioning are not ported (ROADMAP.md queue 1 item 11b).

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
    rank.  ``device_type``: ``"cuda"`` where there is a card, else ``"cpu"``.
    Needs the process group (:func:`initialize_distributed`; a world of
    one rank is a group too).  ``model_parallel > 1`` raises
    ``NotImplementedError``."""
    from torch.distributed.device_mesh import DeviceMesh

    if model_parallel > 1:
        raise NotImplementedError("model_parallel > 1 (tensor parallelism, spatial partitioning: parallel/tp.py, "
                                  "parallel/sp.py) is not ported: ROADMAP.md queue 1 item 11b")
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call initialize_distributed(...) first")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    if data_parallel == -1:
        data_parallel = len(ranks) // model_parallel
    if data_parallel * model_parallel != len(ranks):
        raise ValueError(f"data_parallel {data_parallel} x model_parallel {model_parallel} != {len(ranks)} ranks")
    device_type = device_type or ("cuda" if torch.cuda.is_available() else "cpu")
    mesh = torch.tensor(ranks, dtype=torch.int64).reshape(data_parallel, model_parallel)
    return DeviceMesh(device_type, mesh, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


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
    """Every rank's state made rank 0's (of the mesh's data group): the
    weights and buffers, the optimizer's state and the step of a
    ``TrainState``, or the weights and buffers of a module; returned.
    Every rank must hold the same structure (the same model, the same
    checkpoint restored): the optimizer state's layout is checked first."""
    group = data_group(mesh)
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
