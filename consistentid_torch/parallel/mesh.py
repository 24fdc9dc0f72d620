"""Ranks, the (data, model) mesh and its collectives on torch.distributed:
the port's counterpart of the JAX package's parallel/mesh.py.

A JAX mesh is one process driving many devices; here every rank is one
process and drives one device: rank r takes card `LOCAL_RANK %
torch.cuda.device_count()`, or the CPU when the caller asks for it (the
tests). `make_mesh` lays the world out as JAX does (`devices.reshape(data,
model)`): rank = data_index * model + model_index. Each rank then belongs
to one data group (the ranks that share its model index: gradients and
image batches are reduced and gathered over it) and one model group (the
ranks that share its data index: the tensor-parallel all-reduces). A
control group on gloo carries Python objects (the server's bucket
arguments) whatever the backend of the others.

Backend: NCCL where every rank of the host has a card of its own; gloo
where two ranks share one card (NCCL refuses that) or run on the CPU.
gloo has no CUDA form of most collectives, so under gloo a CUDA tensor is
staged through host memory for each collective; the work itself stays on
the card.

The collectives (`all_reduce_sum`, `all_reduce_max`, `all_reduce_mean`,
`all_gather_cat`, `broadcast_object`) are no-ops on a group of None: a
mesh of one rank has no groups, so code written for a mesh runs unchanged
on one device.
"""
from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the device type of a launched rank (parallel/launch.py sets it)
RANK_DEVICE_ENV = "CONSISTENTID_RANK_DEVICE"


def _local_world() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              os.environ.get("WORLD_SIZE", "1")))


def default_backend(device_type: str = "cuda",
                    local_world: Optional[int] = None) -> str:
    """"nccl" when every rank of this host has a card of its own, else
    "gloo" (the CPU, or several ranks on one card)."""
    if device_type != "cuda" or not torch.cuda.is_available():
        return "gloo"
    local_world = local_world or _local_world()
    return "nccl" if torch.cuda.device_count() >= local_world else "gloo"


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: card LOCAL_RANK % device_count, or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device_type: str = "cuda",
                         timeout_s: float = 300.0) -> None:
    """Join the process group (JAX `initialize_multihost`, mesh.py:23-57).

    With `coordinator_address` ("host:port") the group is built from it,
    `num_processes` and `process_id`, and a failure raises: an explicit
    cluster configuration that fails must not be hidden. Without it the
    launcher's environment (torchrun: MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK) is read; where there is none, it warns and the run
    stays at world size 1, as the JAX call skips on a single host. A group
    already initialised is kept."""
    if dist.is_initialized():
        return
    timeout = timedelta(seconds=timeout_s)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator needs num_processes "
                             "and process_id")
        host, _, port = coordinator_address.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"coordinator address {coordinator_address!r} "
                             "is not host:port")
        backend = backend or default_backend(device_type, num_processes)
        _init(backend, f"tcp://{coordinator_address}", num_processes,
              process_id, timeout, device_type)
        return
    if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
        warnings.warn("torch.distributed not initialised (no cluster "
                      "environment: MASTER_ADDR / WORLD_SIZE unset); "
                      "running at world size 1")
        return
    world = int(os.environ["WORLD_SIZE"])
    backend = backend or default_backend(device_type)
    _init(backend, "env://", world, int(os.environ["RANK"]), timeout,
          device_type)


def _init(backend: str, init_method: str, world: int, rank: int,
          timeout: timedelta, device_type: str) -> None:
    kw = {}
    if backend == "nccl":
        device = rank_device(device_type)
        torch.cuda.set_device(device)
        kw["device_id"] = device
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout,
                            **kw)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclass
class Mesh:
    """This rank's view of a (data, model) mesh. `device` is the rank's
    device; the groups are None on an axis of size 1."""
    data: int
    model: int
    rank: int
    device: torch.device
    backend: str
    data_group: Any = None
    model_group: Any = None
    control_group: Any = None

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def describe(self) -> str:
        return (f"mesh data={self.data} model={self.model} rank={self.rank} "
                f"backend={self.backend} device={self.device}")


def make_mesh(devices: Optional[Sequence] = None, data: Optional[int] = None,
              model: int = 1, device_type: Optional[str] = None) -> Mesh:
    """The (data, model) mesh over every rank of the process group (JAX
    `make_mesh`, mesh.py:60-77): all ranks on the data axis by default.
    `devices`, where given, lists one device per rank (its length must be
    the world size). `device_type` ("cuda" or "cpu") picks the rank's
    device: by default the launcher's choice, else the card where there is
    one. Every rank must call this, in the same order as any other group
    construction."""
    n = world_size()
    if devices is not None:
        assert len(devices) == n, (
            f"{len(devices)} devices for a world of {n} ranks")
    if data is None:
        assert n % model == 0, f"{n} ranks not divisible by model={model}"
        data = n // model
    assert data * model == n, f"mesh {data}x{model} != {n} ranks"
    device_type = device_type or os.environ.get(
        RANK_DEVICE_ENV, "cuda" if torch.cuda.is_available() else "cpu")
    device = rank_device(device_type)
    if n == 1:
        return Mesh(1, 1, 0, device, "none")
    rank = dist.get_rank()
    backend = dist.get_backend()
    data_groups = [dist.new_group([d * model + m for d in range(data)])
                   for m in range(model)]
    model_groups = [dist.new_group([d * model + m for m in range(model)])
                    for d in range(data)]
    control = (dist.new_group(list(range(n)), backend="gloo")
               if backend != "gloo" else dist.group.WORLD)
    return Mesh(data, model, rank, device, backend,
                data_group=data_groups[rank % model] if data > 1 else None,
                model_group=model_groups[rank // model] if model > 1
                else None,
                control_group=control)


def data_axis_size(mesh) -> int:
    """Batch shards: the data axis' size (1 without a mesh)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(DATA_AXIS, getattr(mesh, "size", 1)))


def model_axis_size(mesh) -> int:
    return 1 if mesh is None else int(mesh.shape.get(MODEL_AXIS, 1))


def shard_rows(n: int, mesh: Optional[Mesh]) -> slice:
    """This rank's rows of a global batch of n: [r*b, (r+1)*b) with
    b = n / data (JAX's batch-dim sharding)."""
    d = data_axis_size(mesh)
    if d == 1:
        return slice(0, n)
    if n % d:
        raise ValueError(f"a batch of {n} does not split over {d} ranks")
    b = n // d
    return slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)


def shard_batch(mesh: Optional[Mesh], batch, batch_dim: int = 0):
    """This rank's shard of a dict of host arrays (JAX `shard_batch`):
    the rows `shard_rows` gives along `batch_dim`. batch_dim=1 is the
    grad-accumulation layout (accum, global_batch, ...): the per-example
    dim is split and every rank keeps the whole accum dim."""
    def take(x):
        idx = [slice(None)] * x.ndim
        idx[batch_dim] = shard_rows(x.shape[batch_dim], mesh)
        return x[tuple(idx)]
    return {k: take(v) for k, v in batch.items()}


# ------------------------------------------------------------ collectives

def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


_HALF = (torch.bfloat16, torch.float16)


def _host_collective(t: torch.Tensor, group, fn) -> torch.Tensor:
    """Run the reduction `fn(tensor)` in place on `t`: through host memory
    where the group is gloo and `t` is on the card, and on gloo in fp32
    for a 16-bit tensor (each rank's share rounded once, the sum not)."""
    if _staged(group) and (t.device.type == "cuda" or t.dtype in _HALF):
        host = t.detach().to("cpu", torch.float32 if t.dtype in _HALF
                             else t.dtype)
        fn(host)
        t.copy_(host)
    else:
        fn(t)
    return t


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over `group` (a no-op on None); returns `t`."""
    if group is None:
        return t
    return _host_collective(
        t, group, lambda x: dist.all_reduce(x, dist.ReduceOp.SUM, group))


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return t
    return _host_collective(
        t, group, lambda x: dist.all_reduce(x, dist.ReduceOp.MAX, group))


def all_reduce_mean(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Means over `group` of a list of tensors (JAX pmean), in one flat
    all-reduce in at least fp32; returns new tensors in the inputs'
    dtypes."""
    if group is None:
        return list(tensors)
    n = dist.get_world_size(group)
    dtype = torch.float32
    for t in tensors:
        dtype = torch.promote_types(dtype, t.dtype)
    flat = torch.cat([t.detach().to(dtype).reshape(-1) for t in tensors])
    all_reduce_sum(flat, group)
    flat /= n
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).to(t.dtype))
        at += t.numel()
    return out


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (same shapes), concatenated along `dim` in rank
    order of the group; `t` itself on None."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    src = t.contiguous()
    if _staged(group) and (src.device.type == "cuda" or src.dtype in _HALF):
        # gloo has no 16-bit gather: fp32 holds them exactly
        host = src.to("cpu", torch.float32 if src.dtype in _HALF
                      else src.dtype)
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group)
        return torch.cat(parts, dim).to(t.device, t.dtype)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group)
    return torch.cat(parts, dim)


def broadcast_object(obj, mesh: Optional[Mesh], src: int = 0):
    """`obj` of rank `src`, on every rank (over the control group)."""
    if mesh is None or mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=mesh.control_group)
    return box[0]
