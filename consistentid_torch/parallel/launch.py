"""Start N ranks of one function on this host: the port's own launcher
(torchrun's job for a single host, in-process).

    results = launch(fn, 2, arg, device_type="cuda")

spawns 2 processes (multiprocessing "spawn"), gives each the launcher
environment torchrun would (MASTER_ADDR=localhost, a free MASTER_PORT,
WORLD_SIZE, RANK, LOCAL_RANK, LOCAL_WORLD_SIZE), joins the process group
(`initialize_multihost`; gloo unless every rank has a card of its own),
calls `fn(*args)` and returns every rank's return value, in rank order.
A rank that raises fails the launch: the exception is raised here, with
the rank's traceback. `fn` must be importable by name (a module-level
function of a module that imports cheaply: the ranks import it anew).
"""
from __future__ import annotations

import os
import socket
import tempfile
from typing import Any, Callable, List

import torch

from .mesh import RANK_DEVICE_ENV, default_backend, initialize_multihost


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, nprocs: int, port: int, backend: str,
               device_type: str, threads: int, out_dir: str,
               fn: Callable, args: tuple) -> None:
    import torch.distributed as dist

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(nprocs), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs))
    os.environ[RANK_DEVICE_ENV] = device_type
    if threads:
        torch.set_num_threads(threads)
    initialize_multihost(backend=backend, device_type=device_type)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, nprocs: int, *args,
           device_type: str = "cuda") -> List[Any]:
    """Run `fn(*args)` on `nprocs` ranks; returns their results in rank
    order (each must be something torch.save can write). On the CPU each
    rank gets an equal share of this process's threads."""
    backend = default_backend(device_type, nprocs)
    threads_per_rank = (max(1, torch.get_num_threads() // nprocs)
                        if device_type == "cpu" else 0)
    with tempfile.TemporaryDirectory(prefix="cid_launch_") as out_dir:
        torch.multiprocessing.start_processes(
            _rank_main, nprocs=nprocs, join=True, start_method="spawn",
            args=(nprocs, free_port(), backend, device_type,
                  threads_per_rank, out_dir, fn, args))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
