"""Process-group bootstrap for sharded CAVI training (port of
`hgaprec_tpu/parallel/distributed.py`).

The JAX package joins hosts with `jax.distributed` and shards over every
chip of the pod. Here one process drives one device: a rank of a
`torch.distributed` process group, NCCL between CUDA devices and gloo on
the CPU. The launch is torchrun's:

    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK

or the CLI's own, which sets WORLD_SIZE, RANK and LOCAL_RANK for the
workers it starts and, in place of an address and a port, names a
rendezvous file in INIT_METHOD_ENV.

Usage (the same script on every rank):

    from hgaprec_tpu_torch.parallel import distributed
    distributed.initialize_from_env(device)   # False for one process
    run = build_sharded_run(store, cfg, dist.group.WORLD, device)
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

# the init method of a launch that is not torchrun's (the CLI's spawned
# ranks: a file:// rendezvous), read when no init_method is passed
INIT_METHOD_ENV = "HGAPREC_INIT_METHOD"


def initialize_from_env(device=None, init_method: Optional[str] = None,
                        world_size: Optional[int] = None,
                        rank: Optional[int] = None) -> bool:
    """Initialize the default process group when a multi-process launch is
    detected. Explicit arguments take the place of the environment
    (WORLD_SIZE, RANK; the init method defaults to INIT_METHOD_ENV's value
    and without it to `env://`, which reads MASTER_ADDR and MASTER_PORT),
    so a caller can pass a `file://` or `tcp://localhost:PORT` method.
    The backend is NCCL for a CUDA `device` and gloo otherwise. Returns
    True when the group was initialized, False for a plain single-process
    run (nothing to do)."""
    init_method = init_method or os.environ.get(INIT_METHOD_ENV)
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None or (world_size <= 1 and init_method is None):
        return False
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda and torch.device(device).index is not None:
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=init_method or "env://",
                            world_size=world_size, rank=rank or 0)
    return True


def local_rank() -> int:
    """This process's device index on its host (torchrun's LOCAL_RANK)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def _rank_world():
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return _rank_world()[0]


def is_primary() -> bool:
    """True on the process that should write output files (rank 0)."""
    return rank() == 0


def local_device_slice(n_global_rows: int) -> slice:
    """Row range of the user axis owned by this rank: equal blocks in rank
    order, the last one taking the remainder (distributed.py:74-83 of the
    JAX package, with one device per process)."""
    rank, world = _rank_world()
    per = n_global_rows // world
    lo = rank * per
    hi = n_global_rows if rank == world - 1 else lo + per
    return slice(lo, hi)


def host_user_rows(n: int, ndev: Optional[int] = None) -> slice:
    """Seq-id training rows THIS rank should ingest, for
    data.ratings.load_dataset(user_rows=host_user_rows): the user axis
    padded to a multiple of the device count, partitioned in rank order
    (distributed.py:86-99 of the JAX package), which is the row
    partition of parallel.sharded.build_sharded_run, so a store holding
    only these rows feeds exactly this rank's shard.

    Pass the callable itself: it takes the ACTUAL user count, known only
    after the global id remap."""
    ndev = ndev or _rank_world()[1]
    n_padded = -(-n // ndev) * ndev
    return local_device_slice(n_padded)
