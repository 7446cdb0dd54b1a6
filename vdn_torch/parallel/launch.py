"""Process-group initialization (vdn/parallel/launch.py).

vdn calls ``jax.distributed.initialize`` and honours the reference's
SLURM / torchrun wiring (MASTER_ADDR / MASTER_PORT, WORLD_SIZE, RANK,
reference metric_depth/util/dist_helper.py:14-29) as a fallback; here that
wiring is the rule, as torchrun sets it:

    torchrun --nproc-per-node 4 script.py    # one rank per card
    initialize_distributed()
    mesh = make_mesh(seq=4)

With no environment and no arguments it sets up a world of one rank on the
card (NCCL over an in-process store: no port is opened).  ``device="cpu"``
takes gloo instead, for CPU runs; without a card, ``device="cuda"``
raises.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "is_primary"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: str = "cuda",
                           init_method: Optional[str] = None) -> None:
    """Join (or form) the default process group, once per process.

    ``coordinator_address`` ("host:port") or the env's MASTER_ADDR /
    MASTER_PORT name the rendezvous, with WORLD_SIZE and RANK for
    ``num_processes`` and ``process_id``; ``init_method`` (e.g. a
    ``file://`` store) replaces the address.  Neither given: a world of
    one.  On the card each rank takes the card LOCAL_RANK (else its rank)
    modulo the cards of the host."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: no CUDA device; pass "
                               "device='cpu' for a gloo group on the CPU")
        backend = "nccl"
    elif device == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize_distributed: device {device!r}")
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if init_method is None and coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    if init_method is not None:
        world = num_processes or int(env.get("WORLD_SIZE", "1"))
        rank = process_id if process_id is not None else int(
            env.get("RANK", "0"))
        kw = dict(init_method=init_method)
    else:
        world, rank = 1, 0
        kw = dict(store=dist.HashStore())
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, world_size=world, rank=rank, **kw)


def is_primary() -> bool:
    """The rank-0 check (the reference's ``rank == 0`` guards); True
    outside a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0
