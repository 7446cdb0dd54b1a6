"""Device mesh and axis conventions (vdn/parallel/mesh.py) on
torch.distributed.

Axes, as vdn's:

- ``data``: the batch (data parallel);
- ``seq``: the frame axis of a clip (context parallel; the temporal
  attention spans it);
- ``model``: reserved for tensor parallelism of vitg.

``make_mesh`` lays the world's ranks out as a [data, seq, model]
``DeviceMesh`` (NCCL on the card, gloo when the caller asks for the CPU).
vdn names a mesh axis inside ``shard_map``; here ``use_mesh`` makes a mesh
the one in which a module's ``seq_axis`` name resolves (``axis_group``),
and ``shard_clip`` / ``gather_clip`` are ``P(data, seq)``: a rank's
[B / data, T / seq] block of a clip, and the blocks gathered back in mesh
order.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from vdn_torch.parallel.launch import initialize_distributed

__all__ = ["DATA_AXIS", "SEQ_AXIS", "MODEL_AXIS", "make_mesh", "use_mesh",
           "current_mesh", "axis_group", "axis_index", "axis_size",
           "shard_clip", "gather_clip"]

DATA_AXIS = "data"
SEQ_AXIS = "seq"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, SEQ_AXIS, MODEL_AXIS)

Axis = Union[str, dist.ProcessGroup]

_MESH = contextvars.ContextVar("vdn_torch_mesh", default=None)


def make_mesh(data: Optional[int] = None, seq: int = 1, model: int = 1,
              device: str = "cuda") -> DeviceMesh:
    """The world's ranks as a [data, seq, model] mesh; ``data`` defaults to
    what the world leaves.  Forms a world of one first if no process group
    exists (``initialize_distributed``).  ``device="cuda"`` without a card
    raises; it never falls back to the CPU."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' "
                           "for a gloo mesh on the CPU")
    initialize_distributed(device=device)
    n = dist.get_world_size()
    if data is None:
        data = n // (seq * model)
    if data * seq * model != n:
        raise ValueError(f"mesh {data}x{seq}x{model} != {n} ranks")
    return init_device_mesh(device, (data, seq, model), mesh_dim_names=AXES)


@contextlib.contextmanager
def use_mesh(mesh: DeviceMesh):
    """Resolve axis names in ``mesh`` inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh() -> DeviceMesh:
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("no mesh in use: a seq_axis model runs inside "
                           "use_mesh(mesh) or make_context_parallel_forward")
    return mesh


def axis_group(axis: Axis) -> dist.ProcessGroup:
    """The process group of a mesh axis name (in the mesh in use), or
    ``axis`` itself when it is a group."""
    if isinstance(axis, str):
        return current_mesh().get_group(axis)
    return axis


def axis_index(axis: Axis) -> int:
    """This rank's index along the axis (``jax.lax.axis_index``)."""
    return dist.get_rank(axis_group(axis))


def axis_size(axis: Axis) -> int:
    """The number of ranks along the axis (``jax.lax.axis_size``)."""
    return dist.get_world_size(axis_group(axis))


def shard_clip(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's [B / data, T / seq, ...] block of a clip [B, T, ...]
    (``clip_sharding``: P(data, seq))."""
    d, s = mesh.get_coordinate()[:2]
    nd, ns = mesh.size(0), mesh.size(1)
    b, t = x.shape[:2]
    if b % nd or t % ns:
        raise ValueError(f"clip {tuple(x.shape[:2])} does not divide over "
                         f"data {nd} x seq {ns}")
    bl, tl = b // nd, t // ns
    return x[d * bl:(d + 1) * bl, s * tl:(s + 1) * tl]


def gather_clip(y: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's block [B / data, T / seq, ...] gathered into [B, T, ...]
    in mesh order (``out_specs=P(data, seq)``); the ranks along ``model``
    hold the same block and the first one's is taken."""
    y = y.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, y)
    ranks = mesh.mesh
    return torch.cat([torch.cat([parts[int(ranks[i, j, 0])]
                                 for j in range(ranks.shape[1])], dim=1)
                      for i in range(ranks.shape[0])], dim=0)
