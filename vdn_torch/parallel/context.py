"""Context parallelism over the frame axis (vdn/parallel/context.py).

Every stage of the video model is frame-independent except the temporal
attention, so the clip forward runs on each rank's [B / data, T / seq]
block (``make_context_parallel_forward``) and the temporal attention of a
``seq_axis`` model spans the seq group:

- ``ring_attention``: K / V blocks rotate rank i -> i + 1 for p steps,
  each step an online-softmax update of an fp32 (o, m, l) carry (logits and
  products in fp32); differentiable (the rotation's backward rotates the
  cotangent back);
- ``ulysses_attention``: all-to-all [N, T/p, H, D] -> [N/p, T, H, D], the
  plain attention over the whole frame range, and the inverse all-to-all;
- ``distributed_kv_attention``: replicated queries over sharded K / V,
  combined with one all-reduce MAX and two all-reduce SUMs (the streaming
  decode's primitive; inference only);
- ``cp_attention``: the mode's choice (``set_cp_mode`` / ``VDN_CP_MODE``):
  ``"ring"``, ``"alltoall"``, ``"ring_pallas"`` (the ring of kernel E1,
  vdn_torch.kernels.ring_attention) or ``"auto"``, which takes E1 from a
  local K / V length of 128 on, as vdn's gate does (vdn's reasons for 128
  are its own TPU measurements, context.py:165-182; the H100's are in
  PERF.md).

An ``axis`` is a mesh axis name, resolved in the mesh in use
(vdn_torch.parallel.mesh.use_mesh), or a process group.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from vdn_torch.ops.attention import dot_product_attention
from vdn_torch.parallel.mesh import (Axis, axis_group, gather_clip,
                                     shard_clip, use_mesh)

__all__ = ["ring_attention", "sequence_position_offset",
           "make_context_parallel_forward", "distributed_kv_attention",
           "ulysses_attention", "set_cp_mode", "cp_attention",
           "post_ring_shift", "ring_shift", "ring_update_plain"]


def sequence_position_offset(axis: Axis, t_local: int) -> int:
    """Global frame index of this rank's first frame."""
    return dist.get_rank(axis_group(axis)) * t_local


def post_ring_shift(group, *tensors: torch.Tensor, step: int = 1):
    """Post the rotation of ``tensors`` by ``step`` ranks along ``group``
    (rank i sends to i + step and receives from i - step) in one batch.
    Returns (works, received buffers); wait on the works before reading
    the buffers.  With p == 2 the send and the receive share a peer."""
    ranks = dist.get_process_group_ranks(group)
    p, me = len(ranks), dist.get_rank(group)
    dst, src = ranks[(me + step) % p], ranks[(me - step) % p]
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, dst, group, tag=i)
           for i, t in enumerate(tensors)]
    ops += [dist.P2POp(dist.irecv, o, src, group, tag=i)
            for i, o in enumerate(outs)]
    return dist.batch_isend_irecv(ops), outs


def _wait(works) -> None:
    for w in works:
        w.wait()


class _RingShift(torch.autograd.Function):
    """vdn's ``ppermute`` with perm [(i, i + 1)]: its transpose rotates the
    cotangents back, i + 1 -> i."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        works, outs = post_ring_shift(group, *tensors)
        _wait(works)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        works, outs = post_ring_shift(
            ctx.group, *(g.contiguous() for g in grads), step=-1)
        _wait(works)
        return (None, *outs)


def ring_shift(group, *tensors: torch.Tensor):
    """``tensors`` rotated rank i -> i + 1 along ``group``."""
    return _RingShift.apply(group, *tensors)


def ring_update_plain(qf, k, v, o, m, l, scale: float):
    """One step of the plain ring: the fp32 online-softmax update of the
    carry (o [B, H, Tq, D], m and l [B, H, Tq, 1]) with a K / V block
    [B, Tk, H, D], qf [B, Tq, H, D] fp32 (vdn/parallel/context.py:52-62).
    Returns the new (o, m, l)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float()) * scale
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    pm = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    l = l * corr + pm.sum(-1, keepdim=True)
    o = o * corr + torch.einsum("bhqk,bkhd->bhqd", pm, v.float())
    return o, m_new, l


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: Axis, scale: Optional[float] = None) -> torch.Tensor:
    """Attention over [B, Tq_local, H, D] with K / V sharded over ``axis``:
    p steps of ``ring_update_plain``, K / V rotating rank i -> i + 1
    between steps (none with p == 1), the carry starting at m = -1e30,
    l = 0, o = 0.  Matches attention over the gathered T axis up to fp32
    rounding, summed in vdn's order."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    group = axis_group(axis)
    p = dist.get_world_size(group)
    b, tq, h, d = q.shape
    qf = q.float()
    o = qf.new_zeros((b, h, tq, d))
    l = qf.new_zeros((b, h, tq, 1))
    m = l - 1e30                                    # effective -inf
    for i in range(p):
        o, m, l = ring_update_plain(qf, k, v, o, m, l, scale)
        if i < p - 1:
            k, v = ring_shift(group, k, v)
    return (o / l).to(q.dtype).transpose(1, 2)      # [B, Tq, H, D]


def distributed_kv_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, axis: Axis,
                             bias: Optional[torch.Tensor] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Attention with replicated queries over K / V sharded on ``axis``.

    q [B, Tq, H, D] (the same on every rank); k, v [B, Tc_local, H, D];
    bias [Tc_local] fp32 logit bias (a large negative masks padded or
    duplicate columns).  Each rank scores its shard; one all-reduce MAX and
    two all-reduce SUMs combine the softmax exactly (fp32 statistics).
    Inference only: the collectives record no backward."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    group = axis_group(axis)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    m = s.amax(-1, keepdim=True)
    pm = torch.exp(s - m)
    l = pm.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", pm, v.float())
    m_g = m.clone()
    dist.all_reduce(m_g, dist.ReduceOp.MAX, group=group)
    corr = torch.exp(m - m_g)
    l_g = l * corr
    o_g = o * corr
    dist.all_reduce(l_g, group=group)
    dist.all_reduce(o_g, group=group)
    return (o_g / l_g).to(q.dtype).transpose(1, 2)  # [B, Tq, H, D]


def make_context_parallel_forward(model, mesh):
    """The clip forward with the frame axis sharded over the mesh's seq
    axis.  ``model`` is built with ``seq_axis=SEQ_AXIS`` so that its
    temporal attention spans the seq group.  Returns fn(x): x [B, T, H, W,
    3], the same on every rank (B divisible by the data size, T by the
    seq size) -> depth [B, T, H, W] on every rank; each rank runs the model
    on its own [B / data, T / seq] block."""
    def fwd(x: torch.Tensor) -> torch.Tensor:
        with use_mesh(mesh), torch.no_grad():
            y = model(shard_clip(x, mesh))
            return gather_clip(y, mesh)

    return fwd


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """[p, ...] blocks: block j goes to rank j; block i of the result came
    from rank i."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: Axis,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses-style context parallelism: an all-to-all swaps the sharded
    frame axis for a sharded token axis ([N, T/p, H, D] -> [N/p, T, H, D],
    vdn's ``all_to_all(x, axis, 0, 1, tiled=True)``), the plain attention
    runs over the whole frame range, and the inverse all-to-all swaps
    back.  The token axis N must divide over the axis."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    group = axis_group(axis)
    p = dist.get_world_size(group)
    n, tl = q.shape[:2]
    if n % p:
        raise ValueError(f"ulysses_attention: tokens {n} do not divide over "
                         f"{p} ranks")

    def swap_in(x):   # split N, gather T
        y = _all_to_all(x.reshape(p, n // p, *x.shape[1:]), group)
        return y.movedim(0, 1).reshape(n // p, p * tl, *x.shape[2:])

    out = dot_product_attention(swap_in(q), swap_in(k), swap_in(v), scale,
                                use_flash=False)
    # split T, gather N
    y = out.reshape(n // p, p, tl, *out.shape[2:]).movedim(1, 0)
    return _all_to_all(y, group).reshape(n, tl, *out.shape[2:])


_CP_MODES = ("auto", "ring", "alltoall", "ring_pallas")
_CP_MODE = os.environ.get("VDN_CP_MODE", "auto")
_PALLAS_MIN_T = 128


def set_cp_mode(mode: str) -> None:
    """The context-parallel attention flavor: "auto" | "ring" |
    "alltoall" | "ring_pallas"."""
    global _CP_MODE
    if mode not in _CP_MODES:
        raise ValueError(f"set_cp_mode: {mode!r} not in {_CP_MODES}")
    _CP_MODE = mode


def cp_attention(q, k, v, axis: Axis,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Dispatch to the configured context-parallel attention flavor."""
    if _CP_MODE == "alltoall":
        return ulysses_attention(q, k, v, axis, scale)
    mode = _CP_MODE
    if mode == "auto":
        mode = "ring_pallas" if k.shape[1] >= _PALLAS_MIN_T else "ring"
    if mode == "ring_pallas":
        from vdn_torch.kernels.ring_attention import ring_attention_kernel
        return ring_attention_kernel(q, k, v, axis_group(axis), scale)
    return ring_attention(q, k, v, axis, scale)
