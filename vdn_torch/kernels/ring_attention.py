"""E1: the ring-attention step, and the ring of it.

``ring_step`` replaces vdn/ops/pallas/ring_attention.py ``ring_step``
(``_ring_step_kernel``): one online-softmax update of the carry (o, m, l)
with one K / V block, in place, as the TPU kernel's
``input_output_aliases`` do.  On the H100 the kernel
(csrc/ring_step.cu) is bound by its bytes: both products on mma.sync (bf16,
or 3xTF32 for fp32), q, k, v and the carry's o rows copied ahead of their
use into shared memory, q, k, v read through their strides (a
[B, T, H, D] tensor needs no transpose).  ``e1_plan`` picks its mode (a
warp per (row, head) item at Tq, Tk <= 16 and D <= 64, else a block of
warps sharing one item's K / V tiles, two passes over them above 128
keys), warps, stages and grid; the shared bytes and what a launch holds
on an SM it reads from csrc/e1_layout.cuh (through the library's
``vdn_ring_step_fit``), the layout's one source.  See the note in the .cu
file.

``ring_attention_kernel`` replaces ``ring_attention_pallas``: the ring of
``ring_step`` over the seq group, K / V rotating rank i -> i + 1 between
steps (vdn/parallel/context.py's direction and step count, so the carry
sums in vdn's order), the rotation of step i + 1's block posted before
step i's launch and waited on after it.  Its backward re-runs the plain
fp32 ring of vdn_torch.parallel.context under autograd, with the same
collectives, as vdn's ``_bwd`` does; it saves q, k and v only.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.distributed as dist

from vdn_torch.kernels import (build, check_kernel_args, launch, launches,
                               same_dispatch, save_dispatch, sm_count,
                               use_kernel, wants_grad)
from vdn_torch.parallel.context import post_ring_shift, ring_attention

MAX_D = 256
# the warp mode where it measured faster than the block mode (tools/
# e1_plans.py on the card: T 8 at D 32 / 48; the block mode at T 8, D 128
# / 192 and at T 32 at every width)
WARP_MODE_T, WARP_MODE_D = 16, 64
MODES = {"warp": 0, "block": 1}


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[B, T, H, D] -> [B * H, T, D]; a 3-D [G, T, D] as it is."""
    if x.ndim == 4:
        b, t, h, d = x.shape
        return x.transpose(1, 2).reshape(b * h, t, d)
    return x


def ring_step_plain(q, k, v, o, m, l, scale: float):
    """The updated (o, m, l) with the rounding points of
    ring_attention.py:44-62: logits summed in fp32 from the operands'
    values, scaled in fp32; p = exp(s - m') in fp32, its row sum into l; p
    rounded to v's dtype for the value product, summed in fp32.  q
    [G, Tq, D] or [B, Tq, H, D]; k, v likewise with Tk; o [G, Tq, D], m, l
    [G, Tq] fp32 (G = B * H, head-minor).  Returns new tensors."""
    q3, k3, v3 = _rows(q), _rows(k), _rows(v)
    s = torch.einsum("gqd,gkd->gqk", q3.float(), k3.float()) * scale
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    pv = torch.einsum("gqk,gkd->gqd", p.to(v.dtype).float(), v3.float())
    return o * corr[..., None] + pv, m_new, l_new


def fit(lib, esize: int, mode: str, d: int, tq: int, tk: int, warps: int,
        stages: int, kc: int) -> dict:
    """What a launch holds, from ``lib``'s ``vdn_ring_step_fit``
    (csrc/e1_layout.cuh ``fit``): its warps resident on an SM (0 where the
    kernel does not take it), shared bytes, tiles of a block's walk and
    passes over the K tiles."""
    out = (ctypes.c_int * 4)()
    lib.vdn_ring_step_fit(esize, MODES[mode], d, tq, tk, warps, stages, kc,
                          out)
    return dict(zip(("resident", "smem", "walk", "passes"), out))


@functools.lru_cache(maxsize=None)
def e1_plan(g: int, tq: int, tk: int, d: int, dtype: torch.dtype,
            sms: int, lib=None) -> dict:
    """What E1's launch takes for G rows of Tq queries against Tk keys at
    head width d on a card of ``sms`` SMs, the shared layout's bytes and
    residency read from ``lib`` (a library exporting csrc/e1_layout.cuh's
    ``vdn_ring_step_fit``; default: the kernels' own).  "warp" (Tq, Tk <=
    WARP_MODE_T and D <= WARP_MODE_D): the most warps a block, up to g,
    that the layout takes, persistent blocks over the g items, at most one
    a SM.  "block" (the rest): 1, 2, 4 or 8 warps
    (16-row q tiles, up to ceil(Tq / 16)), tiles of 32 or (above 32 keys)
    64 keys and a ring of 2 up to 4 tiles, no deeper than the walk: the
    most warps resident on an SM first, then the larger tile, the deeper
    ring, the larger block (the fastest of every plan at vitl's and vitg's
    shapes but where two were within a few per cent, tools/e1_plans.py);
    one block a (row, q tile) item, q tiles of a row adjacent (they share
    its K / V in L2)."""
    lib = lib or build()
    esize = 2 if dtype == torch.bfloat16 else 4
    if max(tq, tk) <= WARP_MODE_T and d <= WARP_MODE_D:
        for warps in range(min(32, g), 0, -1):   # a block's most warps
            f = fit(lib, esize, "warp", d, tq, tk, warps, 2, 32)
            if f["resident"]:
                return {"mode": "warp", "warps": warps, "stages": 2,
                        "kc": 32, "grid": min(-(-g // warps), sms),
                        "smem": f["smem"], "walk": f["walk"],
                        "passes": f["passes"]}
    best = None
    for kc in ((32, 64) if tk > 32 else (32,)):
        for warps in (1, 2, 4, 8):
            if warps > -(-tq // 16):
                break
            for stages in (2, 3, 4):
                f = fit(lib, esize, "block", d, tq, tk, warps, stages, kc)
                if f["resident"] and stages <= f["walk"]:
                    key = (f["resident"], kc, stages, warps)
                    if best is None or key > best[0]:
                        best = (key, f)
    (_, kc, stages, warps), f = best
    return {"mode": "block", "warps": warps, "stages": stages, "kc": kc,
            "grid": g * -(-tq // (16 * warps)), "smem": f["smem"],
            "walk": f["walk"], "passes": f["passes"]}


def _strides(x: torch.Tensor):
    """(batch, row, head) strides in elements and the head count of a
    [G, T, D] or [B, T, H, D] operand."""
    if x.ndim == 3:
        return x.stride(0), x.stride(1), 0, 1
    return x.stride(0), x.stride(1), x.stride(2), x.shape[2]


def ring_step(q, k, v, o, m, l, scale: float):
    """One fused update of (o, m, l) with a K / V block, in place; returns
    (o, m, l).  Shapes as ring_step_plain's.  The kernel takes bf16 or
    fp32 q, k, v of one dtype, any Tq, Tk >= 1, D a multiple of 8 up to
    256 and scale > 0; no backward (the ring's is a recompute)."""
    if not use_kernel(q):
        for t, new in zip((o, m, l), ring_step_plain(q, k, v, o, m, l,
                                                     scale)):
            t.copy_(new)
        return o, m, l
    name = "ring_step"
    if wants_grad(q, k, v, o):
        raise RuntimeError(f"{name}: no backward; train through "
                           "ring_attention_kernel")
    g = q.shape[0] * (q.shape[2] if q.ndim == 4 else 1)
    tq, d = q.shape[1], q.shape[-1]
    tk = k.shape[1]
    if (q.dtype not in (torch.bfloat16, torch.float32)
            or k.dtype != q.dtype or v.dtype != q.dtype or d % 8
            or not 8 <= d <= MAX_D or tq < 1 or tk < 1 or not scale > 0
            or k.shape != v.shape or k.stride() != v.stride()
            or q.stride(-1) != 1 or k.stride(-1) != 1
            or tuple(o.shape) != (g, tq, d) or tuple(m.shape) != (g, tq)
            or tuple(l.shape) != (g, tq)
            or any(t.dtype != torch.float32 for t in (o, m, l))):
        raise ValueError(
            f"{name}: kernel takes q [G | B, Tq, (H,) D], k = v [.., Tk, .., "
            f"D] in one of bf16 / fp32, D % 8 == 0 <= {MAX_D}, scale > 0, "
            f"o [G, Tq, D], m, l [G, Tq] fp32; got q {tuple(q.shape)} "
            f"{q.dtype}, k {tuple(k.shape)} {k.dtype}, v {tuple(v.shape)}, o "
            f"{tuple(o.shape)}, m {tuple(m.shape)}, l {tuple(l.shape)}")
    check_kernel_args(name, o)
    check_kernel_args(name, m, l, aligned=False)
    for t in (q, k, v):
        if not t.is_cuda:
            raise ValueError(f"{name}: tensor on {t.device}, expected cuda")
    qsb, qst, sh, h = _strides(q)
    kvsb, kvst, ksh, kh = _strides(k)
    if (kh, ksh) != (h, sh):
        raise ValueError(f"{name}: q and k / v differ in heads or head "
                         "stride")
    vec = 16 // q.element_size()   # the kernel's 16-byte loads
    if (any(t.data_ptr() % 16 for t in (q, k, v))
            or any(st % vec for st in (qsb, qst, sh, kvsb, kvst))):
        raise ValueError(f"{name}: q, k, v and their strides must be "
                         "16-byte aligned")
    plan = e1_plan(g, tq, tk, d, q.dtype, sm_count(q.device.index))
    launch("vdn_ring_step", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           int(q.dtype == torch.bfloat16), g, tq, tk, d, h, qsb, qst, kvsb,
           kvst, sh, float(scale), o.data_ptr(), m.data_ptr(), l.data_ptr(),
           MODES[plan["mode"]], plan["warps"], plan["stages"], plan["kc"],
           plan["grid"])
    launches[name] += 1
    return o, m, l


def _ring(q, k, v, group, scale: float) -> torch.Tensor:
    """The ring of ring_step over the process ``group``: q, k, v
    [B, T_local, H, D] -> [B, Tq, H, D] in q's dtype."""
    p = dist.get_world_size(group)
    b, tq, h, d = q.shape
    o = torch.zeros((b * h, tq, d), dtype=torch.float32, device=q.device)
    l = torch.zeros((b * h, tq), dtype=torch.float32, device=q.device)
    m = torch.full_like(l, -1e30)                    # effective -inf
    k, v = k.contiguous(), v.contiguous()
    for i in range(p):
        # step i + 1's block travels while step i's kernel runs
        works, nxt = post_ring_shift(group, k, v) if i < p - 1 else ((), ())
        ring_step(q, k, v, o, m, l, scale)
        for w in works:
            w.wait()
        if nxt:
            k, v = nxt
    out = (o / l[..., None]).to(q.dtype)
    return out.reshape(b, h, tq, d).transpose(1, 2)


class _RingAttention(torch.autograd.Function):
    """The ring of E1 forward; the plain fp32 ring under autograd as its
    backward (vdn's custom_vjp: ring_attention.py:140-149)."""

    @staticmethod
    def forward(ctx, q, k, v, group, scale):
        ctx.save_for_backward(q, k, v)
        ctx.group, ctx.scale = group, scale
        save_dispatch(ctx)
        return _ring(q, k, v, group, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad(), same_dispatch(ctx):
            args = [t.detach().requires_grad_() for t in (q, k, v)]
            out = ring_attention(*args, ctx.group, ctx.scale)
            grads = torch.autograd.grad(out, args, g)
        return (*grads, None, None)


def ring_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          group, scale: Optional[float] = None
                          ) -> torch.Tensor:
    """Ring attention over [B, T_local, H, D] with K / V sharded over the
    process ``group`` (vdn's ``ring_attention_pallas``); differentiable
    where grad is enabled and an input requires it."""
    scale = scale or q.shape[-1] ** -0.5
    if wants_grad(q, k, v):
        return _RingAttention.apply(q, k, v, group, scale)
    return _ring(q, k, v, group, scale)
