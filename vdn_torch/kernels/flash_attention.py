"""A1, C1, C2: the long-sequence attention kernels.

A1 replaces vdn/ops/pallas/flash_attention.py ``flash_attention_fused_qkv``
(the TPU's full-K ``_flash_cols_kernel``): ViT self-attention read off the
fused qkv projection.  On the H100 the kernel (csrc/flash_attn_qkv.cu) is
bound by its two tensor-core products and, as much, by the exp2 of every
logit; one head's K/V (350 KB at T = 1370) does not fit a block's shared
memory, so it streams 128-key tiles through a TMA ring with an online
softmax, two consumer warpgroups of 64 q rows taking turns at the wgmma
products so that one's softmax runs under the other's products.
Persistent blocks walk the (frame, head, 128-row q tile) items
(``a1_plan``).  See the note in the .cu file.

C2 replaces ``flash_attention`` (``_flash_kernel``) and C1
``flash_attention_colbias`` (``_flash_colbias_kernel``): attention over
separate q, k, v in [B, T, H, D], C1 with an additive fp32 bias per key
column (natural-log units, -inf allowed: the memory bank's slot mask).
In bf16 at D = 64 both are forms of A1's kernel (csrc/flash_attn_qkv.cu),
on ``a1_plan``'s items over the q tiles of Tq: C2 its ``kBthd`` form (q, k
and v each through a 4-D tensor map of its own, read in place by their
strides, Tq and Tk apart; also at D = 56, SAM2's hiera_base_plus global
blocks, the columns past 56 zero-filled by TMA), C1 its
``kC1`` form, kBthd's with each 128-key stage's bias values carried into
shared memory beside its K and V tiles and added to the logits before the
row max, and the key tiles whose every column is -inf skipped by the
producer and the consumers alike (each block lists the live ones from the
bias first; Tk up to MAX_KEY_TILES tiles).  C2 in bf16 at D = 256 (SAM2's
memory attention) and at D = 72 / 96 (the hiera_large and hiera_tiny /
small trunks' global blocks: a 128-column row, TMA zero-filling the
columns past D) is a kernel of its own (csrc/flash_attn_wide.cu,
``c2_wide_plan``).  C2 also runs fp32 at D = 56, 72, 96 and 256
(csrc/flash_attn_bthd_f32.cu, its products on the tensor cores in
3xTF32, which keeps fp32 accuracy, ``c2_f32_plan``): hieradet's global
blocks on the v1 model and SAM2's fp32 path, q, k and v read in place
(slices of the fused qkv projection).  At D = 256 both split each unit's
key tiles into shares where the q tiles alone leave SMs idle, and a
second launch combines the shares (``key_shares``).

Training through C2: with grad enabled and q, k or v requiring it, C2 runs
as an autograd Function.  Its forward also writes the base-2 row
log-sum-exp [B, H, Tq]; its backward is D2 (csrc/flash_attn_bthd_bwd.cu),
vdn's ``_flash_bwd_bhtd``: delta = rowsum(dO * O), dV = P^T dO, dS = P (dP
- delta), dQ = dS K * scale, dK = dS^T q * scale, with P recomputed from
the saved log-sum-exp, its products in 3xTF32 on the tensor cores
(mma.sync) from tiles that TMA streams in.  D2 covers fp32 at D = 96; C1
and C2's bf16 kernel are inference kernels, and on the card an input that
requires grad raises there.

Training: with grad enabled and qkv requiring it, A1 runs as an autograd
Function.  Its forward is A1's training variant (the same kernel with
``save_lse``), which also writes the base-2 row log-sum-exp [B, H, T]; its
backward is D1 (csrc/flash_attn_qkv_bwd.cu), vdn's ``_flash_bwd_cols``:
the normalized softmax recomputed from the saved log-sum-exp, delta =
rowsum(dO * O), dqkv in qkv's layout.  On the card a pre-pass writes qs =
bf16(q * qscale) and delta (beside a copy of the log-sum-exp padded to
``D1_ROWS``), then a dK / dV and a dQ kernel on wgmma and TMA, each block
128 keys or q rows of one (frame, head), sum over the other axis in order
in registers: no atomics, so two launches give the same bits.

C3 replaces ``flash_attention_qkv`` (``_flash_qkv_kernel``): self-attention
off the fused qkv, written head-major as [B, H, T, D], with its own
arithmetic in natural units (s = (q k^T) * scale in fp32, p = exp(s - m),
the row sum from the unrounded p, out = (bf16(p) V) / l).  No model path
calls it, in vdn or here; its kernel is a form of A1's (csrc/
flash_attn_qkv.cu, ``kC3``) on the same plan: the row sums in registers,
out stored [B, H, T, D] through a tensor map of [B * H, T, D].

F6 replaces ``flash_attention_int8_fused_qkv`` (``_flash_cols_int8_kernel``
via ``_flash_int8_call``): A1 with the QK^T and / or the P V product in
int8, the serving mode's attention.  ``VDN_FLASH_INT8`` picks the mode,
read at each call: "qk" quantizes q per row and the token-centred k per
(batch, head), "pv" the softmax probabilities with the fixed scale 127 and
the token-centred v per channel, "all" both; any other value (default
"0") is A1.  See ``flash_attention_int8_fused_qkv_plain`` for the
rounding points and csrc/flash_attn_int8.cu for the kernels: a pre-pass
writes the codes and scales, then A1's skeleton on s8 wgmma walks each
item's keys twice (the exact row max, then the sums), on ``a1_plan``'s
items.  Serving only: no backward.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import torch

from vdn_torch.kernels import (LOG2E, check_kernel_args, launch, launches,
                               same_dispatch, save_dispatch, sm_count,
                               use_kernel, wants_grad)

MAX_KEY_TILES = 4096  # C1 (kC1, csrc/flash_attn_qkv.cu): its live-tile list
D1_ROWS = 128         # csrc/flash_attn_qkv_bwd.cu: keys / q rows of a block
A1_ROWS = 128         # csrc/flash_attn_qkv.cu: q rows of an item, keys a tile


def a1_plan(b: int, t: int, h: int, sms: int) -> dict:
    """A1's launch for b frames of t tokens and h heads on a card of
    ``sms`` SMs: its work items, (frame, head, A1_ROWS-row q tile) in that
    order with the q tile fastest (item i: tile i % n, head (i // n) % h,
    frame i // (n h)), and the persistent blocks, min(items, sms); block k
    takes items k, k + grid, ...  Each item walks the t keys in
    A1_ROWS-key tiles (C2, the kernel's kBthd form: t is Tq, and each item
    walks the Tk keys)."""
    items = b * h * -(-t // A1_ROWS)
    return {"items": items, "grid": min(items, sms)}


def _qscale(q: torch.Tensor, scale: float) -> torch.Tensor:
    """scale * log2(e) rounded to q's dtype: the factor the kernels fold
    into q."""
    return torch.tensor(scale * LOG2E, dtype=q.dtype, device=q.device)


@functools.lru_cache(maxsize=None)
def _kernel_qscale(scale: float, dtype: torch.dtype = torch.bfloat16
                   ) -> float:
    """The kernels' q factor, scale * log2(e) rounded to the operands'
    dtype (on the host: no device round trip)."""
    return float(torch.tensor(scale * LOG2E, dtype=dtype))


def _attention_lse_plain(q, k, v, col_bias, scale):
    """(out [B, Tq, H, D], lse [B, H, Tq] fp32): the TPU kernels' math step
    by step, an exact full-K softmax in fp32, base 2; q * (scale * log2 e)
    in the input dtype, logits summed in fp32, + bias * log2 e in fp32, p =
    exp2(s - rowmax) rounded to the value dtype, the row sum l taken from
    the rounded p, o / l rounded to the output dtype; lse = rowmax +
    log2(l), as the training forward writes it."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dt = v.dtype
    s = torch.einsum("bqhd,bkhd->bhqk", (q * _qscale(q, scale)).float(),
                     k.float())
    if col_bias is not None:
        s = s + col_bias.reshape(-1).float() * LOG2E
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m).to(dt).float()
    l = p.sum(-1)                                       # [B, H, Tq]
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l.permute(
        0, 2, 1)[..., None]
    return out.to(q.dtype), m[..., 0] + torch.log2(l)


def flash_attention_colbias_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  col_bias: Optional[torch.Tensor],
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """q [B, Tq, H, D], k / v [B, Tk, H, D], col_bias [Tk] or None ->
    [B, Tq, H, D] (see ``_attention_lse_plain``)."""
    return _attention_lse_plain(q, k, v, col_bias, scale)[0]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """C2's function at any D and dtype (in fp32: vdn's exact full-K
    softmax, p = exp2(s - rowmax) and out = (p V) / rowsum(p))."""
    return flash_attention_colbias_plain(q, k, v, None, scale)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor,
                              scale: Optional[float] = None):
    """D2's function, (dq, dk, dv), with vdn's math and rounding points
    (``_flash_bwd_kernel``, flash_attention.py:294-363): the softmax
    recomputed over the whole row, unnormalized, p = exp2(s - rowmax) in
    fp32 and l = rowsum(p); delta = rowsum(dO * out) from the saved output;
    1 / l folded into the [Tq, D] operands (dO / l for dV, q / l rounded to
    q's dtype for dK, the row rescale of dQ); dP = dO V^T, t = p (dP -
    delta) rounded to q's dtype; dQ = t K * (scale / l), dK = t^T (q / l) *
    scale, dV = p^T (dO / l), each summed in fp32 and rounded to its
    input's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dt = q.dtype
    s = torch.einsum("bqhd,bkhd->bhqk", (q * _qscale(q, scale)).float(),
                     k.float())
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    inv_l = (1.0 / p.sum(-1).clamp_min(1e-30)).permute(0, 2, 1)[..., None]
    g = dout.float()
    delta = (g * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g * inv_l)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v.float())
    tc = (p * (dp - delta)).to(dt).float()
    dq = torch.einsum("bhqk,bkhd->bqhd", tc, k.float()) * (inv_l * scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", tc,
                      (q.float() * inv_l).to(dt).float()) * scale
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_fused_qkv_plain(qkv: torch.Tensor,
                                    scale: Optional[float] = None
                                    ) -> torch.Tensor:
    """qkv [B, T, 3, H, D] -> [B, T, H, D], the same math off the fused
    projection."""
    return flash_attention_colbias_plain(qkv[:, :, 0], qkv[:, :, 1],
                                         qkv[:, :, 2], None, scale)


def flash_attention_fused_qkv_lse_plain(qkv: torch.Tensor,
                                        scale: Optional[float] = None):
    """The training forward: (out [B, T, H, D], lse [B, H, T] fp32)."""
    return _attention_lse_plain(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                None, scale)


def flash_attention_fused_qkv_bwd_plain(qkv: torch.Tensor, out: torch.Tensor,
                                        lse: torch.Tensor, dout: torch.Tensor,
                                        scale: Optional[float] = None
                                        ) -> torch.Tensor:
    """D1's function: dqkv [B, T, 3, H, D] from the forward's out and lse,
    with vdn's rounding points (flash_attention.py:578-663): p = exp2(s -
    lse) in fp32, dV from bf16(p), dS = p (dP - delta) rounded to qkv's
    dtype, dQ = dS K * scale and dK = dS^T q * scale (the unscaled q; scale,
    not scale * log2 e), each summed in fp32 and rounded."""
    d = qkv.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    dt = qkv.dtype
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    s = torch.einsum("bqhd,bkhd->bhqk", (q * _qscale(q, scale)).float(),
                     k.float())
    p = torch.exp2(s - lse.float()[..., None])
    g = dout.to(dt).float()
    delta = (g * out.float()).sum(-1).permute(0, 2, 1)[..., None]
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v.float())
    ds = (p * (dp - delta)).to(dt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), g)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return torch.stack([dq.to(dt), dk.to(dt), dv.to(dt)], dim=2)


def _check_fused_qkv(name: str, qkv: torch.Tensor) -> None:
    b, t, three, h, d = qkv.shape
    if three != 3 or d != 64 or qkv.dtype != torch.bfloat16:
        raise ValueError(f"{name}: kernel takes bf16 [B, T, 3, H, 64], got "
                         f"{tuple(qkv.shape)} {qkv.dtype}")


def _fused_qkv_forward(qkv: torch.Tensor, scale: Optional[float],
                       save_lse: bool):
    """A1 on the card, or its plain version: out, or (out, lse) with
    ``save_lse`` (the training variant)."""
    if not use_kernel(qkv):
        if save_lse:
            return flash_attention_fused_qkv_lse_plain(qkv, scale)
        return flash_attention_fused_qkv_plain(qkv, scale)
    _check_fused_qkv("flash_attention_fused_qkv", qkv)
    qkv = qkv.contiguous()
    b, t, _, h, d = qkv.shape
    check_kernel_args("flash_attention_fused_qkv", qkv)
    scale = d ** -0.5 if scale is None else scale
    # scale * log2(e) rounded to bf16, as the plain version folds it
    qscale = _kernel_qscale(scale)
    out = torch.empty((b, t, h, d), dtype=qkv.dtype, device=qkv.device)
    grid = a1_plan(b, t, h, sm_count(qkv.device.index))["grid"]
    if not save_lse:
        launch("vdn_flash_attention_qkv", qkv.data_ptr(), b, t, h, qscale,
               out.data_ptr(), grid)
        launches["flash_attention_fused_qkv"] += 1
        return out
    lse = torch.empty((b, h, t), dtype=torch.float32, device=qkv.device)
    launch("vdn_flash_attention_qkv_lse", qkv.data_ptr(), b, t, h, qscale,
           out.data_ptr(), lse.data_ptr(), grid)
    launches["flash_attention_fused_qkv_train"] += 1
    return out, lse


def flash_attention_fused_qkv_bwd(qkv: torch.Tensor, out: torch.Tensor,
                                  lse: torch.Tensor, dout: torch.Tensor,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """D1: dqkv [B, T, 3, H, D]; kernel for bf16, D = 64."""
    if not use_kernel(qkv):
        return flash_attention_fused_qkv_bwd_plain(qkv, out, lse, dout,
                                                   scale)
    name = "flash_attention_fused_qkv_bwd"
    _check_fused_qkv(name, qkv)
    b, t, _, h, d = qkv.shape
    qkv, out, lse = qkv.contiguous(), out.contiguous(), lse.contiguous()
    dout = dout.to(qkv.dtype).contiguous()
    if out.shape != (b, t, h, d) or dout.shape != out.shape or (
            lse.shape != (b, h, t) or lse.dtype != torch.float32):
        raise ValueError(f"{name}: out / dout [B, T, H, 64] and lse fp32 "
                         f"[B, H, T], got {tuple(out.shape)}, "
                         f"{tuple(dout.shape)}, {tuple(lse.shape)} "
                         f"{lse.dtype}")
    scale = d ** -0.5 if scale is None else scale
    tp = -(-t // D1_ROWS) * D1_ROWS
    qs = torch.empty_like(out)
    # the pre-pass's lse (padded rows +inf) and delta (padded rows 0)
    stats = torch.empty((2, b, h, tp), dtype=torch.float32,
                        device=qkv.device)
    dqkv = torch.empty_like(qkv)
    check_kernel_args(name, qkv, out, dout, lse, qs, stats, dqkv)
    launch("vdn_flash_attention_qkv_bwd", qkv.data_ptr(), out.data_ptr(),
           dout.data_ptr(), lse.data_ptr(), b, t, h,
           _kernel_qscale(scale), float(scale), qs.data_ptr(),
           stats.data_ptr(), dqkv.data_ptr())
    launches[name] += 1
    return dqkv


class _FusedQKVAttention(torch.autograd.Function):
    """A1's training forward (with the log-sum-exp) and D1 as its
    backward."""

    @staticmethod
    def forward(ctx, qkv, scale):
        out, lse = _fused_qkv_forward(qkv, scale, save_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.scale = scale
        save_dispatch(ctx)
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, out, lse = ctx.saved_tensors
        with same_dispatch(ctx):
            return flash_attention_fused_qkv_bwd(qkv, out, lse, dout,
                                                 ctx.scale), None


def flash_attention_fused_qkv(qkv: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """qkv [B, T, 3, H, D] -> out [B, T, H, D]; kernel for bf16, D = 64.
    Differentiable (D1) where grad is enabled and qkv requires it."""
    if wants_grad(qkv):
        return _FusedQKVAttention.apply(qkv, scale)
    return _fused_qkv_forward(qkv, scale, save_lse=False)


# C2 in bf16: csrc/flash_attn_qkv.cu (kBthd) at D 56 / 64, and
# csrc/flash_attn_wide.cu at WIDE_HEAD_DIMS
BF16_HEAD_DIMS = (56, 64, 72, 96, 256)
WIDE_HEAD_DIMS = (72, 96, 256)
WIDE_KEYS = 64   # csrc/flash_attn_wide.cu: keys of a K / V stage


def key_shares(units: int, tiles: int, sms: int) -> int:
    """How many shares each of ``units`` work units splits its ``tiles``
    key tiles into: as many as fill ``sms`` SMs with one unit a share (1
    where the units alone fill them), no share empty."""
    shares = max(1, min(sms // units, tiles))
    return -(-tiles // -(-tiles // shares))


@functools.lru_cache(maxsize=256)
def c2_wide_plan(b: int, tq: int, tk: int, h: int, sms: int) -> dict:
    """C2's D = 72 / 96 / 256 launch (csrc/flash_attn_wide.cu) on a card of
    ``sms`` SMs: a1_plan's items (batch, head, A1_ROWS-row q tile), each
    split into ``splits`` shares of its WIDE_KEYS-key tiles (``key_shares``:
    one block an SM, and SAM2's one head of 4096 rows is 32 items); the
    persistent blocks, min(units, sms).  A unit is (item, share), the share
    fastest."""
    items = b * h * -(-tq // A1_ROWS)
    splits = key_shares(items, -(-tk // WIDE_KEYS), sms)
    return {"items": items, "splits": splits,
            "grid": min(items * splits, sms)}


def _launch_bthd(name: str, q, k, v, col_bias, scale) -> torch.Tensor:
    """C2 (``col_bias`` None) in bf16 at D = 56 or 64 (A1's kernel, kBthd)
    or 72, 96 and 256 (csrc/flash_attn_wide.cu), q, k, v read in place
    through their strides; or C1 (kC1) at D = 64 on contiguous, 16-byte
    aligned q, k, v (row stride H * 64)."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    dims = BF16_HEAD_DIMS if col_bias is None else (64,)
    limit = col_bias is not None and tk > A1_ROWS * MAX_KEY_TILES
    if (d not in dims or q.dtype != torch.bfloat16 or k.dtype != q.dtype
            or v.dtype != q.dtype or k.shape != (b, tk, h, d)
            or v.shape != k.shape or limit):
        raise ValueError(
            f"{name}: kernel takes bf16 q [B, Tq, H, D] and k, v "
            f"[B, Tk, H, D] with D in {dims}"
            + (f" (C2 also fp32 with D in {F32_HEAD_DIMS})"
               if col_bias is None
               else f" and Tk <= {A1_ROWS * MAX_KEY_TILES}")
            + f", got q {tuple(q.shape)} {q.dtype}, k {tuple(k.shape)} "
            f"{k.dtype}, v {tuple(v.shape)} {v.dtype}")
    if wants_grad(q, k, v):
        raise RuntimeError(
            f"{name}: the bf16 kernel has no backward (D2 takes fp32 at "
            f"D = 96); run under torch.no_grad()")
    scale = d ** -0.5 if scale is None else scale
    # scale * log2(e) rounded to bf16, as the plain version folds it
    qscale = _kernel_qscale(scale)
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    sms = sm_count(q.device.index)
    if col_bias is None:
        strides = [s for t in (q, k, v) for s in _strides(name, t, d)]
        check_kernel_args(name, out)
        if d in WIDE_HEAD_DIMS:
            plan = c2_wide_plan(b, tq, tk, h, sms)
            scratch = _shares_scratch(plan["splits"], b, tq, h, d, q.device)
            launch("vdn_flash_attention_bthd_wide", q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), b, tq, tk, h, d, *strides,
                   qscale, out.data_ptr(), plan["splits"], *_ptrs(scratch),
                   plan["grid"])
        else:
            launch("vdn_flash_attention_bthd", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), b, tq, tk, h, d, *strides, qscale,
                   out.data_ptr(), a1_plan(b, tq, h, sms)["grid"])
    else:
        if col_bias.shape != (tk,) or col_bias.dtype != torch.float32:
            raise ValueError(f"{name}: col_bias must be fp32 [{tk}], got "
                             f"{tuple(col_bias.shape)} {col_bias.dtype}")
        check_kernel_args(name, q, k, v, col_bias, out)
        launch("vdn_flash_attention_colbias", q.data_ptr(), k.data_ptr(),
               v.data_ptr(), col_bias.data_ptr(), b, tq, tk, h, qscale,
               out.data_ptr(), a1_plan(b, tq, h, sms)["grid"])
    launches[name] += 1
    return out


F32_HEAD_DIMS = (56, 72, 96, 256)   # csrc/flash_attn_bthd_f32.cu
D2_HEAD_DIMS = (96,)            # csrc/flash_attn_bthd_bwd.cu
D2_ROWS = 64            # csrc/flash_attn_bthd_bwd.cu: keys / q rows of a block


def _is_f32_case(q, k, v, dims=F32_HEAD_DIMS) -> bool:
    """True where C2's fp32 kernel (D2: ``dims=D2_HEAD_DIMS``) takes the
    call."""
    return (q.dtype == k.dtype == v.dtype == torch.float32
            and q.shape[-1] in dims)


def _strides(name: str, t: torch.Tensor, d: int) -> tuple:
    """(batch, row) strides of a [B, T, H, D] operand the kernels read in
    place: a head at h * D, elements contiguous, 16-byte rows and base.
    A single batch's stride is taken as T rows (torch may give it any
    value)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: tensor on {t.device}, expected cuda")
    sb, st, sh, sd = t.stride()
    if t.shape[0] == 1:
        sb = st * t.shape[1]
    align = 16 // t.element_size()
    if (sd != 1 or sh != d or st % align or sb % align or t.data_ptr() % 16
            or st < t.shape[2] * d):
        raise ValueError(f"{name}: [B, T, H, {d}] operand with strides "
                         f"{t.stride()} is not readable in place")
    return sb, st


def _check_f32(name: str, q, k, v) -> None:
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if k.shape != (b, tk, h, d) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")


F32_ROWS = 64            # csrc/flash_attn_bthd_f32.cu: q rows of a block


@functools.lru_cache(maxsize=256)
def c2_f32_plan(b: int, tq: int, tk: int, h: int, d: int, sms: int,
                save_lse: bool = False) -> dict:
    """C2's fp32 launch (csrc/flash_attn_bthd_f32.cu): blocks of F32_ROWS q
    rows of a (batch, head); at D > 128 (one block an SM, TcDims) each
    block's 32-key tiles split into ``splits`` shares (``key_shares``),
    never with the log-sum-exp."""
    blocks = b * h * -(-tq // F32_ROWS)
    splits = (1 if d <= 128 or save_lse
              else key_shares(blocks, -(-tk // 32), sms))
    return {"blocks": blocks, "splits": splits}


def _shares_scratch(splits: int, b: int, tq: int, h: int, d: int,
                    device) -> list:
    """The share scratch the C entries combine by a second launch: the
    shares' partial O [splits, B, Tq, H, D] and (m, l) [splits, B, H, Tq,
    2], fp32; none for one share.  The caller holds them until the
    launch (``_ptrs``)."""
    if splits == 1:
        return []
    return [torch.empty(shape, dtype=torch.float32, device=device)
            for shape in ((splits, b, tq, h, d), (splits, b, h, tq, 2))]


def _ptrs(scratch: list) -> tuple:
    """The scratch's pointers, or two nulls."""
    return tuple(t.data_ptr() for t in scratch) or (None, None)


def _launch_f32(q, k, v, scale, save_lse: bool):
    """C2's fp32 kernel: out, or (out, lse) with ``save_lse``."""
    name = "flash_attention"
    _check_f32(name, q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    strides = [s for t in (q, k, v) for s in _strides(name, t, d)]
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
           if save_lse else None)
    splits = c2_f32_plan(b, tq, tk, h, d, sm_count(q.device.index),
                         save_lse)["splits"]
    scratch = _shares_scratch(splits, b, tq, h, d, q.device)
    launch("vdn_flash_attention_bthd_f32", q.data_ptr(), k.data_ptr(),
           v.data_ptr(), b, tq, tk, h, d, *strides,
           _kernel_qscale(scale, torch.float32), out.data_ptr(),
           None if lse is None else lse.data_ptr(), splits, *_ptrs(scratch))
    launches[name] += 1
    return (out, lse) if save_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, scale: Optional[float] = None):
    """D2: (dq, dk, dv) of C2 from the forward's out and base-2 lse
    [B, H, Tq]; kernel for fp32 at D = 96 (q, k, v read in place through
    tensor maps: rows and bases 16-byte aligned)."""
    if not use_kernel(q):
        return flash_attention_bwd_plain(q, k, v, out, dout, scale)
    name = "flash_attention_bwd"
    if not _is_f32_case(q, k, v, D2_HEAD_DIMS):
        raise ValueError(f"{name}: kernel takes fp32 q, k, v with D in "
                         f"{D2_HEAD_DIMS}, got {q.dtype} D = {q.shape[-1]}")
    _check_f32(name, q, k, v)
    b, tq, h, d = q.shape
    tk = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    strides = [s for t in (q, k, v) for s in _strides(name, t, d)]
    out, lse = out.contiguous(), lse.contiguous()
    dout = dout.to(q.dtype).contiguous()
    if out.shape != q.shape or dout.shape != q.shape or (
            lse.shape != (b, h, tq) or lse.dtype != torch.float32):
        raise ValueError(f"{name}: out / dout {tuple(q.shape)} and lse fp32 "
                         f"[B, H, Tq], got {tuple(out.shape)}, "
                         f"{tuple(dout.shape)}, {tuple(lse.shape)} "
                         f"{lse.dtype}")
    # the delta launch's lse copy (padded rows +inf) and delta (padded 0)
    tp = -(-tq // D2_ROWS) * D2_ROWS
    stats = torch.empty((2, b, h, tp), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, tk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    check_kernel_args(name, out, dout, lse, stats, dq, dk, dv)
    launch("vdn_flash_attention_bthd_bwd", q.data_ptr(), k.data_ptr(),
           v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), b,
           tq, tk, h, d, *strides, _kernel_qscale(scale, torch.float32),
           float(scale), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr())
    launches[name] += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """C2 with its log-sum-exp and D2 as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        if use_kernel(q):
            if not _is_f32_case(q, k, v, D2_HEAD_DIMS):
                raise RuntimeError(
                    f"flash_attention: D2 takes fp32 q, k, v with D in "
                    f"{D2_HEAD_DIMS}, got {q.dtype} D = {q.shape[-1]}; the "
                    f"forward kernels at other widths and in bf16 run "
                    f"under torch.no_grad() only")
            out, lse = _launch_f32(q, k, v, scale, save_lse=True)
        else:
            out, lse = _attention_lse_plain(q, k, v, None, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        save_dispatch(ctx)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        with same_dispatch(ctx):
            return (*flash_attention_bwd(q, k, v, out, lse, dout, ctx.scale),
                    None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """C2: attention over [B, T, H, D]; kernel for bf16 with D in
    BF16_HEAD_DIMS and fp32 with D in F32_HEAD_DIMS, q, k, v read in place
    through their strides (a CUDA tensor at any other width raises).
    Differentiable (D2, fp32 D = 96 on the card) where grad is enabled and
    an input requires it."""
    if wants_grad(q, k, v):
        return _Attention.apply(q, k, v, scale)
    if not use_kernel(q):
        return flash_attention_plain(q, k, v, scale)
    if _is_f32_case(q, k, v):
        return _launch_f32(q, k, v, q.shape[-1] ** -0.5 if scale is None
                           else scale, save_lse=False)
    return _launch_bthd("flash_attention", q, k, v, None, scale)


def flash_attention_colbias(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, col_bias: torch.Tensor,
                            scale: Optional[float] = None) -> torch.Tensor:
    """C1: attention over [B, T, H, D] with an additive logits bias [Tk]
    shared by every batch, head and query (at least one column finite);
    kernel for bf16, D = 64."""
    col_bias = col_bias.reshape(-1)
    if not use_kernel(q):
        return flash_attention_colbias_plain(q, k, v, col_bias, scale)
    return _launch_bthd("flash_attention_colbias", q, k, v, col_bias, scale)


# ------------------------------------------------------------------- C3
def flash_attention_qkv_plain(qkv: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """C3's function, qkv [B, T, 3, H, D] -> [B, H, T, D], with vdn's
    rounding points (flash_attention.py:945-961): s = (q k^T) * scale in
    fp32, p = exp(s - rowmax) in fp32, l = rowsum(p) of the unrounded p,
    out = (p rounded to v's dtype) V / l, summed in fp32."""
    scale = qkv.shape[-1] ** -0.5 if scale is None else scale
    q, k, v = (qkv[:, :, i].transpose(1, 2).float() for i in range(3))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    pv = torch.matmul(p.to(qkv.dtype).float(), v)
    return (pv / l).to(qkv.dtype)


def flash_attention_qkv(qkv: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """C3: qkv [B, T, 3, H, D] -> out [B, H, T, D] (head-major); kernel
    for bf16, D = 64.  Inference only: on the card an input that requires
    grad raises (vdn's has no VJP)."""
    if not use_kernel(qkv):
        return flash_attention_qkv_plain(qkv, scale)
    name = "flash_attention_qkv"
    _check_fused_qkv(name, qkv)
    if wants_grad(qkv):
        raise RuntimeError(f"{name}: the kernel has no backward; run under "
                           f"torch.no_grad()")
    qkv = qkv.contiguous()
    b, t, _, h, d = qkv.shape
    check_kernel_args(name, qkv)
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, h, t, d), dtype=qkv.dtype, device=qkv.device)
    launch("vdn_flash_attention_qkv_heads", qkv.data_ptr(), b, t, h,
           float(scale), out.data_ptr(),
           a1_plan(b, t, h, sm_count(qkv.device.index))["grid"])
    launches[name] += 1
    return out


# ------------------------------------------------------------------- F6
INT8_FLASH_MODES = ("qk", "pv", "all")
_MODE_BITS = {"qk": 1, "pv": 2, "all": 3}   # csrc/flash_attn_int8.cu
INT8_TILE = A1_ROWS     # the kernel's key tile: its scratch is padded to it
# log2(127): exp2(s - (m - this)) is 127 * exp2(s - m), vdn's fold of the
# fixed probability scale into the exponential
LOG2_127 = 6.988684686772166


def int8_flash_mode() -> str:
    """``VDN_FLASH_INT8`` as vdn reads it ("0", off, by default), read at
    each call."""
    return os.environ.get("VDN_FLASH_INT8", "0")


def int8_heads_ok(h: int, d: int) -> bool:
    """vdn's column-block gate for F6 (``pick_heads_per_block`` at its
    default): hb = max(1, 128 // d) heads must divide H and fill whole
    128-lane blocks; any other head config takes A1."""
    hb = max(1, 128 // d)
    return h % hb == 0 and (d * hb) % 128 == 0


def _int8_route(qkv: torch.Tensor, mode: Optional[str]) -> Optional[str]:
    """The F6 mode a call runs, or None where it is A1."""
    mode = int8_flash_mode() if mode is None else mode
    if mode not in INT8_FLASH_MODES or not int8_heads_ok(*qkv.shape[-2:]):
        return None
    return mode


def vt_key_order(tp: int) -> torch.Tensor:
    """The position of each of ``tp`` keys in F6's transposed v codes
    (vt, csrc/flash_attn_int8.cu ``vt_pos``): within each 32-key group,
    key 2t + 8 (q // 2) + q % 2 + 16 hf sits at 4t + q + 16 hf, the byte
    of the s8 wgmma A fragment that holds it, so that each thread packs
    its own accumulator's codes."""
    k = torch.arange(tp)
    return ((k & ~31) | (k & 16) | ((k & 6) << 1) | ((k & 8) >> 2)
            | (k & 1))


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _token_mean(x: torch.Tensor) -> torch.Tensor:
    """fp32 [.., T, D] -> its mean over T, [.., 1, D]: the sum, then a true
    division by T (vdn's jnp.mean; CUDA divides by a Python scalar as a
    multiply by its reciprocal)."""
    return x.sum(-2, keepdim=True) / _f32(x.shape[-2], x.device)


def _int8_attention_one(q, k, v, scale, mode, dt, ops):
    """One frame: q, k, v [H, T, D] -> out fp32 [H, T, D]; ``ops`` (a dict,
    or None) receives the frame's codes (int8) and scales."""
    dev = q.device
    c2f = _f32(scale * LOG2E, dev)
    inv127 = _f32(1.0 / 127.0, dev)
    ops = {} if ops is None else ops
    i8 = torch.int8
    if mode in ("qk", "all"):
        qf, kf = q.float(), k.float()
        kf = kf - _token_mean(kf)
        aq = torch.clamp_min(qf.abs().amax(-1, keepdim=True), 1e-30) * inv127
        ak = torch.clamp_min(kf.abs().amax((-2, -1), keepdim=True),
                             1e-30) * inv127
        qi = torch.round(qf * torch.reciprocal(aq))
        ki = torch.round(kf * torch.reciprocal(ak))
        # every partial sum of D int8 products is an integer of at most D *
        # 127^2, below 2^24 for D <= 1040: exact in fp32 in any order
        si = torch.matmul(qi, ki.transpose(-1, -2))
        s = si * (aq * (ak * c2f))
        ops.update(qi=qi.to(i8), aq=aq[..., 0], ki=ki.to(i8), ak=ak[:, 0, 0])
    else:
        s = torch.matmul((q * _qscale(q, scale)).float(),
                         k.float().transpose(-1, -2))
    m = s.amax(-1, keepdim=True)
    if mode in ("pv", "all"):
        vf = v.float()
        mu = _token_mean(vf)
        vf = vf - mu
        av = torch.clamp_min(vf.abs().amax(-2, keepdim=True), 1e-30) * inv127
        vi = torch.round(vf * torch.reciprocal(av))
        pi = torch.round(torch.exp2(s - (m - _f32(LOG2_127, dev))))
        l = pi.sum(-1, keepdim=True)       # integers: exact in fp32
        # the int32 sums of the kernel, exact in float64, then rounded to
        # fp32 as vdn's int32 -> fp32 conversion rounds them
        pv = torch.matmul(pi.double(), vi.double()).float()
        out = pv * av / l + mu
        ops.update(vi=vi.to(i8), av=av[:, 0], mu=mu[:, 0], pi=pi.to(i8))
    else:
        p = torch.exp2(s - m).to(dt).float()
        out = torch.matmul(p, v.float()) / p.sum(-1, keepdim=True)
    return out


def flash_attention_int8_fused_qkv_plain(qkv: torch.Tensor,
                                         scale: Optional[float] = None,
                                         mode: Optional[str] = None,
                                         operands: Optional[dict] = None
                                         ) -> torch.Tensor:
    """F6's function: qkv [B, T, 3, H, D] -> [B, T, H, D] in qkv's dtype,
    rounding where vdn's ``_flash_cols_int8_kernel`` rounds, per (batch,
    head) over all T tokens:

    - QK^T in "qk" / "all": kf = k in fp32 less its mean over tokens;
      aq = max(max_D |q|, 1e-30) * fp32(1/127) per row, ak = max(max
      |kf|, 1e-30) * fp32(1/127) per (batch, head); qi = round(q * (1 /
      aq)), ki = round(kf * (1 / ak)), half to even; s = (qi ki^T) * (aq *
      (ak * c2f)) with c2f = fp32(scale * log2 e).  Otherwise s = (q *
      bf16(scale * log2 e)) k^T in fp32 (A1's fold of the scale into q);
    - m, the exact row max over all T keys;
    - P V in "pv" / "all": mu the per-channel mean of v over tokens, av =
      max(max_T |v - mu|, 1e-30) * fp32(1/127) per channel, vi = round((v
      - mu) * (1 / av)); pi = round(exp2(s - (m - log2 127))) in [0, 127],
      l = rowsum(pi), out = (pi vi * av) / l + mu.  Otherwise p = exp2(s
      - m) rounded to v's dtype, l from the rounded p, out = (p V) / l.

    ``mode`` None reads ``VDN_FLASH_INT8``; a mode that is not "qk", "pv"
    or "all", or a head config vdn's gate turns away (``int8_heads_ok``),
    is A1's plain version.  ``operands``, where given, receives the int8
    codes qi, ki, vi [B, H, T, D] and pi [B, H, T, T] (int8), and the
    scales aq [B, H, T], ak [B, H], av and mu [B, H, D] of the mode."""
    mode = _int8_route(qkv, mode)
    if mode is None:
        return flash_attention_fused_qkv_plain(qkv, scale)
    scale = qkv.shape[-1] ** -0.5 if scale is None else scale
    dt = qkv.dtype
    outs, per_frame = [], []
    for x in qkv:                      # one frame at a time: [T, 3, H, D]
        q, k, v = (x[:, i].transpose(0, 1) for i in range(3))
        ops = None if operands is None else {}
        outs.append(_int8_attention_one(q, k, v, scale, mode, dt,
                                        ops).to(dt).transpose(0, 1))
        per_frame.append(ops)
    if operands is not None:
        operands.update({key: torch.stack([f[key] for f in per_frame])
                         for key in per_frame[0]})
    return torch.stack(outs)


def flash_attention_int8_fused_qkv(qkv: torch.Tensor,
                                   scale: Optional[float] = None,
                                   mode: Optional[str] = None,
                                   operands: Optional[dict] = None
                                   ) -> torch.Tensor:
    """F6: qkv [B, T, 3, H, D] -> out [B, T, H, D] with int8 QK^T and / or
    P V; kernel for bf16, D = 64.  ``mode`` None reads ``VDN_FLASH_INT8``;
    off (any value but "qk", "pv", "all") or a head config vdn's gate
    turns away, this is A1 (``flash_attention_fused_qkv``) unchanged.
    ``operands`` receives what the plain version records, but pi (the
    kernel keeps the probabilities in registers), vi in key order.
    Serving only: on the card an input that requires grad raises."""
    route = _int8_route(qkv, mode)
    if route is None:
        return flash_attention_fused_qkv(qkv, scale)
    if not use_kernel(qkv):
        return flash_attention_int8_fused_qkv_plain(qkv, scale, route,
                                                    operands)
    name = "flash_attention_int8_fused_qkv"
    _check_fused_qkv(name, qkv)
    if wants_grad(qkv):
        raise RuntimeError(f"{name}: the int8 kernels have no backward; run "
                           f"under torch.no_grad()")
    qkv = qkv.contiguous()
    b, t, _, h, d = qkv.shape
    scale = d ** -0.5 if scale is None else scale
    tp = -(-t // INT8_TILE) * INT8_TILE
    dev = qkv.device
    qk, pv = route in ("qk", "all"), route in ("pv", "all")

    def scratch(shape, dtype, wanted):
        return torch.empty(shape, dtype=dtype, device=dev) if wanted else None

    qi = scratch((b, h, tp, d), torch.int8, qk)
    aq = scratch((b, h, tp), torch.float32, qk)
    ki = scratch((b, h, tp, d), torch.int8, qk)
    ak = scratch((b, h), torch.float32, qk)
    vt = scratch((b, h, d, tp), torch.int8, pv)
    av = scratch((b, h, d), torch.float32, pv)
    mu = scratch((b, h, d), torch.float32, pv)
    out = torch.empty((b, t, h, d), dtype=qkv.dtype, device=dev)
    bufs = (qi, aq, ki, ak, vt, av, mu)
    check_kernel_args(name, qkv, out, *(x for x in bufs if x is not None))
    launch("vdn_flash_attention_int8", qkv.data_ptr(), b, t, h,
           _MODE_BITS[route], float(scale * LOG2E), _kernel_qscale(scale),
           *(None if x is None else x.data_ptr() for x in bufs),
           out.data_ptr(), a1_plan(b, t, h, sm_count(dev.index))["grid"])
    launches[name] += 1
    if operands is not None:
        if qk:
            operands.update(qi=qi[:, :, :t], aq=aq[:, :, :t], ki=ki[:, :, :t],
                            ak=ak)
        if pv:
            vi = vt.index_select(-1, vt_key_order(tp)[:t].to(dev))
            operands.update(vi=vi.transpose(-1, -2), av=av, mu=mu)
    return out
