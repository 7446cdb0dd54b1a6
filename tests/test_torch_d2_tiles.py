"""D2's arithmetic (csrc/flash_attn_bthd_bwd.cu, C2's fp32 backward, 3xTF32
on the tensor cores) emulated on the CPU in the kernels' order and held to
the plain fp32 backward and to vdn's.

The card's kernels split every fp32 operand into big (TF32) and small and
sum each 8-deep step of a product as small * big, big * small, big * big
into a zeroed temporary, each ``mma.sync m16n8k8`` summing its 8 products
with the temporary exactly and truncating toward zero, then add the
temporary to the accumulator in fp32 (``mma_3xtf32``;
tests/test_torch_tf32x3.py emulates the same for the forward).  D2 runs it
in two kernels after the delta launch:

- dK / dV, keys as rows: S^T = K (q qscale)^T and dP^T = V dO^T (A = K or
  V, 12 steps over the head), p = exp2(S - lse) in fp32 from the
  forward's base-2 log-sum-exp, dS = p (dP - delta), then dV += P^T dO and
  dK += dS^T (q qscale) with one step per 8 q rows in order, and dK times
  fp32(scale / qscale);
- dQ, q rows as rows: S = (q qscale) K^T and dP = dO V^T (A = q qscale or
  dO), the same p and dS, dQ += dS K one step per 8 keys, times scale.

qscale = fp32(scale * log2 e), as the forward folds it.  delta = rowsum(dO
* out) is an fp32 sum (the kernel's warp sum differs in its order only).
On one (batch, head) slice of v1's global blocks (T 256 and 324, D 96,
numpy draws from a seed, out and lse from the plain forward) dq, dk and dv
stay within 1e-5 rel L2 of the port's ``flash_attention_bwd_plain`` and of
vdn's ``_flash_bwd_bhtd`` (Pallas, interpret mode).  The tails (T 324 =
5 * 64 + 4): q rows past T load as zeros with lse +inf (p = 0) and keys
past T as zeros, masked to p = 0 in the dQ kernel; padded to the kernels'
tiles the emulation gives the same values.  Summed in one accumulator per
output instead (the chained order, 32-41 steps for dK, dV and dQ) the
emulation drifts several-fold above the zeroed temporaries, but within
the gate.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_tf32x3 import GATE, _mma, _rel_l2
from vdn_torch.kernels import LOG2E
from vdn_torch.kernels import flash_attention as tfa

D = 96
TILE = 64      # keys of a dK / dV block, q rows of a dQ block
PAD = tfa.D2_ROWS  # the stats' rows: T up to a multiple


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _pad(x: torch.Tensor, rows: int, value: float = 0.0) -> torch.Tensor:
    """x [T, ...] with rows past T set to ``value`` up to a multiple of
    ``rows``."""
    n = -(-x.shape[0] // rows) * rows - x.shape[0]
    return torch.cat([x, x.new_full((n, *x.shape[1:]), value)])


def d2_emulated(q, k, v, out, lse, g, chained: bool = False,
                tails: bool = False):
    """One head: q, k, v, out, dO [T, 96] fp32, lse [T] -> (dq, dk, dv) by
    the kernels' products (``chained``: every step's products in the
    accumulator itself); ``tails``: on operands padded as TMA and the
    delta launch leave them (q, dO rows past T zeros, lse +inf, delta 0;
    K, V rows past T zeros, their p masked to 0 in the dQ kernel)."""
    t = q.shape[0]
    scale = D ** -0.5
    qscale = _f32(scale * LOG2E)
    qs = q * qscale
    delta = (g * out).sum(-1)
    if tails:
        qs, g = _pad(qs, PAD), _pad(g, PAD)
        lse, delta = _pad(lse, PAD, math.inf), _pad(delta, PAD)
        k, v = _pad(k, TILE), _pad(v, TILE)
    mma = lambda a, b: _mma(torch.zeros((a.shape[0], b.shape[1])), a, b,
                            3, chained)
    # dK / dV: keys as rows
    st = mma(k, qs.t())                         # S^T [keys, q rows]
    dpt = mma(v, g.t())
    pt = torch.exp2(st - lse[None])
    dst = pt * (dpt - delta[None])
    acc = lambda a, b: _mma(torch.zeros((a.shape[0], D)), a, b, 3, chained)
    dv = acc(pt, g)
    dk = acc(dst, qs) * _f32(scale / qscale.item())
    # dQ: q rows as rows
    s = mma(qs, k.t())
    dp = mma(g, v.t())
    p = torch.exp2(s - lse[:, None])
    if tails:
        p[:, t:] = 0.0
    ds = p * (dp - delta[:, None])
    dq = acc(ds, k) * _f32(scale)
    return dq[:t], dk[:t], dv[:t]


def _head(t: int):
    """q, k, v, dO [T, 96] and the plain forward's out and lse."""
    rng = np.random.default_rng(t + 5)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((t, D)).astype(
        np.float32)) for _ in range(4))
    out, lse = tfa._attention_lse_plain(*(x[None, :, None] for x in (q, k, v)),
                                        None, D ** -0.5)
    return q, k, v, out[0, :, 0], lse[0, 0], g


def _plain(q, k, v, out, g):
    got = tfa.flash_attention_bwd_plain(
        *(x[None, :, None] for x in (q, k, v, out, g)))
    return [x[0, :, 0] for x in got]


def _vdn(q, k, v, out, g):
    from vdn.ops.pallas import flash_attention as jfa
    with pltpu.force_tpu_interpret_mode():
        got = jfa._flash_bwd_bhtd(
            *(jnp.asarray(x.numpy()[None]) for x in (q, k, v, g, out)),
            scale=D ** -0.5, block_q=jfa.DEFAULT_BLOCK_Q)
    return [np.asarray(jax.device_get(x))[0] for x in got]


@pytest.mark.parametrize("t", [256, 324])
def test_d2_emulation_matches_plain_and_vdn(t):
    """dq, dk, dv of the emulated kernels within 1e-5 rel L2 of the plain
    fp32 backward and of vdn's Pallas backward, and within 1e-5 of each
    output's scale elementwise (chip_smoke's FP32_RTOL)."""
    q, k, v, out, lse, g = _head(t)
    got = d2_emulated(q, k, v, out, lse, g)
    plain = _plain(q, k, v, out, g)
    want = _vdn(q, k, v, out, g)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, plain, want):
        assert _rel_l2(b, c) <= GATE, name
        assert _rel_l2(a, b) <= GATE, name
        assert _rel_l2(a, c) <= GATE, name
        assert (a - b).abs().max() <= GATE * b.abs().max(), name


def test_d2_tails_take_p_zero():
    """At T 324 the emulation on operands padded as the kernels read them
    (q, dO rows past T zeros with lse +inf and delta 0, K and V rows past
    T zeros with p masked in the dQ kernel) is finite and gives the
    unpadded emulation's values: the padding adds only zero products (to
    within the emulation's own float64 step sums, which BLAS orders by
    the step's width: a few outputs move by one fp32 ulp)."""
    args = _head(324)
    for a, b in zip(d2_emulated(*args, tails=True), d2_emulated(*args)):
        assert bool(torch.isfinite(a).all())
        assert _rel_l2(a, b) <= 1e-7


@pytest.mark.parametrize("t", [256, 324])
def test_d2_chained_accumulators_drift(t):
    """Summed in one accumulator per output (each step's three truncating
    products into the running sum) the emulation drifts at least threefold
    above the kernels' zeroed temporaries (about 4-5e-6 rel L2 against
    6e-7 at these draws) and stays within the gate: the chained order
    would not miss it here, the temporaries keep a tenfold margin."""
    q, k, v, out, lse, g = _head(t)
    plain = _plain(q, k, v, out, g)
    fresh = d2_emulated(q, k, v, out, lse, g)
    chained = d2_emulated(q, k, v, out, lse, g, chained=True)
    for name, a, c, b in zip(("dq", "dk", "dv"), fresh, chained, plain):
        err_fresh, err_chained = _rel_l2(a, b), _rel_l2(c, b)
        assert err_chained >= 3 * err_fresh, (name, err_fresh, err_chained)
        assert err_chained <= GATE, (name, err_chained)
