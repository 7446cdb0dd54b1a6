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
On one (batch, head) slice of v1's global blocks (T 256 and 324; D 96 at
hiera_base, 56 at hiera_base_plus, 72 at hiera_large; numpy draws from a
seed, out and lse from the plain forward) dq, dk and dv stay within 1e-5
rel L2 of the port's ``flash_attention_bwd_plain`` and of vdn's
``_flash_bwd_bhtd`` (Pallas, interpret mode).  A narrow head's rows sit
in whole 32-float atoms (D 56 in 64 columns, D 72 in 96) whose columns
past D the kernels' 4-D tensor maps fill with zeros: emulated on operands
padded so, the products over the head take only zero steps past D and
the padded columns of dq, dk and dv come out 0 (the kernels skip those
tiles and store D columns).  The tails (T 324 =
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
WIDTHS = (56, 72, 96)   # D2_HEAD_DIMS: hiera_base_plus, hiera_large, base
TILE = 64      # keys of a dK / dV block, q rows of a dQ block
PAD = tfa.D2_ROWS  # the stats' rows: T up to a multiple


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _pad(x: torch.Tensor, rows: int, value: float = 0.0) -> torch.Tensor:
    """x [T, ...] with rows past T set to ``value`` up to a multiple of
    ``rows``."""
    n = -(-x.shape[0] // rows) * rows - x.shape[0]
    return torch.cat([x, x.new_full((n, *x.shape[1:]), value)])


def _pad_cols(x: torch.Tensor) -> torch.Tensor:
    """[T, D] -> [T, ceil(D / 32) * 32]: the columns of the row's last
    32-float atom past D zero, as the kernels' tensor maps load them."""
    n = -(-x.shape[1] // 32) * 32 - x.shape[1]
    return torch.cat([x, x.new_zeros((x.shape[0], n))], 1)


def d2_emulated(q, k, v, out, lse, g, chained: bool = False,
                tails: bool = False, padded: bool = False):
    """One head: q, k, v, out, dO [T, D] fp32, lse [T] -> (dq, dk, dv) by
    the kernels' products (``chained``: every step's products in the
    accumulator itself); ``tails``: on operands padded as TMA and the
    delta launch leave them (q, dO rows past T zeros, lse +inf, delta 0;
    K, V rows past T zeros, their p masked to 0 in the dQ kernel);
    ``padded``: on rows padded to whole atoms (``_pad_cols``), the outputs
    returned at the padded width."""
    t, d = q.shape
    scale = d ** -0.5
    qscale = _f32(scale * LOG2E)
    qs = q * qscale
    delta = (g * out).sum(-1)
    if padded:
        qs, k, v, g = (_pad_cols(x) for x in (qs, k, v, g))
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
    acc = lambda a, b: _mma(torch.zeros((a.shape[0], b.shape[1])), a, b, 3,
                            chained)
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


def _head(t: int, d: int = D):
    """q, k, v, dO [T, d] and the plain forward's out and lse."""
    rng = np.random.default_rng(t + 5 + d)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((t, d)).astype(
        np.float32)) for _ in range(4))
    out, lse = tfa._attention_lse_plain(*(x[None, :, None] for x in (q, k, v)),
                                        None, d ** -0.5)
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
            scale=q.shape[1] ** -0.5, block_q=jfa.DEFAULT_BLOCK_Q)
    return [np.asarray(jax.device_get(x))[0] for x in got]


def test_d2_widths():
    """D2 takes fp32 at every released hieradet trunk's global-block head
    width."""
    assert tfa.D2_HEAD_DIMS == WIDTHS


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("t", [256, 324])
def test_d2_emulation_matches_plain_and_vdn(t, d):
    """dq, dk, dv of the emulated kernels (on rows padded to whole atoms,
    as the kernels read them) within 1e-5 rel L2 of the plain fp32
    backward and of vdn's Pallas backward, and within 1e-5 of each
    output's scale elementwise (chip_smoke's FP32_RTOL)."""
    q, k, v, out, lse, g = _head(t, d)
    got = [x[:, :d] for x in d2_emulated(q, k, v, out, lse, g,
                                         padded=True)]
    plain = _plain(q, k, v, out, g)
    want = _vdn(q, k, v, out, g)
    for name, a, b, c in zip(("dq", "dk", "dv"), got, plain, want):
        assert _rel_l2(b, c) <= GATE, name
        assert _rel_l2(a, b) <= GATE, name
        assert _rel_l2(a, c) <= GATE, name
        assert (a - b).abs().max() <= GATE * b.abs().max(), name


@pytest.mark.parametrize("d", WIDTHS)
def test_d2_tails_take_p_zero(d):
    """At T 324 the emulation on operands padded as the kernels read them
    (q, dO rows past T zeros with lse +inf and delta 0, K and V rows past
    T zeros with p masked in the dQ kernel; the columns past D of the last
    atom zero) is finite and gives the unpadded emulation's values, the
    padded columns 0: the padding adds only zero products (to within the
    emulation's own float64 step sums, which BLAS orders by the step's
    width: a few outputs move by one fp32 ulp)."""
    args = _head(324, d)
    for a, b in zip(d2_emulated(*args, tails=True, padded=True),
                    d2_emulated(*args)):
        assert bool(torch.isfinite(a).all())
        assert not bool(a[:, d:].any())
        assert _rel_l2(a[:, :d], b) <= 1e-7


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


def test_hiera_base_plus_global_block_grad_matches_vdn(monkeypatch):
    """hiera_base_plus's stage-3 global block (dim 448, 8 heads of 56) on
    two 16 x 16 maps (256 tokens: the flash gate): the port routes its
    attention to C2 with D2 as the backward (their plain versions on the
    CPU; on the card the kernels at D 56), where vdn runs XLA's attention.
    The gradient of the output's dot with a fixed cotangent, to the input
    and to every parameter, within 1e-5 rel L2 of vdn's jax.grad (two fp32
    backwards summing in another order)."""
    import vdn.nn.hiera as jh
    import vdn_torch.nn.hiera as th
    import vdn_torch.ops.attention as ta
    from tests.test_torch_sam2 import pair
    from vdn_torch.core.convert import state_dict_from_flax
    routed = []
    real = ta.flash_attention
    monkeypatch.setattr(ta, "flash_attention", lambda *a: routed.append(
        (tuple(a[0].shape), a[0].requires_grad)) or real(*a))
    cfg = th.HIERA_CONFIGS["hiera_base_plus"]
    dim, heads = cfg["embed_dim"] * 4, cfg["num_heads"] * 4
    assert (dim, heads) == (448, 8)
    jm = jh.MultiScaleBlock(dim, dim, heads)
    tm = th.MultiScaleBlock(dim, dim, heads)
    rng = np.random.default_rng(56)
    x = rng.standard_normal((2, 16, 16, dim)).astype(np.float32)
    cot = rng.standard_normal((2, 16, 16, dim)).astype(np.float32)
    params, missing = pair(jm, tm, rng, x)
    assert missing == []

    def loss(p, x):
        return (jm.apply(p, x) * cot).sum()

    jgp, jgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    xt = torch.from_numpy(x).requires_grad_()
    (tm(xt) * torch.from_numpy(cot)).sum().backward()
    assert routed == [((2, 256, heads, 56), True)]
    assert _rel_l2(xt.grad, torch.from_numpy(np.array(jgx))) <= 1e-5
    want = state_dict_from_flax(jax.tree.map(np.asarray, jgp))
    got = {n: p.grad for n, p in tm.named_parameters()}
    assert sorted(got) == sorted(want)
    for n, g in got.items():
        assert _rel_l2(g, want[n]) <= 1e-5, n
