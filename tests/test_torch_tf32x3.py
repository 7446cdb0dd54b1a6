"""C2's fp32 kernel arithmetic, 3xTF32 on the tensor cores, emulated on the
CPU in the kernel's order (csrc/flash_attn_bthd_f32.cu, csrc/attn_f32.cuh)
and held to fp32 attention.

The kernel splits every fp32 operand x into big (x rounded to TF32's 11
significant bits by Veltkamp's split, t = x (2^13 + 1), big = t - (t - x))
and small = x - big, which the tensor cores read truncated to TF32; each
``mma.sync m16n8k8`` sums 8 exact products into its fp32 accumulator and
truncates toward zero (emulated here: the 8 products and the accumulator
added in float64, rounded toward zero to fp32).  Each 8-wide step takes
small * big, big * small, big * big in that order into a zeroed
temporary, which one rounded fp32 add takes into the running sum: summed
in one accumulator, the truncations drift (``chained=True``: the measured
error of that first design on the card, 3-6e-6 of the output's scale,
matches it).  The logits take q * fp32(scale * log2 e) as the plain
version does, then an online softmax in base 2 over 64-key tiles, p split
again for P V.

On one (batch, head) slice of v1's global blocks (T 256 and the ragged
324, D 96, numpy draws from a seed), the emulation stays within 1e-5 rel
L2 (chip_smoke's FP32_RTOL and V1_INFER_REL_L2) of the port's plain fp32
version and of vdn's flash_attention (Pallas, interpret mode, as
tests/test_torch_v1.py runs it); a single TF32 product (1xTF32) misses
that gate by more than tenfold, so the split is what keeps fp32 accuracy.
The port's plain version stays exact fp32: the emulation is test code.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from vdn_torch.kernels import LOG2E
from vdn_torch.kernels import flash_attention as tfa

KEYS = 64   # keys per K / V tile in the kernel
D = 96
GATE = 1e-5


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an fp32 register: its low 13 mantissa
    bits dropped."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _split(x: torch.Tensor, passes: int):
    """(big, small) as the kernel forms them (fp32 steps, each rounded);
    passes == 1: the single TF32 operand, x rounded to TF32 (small 0)."""
    t = x * torch.tensor(8193.0)
    big = t - (t - x)
    if passes == 1:
        return big, torch.zeros_like(x)
    return big, _tf32_trunc(x - big)


def _round_to_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> fp32 truncated toward zero, as the tensor cores sum."""
    f = x.float()
    return torch.where(f.double().abs() > x.abs(),
                       torch.nextafter(f, torch.zeros_like(f)), f)


def _mma(acc, a, b, passes: int, chained: bool = False):
    """acc [M, N] fp32 += a [M, K] b [K, N] over K in steps of 8: per step
    the TF32 products (small * big, big * small, big * big), each
    instruction's 8 products summed exactly with its accumulator and
    truncated to fp32; into a zeroed temporary added to acc in fp32, or
    (``chained``) into acc itself."""
    ab, as_ = _split(a, passes)
    bb, bs = _split(b, passes)
    terms = ((ab, bb),) if passes == 1 else ((as_, bb), (ab, bs), (ab, bb))
    for k in range(0, a.shape[1], 8):
        sl = slice(k, k + 8)
        t = acc if chained else torch.zeros_like(acc)
        for x, y in terms:
            t = _round_to_zero(t.double() + x[:, sl].double() @ y[sl].double())
        acc = t if chained else acc + t
    return acc


def attention_tf32(q, k, v, passes: int = 3, chained: bool = False
                   ) -> torch.Tensor:
    """One head: q [Tq, D], k / v [Tk, D] fp32 -> out [Tq, D], the kernel's
    online softmax over 64-key tiles with its products in ``passes`` x
    TF32 (``chained``: every step's products in one accumulator)."""
    qs = q * torch.tensor(D ** -0.5 * LOG2E, dtype=torch.float32)
    tq, tk = q.shape[0], k.shape[0]
    m = torch.full((tq, 1), -torch.inf)
    l = torch.zeros((tq, 1))
    o = torch.zeros((tq, D))
    for k0 in range(0, tk, KEYS):
        kt, vt = k[k0:k0 + KEYS], v[k0:k0 + KEYS]
        s = _mma(torch.zeros((tq, kt.shape[0])), qs, kt.t(), passes,
                 chained)
        m_new = torch.maximum(m, s.amax(1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(1, keepdim=True)
        o = _mma(o * alpha, p, vt, passes, chained)
        m = m_new
    return o / l


def _head(t: int):
    rng = np.random.default_rng(t)
    return [rng.standard_normal((t, D)).astype(np.float32) for _ in range(3)]


def _vdn(q, k, v):
    from vdn.ops.pallas import flash_attention as jfa
    with pltpu.force_tpu_interpret_mode():
        out = jfa.flash_attention(*(jnp.asarray(a[None, :, None])
                                    for a in (q, k, v)))
    return np.asarray(jax.device_get(out))[0, :, 0]


@pytest.mark.parametrize("t", [256, 324])
def test_3xtf32_matches_fp32_attention(t):
    """3xTF32 in the kernel's order within 1e-5 rel L2 of the plain fp32
    version and of vdn's flash_attention, one (batch, head) of v1's
    global blocks; the max error within 1e-5 of the output's scale."""
    q, k, v = _head(t)
    got = attention_tf32(*map(torch.from_numpy, (q, k, v))).numpy()
    plain = tfa.flash_attention_plain(
        *(torch.from_numpy(a)[None, :, None] for a in (q, k, v)))[0, :, 0]
    want = _vdn(q, k, v)
    assert _rel_l2(plain, want) <= GATE
    assert _rel_l2(got, plain) <= GATE
    assert _rel_l2(got, want) <= GATE
    assert np.abs(got - plain.numpy()).max() <= GATE * np.abs(
        plain.numpy()).max()


@pytest.mark.parametrize("t", [256, 324])
def test_chained_accumulators_drift(t):
    """Summed in one accumulator per output (36 truncating products per
    logits tile, 24 per key tile into O) 3xTF32 drifts several-fold above
    the kernel's fresh temporaries, towards the gate: the first design's
    error on the card."""
    q, k, v = map(torch.from_numpy, _head(t))
    plain = tfa.flash_attention_plain(q[None, :, None], k[None, :, None],
                                      v[None, :, None])[0, :, 0]
    fresh = _rel_l2(attention_tf32(q, k, v), plain)
    chained = _rel_l2(attention_tf32(q, k, v, chained=True), plain)
    assert chained >= 3 * fresh and chained <= GATE


@pytest.mark.parametrize("t", [256, 324])
def test_1xtf32_misses_the_gate(t):
    """A single TF32 product per term misses the 1e-5 gate by more than
    tenfold (at least 1e-4 rel L2 from the plain fp32 version): the split
    is needed."""
    q, k, v = map(torch.from_numpy, _head(t))
    got = attention_tf32(q, k, v, passes=1)
    plain = tfa.flash_attention_plain(q[None, :, None], k[None, :, None],
                                      v[None, :, None])[0, :, 0]
    assert _rel_l2(got, plain) >= 1e-4


def test_split_is_exact_and_tf32():
    """big carries at most TF32's 11 significant bits, big + small is x
    exactly, and small is below 2^-11 |x|."""
    x = torch.from_numpy((np.random.default_rng(0).standard_normal(4096)
                          * 10.0 ** np.arange(-3, 5).repeat(512)
                          ).astype(np.float32))
    big, small = _split(x, 3)
    t = x * torch.tensor(8193.0)
    raw_small = x - (t - (t - x))
    assert torch.equal(_tf32_trunc(big), big)
    assert torch.equal(big.double() + raw_small.double(), x.double())
    assert bool((small.abs() <= x.abs() * 2.0 ** -11).all())
