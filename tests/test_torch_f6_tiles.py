"""F6's schedule on the card (csrc/flash_attn_int8.cu), replayed in plain
torch on the CPU and held to ``flash_attention_int8_fused_qkv_plain`` and
to vdn's Pallas kernel.

The kernels need the card; what their design changes is the order of the
sums and the tiling, which plain torch can replay:

- the pre-pass: q per row (qi, aq), k and v centred on their means over
  the T tokens, the means summed as the kernel sums them (each of 128 row
  groups its rows in order, then four row groups of a warp in pairs, then
  the 32 warps in order; / T), scratch padded to Tp = T rounded up to 128
  (zero codes past T), v transposed as vt [64, Tp] with the keys of each
  32-key group in ``vt_key_order``'s order;
- the attention on ``a1_plan``'s items (frame, head, 128-row q tile), each
  of two warpgroups taking 64 q rows: pass 1 walks the 128-key tiles for
  the row max (in "qk" / "all" the integer max of si = qi ki^T, keys past
  T skipped, then m = float(max si) * rs; in "pv" the max of A1's bf16
  logits), pass 2 walks them again: pi = rint(exp2(s - (m - log2 127)))
  packed from the S accumulator into the s8 A fragment with no exchange
  between lanes (vt's key order matches the two layouts), P V in int32
  against vt and 16 rows of ones (l, O's columns 64-79), out = (float(pv)
  * av) / float(l) + mu; in "qk" p = bf16(exp2(s - m)) against the exact
  max, l the sum of the rounded p (A1's ones column), out = O / l.

At T 90 (one tile, 38 keys past T), 257 (three tiles, the last with one
key) and 1370 (eleven, the last with 90) in each mode, the replay's codes
equal the plain version's and vdn's but at ties (chip_smoke.py's
int8_check: <= 0.1% differ, by one), and its output sits within
KERNEL_ULPS bf16 ulps of theirs (at the output's scale) on the rows whose
q codes have no tie.  vdn runs in Pallas interpret mode, as
tests/test_torch_attention_int8.py runs it.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from vdn.ops.pallas import flash_attention as jfa
from vdn_torch.kernels import LOG2E
from vdn_torch.kernels import flash_attention as fa

torch.set_num_threads(2)

KERNEL_ULPS = 4     # chip_smoke.py: kernel vs plain, bf16 ulps at the scale
TIE_SHARE = 1e-3    # chip_smoke.py's INT8_TIE_SHARE
WG_ROWS = 64        # q rows of a consumer warpgroup
ROW_GROUPS = 128    # the pre-pass: 1024 threads, 8 channels each
F32 = torch.float32
SI_MAX = 127 * 127 * 64


def _qkv(t: int, seed: int) -> np.ndarray:
    """vdn's F6 test input (test_flash_attention.py:205-207), one frame of
    two heads: normal draws with channel-mean outliers on k and v."""
    qkv = np.random.default_rng(seed).standard_normal(
        (1, t, 3, 2, 64)).astype(np.float32)
    qkv[:, :, 1, :, 3] += 4.0
    qkv[:, :, 2, :, 5] += 3.0
    return qkv


def _vdn_codes(qkv: np.ndarray, mode: str) -> dict:
    """vdn's int8 codes (``_flash_cols_int8_kernel``'s steps,
    flash_attention.py:822-886) of a bf16 input: qi, ki, vi [B, H, T, D]."""
    x = jnp.asarray(qkv, jnp.bfloat16).astype(jnp.float32)
    q, k, v = (jnp.moveaxis(x[:, :, i], 1, 2) for i in range(3))
    amax = lambda a, axis: jnp.maximum(jnp.max(jnp.abs(a), axis=axis,
                                               keepdims=True), 1e-30)
    codes = {}
    if mode in ("qk", "all"):
        aq = amax(q, -1) * (1.0 / 127.0)
        kf = k - jnp.mean(k, axis=-2, keepdims=True)
        ak = amax(kf, (-2, -1)) * (1.0 / 127.0)
        codes.update(qi=jnp.round(q * (1.0 / aq)),
                     ki=jnp.round(kf * (1.0 / ak)))
    if mode in ("pv", "all"):
        vf = v - jnp.mean(v, axis=-2, keepdims=True)
        av = amax(vf, -2) * (1.0 / 127.0)
        codes["vi"] = jnp.round(vf * (1.0 / av))
    return {key: np.asarray(a) for key, a in codes.items()}


def f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=F32)


def bf16_ulp(x: float) -> float:
    return 2.0 ** (math.floor(math.log2(max(x, 1e-30))) - 7)


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax, 1e-30) * f32(1.0 / 127.0)


def kernel_mean(x: torch.Tensor, t: int) -> torch.Tensor:
    """fp32 [T, D] -> [D]: the pre-pass's sum order, then / T."""
    part = torch.zeros((ROW_GROUPS, x.shape[1]), dtype=F32)
    for r0 in range(0, t, ROW_GROUPS):       # each row group, in order
        rows = x[r0:r0 + ROW_GROUPS]
        part[:rows.shape[0]] = part[:rows.shape[0]] + rows
    p = part.reshape(32, 4, -1)              # warps x their 4 row groups
    warp = (p[:, 0] + p[:, 1]) + (p[:, 2] + p[:, 3])
    s = torch.zeros(x.shape[1], dtype=F32)
    for w in warp:
        s = s + w
    return s / f32(t)


def pre_pass(x: torch.Tensor, mode: str) -> dict:
    """One (frame, head): x [T, 3, 64] bf16 -> the pre-pass's scratch."""
    t = x.shape[0]
    tp = -(-t // fa.A1_ROWS) * fa.A1_ROWS
    pad = lambda a: torch.cat([a, a.new_zeros((tp - t, *a.shape[1:]))])
    q, k, v = (x[:, i].float() for i in range(3))
    out = {}
    if mode in ("qk", "all"):
        aq = scale_of(q.abs().amax(1))
        out["qi"] = pad(torch.round(q * torch.reciprocal(aq)[:, None]))
        out["aq"] = pad(aq)
        kc = k - kernel_mean(k, t)
        ak = scale_of(kc.abs().amax())
        out["ki"] = pad(torch.round(kc * torch.reciprocal(ak)))
        out["ak"] = ak
    if mode in ("pv", "all"):
        mu = kernel_mean(v, t)
        vc = v - mu
        av = scale_of(vc.abs().amax(0))
        vi = pad(torch.round(vc * torch.reciprocal(av)))   # [Tp, 64]
        vt = torch.empty((64, tp), dtype=F32)
        vt[:, fa.vt_key_order(tp)] = vi.t()
        out.update(vt=vt, av=av, mu=mu, vi=vi)
    return out


def frag_of_accumulator() -> list:
    """(warp row, A fragment byte (register q, byte b) of thread lane)
    -> accumulator (row, column) within a 32-key group, as the kernel's
    tile_p packs them: register q = 2 hf + r holds row r's columns 8 (4
    kk + 2 hf) + 2t (+1) and 8 (4 kk + 2 hf + 1) + 2t (+1)."""
    out = []
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for q in range(4):
            hf, r = q // 2, q % 2
            for b in range(4):
                i = 2 * hf + b // 2            # accumulator group in kk
                acc = (g + 8 * r, 8 * i + 2 * t + b % 2)
                # the s8 A fragment (PTX, wgmma .m64nNk32 A in registers):
                # a0 row g keys 4t..4t+3, a1 row g + 8, a2 / a3 keys + 16
                frag = (g + 8 * (q % 2), 4 * t + b + 16 * (q // 2))
                out.append((lane, q, b, acc, frag))
    return out


def attention(x: torch.Tensor, scratch: dict, mode: str, qscale,
              c2f) -> torch.Tensor:
    """One (frame, head) by the kernel's items, warpgroups, tiles and
    passes: x [T, 3, 64] bf16 -> out fp32 [T, 64]."""
    t = x.shape[0]
    n = -(-t // fa.A1_ROWS)
    tp = n * fa.A1_ROWS
    qk, pv = mode in ("qk", "all"), mode in ("pv", "all")
    padded = lambda a: torch.cat([a, a.new_zeros((tp - t, 64))])
    qs = padded((x[:, 0] * qscale).float())       # bf16(q * qscale)
    kf, vf = padded(x[:, 1].float()), padded(x[:, 2].float())
    order = fa.vt_key_order(fa.A1_ROWS)
    out = torch.full((tp, 64), math.nan)
    for qt in range(n):
        for w in range(fa.A1_ROWS // WG_ROWS):
            rows = slice(qt * fa.A1_ROWS + w * WG_ROWS,
                         qt * fa.A1_ROWS + (w + 1) * WG_ROWS)
            if qk:
                rs = scratch["aq"][rows] * (scratch["ak"] * c2f)

            def logits(k0):
                keys = slice(k0, k0 + fa.A1_ROWS)
                if qk:
                    si = (scratch["qi"][rows].double()
                          @ scratch["ki"][keys].double().t())
                    return si
                return qs[rows] @ kf[keys].t()

            masked = lambda k0: torch.arange(k0, k0 + fa.A1_ROWS) >= t
            # pass 1: the row max
            mx = torch.full((WG_ROWS,), -math.inf, dtype=torch.float64)
            for k0 in range(0, tp, fa.A1_ROWS):
                s = logits(k0).double()
                s[:, masked(k0)] = -math.inf
                mx = torch.maximum(mx, s.amax(1))
            m = (mx.float() * rs) if qk else mx.float()
            shift = m - f32(fa.LOG2_127) if pv else m
            # pass 2: the same logits, then P V
            o = torch.zeros((WG_ROWS, 80 if pv else 72), dtype=torch.float64)
            for k0 in range(0, tp, fa.A1_ROWS):
                s = logits(k0)
                s = (s.float() * rs[:, None]) if qk else s.float()
                s[:, masked(k0)] = -math.inf
                p = torch.exp2(s - shift[:, None])
                keys = slice(k0, k0 + fa.A1_ROWS)
                if pv:
                    pi = torch.round(p).double()
                    # the A fragments hold P in vt's key order
                    a = torch.empty_like(pi)
                    for g0 in range(0, fa.A1_ROWS, 32):
                        a[:, g0 + order[:32]] = pi[:, g0:g0 + 32]
                    b = torch.cat([scratch["vt"][:, keys].t().double(),
                                   torch.ones((fa.A1_ROWS, 16),
                                              dtype=torch.float64)], 1)
                    o = o + a @ b                       # exact in int32
                else:
                    pb = p.to(torch.bfloat16).double()
                    b = torch.cat([vf[keys].double(),
                                   torch.ones((fa.A1_ROWS, 8),
                                              dtype=torch.float64)], 1)
                    o = o + (pb @ b).float().double()
            if pv:
                pvs, l = o[:, :64].float(), o[:, 64].float()
                assert torch.equal(o[:, 64:], o[:, 64:65].expand(-1, 16))
                out[rows] = (pvs * scratch["av"]) / l[:, None] + scratch["mu"]
            else:
                out[rows] = o[:, :64].float() / o[:, 64].float()[:, None]
    return out[:t]


def replay(qkv: torch.Tensor, mode: str) -> tuple:
    """(out [B, T, H, D] bf16, codes {qi, ki, vi: [B, H, T, D]}) by the
    kernels' schedule, frame and head by frame and head (a1_plan's items
    cover each once: tests/test_torch_a1_tiles.py)."""
    b, t, _, h, d = qkv.shape
    scale = d ** -0.5
    qscale = fa._qscale(qkv, scale)
    c2f = f32(scale * LOG2E)
    out = torch.empty((b, t, h, d), dtype=qkv.dtype)
    codes = {}
    for bi in range(b):
        for hi in range(h):
            x = qkv[bi, :, :, hi]
            sc = pre_pass(x, mode)
            out[bi, :, hi] = attention(x, sc, mode, qscale, c2f).to(
                qkv.dtype)
            for key in ("qi", "ki", "vi"):
                if key in sc:
                    codes.setdefault(key, []).append(sc[key][:t])
    return out, {k: torch.stack(v).reshape(b, h, t, d)
                 for k, v in codes.items()}


def tie_rows(got: dict, want: dict) -> torch.Tensor:
    """[B * T * H] rows (the output's order) whose q codes differ; every
    code held to int8_check's share and step."""
    rows = None
    for key, a in got.items():
        dif = (a - torch.as_tensor(np.asarray(want[key], np.float32))).abs()
        assert dif.max() <= 1 and (dif > 0).float().mean() <= TIE_SHARE, \
            (key, float(dif.max()), float((dif > 0).float().mean()))
        if key == "qi":
            rows = (dif > 0).any(-1).permute(0, 2, 1).reshape(-1)
    return rows


def close(got: torch.Tensor, want, ties, what: str) -> None:
    g = got.float().reshape(-1, got.shape[-1])
    if isinstance(want, torch.Tensor):
        want = want.float()
    w = torch.as_tensor(np.asarray(want, np.float32)).reshape(g.shape)
    keep = torch.ones(g.shape[0], dtype=torch.bool) if ties is None else ~ties
    scale = w.abs().max().item()
    err = (g[keep] - w[keep]).abs().max().item()
    assert err <= KERNEL_ULPS * bf16_ulp(scale), (what, err, scale)


@pytest.mark.parametrize("t", [90, 257, 1370])
@pytest.mark.parametrize("mode", ["qk", "pv", "all"])
def test_replay_matches_plain_and_vdn(mode, t):
    """The replayed schedule's codes and output against the plain version
    and against vdn's kernel (interpret mode) and codes."""
    a = _qkv(t, seed=t)
    qkv = torch.from_numpy(a).to(torch.bfloat16)
    out, codes = replay(qkv, mode)
    ops = {}
    want = fa.flash_attention_int8_fused_qkv_plain(qkv, mode=mode,
                                                   operands=ops)
    close(out, want, tie_rows(codes, {k: ops[k] for k in codes}), "plain")
    jq = jnp.asarray(a, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        vdn_out = jfa.flash_attention_int8_fused_qkv(jq, None, 128, mode=mode)
    vdn_codes = _vdn_codes(a, mode)
    close(out, vdn_out, tie_rows(codes, {k: vdn_codes[k] for k in codes}),
          "vdn")


def test_vt_order_matches_the_fragments():
    """vt's key order is a bijection of each 32-key group, and every A
    fragment byte the kernel packs from the S accumulator (a thread's own
    values) is the key that vt holds at that byte's position, in the same
    row."""
    order = fa.vt_key_order(256)
    for g0 in range(0, 256, 32):
        assert sorted(order[g0:g0 + 32].tolist()) == list(range(g0, g0 + 32))
    seen = set()
    for lane, q, b, (arow, akey), (frow, fpos) in frag_of_accumulator():
        assert arow == frow, (lane, q, b)
        assert int(order[akey]) == fpos, (lane, q, b, akey, fpos)
        seen.add((frow, fpos))
    assert len(seen) == 16 * 32      # a warp's 16 rows x 32 positions


@settings(max_examples=300, deadline=None)
@given(st.lists(st.integers(-SI_MAX, SI_MAX), min_size=1, max_size=64),
       st.floats(float(np.float32(1e-9)), float(np.float32(1e-2)),
                 width=32))
def test_integer_max_is_the_logit_max(si, rs):
    """Pass 1's m = float(max si) * rs is max(float(si) * rs), bit for
    bit: float(si) is exact below 2^24 and rounding keeps the order."""
    s = np.asarray(si, np.int64)
    assert np.abs(s).max() < 2 ** 24
    r = np.float32(rs)
    m_int = np.float32(s.max()) * r
    m_all = (s.astype(np.float32) * r).max()
    assert m_int.dtype == m_all.dtype == np.float32
    assert m_int.tobytes() == m_all.tobytes()
