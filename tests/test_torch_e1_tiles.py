"""E1's host-side plan (vdn_torch/kernels/ring_attention.py ``e1_plan``) and
the order of its kernel's arithmetic (csrc/ring_step.cu), on the CPU.

The kernel needs the card.  Its shared-memory layout and what a launch
holds on an SM live in csrc/e1_layout.cuh, plain C++ that the host's
compiler builds here into a library of its own (the kernels' library
exports the same ``vdn_ring_step_fit``); ``e1_plan`` reads it.  Held here:
the mode, warps, ring depth, grid and shared bytes at vitl's and vitg's
context-parallel shapes (G = tokens x 8 heads) for local T 8, 32, 128 and
256 and at a ragged width, within an H100 block's shared memory at every
Tq, Tk and D the kernel takes; the warp mode's persistent walk and the
block mode's (row, q tile) blocks cover every item and every 16-row q
tile exactly once; the ring is never deeper than the block's walk.

Then plain torch replays the kernel's arithmetic in its order, taking the
key tiles in the ring's order for the plan's tile size: S over the head in
16-wide k steps (bf16; fp32 in 3xTF32, 8-wide, emulated as
tests/test_torch_tf32x3.py does) in 32-key groups, each row's max over the
whole block (two passes above 128 keys: the second recomputes S), exp, the
unrounded p summed into l, p rounded to v's dtype against v over 16-key
steps (fp32: 8-key steps in 3xTF32), o corr + pv.  The replay holds the
plain version (ring_step_plain) and vdn's Pallas ring_step in interpret
mode to 4 bf16 ulps at each output's scale (fp32: 1e-5 of it), at 9-37
tokens x 8 heads, local T 8 / 32 / 128 / 256, a non-zero incoming carry
and Tq != Tk.
"""

import ctypes
import functools
import math
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_tf32x3 import _round_to_zero, _split
from vdn.ops.pallas.ring_attention import ring_step as jring_step
from vdn_torch.kernels import ring_attention as ra

torch.set_num_threads(2)

SMS = 132          # an H100 SXM
SMEM_MAX = 232448  # an H100 block's dynamic shared memory
BF = torch.bfloat16
# (G, D) of the four motion modules at 518 px, G = tokens x 8 heads
WIDTHS = {"vitl": [(10952, 128), (2888, 128), (10952, 32), (43808, 32)],
          "vitg": [(10952, 192), (2888, 192), (10952, 48), (43808, 48)],
          "ragged": [(72, 24)]}
LAYOUT = (Path(__file__).resolve().parents[1] / "vdn_torch" / "csrc"
          / "e1_layout.cuh")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """csrc/e1_layout.cuh built by the host's C++ compiler."""
    so = tmp_path_factory.mktemp("e1_layout") / "e1_layout.so"
    cxx = shutil.which("g++") or shutil.which("c++")
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-x", "c++",
                    str(LAYOUT), "-o", str(so)], check=True)
    out = ctypes.CDLL(str(so))
    out.vdn_ring_step_fit.argtypes = (ctypes.c_int,) * 8 + (ctypes.c_void_p,)
    out.vdn_ring_step_fit.restype = ctypes.c_int
    return out


def block_key(lib, d, tq, tk, w, st, kc, esize=2):
    """The block mode's ranking of one launch (resident warps, tile keys,
    ring depth, warps), None where the layout does not take it or the ring
    is deeper than the walk."""
    f = ra.fit(lib, esize, "block", d, tq, tk, w, st, kc)
    return ((f["resident"], kc, st, w)
            if f["resident"] and st <= f["walk"] else None)


# ---------------------------------------------------------------- the plan
@pytest.mark.parametrize("t", [8, 32, 128, 256])
@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_plan_modes(lib, widths, t):
    """Local T <= 16 at D <= 64: the warp mode, as many warps a block as fit
    (at most 16 and G), one persistent block a SM.  Else the block mode:
    1, 2, 4 or 8 warps, tiles of 32 or (above 32 keys) 64 keys and a ring
    of 2 up to 4 tiles (no deeper than the item's walk), the most warps
    resident on an SM, then the larger tile, the deeper ring, the larger
    block; one block a (row, q tile), one pass up to 128 keys and two
    above."""
    for g, d in WIDTHS[widths]:
        plan = ra.e1_plan(g, t, t, d, BF, SMS, lib)
        assert 0 < plan["smem"] <= SMEM_MAX
        if t <= 16 and d <= 64:
            w = plan["warps"]
            assert plan["mode"] == "warp" and plan["stages"] == 2
            assert plan["smem"] == ra.fit(lib, 2, "warp", d, t, t, w, 2,
                                          32)["smem"]
            assert w == min(16, g) or not ra.fit(lib, 2, "warp", d, t, t,
                                                 w + 1, 2, 32)["resident"]
            assert plan["grid"] == min(-(-g // w), SMS)
            continue
        w, st, kc = plan["warps"], plan["stages"], plan["kc"]
        assert plan["mode"] == "block" and w in (1, 2, 4, 8)
        assert w <= -(-t // 16) and kc in ((32, 64) if t > 32 else (32,))
        assert plan["passes"] == (1 if t <= 128 else 2)
        assert plan["walk"] == (plan["passes"] + 1) * -(-t // kc)
        assert 2 <= st <= min(4, plan["walk"])
        assert plan["grid"] == g * -(-t // (16 * w))
        mine = block_key(lib, d, t, t, w, st, kc)
        assert mine is not None
        for kc2 in ((32, 64) if t > 32 else (32,)):
            for w2 in (1, 2, 4, 8):
                for st2 in (2, 3, 4):
                    if w2 <= -(-t // 16):
                        other = block_key(lib, d, t, t, w2, st2, kc2)
                        assert other is None or other <= mine


def test_plan_pinned(lib):
    """The plans at vitl's and vitg's shapes, each the fastest of the plans
    tools/e1_plans.py timed on the card (PERF.md §6, E1)."""
    def plans(t, widths):
        return [(p["mode"], p["warps"], p["stages"], p["kc"]) for p in
                (ra.e1_plan(g, t, t, d, BF, SMS, lib)
                 for g, d in WIDTHS[widths])]
    assert plans(8, "vitl") == [("block", 1, 2, 32)] * 2 \
        + [("warp", 16, 2, 32)] * 2
    assert plans(8, "vitg") == [("block", 1, 2, 32)] * 2 \
        + [("warp", 12, 2, 32)] * 2
    for widths in ("vitl", "vitg"):
        assert plans(32, widths) == [("block", 2, 2, 32)] * 4
    for t in (128, 256):
        assert plans(t, "vitl") == [("block", 4, 2, 32)] * 2 \
            + [("block", 8, 4, 64)] * 2
        assert plans(t, "vitg") == [("block", 8, 3, 64)] * 2 \
            + [("block", 8, 4, 64)] * 2


@pytest.mark.parametrize("dtype", [BF, torch.float32])
def test_plan_domain(lib, dtype):
    """Any Tq, Tk >= 1 and D % 8 == 0 up to 256 has a launch within an
    H100 block's shared memory (no 128-key limit); the warp mode only at
    Tq, Tk <= 32."""
    for d in range(8, ra.MAX_D + 1, 8):
        for tq, tk in ((1, 1), (1, 300), (300, 1), (33, 32), (32, 33),
                       (17, 5), (32, 32), (200, 200), (256, 512)):
            plan = ra.e1_plan(37 * 8, tq, tk, d, dtype, SMS, lib)
            assert 0 < plan["smem"] <= SMEM_MAX
            if plan["mode"] == "warp":
                assert tq <= 32 and tk <= 32
            else:
                assert 1 <= plan["warps"] <= min(8, -(-tq // 16))
                assert 2 <= plan["stages"] <= min(4, plan["walk"])
                assert plan["passes"] == (1 if tk <= 128 else 2)


def warp_hits(items: int, grid: int, warps: int) -> np.ndarray:
    """How often each item is in a warp's walk: warp w of block b takes
    items b warps + w, + grid warps, ..."""
    hits = np.zeros(items, np.int32)
    for b in range(grid):
        for w in range(warps):
            hits[b * warps + w::grid * warps] += 1
    return hits


def block_hits(g: int, tq: int, grid: int, warps: int) -> np.ndarray:
    """How often each (item, 16-row q tile) is taken: block i is item i //
    nqt, q tile i % nqt of 16 warps rows; warp w its rows 16 w ..; a warp
    past Tq idles."""
    nqt = -(-tq // (16 * warps))
    hits = np.zeros((g, -(-tq // 16)), np.int32)
    for i in range(grid):
        item, qt = divmod(i, nqt)
        for w in range(warps):
            r0 = qt * 16 * warps + 16 * w
            if r0 < tq:
                hits[item, r0 // 16] += 1
    return hits


@pytest.mark.parametrize("t", [8, 32, 40, 128, 200, 256])
def test_walk_covers(lib, t):
    """Every item (warp mode) or every (item, 16-row q tile) (block mode)
    once, at a G of 37 tokens x 8 heads and on a card with more SMs than
    items."""
    for g, d in ((37 * 8, 32), (37 * 8, 128), (9 * 8, 48)):
        for sms in (SMS, 10 ** 4):
            plan = ra.e1_plan(g, t, t, d, BF, sms, lib)
            if plan["mode"] == "warp":
                assert (warp_hits(g, plan["grid"], plan["warps"]) == 1).all()
            else:
                assert (block_hits(g, t, plan["grid"], plan["warps"])
                        == 1).all()


def ring_walk(nc: int, passes: int):
    """The block mode's tiles in ring order, (tensor, key tile)
    (csrc/ring_step.cu ``issue``): one pass, the K tiles then the V tiles;
    two, the K tiles (the max), then K and V of each key tile.  The warp
    mode's one item is the walk of one 32-key tile."""
    ks = [("k", c) for c in range(nc)]
    if passes == 1:
        return ks + [("v", c) for c in range(nc)]
    return ks + [x for c in range(nc) for x in (("k", c), ("v", c))]


def test_ring_within_walk(lib):
    """The plan's ring never holds more tiles than the block's walk has,
    and the walk it sees is ring_walk's, at vitl's and vitg's shapes, the
    ragged one and the replay's cases."""
    shapes = [(g, t, t, d) for w in WIDTHS.values() for g, d in w
              for t in (8, 32, 40, 128, 200, 256)]
    shapes += [(n * h, tq, tk, d) for n, h, tq, tk, d, _ in CASES.values()]
    for g, tq, tk, d in shapes:
        for dtype in (BF, torch.float32):
            plan = ra.e1_plan(g, tq, tk, d, dtype, SMS, lib)
            if plan["mode"] == "block":
                walk = ring_walk(-(-tk // plan["kc"]), plan["passes"])
                assert plan["walk"] == len(walk)
                assert plan["stages"] <= len(walk)


# ---------------------------------------------------------------- replay
def _tf32x3(acc, a, b):
    """acc [..., M, N] + a [..., M, K] b [..., K, N] in 8-wide steps as
    attn_f32.cuh's mma_3xtf32 (each step's small * big, big * small, big *
    big into a zeroed temporary, every instruction's sums exact and
    truncated to fp32, the temporary added in fp32)."""
    ab, as_ = _split(a, 3)
    bb, bs = _split(b, 3)
    for k in range(0, a.shape[-1], 8):
        sl = slice(k, k + 8)
        t = torch.zeros_like(acc)
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            t = _round_to_zero(t.double() + x[..., sl].double()
                               @ y[..., sl, :].double())
        acc = acc + t
    return acc


def replay(q, k, v, o, m, l, scale, kc=32, passes=1):
    """E1's arithmetic in csrc/ring_step.cu's order, the key tiles of kc
    keys taken in ring_walk's order (the warp mode: one 32-key tile, one
    pass)."""
    q3, k3, v3 = (ra._rows(x).float() for x in (q, k, v))
    bf = q.dtype == BF
    g, tq, d = q3.shape
    tk = k3.shape[1]
    nc = -(-tk // kc)
    dp = 16 * -(-d // 16) if bf else d            # the zero-padded width
    qp = torch.zeros(g, tq, dp)
    qp[..., :d] = q3
    kp, vp = torch.zeros(g, nc * kc, dp), torch.zeros(g, nc * kc, d)
    kp[:, :tk, :d], vp[:, :tk] = k3, v3           # zero-filled key tails
    keys = torch.arange(nc * kc)

    def group(k0):
        """S of the 32 keys from k0, scaled, keys >= Tk -inf."""
        kt = kp[:, k0:k0 + 32].transpose(1, 2)
        acc = torch.zeros(g, tq, 32)
        if bf:
            for kk in range(0, dp, 16):
                acc = acc + qp[..., kk:kk + 16] @ kt[:, kk:kk + 16]
        else:
            acc = _tf32x3(acc, qp, kt)
        s = acc * torch.tensor(scale, dtype=torch.float32)
        return torch.where(keys[k0:k0 + 32] < tk, s, -torch.inf)

    def logits(c):
        return torch.cat([group(k0) for k0 in range(c * kc, (c + 1) * kc,
                                                     32)], -1)

    first, p = {}, {}
    pv, lsum = torch.zeros(g, tq, d), torch.zeros(g, tq)

    def exp_of(c, s):
        nonlocal lsum
        p[c] = torch.exp(s - m_new[..., None])
        lsum = lsum + p[c].sum(-1)

    for j, (x, c) in enumerate(ring_walk(nc, passes)):
        if j < nc:                                 # the max's pass
            first[c] = logits(c)
            if j == nc - 1:
                mx = torch.stack([s.amax(-1) for s in first.values()])
                m_new = torch.maximum(m, mx.amax(0))
                corr = torch.exp(m - m_new)
                if passes == 1:                    # p of every tile now
                    for c2 in range(nc):
                        exp_of(c2, first[c2])
        elif x == "k":                             # the second pass
            s = logits(c)
            assert torch.equal(s, first[c])        # recomputed, same bits
            exp_of(c, s)
        elif bf:
            pb = p[c].to(BF).float()
            for kk in range(c * kc, (c + 1) * kc, 16):
                pv = pv + pb[..., kk - c * kc:kk - c * kc + 16] \
                    @ vp[:, kk:kk + 16]
        else:
            for k0 in range(c * kc, (c + 1) * kc, 32):
                pv = _tf32x3(pv, p[c][..., k0 - c * kc:k0 - c * kc + 32],
                             vp[:, k0:k0 + 32])
    return o * corr[..., None] + pv, m_new, l * corr + lsum


# (tokens, heads, Tq, Tk, D, carry): the warp mode at T 8 (and at 16, its
# longest under the plan), the block mode at 32, 128 (one pass) and 256
# (two), Tq != Tk either side of 32, 37 tokens at a ragged width
CASES = {"warp_t8": (9, 8, 8, 8, 32, False),
         "warp_t16_carry": (9, 8, 16, 16, 48, True),
         "block_t32_carry": (9, 8, 32, 32, 48, True),
         "block_t128": (9, 8, 128, 128, 24, False),
         "block_t256_carry": (9, 8, 256, 256, 32, True),
         "block_tq24_tk40_carry": (9, 8, 24, 40, 16, True),
         "block_tq48_tk8": (37, 8, 48, 8, 40, False)}


def _inputs(case, dtype, seed=0):
    """q, k, v [tokens, T, heads, D] in ``dtype`` (the layout the CP model
    hands E1) and the carry (o, m, l) [G, Tq, (D)] fp32."""
    n, h, tq, tk, d, carry = CASES[case]
    rng = np.random.default_rng(seed)
    r = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, k, v = r(n, tq, h, d).to(dtype), r(n, tk, h, d).to(dtype), \
        r(n, tk, h, d).to(dtype)
    g = n * h
    if carry:   # the carry after an earlier block: a ring's second step
        o, m = r(g, tq, d) * 3, r(g, tq) + 2
        l = torch.from_numpy(rng.random((g, tq)).astype(np.float32)) * 4 + 1
    else:
        o, m, l = torch.zeros(g, tq, d), torch.full((g, tq), -1e30), \
            torch.zeros(g, tq)
    return q, k, v, o, m, l, d ** -0.5


@functools.lru_cache(maxsize=None)
def _replayed(case, dtype, kc, passes):
    """The inputs of ``case`` and the replay's outputs at the plan's tile
    size and passes (each computed once for the module)."""
    args = _inputs(case, dtype)
    return args, replay(*args, kc=kc, passes=passes)


def _plan_replayed(lib, case, dtype):
    """``case``'s plan, inputs and replay."""
    n, h, tq, tk, d, _ = CASES[case]
    plan = ra.e1_plan(n * h, tq, tk, d, dtype, SMS, lib)
    return (plan,) + _replayed(case, dtype, plan["kc"], plan["passes"])


def _close(got, want, dtype):
    """Each output within 4 bf16 ulps of its scale (fp32: 1e-5 of it)."""
    for a, b in zip(got, want):
        b = torch.from_numpy(np.array(b, np.float32))
        scale = b.abs().max().item()
        tol = (4 * 2.0 ** (math.floor(math.log2(scale)) - 7) if dtype == BF
               else 1e-5 * scale)
        assert (a.float() - b).abs().max().item() <= tol


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [BF, torch.float32], ids=["bf16", "fp32"])
def test_replay_matches_plain(lib, case, dtype):
    plan, args, got = _plan_replayed(lib, case, dtype)
    assert plan["mode"] == ("warp" if case.startswith("warp") else "block")
    _close(got, ra.ring_step_plain(*args), dtype)


@pytest.mark.parametrize("case,dtype", [
    ("warp_t16_carry", BF), ("block_t256_carry", BF),
    ("block_t256_carry", torch.float32),
    ("block_tq24_tk40_carry", torch.float32)],
    ids=["bf16-warp_t16", "bf16-t256", "fp32-t256", "fp32-tq24_tk40"])
def test_replay_matches_vdn(lib, case, dtype):
    """Against vdn's ring_step (Pallas, interpret mode) on [G, T, D]."""
    _, (q, k, v, o, m, l, scale), got = _plan_replayed(lib, case, dtype)
    jd = jnp.bfloat16 if dtype == BF else jnp.float32
    rows = [ra._rows(x).float().numpy() for x in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        want = jring_step(*(jnp.asarray(a, jd) for a in rows),
                          *(jnp.asarray(a.numpy()) for a in (o, m, l)),
                          scale)
    _close(got, want, dtype)


def test_wrapper_long_block_on_cpu():
    """The wrapper takes Tk 256 and Tq != Tk (its plain version on the
    CPU; on the card the kernel at any Tk), the carry updated in place."""
    for case in ("block_t256_carry", "block_tq24_tk40_carry"):
        q, k, v, o, m, l, scale = _inputs(case, BF, seed=2)
        want = ra.ring_step_plain(q, k, v, o, m, l, scale)
        got = ra.ring_step(q, k, v, o, m, l, scale)
        assert got[0] is o and got[1] is m and got[2] is l
        for a, b in zip(got, want):
            assert torch.equal(a, b)
