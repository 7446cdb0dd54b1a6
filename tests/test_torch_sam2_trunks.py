"""SAM2's other released trunks in the port against vdn on the CPU: C2's
plain version at the head widths they give it (D 72: hiera_large; D 96:
hiera_tiny and hiera_small) against vdn's flash_attention (Pallas,
interpret mode) in bf16 and fp32 with a ragged Tk; each released trunk at
its own widths and heads, cut to four blocks, against vdn's Hiera with
its global block's attention routed to C2 at the variant's head width;
and the weight conversion at hiera_large's key layout and widths.

Tolerances as tests/test_torch_sam2.py's: C2 1e-5 relative L2 in fp32 and
4 bf16 ulps of the output's scale in bf16; modules rtol 1e-4 and atol
1e-4 of the output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tests.test_torch_sam2 import _close, _np, _rel_l2, _t, pair, seeded_tree

torch.set_num_threads(2)

RELEASED = {"hiera_tiny": 96, "hiera_small": 96, "hiera_base_plus": 56,
            "hiera_large": 72}


@pytest.mark.parametrize("d,h,tq,tk", [(72, 2, 300, 260),
                                       (96, 2, 130, 388)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_new_widths_match_vdn(d, h, tq, tk, dtype):
    """C2's plain version at D 72 and 96 against vdn's flash_attention
    (Pallas, interpret mode), ragged Tk (260 = 2 * 128 + 4, 388 = 3 *
    128 + 4, as 4100 is at 4096 + 4); both widths are among the kernel's
    on the card in bf16 and fp32."""
    from vdn.ops.pallas import flash_attention as jfa
    from vdn_torch.kernels import flash_attention as tfa
    assert d in tfa.BF16_HEAD_DIMS and d in tfa.F32_HEAD_DIMS
    rng = np.random.default_rng(d + tq + tk)
    q, k, v = (rng.standard_normal((1, t, h, d)).astype(np.float32)
               for t in (tq, tk, tk))
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    with pltpu.force_tpu_interpret_mode():
        want = jfa.flash_attention(*(jnp.asarray(a, jd) for a in (q, k, v)))
    want = np.asarray(want.astype(jnp.float32))
    td = getattr(torch, dtype)
    got = tfa.flash_attention(*(_t(a).to(td) for a in (q, k, v)))
    assert got.dtype == td and got.shape == (1, tq, h, d)
    if dtype == "float32":
        assert _rel_l2(got, want) <= 1e-5
    else:
        scale = float(np.abs(want).max())
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert float(np.abs(_np(got) - want).max()) <= 4 * ulp


def test_c2_widths_table():
    """The widths C2 takes on the card, and those it still refuses:
    bf16 56 / 64 / 72 / 96 / 256, fp32 56 / 72 / 96 / 256, D2 fp32 56 /
    72 / 96 (every released trunk's global blocks train on the card)."""
    from vdn_torch.kernels import flash_attention as tfa
    assert tfa.BF16_HEAD_DIMS == (56, 64, 72, 96, 256)
    assert tfa.F32_HEAD_DIMS == (56, 72, 96, 256)
    assert tfa.WIDE_HEAD_DIMS == (72, 96, 256)
    assert tfa.D2_HEAD_DIMS == (56, 72, 96)
    for variant, dh in RELEASED.items():
        assert dh in tfa.BF16_HEAD_DIMS and dh in tfa.F32_HEAD_DIMS, variant
        assert dh in tfa.D2_HEAD_DIMS, variant


def _cut(cfg):
    """A released trunk's widths, heads, windows and pos-embed, cut to
    four blocks with the global block at stage 3."""
    return {**cfg, "stages": (1, 1, 2, 1), "global_att_blocks": (3,)}


@pytest.mark.parametrize("variant", sorted(RELEASED))
def test_released_trunks_match_vdn(variant, monkeypatch):
    """Each released trunk at its own widths (cut to four blocks) at 256
    px: stage 3's 16 x 16 = 256 tokens take C2 at the variant's head
    width (hiera_tiny / small 4 heads of 96, hiera_base_plus 8 of 56,
    hiera_large 8 of 72), q, k and v read off the fused qkv; every level
    as vdn's."""
    import vdn.nn.hiera as jh
    import vdn_torch.nn.hiera as th
    import vdn_torch.ops.attention as ta
    assert th.HIERA_CONFIGS[variant] == jh.HIERA_CONFIGS[variant]
    name = f"{variant}_cut"
    for mod in (jh, th):
        monkeypatch.setitem(mod.HIERA_CONFIGS, name,
                            _cut(mod.HIERA_CONFIGS[variant]))
    routed = []
    real = ta.flash_attention
    monkeypatch.setattr(ta, "flash_attention", lambda *a: routed.append(
        (tuple(a[0].shape), a[0].is_contiguous())) or real(*a))
    jm, tm = jh.make_hiera(name), th.make_hiera(name)
    rng = np.random.default_rng(len(variant))
    x = rng.standard_normal((1, 256, 256, 3)).astype(np.float32)
    params, missing = pair(jm, tm, rng, x)
    assert missing == []
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(_t(x))
    for g, w in zip(got, want):
        _close(g, w)
    dh = RELEASED[variant]
    heads = th.HIERA_CONFIGS[variant]["num_heads"] * 4
    assert routed == [((1, 256, heads, dh), False)]


def test_convert_hiera_large_key_layout(monkeypatch):
    """The SAM2 image model at hiera_large's widths (trunk cut to four
    blocks, d_model 256): a reference-layout state dict through vdn's
    convert_torch_state and the port's load_flax_params covers every
    parameter, and state_dict_from_flax gives the state dict back, the
    trunk's keys the same names at these widths (no new rule)."""
    import vdn_torch.nn.hiera as th
    from vdn_torch.core.convert import state_dict_from_flax
    from vdn_torch.models.sam2_image import build_sam2_image_model
    monkeypatch.setitem(th.HIERA_CONFIGS, "large_cut",
                        _cut(th.HIERA_CONFIGS["hiera_large"]))
    tm = build_sam2_image_model("large_cut", 256, device="cpu")
    assert tm.image_encoder.trunk.patch_embed.proj.weight.shape[0] == 144
    tree = seeded_tree(tm, np.random.default_rng(9))["params"]
    back = state_dict_from_flax(tree)
    state = tm.state_dict()
    assert set(back) == set(state)
    for k, v in back.items():
        assert tuple(v.shape) == tuple(state[k].shape), k
        assert torch.equal(v, state[k]), k
