"""vdn_torch modules against vdn and the committed goldens, in fp32.

The JAX modules get their weights from flax init with a fixed key; the port
gets the same numbers through ``state_dict_from_flax``.  The goldens
(tests/goldens/*.npz) hold reference-layout torch weights, which the port
loads with plain ``load_state_dict``, and fp64 torch-reference outputs.
Tolerances: rtol 1e-4 / atol 1e-5 against the goldens (as
tests/test_goldens.py), rtol = atol = 1e-4 against vdn (two fp32
implementations summing in different orders).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdn.core.convert import convert_torch_state
from vdn_torch.core.convert import load_flax_params, state_dict_from_flax

torch.set_num_threads(2)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_golden(name):
    z = np.load(os.path.join(GOLDENS, f"{name}.npz"), allow_pickle=False)
    weights = {k[3:]: torch.from_numpy(z[k]) for k in z.files
               if k.startswith("w::")}
    inputs = [z[k] for k in sorted(k for k in z.files if k.startswith("in::"))]
    outputs = [z[k] for k in sorted(k for k in z.files
                                    if k.startswith("out::"))]
    return weights, inputs, outputs


def np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ---------------------------------------------------------------- convert
@pytest.mark.parametrize("name,convt", [
    ("vit_tiny_d3", ()),
    ("dpt_head", (r"resize_layers\.[01]\.",)),
    ("temporal_module", ()),
])
def test_state_dict_round_trip_from_torch(name, convt):
    """torch -> flax (vdn) -> torch gives back every tensor exactly; only
    the recomputed ``pe`` buffers are dropped on the way."""
    weights, _, _ = load_golden(name)
    tree = convert_torch_state({k: v.numpy() for k, v in weights.items()},
                               convt_patterns=convt)
    back = state_dict_from_flax(tree, convt)
    assert set(back) == {k for k in weights if not k.endswith(".pe")}
    for k, v in back.items():
        assert torch.equal(v, weights[k]), k


def test_state_dict_round_trip_from_flax():
    """flax -> torch -> flax is the identity leaf for leaf, over a whole
    VideoDepthAnything tree (ConvTranspose, indexed names, LayerScale)."""
    from vdn.models.video_depth_anything import build_video_depth_anything
    model = build_video_depth_anything("vits", features=32,
                                       out_channels=(32, 32, 64, 64))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, 28, 28, 3)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    sd = state_dict_from_flax(params)
    back = convert_torch_state({k: v.numpy() for k, v in sd.items()})
    want, got = dict(flat(params)), dict(flat(back))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


# ---------------------------------------------------------------- ViT
def test_vit_golden():
    from vdn_torch.nn.vit import DinoVisionTransformer
    weights, (x,), outs = load_golden("vit_tiny_d3")
    model = DinoVisionTransformer(embed_dim=64, depth=3, num_heads=4)
    model.load_state_dict(weights)
    with torch.no_grad():
        got = model.get_intermediate_layers(
            torch.from_numpy(x.transpose(0, 2, 3, 1)), [0, 2])
    flat_got = [t for pair in got for t in pair]
    assert len(flat_got) == len(outs)
    for g, o in zip(flat_got, outs):
        np.testing.assert_allclose(g.numpy(), o.astype(np.float32),
                                   rtol=1e-4, atol=1e-5)


def test_vit_matches_vdn_on_kernel_paths():
    """4 frames of 224 px: 257 tokens and 1028 rows, so the port's blocks
    take A1 (T >= 256) and A2 (rows >= 1024), here as their plain versions;
    the pos-embed is interpolated from 37 x 37 to 16 x 16."""
    from vdn.nn.vit import DinoVisionTransformer as JViT
    from vdn_torch.nn.vit import DinoVisionTransformer as TViT
    x = np.random.default_rng(0).standard_normal(
        (4, 224, 224, 3)).astype(np.float32)
    jm = JViT(embed_dim=64, depth=2, num_heads=4)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x[:1]))
    want = jm.apply(params, jnp.asarray(x), [0, 1],
                    method=jm.get_intermediate_layers)
    tm = TViT(embed_dim=64, depth=2, num_heads=4)
    assert load_flax_params(tm, np_params(params)) == []
    with torch.no_grad():
        got = tm.get_intermediate_layers(torch.from_numpy(x), [0, 1])
    for (gt, gc), (wt, wc) in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------- DPT
def test_dpt_head_golden():
    from vdn_torch.nn.dpt import DPTHead
    weights, (feats,), (ref_depth, ref_feat) = load_golden("dpt_head")
    model = DPTHead(in_channels=64, features=32, out_channels=(24, 48, 96, 96))
    model.load_state_dict(weights)
    with torch.no_grad():
        depth, feat = model([(torch.from_numpy(f), None) for f in feats],
                            6, 6)
    np.testing.assert_allclose(depth[..., 0].numpy(),
                               ref_depth[:, 0].astype(np.float32),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(feat.permute(0, 3, 1, 2).numpy(),
                               ref_feat.astype(np.float32),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- motion
def test_temporal_module_golden_outputs():
    """Outputs only: the golden's cache entries are in the reference's raw
    format, which neither package's clip path emits."""
    from vdn_torch.nn.motion import TemporalModule
    weights, (x,), outs = load_golden("temporal_module")
    b, c, s, h, w = x.shape
    model = TemporalModule(c, num_attention_heads=4, num_transformer_block=1,
                           num_attention_blocks=2, temporal_max_len=8)
    model.load_state_dict(weights)   # strict: includes pos_encoder.pe
    x_nhwc = torch.from_numpy(
        x.transpose(0, 2, 3, 4, 1).reshape(b * s, h, w, c))
    with torch.no_grad():
        got = model(x_nhwc, s)
    got = got.numpy().reshape(b, s, h, w, c).transpose(0, 4, 1, 2, 3)
    np.testing.assert_allclose(got, outs[0].astype(np.float32),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("c,t", [(256, 32), (64, 8)])
def test_temporal_module_matches_vdn(c, t):
    """Both motion widths' head splits (dh 32 and 8) with a nonzero
    proj_out, so A3 and A4 (plain versions) reach the output."""
    from vdn.nn.motion import TemporalModule as JTM
    from vdn_torch.nn.motion import TemporalModule as TTM
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2 * t, 3, 5, c)).astype(np.float32)
    jm = JTM(c, temporal_max_len=32)
    params = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.PRNGKey(2), jnp.asarray(x), t))
    proj_out = params["params"]["temporal_transformer"]["proj_out"]
    proj_out["kernel"] = rng.standard_normal(
        proj_out["kernel"].shape).astype(np.float32) / np.sqrt(c)
    want, _ = jm.apply(params, jnp.asarray(x), t)
    tm = TTM(c, temporal_max_len=32)
    assert load_flax_params(tm, params) == []
    with torch.no_grad():
        got = tm(torch.from_numpy(x), t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)


def _stream_caches(rng, mode, heads, n_tok, c):
    """Random caches of vdn's packed contract for one TemporalModule (two
    attention blocks): gathered windows [h * N, 31, dpad] for the
    per-frame path, (ring [h * N, 43, dpad], one-hot [k, 32, 43 + k]) for
    the chunk path with k = 4."""
    from vdn.nn.motion import ring_lane_width
    dpad = ring_lane_width(c // heads)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    if mode == "first":
        return None
    if mode == "cached_local":
        return [r(heads * n_tok, 31, dpad) for _ in range(2)]
    k, cap = 4, 43
    onehot = np.zeros((k, 32, cap + k), np.float32)
    for j in range(k):
        cols = rng.permutation(cap + j)[:31]   # ring slots or earlier frames
        onehot[j, np.arange(31), cols] = 1.0
        onehot[j, 31, cap + j] = 1.0           # the frame's own entry
    return [(r(heads * n_tok, cap, dpad), onehot) for _ in range(2)]


@pytest.mark.parametrize("mode", ["first", "cached_local", "chunk_window"])
@pytest.mark.parametrize("c", [256, 64])
def test_temporal_module_stream_matches_vdn(c, mode):
    """The streaming paths -- the first frame's generic path (here A3's
    plain version at T = 1), ``_cached_local`` and ``_chunk_window`` --
    and their cache entries, held to vdn's packed K/V contract."""
    from vdn.nn.motion import TemporalModule as JTM
    from vdn_torch.nn.motion import TemporalModule as TTM
    rng = np.random.default_rng(8)
    t = 4 if mode == "chunk_window" else 1
    x = rng.standard_normal((t, 3, 5, c)).astype(np.float32)
    caches = _stream_caches(rng, mode, 8, 15, c)
    jm = JTM(c, temporal_max_len=32)
    params = jax.tree_util.tree_map(
        np.array, jm.init(jax.random.PRNGKey(3), jnp.asarray(x), t))
    proj_out = params["params"]["temporal_transformer"]["proj_out"]
    proj_out["kernel"] = rng.standard_normal(
        proj_out["kernel"].shape).astype(np.float32) / np.sqrt(c)
    jcaches = None if caches is None else [
        jax.tree_util.tree_map(jnp.asarray, e) for e in caches]
    want, want_entries = jm.apply(params, jnp.asarray(x), t, jcaches)
    tm = TTM(c, temporal_max_len=32)
    assert load_flax_params(tm, params) == []
    tcaches = None if caches is None else [
        tuple(map(torch.from_numpy, e)) if isinstance(e, tuple)
        else torch.from_numpy(e) for e in caches]
    with torch.no_grad():
        got, entries = tm.forward_stream(torch.from_numpy(x), t, tcaches)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    assert len(entries) == len(want_entries) == 2
    for g, w in zip(entries, want_entries):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_constants_follow_weight_updates(dtype):
    """The streaming paths' cached weight-only tensors are rebuilt when the
    weights are loaded in place after a first call, and per dtype."""
    from vdn_torch.nn.layers import init_parameters
    from vdn_torch.nn.motion import TemporalAttention
    rng = np.random.default_rng(5)
    c, n = 64, 6
    x = torch.from_numpy(rng.standard_normal((n, 1, c)).astype(np.float32))
    cache = torch.from_numpy(
        rng.standard_normal((8 * n, 31, 128)).astype(np.float32))
    a, b = TemporalAttention(c), TemporalAttention(c)
    init_parameters(a, torch.Generator().manual_seed(1))
    init_parameters(b, torch.Generator().manual_seed(2))
    with torch.no_grad():
        before, _ = a._cached_local(x, cache)     # fp32 constants of a
        a.load_state_dict(b.state_dict())
        got, got_e = a._cached_local(x.to(dtype), cache.to(dtype))
        want, want_e = b._cached_local(x.to(dtype), cache.to(dtype))
        other, _ = b._cached_local(x, cache)
    assert not torch.equal(before, other)
    assert torch.equal(got, want) and torch.equal(got_e, want_e)


# ---------------------------------------------------------------- host side
@pytest.mark.parametrize("hw", [(300, 400), (700, 900), (518, 518)])
def test_preprocess_frame_matches_cv2(hw):
    """torch bicubic (A = -0.75, half-pixel) against cv2's INTER_CUBIC.
    Tolerance 5e-4 in normalized units, about 0.03 of an 8-bit grey level:
    the two evaluate the same taps with float32 weights in another order."""
    from vdn.pipelines.transform import preprocess_frame as cv2_version
    from vdn_torch.pipelines.transform import preprocess_frame
    frame = np.random.default_rng(3).integers(0, 256, hw + (3,),
                                              dtype=np.uint8)
    want = cv2_version(frame, 518)
    got = preprocess_frame(frame, 518)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


def test_port_imports_no_jax_flax_or_cv2():
    """Every module of vdn_torch (the CLIs, the training CLIs, the data
    layer, the config, the logger and the visualization included),
    chip_smoke.py and tools/profile_torch.py, imported in a fresh
    interpreter, pull in nothing of jax, flax, optax, orbax, cv2,
    matplotlib, yaml, h5py, wandb or vdn: the card's machine has neither
    cv2, matplotlib, PyYAML, h5py nor wandb."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vdn_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    vdn_torch.__path__, 'vdn_torch.')]\n"
        "assert len(names) > 30, names\n"
        "new = {'vdn_torch.cli.' + n for n in ('_common', 'train',\n"
        "       'train_metric', 'train_v1', 'evaluate')} | {\n"
        "       'vdn_torch.core.config', 'vdn_torch.data.base',\n"
        "       'vdn_torch.data.datasets', 'vdn_torch.data.factory',\n"
        "       'vdn_torch.data.metric_datasets', 'vdn_torch.utils.logging',\n"
        "       'vdn_torch.utils.visualization'}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "for name in names + ['chip_smoke', 'tools.profile_torch']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax',\n"
        "                                    'cv2', 'matplotlib', 'yaml',\n"
        "                                    'h5py', 'wandb', 'vdn'))\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
