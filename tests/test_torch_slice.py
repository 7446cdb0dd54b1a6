"""The port's clip-depth slice against vdn's, end to end, in fp32.

VideoDepthAnything(encoder="vits", features=32, out_channels=(32, 32, 64,
64)) at 42 px (3 x 3 patches, so the pos-embed is interpolated from the
37 x 37 table).  One set of weights, drawn with numpy from a seed in vdn's
flax layout, goes to both packages (the port through
``state_dict_from_flax``); every motion module's proj_out is nonzero, so
the temporal blocks reach the depth.  vdn runs un-jitted.  Tolerance:
rtol 1e-4 and atol 1e-4 of the depth's scale, two fp32 implementations
summing in different orders through 12 blocks and the DPT head.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdn.models.video_depth_anything import build_video_depth_anything as jbuild
from vdn_torch.core.convert import load_flax_params
from vdn_torch.models.video_depth_anything import (
    build_video_depth_anything as tbuild)

torch.set_num_threads(2)

CFG = dict(encoder="vits", features=32, out_channels=(32, 32, 64, 64))
SIZE = 42


def _numpy_params(shapes, rng):
    """vdn-style magnitudes: kernels ~ N(0, 1/fan_in), LayerNorm scales
    near 1, small biases and embeddings."""
    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name in ("scale", "gamma"):
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def models():
    jm = jbuild(**CFG)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, SIZE, SIZE, 3)))
    params = _numpy_params(shapes, np.random.default_rng(0))
    tm = tbuild(**CFG, device="cpu")
    missing = load_flax_params(tm, params)
    # flax never creates the reference's unused refinenet4.resConfUnit1
    assert all(".refinenet4.resConfUnit1." in k for k in missing)
    return jm, params, tm


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_clip_forward(models):
    jm, params, tm = models
    x = np.random.default_rng(1).standard_normal(
        (1, 4, SIZE, SIZE, 3)).astype(np.float32)
    want = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (1, 4, SIZE, SIZE)
    _close(got.numpy(), want)


def test_forward_window_cached(models):
    jm, params, tm = models
    rng = np.random.default_rng(2)
    seed_x = rng.standard_normal((1, 2, SIZE, SIZE, 3)).astype(np.float32)
    x_new = rng.standard_normal((1, 3, SIZE, SIZE, 3)).astype(np.float32)
    j_seed = jm.apply(params, jnp.asarray(seed_x),
                      method=jm.forward_features)
    want, want_feats = jm.apply(params, jnp.asarray(x_new), j_seed,
                                method=jm.forward_window_cached)
    with torch.no_grad():
        t_seed = tm.forward_features(torch.from_numpy(seed_x))
        got, got_feats = tm.forward_window_cached(torch.from_numpy(x_new),
                                                  t_seed)
        # the reuse is exact: same as encoding all five frames
        full, _ = tm.forward_window(torch.from_numpy(
            np.concatenate([seed_x, x_new], axis=1)))
    _close(got.numpy(), want)
    for g_layer, w_layer in zip(got_feats, want_feats):
        for g, w in zip(g_layer, w_layer):
            _close(g.numpy(), w)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_infer_video_depth(models):
    """40 frames: two 32-frame windows, the second through the cached
    encoder path, then least-squares stitching and the cross-fade."""
    from vdn.pipelines.infer_video import infer_video_depth as jinfer
    from vdn_torch.pipelines.infer_video import infer_video_depth as tinfer
    jm, params, tm = models
    frames = np.random.default_rng(3).integers(
        0, 256, (40, SIZE, SIZE, 3), dtype=np.uint8)
    # vdn's re-encoding window path (un-jitted) computes what its cached
    # path computes, exactly
    want, fps = jinfer(jm, params, frames, 24.0, input_size=SIZE,
                       forward_fn=lambda p, x: jm.apply(p, x))
    got, got_fps = tinfer(tm, frames, 24.0, input_size=SIZE)
    assert got.shape == (40, SIZE, SIZE) and got_fps == fps
    assert np.isfinite(got).all()
    _close(got, want)
