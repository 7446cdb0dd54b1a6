"""The port's streaming path against vdn's, in fp32.

The vits config of test_torch_slice.py (features 32, 42 px, 3 x 3
patches), one set of numpy-seeded weights in vdn's layout carried over by
``load_flax_params``, every motion module's proj_out nonzero (the weights
are drawn for every leaf), 14 frames: the first-frame path, then 13
per-frame steps, with the gap-41 eviction from frame 11 on.  Tolerances:
rtol 1e-4 and atol 1e-4 of the depth's scale against vdn (two fp32
implementations summing in different orders); 1e-5 between the port's
chunked and per-frame decodes, as vdn's own test
(tests/test_pipelines_parity.py:114-140) holds its two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_slice import CFG, SIZE, _numpy_params
from vdn.models.video_depth_anything import build_video_depth_anything as jbuild
from vdn_torch.core.convert import load_flax_params
from vdn_torch.models.video_depth_anything import (
    build_video_depth_anything as tbuild)
from vdn_torch.pipelines.stream import VideoDepthStreamPipeline

torch.set_num_threads(2)

N_FRAMES = 14


@pytest.fixture(scope="module")
def models():
    jm = jbuild(**CFG)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, SIZE, SIZE, 3)))
    params = _numpy_params(shapes, np.random.default_rng(4))
    tm = tbuild(**CFG, device="cpu")
    load_flax_params(tm, params)
    return jm, params, tm


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(5).integers(
        0, 256, (N_FRAMES, SIZE, SIZE, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def per_frame(models, frames):
    """The port's per-frame stream: (depths, pipeline)."""
    _, _, tm = models
    pipe = VideoDepthStreamPipeline(tm, input_size=SIZE)
    return [pipe.infer_video_depth_one(f) for f in frames], pipe


def test_stream_per_frame_matches_vdn(models, frames, per_frame):
    from vdn.pipelines.stream import VideoDepthStreamPipeline as JStream
    jm, params, _ = models
    got, pipe = per_frame
    jpipe = JStream(jm, params, input_size=SIZE)
    for i, f in enumerate(frames):
        want = jpipe.infer_video_depth_one(f)
        assert got[i].shape == want.shape == (SIZE, SIZE)
        np.testing.assert_allclose(got[i], want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=f"frame {i}")
    # eviction ran: the logical list stopped growing at frame 11
    assert pipe.slots == jpipe.slots and pipe.free == jpipe.free
    assert len(pipe.slots) < N_FRAMES + 32


def test_stream_chunked_matches_per_frame(models, frames, per_frame):
    _, _, tm = models
    want, pipe1 = per_frame
    pipe2 = VideoDepthStreamPipeline(tm, input_size=SIZE)
    got = []
    got += pipe2.infer_video_depth_chunk(list(frames[:5]))   # first + 4
    got += pipe2.infer_video_depth_chunk(list(frames[5:9]))
    got += pipe2.infer_video_depth_chunk(list(frames[9:]))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                   err_msg=f"frame {i}")
    assert pipe1.slots == pipe2.slots and pipe1.free == pipe2.free


def test_stream_fetch_false_returns_tensors(models, frames):
    _, _, tm = models
    pipe = VideoDepthStreamPipeline(tm, input_size=SIZE)
    out = pipe.infer_video_depth_chunk(list(frames[:3]), fetch=False)
    assert len(out) == 3
    assert all(isinstance(d, torch.Tensor) and d.shape == (SIZE, SIZE)
               for d in out)


def test_stream_bf16_drift_as_vdn(models, frames):
    """In bf16 the port's per-frame stream sits no further from vdn's fp32
    stream than twice vdn's own bf16 stream does: the rounding noise of
    the cached paths is vdn's, not added by the port."""
    from vdn.pipelines.stream import VideoDepthStreamPipeline as JStream
    jm, params, _ = models
    jm16 = jbuild(**CFG, compute_dtype=jnp.bfloat16)
    tm16 = tbuild(**CFG, device="cpu", compute_dtype=torch.bfloat16)
    load_flax_params(tm16, params)

    def stream(pipe):
        return np.stack([pipe.infer_video_depth_one(f) for f in frames])

    ref = stream(JStream(jm, params, input_size=SIZE))
    vdn16 = stream(JStream(jm16, params, input_size=SIZE))
    port16 = stream(VideoDepthStreamPipeline(tm16, input_size=SIZE))
    rel = lambda a: np.linalg.norm(a - ref) / np.linalg.norm(ref)
    assert np.isfinite(port16).all()
    assert rel(port16) <= 2 * rel(vdn16), (rel(port16), rel(vdn16))
