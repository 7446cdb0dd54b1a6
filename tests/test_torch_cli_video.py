"""The port's video CLI (``run_video``) and video IO against vdn's, on the
CPU (``--device cpu``).

The ``.pth`` is ``torch.save(model.state_dict())`` of the port's seeded
VideoDepthAnything vits (cut to 4 blocks in both packages, motion modules'
proj_out nonzero; tests/_torch_cli.py); vdn's CLI reads the same file
through its own loader and converter.  The clip is 34 frames of 64 x 64
written as mp4 (two windows and a stitch at input size 56).

- cached clip, and ``--streaming --chunk-size 4`` over 10 frames: the
  ``_depths.npy`` at rtol 1e-4, atol 1e-4 of the depth's scale
  (tests/test_torch_slice.py), in fp32;
- ``--int8`` / ``--int8-dynamic`` (``VDN_FORCE_INT8``: the int8 path at any
  size on the CPU), clip and stream: the CLI's depths equal the port's own
  pipeline called directly on the same decoded frames, bit for bit
  (tests/test_torch_int8.py holds that pipeline against vdn);
- ``read_video_frames`` (``--max-len``, ``--target-fps``, ``--max-res``),
  ``colorize_depth`` and ``save_video``: equal to vdn's.
"""

import cv2
import numpy as np
import pytest
import torch

from tests._torch_cli import assert_fp32_close, save_video_model, short_vits

torch.set_num_threads(2)

SIZE = 56
N_FRAMES = 34


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli_video") / "vda_vits.pth"
    with short_vits():
        save_video_model(path)
        yield str(path)


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """34 frames of a drifting grating + noise, 64 x 64 at 8 fps."""
    path = str(tmp_path_factory.mktemp("cli_clip") / "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8,
                             (64, 64))
    rng = np.random.default_rng(1)
    xx = np.mgrid[0:64, 0:64][1]
    for i in range(N_FRAMES):
        img = 127 + 60 * np.sin(xx / 7 + i / 5)[..., None] + rng.normal(
            0, 10, (64, 64, 3))
        writer.write(img.clip(0, 255).astype(np.uint8))
    writer.release()
    return path


def _argv(ckpt, video, outdir, extra=()):
    return ["--video-path", video, "--encoder", "vits", "--checkpoint", ckpt,
            "--input-size", str(SIZE), "--outdir", str(outdir), *extra]


@pytest.mark.parametrize("mode", ["clip", "stream"])
def test_run_video_cli_matches_vdn(ckpt, video, tmp_path, mode):
    from vdn.cli.run_video import main as vdn_main
    from vdn_torch.cli.run_video import main
    extra = ["--compute-dtype", "fp32"] + (
        ["--streaming", "--chunk-size", "4", "--max-len", "10"]
        if mode == "stream" else [])
    vdn_main(_argv(ckpt, video, tmp_path / "vdn", extra))
    main(_argv(ckpt, video, tmp_path / "port", extra + ["--device", "cpu"]))
    n = N_FRAMES if mode == "clip" else 10
    want = np.load(tmp_path / "vdn" / "clip_depths.npy")
    got = np.load(tmp_path / "port" / "clip_depths.npy")
    assert got.shape == want.shape == (n, 64, 64)
    assert want.std() > 0 and (want > 0).mean() > 0.1
    assert_fp32_close(got, want)
    for name in ("clip_src.mp4", "clip_vis.mp4"):
        cap = cv2.VideoCapture(str(tmp_path / "port" / name))
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == n, name
        cap.release()


@pytest.mark.parametrize("mode", ["clip", "stream"])
@pytest.mark.parametrize("flag", ["--int8", "--int8-dynamic"])
def test_run_video_int8_cli_equals_pipeline(ckpt, video, tmp_path,
                                            monkeypatch, flag, mode):
    from vdn_torch.cli.run_video import build_model, infer_frames, main
    from vdn_torch.pipelines.infer_video import infer_video_depth
    from vdn_torch.pipelines.stream import VideoDepthStreamPipeline
    from vdn_torch.utils.video_io import read_video_frames
    monkeypatch.setenv("VDN_FORCE_INT8", "1")
    stream = ["--streaming", "--chunk-size", "4", "--max-len", "10"]
    main(_argv(ckpt, video, tmp_path, [flag, "--device", "cpu"]
               + (stream if mode == "stream" else [])))
    got = np.load(tmp_path / "clip_depths.npy")

    quantize = "int8_static" if flag == "--int8" else "int8"
    model = build_model("vits", ckpt, "bf16", quantize, device="cpu")
    assert model.quantize == quantize
    frames, fps = read_video_frames(video, 10 if mode == "stream" else -1)
    if mode == "clip":
        want, _ = infer_video_depth(model, frames, fps, SIZE)
    else:
        pipe = VideoDepthStreamPipeline(model, SIZE)
        want = np.stack([d for i in range(0, len(frames), 4)
                         for d in pipe.infer_video_depth_chunk(
                             list(frames[i:i + 4]))])
    np.testing.assert_array_equal(got, want)
    # the CLI's device function gives the same from a fresh model
    again, _ = infer_frames(build_model("vits", ckpt, "bf16", quantize,
                                        device="cpu"),
                            frames, fps, SIZE, mode == "stream", 4)
    np.testing.assert_array_equal(again, want)


@pytest.mark.parametrize("max_len,target_fps,max_res", [
    (-1, -1, -1), (12, 4, -1), (-1, -1, 48), (5, 3, 40)])
def test_read_video_frames_matches_vdn(video, max_len, target_fps, max_res):
    from vdn.utils.video_io import read_video_frames as vdn_read
    from vdn_torch.utils.video_io import read_video_frames
    want, want_fps = vdn_read(video, max_len, target_fps, max_res)
    got, got_fps = read_video_frames(video, max_len, target_fps, max_res)
    assert got_fps == want_fps
    np.testing.assert_array_equal(got, want)


def test_colorize_and_save_video_match_vdn(tmp_path):
    from vdn.utils.video_io import colorize_depth as vdn_colorize
    from vdn.utils.video_io import save_video as vdn_save
    from vdn_torch.utils.video_io import colorize_depth, save_video
    depths = np.random.default_rng(2).uniform(0, 3, (3, 32, 48)).astype(
        np.float32)
    for cmap, gray in (("inferno", False), ("Spectral_r", False),
                       ("inferno", True)):
        np.testing.assert_array_equal(
            colorize_depth(depths[0], cmap, gray),
            vdn_colorize(depths[0], cmap, gray))
    for gray in (False, True):
        outs = []
        for save, name in ((vdn_save, "v.mp4"), (save_video, "t.mp4")):
            save(depths, str(tmp_path / name), fps=5, is_depths=True,
                 grayscale=gray)
            cap = cv2.VideoCapture(str(tmp_path / name))
            frames = []
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(frame)
            cap.release()
            outs.append(np.stack(frames))
        assert outs[0].shape == (3, 32, 48, 3)
        np.testing.assert_array_equal(outs[1], outs[0])
