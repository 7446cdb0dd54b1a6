"""The port's single-image CLI (``run``) against vdn's, on the CPU
(``--device cpu``), and the no-fallback rule of every model CLI.

One ``.pth`` per model, written with ``torch.save(model.state_dict())``
from the port's seeded vits (cut to 4 blocks in both packages,
tests/_torch_cli.py); vdn's CLIs read the same file through their own
loader and converter.  Input size 56.

- ``run``: two images of a directory through one pipeline, so the memory
  bank carries from the first to the second.  fp32: the depths at rtol
  1e-4, atol 1e-4 of the depth's scale (tests/test_torch_slice.py), and
  ``--pred-only --grayscale`` PNGs within 1 grey level.  bf16: within twice
  vdn's own bf16-vs-fp32 rel L2 (two bf16 paths that round at the same
  points but sum in another order are two draws of one rounding noise;
  chip_smoke's gate).
- Without ``--device cpu`` every model CLI raises the builder's
  RuntimeError here: no CLI looks for a card and quietly takes the CPU.
- ``depth_to_pointcloud`` and ``save_ply``: equal to vdn's.
"""

import numpy as np
import pytest
import torch

from tests._torch_cli import (assert_fp32_close, ckpts, images,  # noqa: F401
                              img_dir, rel_l2)

torch.set_num_threads(2)

SIZE = 56


def _read_png(path):
    import cv2
    return cv2.imread(str(path), cv2.IMREAD_UNCHANGED).astype(np.int64)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_run_cli_matches_vdn(ckpts, img_dir, tmp_path, dtype):
    from vdn.cli.run import build_pipeline as vdn_build
    from vdn.cli.run import main as vdn_main
    from vdn_torch.cli.run import build_pipeline, main
    imgs = images(img_dir)
    pipe = build_pipeline("vits", ckpts["image"], dtype, device="cpu")
    vpipe = vdn_build("vits", ckpts["image"], dtype)
    got = [pipe.infer_image(im, SIZE) for im in imgs]
    want = [vpipe.infer_image(im, SIZE) for im in imgs]
    # the bank reaches the second image
    pipe.clear_memory()
    assert rel_l2(got[1], pipe.infer_image(imgs[1], SIZE)) > 1e-2
    if dtype == "fp32":
        for g, w in zip(got, want):
            assert g.shape == w.shape
            assert_fp32_close(g, w)
        argv = ["--img-path", str(img_dir), "--encoder", "vits",
                "--checkpoint", ckpts["image"], "--input-size", str(SIZE),
                "--pred-only", "--grayscale", "--compute-dtype", "fp32"]
        vdn_main(argv + ["--outdir", str(tmp_path / "vdn")])
        main(argv + ["--outdir", str(tmp_path / "port"), "--device", "cpu"])
        for name, im in zip(("a.png", "b.png"), imgs):
            g = _read_png(tmp_path / "port" / name)
            w = _read_png(tmp_path / "vdn" / name)
            assert g.shape == w.shape == im.shape
            assert np.abs(g - w).max() <= 1, name
        return
    vpipe32 = vdn_build("vits", ckpts["image"], "fp32")
    for im, g, w in zip(imgs, got, want):
        noise = rel_l2(vpipe32.infer_image(im, SIZE), w)
        assert rel_l2(w, g) <= 2 * noise, (rel_l2(w, g), noise)


@pytest.mark.parametrize("cli", ["run", "run_video", "run_metric",
                                 "pointcloud", "app", "eval_da2k"])
def test_cli_without_device_cpu_raises(cli, tmp_path, monkeypatch):
    """``--device`` defaults to cuda; with no card the builder raises and
    no CLI falls back to the CPU."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ckpt = str(tmp_path / "absent.pth")
    argv = {"run": ["--img-path", str(tmp_path), "--checkpoint", ckpt],
            "run_video": ["--video-path", "absent.mp4", "--checkpoint", ckpt],
            "run_metric": ["--img-path", str(tmp_path), "--load-from", ckpt],
            "pointcloud": ["--img-path", str(tmp_path), "--load-from", ckpt],
            "app": ["--checkpoint", ckpt, "--port", "0"],
            "eval_da2k": ["--benchmark-root", str(tmp_path),
                          "--checkpoint", ckpt]}[cli]
    main = importlib.import_module(f"vdn_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + ["--encoder", "vits"])


def test_pointcloud_helpers_match_vdn(tmp_path):
    from vdn.utils.pointcloud import depth_to_pointcloud as vdn_points
    from vdn.utils.pointcloud import save_ply as vdn_save
    from vdn_torch.utils.pointcloud import depth_to_pointcloud, save_ply
    rng = np.random.default_rng(5)
    depth = rng.uniform(-1, 5, (12, 17)).astype(np.float32)
    rgb = rng.integers(0, 255, (12, 17, 3), np.uint8)
    for colors in (None, rgb):
        want = vdn_points(depth, 300.0, 320.0, colors)
        got = depth_to_pointcloud(depth, 300.0, 320.0, colors)
        np.testing.assert_array_equal(got[0], want[0])
        if colors is not None:
            np.testing.assert_array_equal(got[1], want[1])
        vdn_save(str(tmp_path / "v.ply"), *want)
        save_ply(str(tmp_path / "t.ply"), *got)
        assert ((tmp_path / "t.ply").read_bytes()
                == (tmp_path / "v.ply").read_bytes())
