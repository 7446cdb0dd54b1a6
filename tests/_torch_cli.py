"""Shared pieces of the port's CLI tests (tests/test_torch_cli*.py).

vits is cut to its first 4 blocks in both packages (the DPT head reads
blocks 0-3), as tests/test_torch_train.py's ``_short_vits`` does, for CPU
time: vdn's compiles grow with the depth, the per-block math does not
change.  The weights are the port's seeded initializers, saved with
``torch.save(model.state_dict())``; vdn's CLIs read the same file through
their own loader and converter.
"""

import contextlib

import numpy as np
import pytest
import torch

SEED = 0


@contextlib.contextmanager
def short_vits():
    import vdn.nn.vit as jvit
    import vdn_torch.nn.vit as tvit
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jvit, tvit):
            mp.setitem(mod.VIT_CONFIGS, "vits",
                       {**mod.VIT_CONFIGS["vits"], "depth": 4})
            mp.setitem(mod.INTERMEDIATE_LAYER_IDX, "vits", [0, 1, 2, 3])
        yield


def save_image_model(path) -> None:
    """DepthAnythingV2 vits.  With the stock initial values the bank hardly
    reaches the depth (CXBlock.gamma 1e-6, 0.02-normal embeddings), so
    gamma is set to 1 and the embeddings to 0.5-normal, as chip_smoke's
    image model."""
    from vdn_torch.models.depth_anything_v2 import build_depth_anything_v2
    gen = torch.Generator().manual_seed(SEED)
    model = build_depth_anything_v2("vits", device="cpu", generator=gen)
    block = model.memory_block
    with torch.no_grad():
        for layer in block.memory_encoder.fuser.layers:
            layer.gamma.fill_(1.0)
        for p in (block.curr_pos_enc, block.maskmem_tpos_enc,
                  block.no_mem_embed):
            p.copy_(torch.randn(p.shape, generator=gen) * 0.5)
    torch.save(model.state_dict(), str(path))


def save_video_model(path) -> None:
    """VideoDepthAnything vits with nonzero motion-module proj_out (zero
    at init), so the temporal blocks reach the depth."""
    from vdn_torch.models.video_depth_anything import \
        build_video_depth_anything
    gen = torch.Generator().manual_seed(SEED + 1)
    model = build_video_depth_anything("vits", device="cpu", generator=gen)
    with torch.no_grad():
        for mm in model.head.motion_modules:
            w = mm.temporal_transformer.proj_out.weight
            w.copy_(torch.randn(w.shape, generator=gen)
                    * 0.5 * w.shape[1] ** -0.5)
    torch.save(model.state_dict(), str(path))


def save_metric_model(path) -> None:
    from vdn_torch.models.metric_depth import build_metric_depth_anything_v2
    model = build_metric_depth_anything_v2(
        "vits", device="cpu", generator=torch.Generator().manual_seed(
            SEED + 2))
    torch.save(model.state_dict(), str(path))


def assert_fp32_close(got, want):
    """tests/test_torch_slice.py's tolerance: rtol 1e-4 and atol 1e-4 of
    the output's scale (two fp32 implementations summing in another
    order)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(a))


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The image and metric models' .pth files, with vits cut to 4 blocks
    while the module's tests run."""
    root = tmp_path_factory.mktemp("cli_ckpts")
    with short_vits():
        paths = {"image": root / "da2_vits.pth",
                 "metric": root / "metric_vits.pth"}
        save_image_model(paths["image"])
        save_metric_model(paths["metric"])
        yield {k: str(v) for k, v in paths.items()}


@pytest.fixture(scope="module")
def img_dir(tmp_path_factory):
    """Two 60 x 80 images; sorted, a.png comes first."""
    import cv2
    root = tmp_path_factory.mktemp("cli_imgs")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:60, 0:80]
    for i, name in enumerate(("a.png", "b.png")):
        base = 120 + 80 * np.sin(xx / 9.0 + yy / 13.0 + i)
        img = base[..., None] + rng.normal(0, 12, (60, 80, 3))
        cv2.imwrite(str(root / name), img.clip(0, 255).astype(np.uint8))
    return root


def images(img_dir):
    import cv2
    return [cv2.imread(str(img_dir / n)) for n in ("a.png", "b.png")]
