"""The port's metric-depth, point-cloud, demo and DA-2K CLIs against
vdn's, on the CPU (``--device cpu``).

The ``.pth`` files are tests/test_torch_cli.py's (tests/_torch_cli.py):
the port's seeded vits, cut to 4 blocks in both packages.  Input size 56.

- ``run_metric --save-numpy`` and ``pointcloud``: the ``.npy`` and the
  ``.ply`` points at rtol 1e-4, atol 1e-4 of the output's scale, the
  colours equal.
- ``app``: both demos served in the background on port 0 with the same
  ``.pth``, one PNG posted to each.  With both builders set to fp32, gray
  and raw16 within 1 level; as shipped (bf16), the port's answer equals
  its own pipeline's, and its gray sits within twice the gray spread of
  vdn's bf16 demo from its fp32 one (bf16 alone moves the gray by up to 4
  levels here, in vdn as in the port).
- ``eval_da2k``: a synthetic DA-2K root (tests/test_eval_extras.py's
  layout) gives the same JSON as vdn's to 1e-5 relative.
"""

import base64
import json
import os
import urllib.request

import cv2
import numpy as np
import torch

from tests._torch_cli import (assert_fp32_close, ckpts, images,  # noqa: F401
                              img_dir)

torch.set_num_threads(2)

SIZE = 56


def _ply_points(path):
    with open(path) as f:
        lines = f.read().splitlines()
    n = int(next(ln for ln in lines if ln.startswith("element vertex"))
            .split()[-1])
    body = np.array([ln.split() for ln in
                     lines[lines.index("end_header") + 1:]], np.float64)
    assert body.shape[0] == n
    return body[:, :3], body[:, 3:].astype(np.int64)


def test_run_metric_and_pointcloud_cli_match_vdn(ckpts, img_dir, tmp_path):
    from vdn.cli.pointcloud import main as vdn_pointcloud
    from vdn.cli.run_metric import main as vdn_metric
    from vdn_torch.cli.pointcloud import main as pointcloud
    from vdn_torch.cli.run_metric import main as metric
    argv = ["--img-path", str(img_dir), "--encoder", "vits",
            "--load-from", ckpts["metric"], "--input-size", str(SIZE),
            "--compute-dtype", "fp32", "--max-depth", "20"]
    vdn_metric(argv + ["--save-numpy", "--outdir", str(tmp_path / "vm")])
    metric(argv + ["--save-numpy", "--outdir", str(tmp_path / "tm"),
                   "--device", "cpu"])
    vdn_pointcloud(argv + ["--outdir", str(tmp_path / "vp")])
    pointcloud(argv + ["--outdir", str(tmp_path / "tp"), "--device", "cpu"])
    for stem in ("a", "b"):
        want = np.load(tmp_path / "vm" / f"{stem}_raw_depth_meter.npy")
        got = np.load(tmp_path / "tm" / f"{stem}_raw_depth_meter.npy")
        assert got.shape == want.shape and 0 < want.min() < want.max() < 20
        assert_fp32_close(got, want)
        assert (tmp_path / "tm" / f"{stem}.png").exists()
        want_xyz, want_rgb = _ply_points(tmp_path / "vp" / f"{stem}.ply")
        got_xyz, got_rgb = _ply_points(tmp_path / "tp" / f"{stem}.ply")
        assert got_xyz.shape == want_xyz.shape == (want.size, 3)
        assert_fp32_close(got_xyz, want_xyz)
        np.testing.assert_array_equal(got_rgb, want_rgb)


def _post(server, png: bytes) -> dict:
    port = server.server_address[1]
    page = urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                  timeout=60).read()
    assert b"Compute Depth" in page
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=png, method="POST")
    out = json.loads(urllib.request.urlopen(req, timeout=300).read())
    assert set(out) == {"input", "colored", "gray", "raw16"}
    return {k: cv2.imdecode(np.frombuffer(base64.b64decode(v), np.uint8),
                            cv2.IMREAD_UNCHANGED).astype(np.int64)
            for k, v in out.items()}


def _serve_both(ckpt, png):
    from vdn.cli.app import build_pipeline as vdn_build
    from vdn.cli.app import serve as vdn_serve
    from vdn_torch.cli.app import build_pipeline, serve
    out = []
    for start in (lambda: vdn_serve(vdn_build("vits", ckpt, SIZE), port=0,
                                    background=True),
                  lambda: serve(build_pipeline("vits", ckpt, SIZE,
                                               device="cpu"),
                                port=0, background=True)):
        server = start()
        try:
            out.append(_post(server, png))
        finally:
            server.shutdown()
            server.server_close()
    return out


def test_app_matches_vdn(ckpts, img_dir, monkeypatch):
    import jax.numpy as jnp

    import vdn.models.depth_anything_v2 as vdn_models
    import vdn_torch.models.depth_anything_v2 as port_models
    from vdn_torch.core.checkpoint import load_checkpoint
    from vdn_torch.pipelines.infer_image import DepthAnythingV2Pipeline
    png = (img_dir / "a.png").read_bytes()
    shape = images(img_dir)[0].shape
    want16, got16 = _serve_both(ckpts["image"], png)
    for out in (want16, got16):
        assert out["input"].shape == out["colored"].shape == shape
        assert out["gray"].shape == out["raw16"].shape == shape[:2]

    # the port's demo answers with its own bf16 pipeline's depth
    model = port_models.build_depth_anything_v2("vits", "bf16", "cpu")
    load_checkpoint(model, ckpts["image"])
    depth = DepthAnythingV2Pipeline(model).infer_image(images(img_dir)[0],
                                                       SIZE)
    norm = (depth - depth.min()) / max(float(depth.max() - depth.min()),
                                       1e-8) * 255.0
    np.testing.assert_array_equal(got16["gray"], norm.astype(np.uint8))
    np.testing.assert_array_equal(got16["raw16"], depth.astype(np.uint16))

    # both demos in fp32
    vdn_build, port_build = (vdn_models.build_depth_anything_v2,
                             port_models.build_depth_anything_v2)
    monkeypatch.setattr(vdn_models, "build_depth_anything_v2",
                        lambda enc, **kw: vdn_build(
                            enc, **{**kw, "compute_dtype": jnp.float32}))
    monkeypatch.setattr(port_models, "build_depth_anything_v2",
                        lambda enc, **kw: port_build(
                            enc, **{**kw, "compute_dtype": "fp32"}))
    want32, got32 = _serve_both(ckpts["image"], png)
    for key in ("gray", "raw16"):
        assert np.abs(got32[key] - want32[key]).max() <= 1, key
    np.testing.assert_array_equal(got32["input"], want32["input"])
    spread = np.abs(want16["gray"] - want32["gray"]).max()
    assert np.abs(got16["gray"] - want16["gray"]).max() <= 2 * max(spread, 1)


def test_eval_da2k_cli_matches_vdn(ckpts, tmp_path, capsys):
    from vdn.cli.eval_da2k import main as vdn_main
    from vdn_torch.cli.eval_da2k import main
    rng = np.random.default_rng(4)
    ann = {}
    for scene, name, hw in (("indoor", "a.jpg", (60, 80)),
                            ("outdoor", "b.png", (56, 70))):
        os.makedirs(tmp_path / "images" / scene, exist_ok=True)
        cv2.imwrite(str(tmp_path / "images" / scene / name),
                    rng.integers(0, 255, hw + (3,), np.uint8))
        pts = rng.integers(0, 56, (6, 2, 2))
        ann[f"images/{scene}/{name}"] = [
            {"point1": p1.tolist(), "point2": p2.tolist(),
             "closer_point": ("point1", "point2")[i % 2]}
            for i, (p1, p2) in enumerate(pts)]
    (tmp_path / "annotations.json").write_text(json.dumps(ann))
    argv = ["--benchmark-root", str(tmp_path), "--encoder", "vits",
            "--checkpoint", ckpts["image"], "--input-size", str(SIZE),
            "--compute-dtype", "fp32"]
    for extra in ([], ["--scene-type", "outdoor"]):
        vdn_main(argv + extra)
        want = json.loads(capsys.readouterr().out.splitlines()[-1])
        main(argv + extra + ["--device", "cpu"])
        got = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert want["num_pairs"] == 6


