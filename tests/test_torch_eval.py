"""The port's eval suite and checkpoint loader against vdn's, on the CPU.

- ``vdn_torch.eval.metrics``: every metric of ``EVAL_METRICS`` on the same
  masked sequence (a frame with no valid pixel included) to 1e-6 relative:
  the same numpy code in fp64.
- ``vdn_torch.eval.protocol.eval_sequence``: both domains, with and without
  a mask, the prediction smaller and larger than the GT, to 1e-5 relative
  (the port resizes with ``F.interpolate``, vdn with ``cv2.resize``: the
  same bilinear taps, summed in another order).
- ``eval_depthcrafter``'s CLI over a CSV of ``.npy`` / ``.npz`` rows: the
  same JSON lines as vdn's, to 1e-5 relative.
- ``evaluate_da2k`` on the synthetic DA-2K root of tests/test_eval_extras.py
  (ties included): the same dict as vdn's.
- ``vdn_torch.core.checkpoint``: the wrappers, fp16 / bf16 tensors and the
  skip keys give vdn's arrays (its reader, then its converter's skip and
  fp32 rules); ``load_checkpoint`` loads a module's own state_dict exactly
  and raises on a missing or an extra key.
"""

import contextlib
import io
import json
import os

import cv2
import numpy as np
import pytest
import torch

from vdn.core.checkpoint import load_torch_checkpoint as vdn_load
from vdn.core.convert import DEFAULT_SKIP as VDN_SKIP
from vdn.eval import metrics as vdn_metrics
from vdn.eval.protocol import eval_sequence as vdn_eval_sequence
from vdn_torch.core.checkpoint import (DEFAULT_SKIP, load_checkpoint,
                                       load_torch_checkpoint)
from vdn_torch.eval import metrics
from vdn_torch.eval.protocol import eval_sequence


def _rel_close(got: dict, want: dict, rtol: float):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0,
                                   err_msg=k)


def _sequence(rng, t=5, h=24, w=32):
    gt = rng.uniform(0.5, 60.0, (t, h, w))
    pred = gt * rng.uniform(0.8, 1.25, (t, h, w))
    mask = rng.random((t, h, w)) > 0.3
    mask[2] = False                     # a frame with no valid pixel
    return pred, gt, mask


@pytest.mark.parametrize("name", list(metrics.EVAL_METRICS))
def test_metric_matches_vdn(name):
    pred, gt, mask = _sequence(np.random.default_rng(0))
    want = vdn_metrics.compute_metrics(pred, gt, mask, [name])
    got = metrics.compute_metrics(pred, gt, mask, [name])
    _rel_close(got, want, 1e-6)
    np.testing.assert_array_equal(metrics.depth2disparity(gt * mask),
                                  vdn_metrics.depth2disparity(gt * mask))


@pytest.mark.parametrize("pred_hw", [(12, 20), (40, 44)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("domain", ["depth", "disp"])
def test_eval_sequence_matches_vdn(domain, masked, pred_hw):
    """The prediction smaller (upsampled) and larger (downsampled, no
    antialiasing) than the 24 x 32 GT."""
    rng = np.random.default_rng(1)
    _, gt, mask = _sequence(rng)
    pred = rng.uniform(0.02, 2.0, (gt.shape[0],) + pred_hw).astype(
        np.float32)
    kw = dict(seq_len=4, domain=domain, dataset_max_depth=50.0,
              mask=mask if masked else None)
    want = vdn_eval_sequence(pred, gt.astype(np.float32), **kw)
    got = eval_sequence(pred, gt.astype(np.float32), **kw)
    _rel_close(got, want, 1e-5)


def _run_cli(main, argv) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def test_eval_depthcrafter_cli_matches_vdn(tmp_path):
    from vdn.cli.eval_depthcrafter import main as vdn_main
    from vdn_torch.cli.eval_depthcrafter import main
    rng = np.random.default_rng(2)
    rows = []
    for i, (hw, ext) in enumerate([((10, 16), ".npy"), ((30, 36), ".npz")]):
        _, gt, mask = _sequence(rng, t=4)
        pred = rng.uniform(0.02, 2.0, (4,) + hw).astype(np.float32)
        paths = [str(tmp_path / f"{n}{i}{ext}") for n in ("p", "g", "m")]
        for path, arr in zip(paths, (pred, gt, mask)):
            if ext == ".npz":
                np.savez(path, arr)
            else:
                np.save(path, arr)
        rows.append(",".join(paths if i else paths[:2]))
    csv_path = tmp_path / "rows.csv"
    csv_path.write_text("# pred,gt,mask\n" + "\n".join(rows) + "\n")
    argv = ["--csv", str(csv_path), "--seq-len", "3", "--max-depth", "40"]
    want, got = _run_cli(vdn_main, argv), _run_cli(main, argv)
    assert len(got) == len(want) == 3
    for g, w in zip(got[:2], want[:2]):
        assert g.pop("pred") == w.pop("pred")
        _rel_close(g, w, 1e-5)
    assert got[2]["sequences"] == want[2]["sequences"] == 2
    _rel_close(got[2]["mean"], want[2]["mean"], 1e-5)


def test_evaluate_da2k_matches_vdn(tmp_path):
    """tests/test_eval_extras.py's synthetic root, with a second scene and
    a tied pair (``>`` picks point1, so a tie counts as point2)."""
    from vdn.eval.da2k import evaluate_da2k as vdn_da2k
    from vdn_torch.eval.da2k import evaluate_da2k
    rng = np.random.default_rng(0)
    ann = {}
    for scene, name in (("indoor", "a.jpg"), ("outdoor", "b.png")):
        os.makedirs(tmp_path / "images" / scene, exist_ok=True)
        cv2.imwrite(str(tmp_path / "images" / scene / name),
                    rng.integers(0, 255, (32, 32, 3), np.uint8))
        ann[f"images/{scene}/{name}"] = [
            {"point1": [5, 5], "point2": [20, 20], "closer_point": "point1"},
            {"point1": [10, 10], "point2": [25, 25],
             "closer_point": "point2"},
            {"point1": [3, 9], "point2": [9, 3], "closer_point": "point2"},
        ]
    (tmp_path / "annotations.json").write_text(json.dumps(ann))

    def infer(raw):
        h, w = raw.shape[:2]
        yy, xx = np.mgrid[0:h, 0:w]
        return (2 * h - yy - xx).astype(np.float32)

    for scene in (None, "outdoor"):
        want = vdn_da2k(str(tmp_path), infer, scene)
        assert evaluate_da2k(str(tmp_path), infer, scene) == want
    assert want["num_pairs"] == 3 and want["accuracy"] == 2 / 3


# ------------------------------------------------------------- checkpoints
def _state(rng):
    return {
        "blocks.0.attn.qkv.weight": torch.from_numpy(
            rng.standard_normal((6, 4)).astype(np.float32)),
        "blocks.0.norm1.weight": torch.from_numpy(
            rng.standard_normal(4)).to(torch.float16),
        "head.conv.bias": torch.from_numpy(
            rng.standard_normal(3)).to(torch.bfloat16),
        "pos_embed": torch.from_numpy(rng.standard_normal((1, 5, 4))),
        "head.motion_modules.0.pos_encoder.pe": torch.zeros(1, 8, 4),
        "bn.running_mean": torch.ones(3),
        "bn.num_batches_tracked": torch.tensor(7),
        "index_table": torch.arange(6).reshape(2, 3),
    }


@pytest.mark.parametrize("wrapper", [None, "model", "state_dict", "module"])
def test_load_torch_checkpoint_matches_vdn(tmp_path, wrapper):
    """The same arrays as vdn's reader followed by its converter's skip
    rules and fp32 cast (vdn/core/convert.py:40-43, :103-104)."""
    import re
    state = _state(np.random.default_rng(3))
    obj = state if wrapper is None else {wrapper: state, "epoch": 3,
                                         "note": "not a tensor"}
    path = str(tmp_path / "ckpt.pth")
    torch.save(obj, path)
    skip = [re.compile(p) for p in VDN_SKIP]
    want = {}
    for k, v in vdn_load(path).items():
        if not any(p.search(k) for p in skip):
            want[k] = (v.astype(np.float32)
                       if np.issubdtype(v.dtype, np.floating) else v)
    got = load_torch_checkpoint(path)
    assert tuple(DEFAULT_SKIP) == tuple(VDN_SKIP)
    assert set(got) == set(want) == {
        k for k in state if not k.endswith((".pe", "num_batches_tracked"))}
    for k, v in want.items():
        assert got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(4, 3)
        self.pos = torch.nn.Module()
        self.pos.register_buffer("pe", torch.arange(4.0))


@pytest.mark.parametrize("fault", [None, "missing", "extra"])
def test_load_checkpoint_strict(tmp_path, fault):
    """A module's own state_dict loads exactly (its ``pe`` buffer, which
    the loader drops, keeps the module's value); a missing or an extra
    key raises, naming it."""
    src, dst = _Tiny(), _Tiny()
    with torch.no_grad():
        dst.proj.weight.zero_()
    state = dict(src.state_dict())
    if fault == "missing":
        del state["proj.bias"]
    elif fault == "extra":
        state["proj.scale"] = torch.ones(3)
    path = str(tmp_path / "tiny.pth")
    torch.save(state, path)
    if fault is None:
        load_checkpoint(dst, path)
        for k, v in src.state_dict().items():
            assert torch.equal(dst.state_dict()[k], v), k
        return
    with pytest.raises(KeyError, match="proj.bias" if fault == "missing"
                       else "proj.scale"):
        load_checkpoint(dst, path)


def test_load_checkpoint_rename(tmp_path):
    """``rename`` rewrites each key before the check; None drops it."""
    src, dst = _Tiny(), _Tiny()
    state = {"old." + k: v for k, v in src.state_dict().items()}
    state["old.unused"] = torch.ones(1)
    path = str(tmp_path / "renamed.pth")
    torch.save({"model": state}, path)
    load_checkpoint(dst, path, rename=lambda k: (
        None if k == "old.unused" else k.replace("old.", "", 1)))
    assert torch.equal(dst.proj.weight, src.proj.weight)
