"""The port's metric-depth training CLI (``train_metric``) against vdn's, on
the CPU (``--device cpu``, fp32).

vdn's CLI draws its weights from JAX's PRNG on the first training item;
this test keeps the params vdn's run drew (``captured_init``) and carries
them into the port's model with ``load_flax_params``, then drives the port
CLI's ``train`` on its own datasets, after drawing the same first item
(the draw advances the random-crop generator, as vdn's does), both
loaders with one worker (``one_worker``).  VKITTI2's
file-list contract (uint16 PNG depth in cm, 30 x 44 images), vits cut to 4
blocks in both packages (tests/_torch_cli.py), 28 px, batch 2, 2 epochs of
2 steps at LR 1e-6, a val list whose GT stays at 30 x 44 (the prediction
is resized to it on the device).  Tolerance: the logged ``train/loss`` and
every ``val/*`` metric within rtol 1e-4 of vdn's (two fp32
implementations summing in another order); the weights saved each epoch
under vdn's name stem.
"""

import functools
import os

import numpy as np
import pytest
import torch

from tests._torch_cli import short_vits
from tests.test_torch_train_cli import assert_records_close, read_log
from tests.test_torch_train_v1_cli import captured_init

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lists(tmp_path_factory):
    import cv2
    root = tmp_path_factory.mktemp("train_metric_cli")
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:30, 0:44] / 44.0
    lines = []
    for i in range(6):
        base = np.sin(4 * xx + 3 * yy + i) * 0.5 + 0.5
        img = np.stack([base, 1 - base, base ** 2], -1) * 255
        img = img + rng.normal(0, 10, img.shape)
        ip, dp = str(root / f"img{i}.png"), str(root / f"depth{i}.png")
        cv2.imwrite(ip, img.clip(0, 255).astype(np.uint8))
        depth = 150 + 1500 * base + rng.random(base.shape) * 100
        depth[0, :5] = 9000     # beyond 80 m: invalid
        cv2.imwrite(dp, depth.astype(np.uint16))
        lines.append(f"{ip} {dp}")
    train, val = root / "train.txt", root / "val.txt"
    train.write_text("\n".join(lines[:4]) + "\n")
    val.write_text("\n".join(lines[4:]) + "\n")
    return {"root": root, "train": str(train), "val": str(val)}


def argv(lists, out):
    return ["--dataset", "vkitti2", "--train-list", lists["train"],
            "--val-list", lists["val"], "--encoder", "vits",
            "--img-size", "28", "--epochs", "2", "--batch-size", "2",
            "--lr", "1e-6", "--max-depth", "20", "--seed", "5",
            "--compute-dtype", "fp32", "--run-name", "metric",
            "--checkpoint-dir", str(out / "ckpts"),
            "--log-dir", str(out / "logs")]


def one_worker(mp, *modules):
    """Each module's BatchLoader with one worker: the loader's threads
    share the dataset's random-crop generator, so with several the order
    of the draws follows the threads (in vdn's loader as in the port's)."""
    for mod in modules:
        mp.setattr(mod, "BatchLoader",
                   functools.partial(mod.BatchLoader, num_workers=1))


def test_train_metric_cli_matches_vdn(lists):
    import vdn.data.factory as jf
    import vdn_torch.data.factory as tf
    from vdn.cli.train_metric import main as vdn_main
    from vdn.models.metric_depth import MetricDepthAnythingV2 as JMetric
    from vdn_torch.cli import train_metric
    from vdn_torch.core.convert import load_flax_params
    vdn_out, out = lists["root"] / "vdn", lists["root"] / "port"
    with short_vits(), pytest.MonkeyPatch.context() as mp:
        one_worker(mp, jf, tf)
        with captured_init(JMetric) as params:
            vdn_main(argv(lists, vdn_out))
        want = read_log(vdn_out / "logs")
        args = train_metric.build_parser().parse_args(
            argv(lists, out) + ["--device", "cpu"])
        datasets = train_metric.build_datasets(args)
        datasets[0][0]        # vdn's init sample
        model = train_metric.build_model(args)
        # refinenet4's first residual unit: no forward reads it
        assert all("refinenet4.resConfUnit1" in k for k in load_flax_params(
            model, params["params"]))
        got = train_metric.train(args, model, datasets)
    assert [r["epoch"] for r in got] == [1, 2]
    assert {"train/loss", "val/d1", "val/abs_rel", "val/silog"} <= set(got[0])
    assert_records_close(read_log(out / "logs"), want)
    saved = sorted(os.listdir(out / "ckpts"))
    assert saved == [f"metric_metric_vits_epoch_{n}.pth" for n in (1, 2)]
    assert sorted(n + ".pth" for n in os.listdir(vdn_out / "ckpts")) == saved
    state = torch.load(out / "ckpts" / saved[-1], weights_only=True)
    for k, v in model.state_dict().items():
        assert torch.equal(state[k], v), k
