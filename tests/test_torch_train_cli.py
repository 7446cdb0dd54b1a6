"""The port's refinement training and evaluation CLIs (``train``,
``evaluate``) against vdn's, on the CPU (``--device cpu``, fp32).

One ``.pth`` of the port's seeded RefineVideoDepth v4 vits (cut to 4
blocks in both packages, tests/_torch_cli.py; the zero-initialized shift
/ scale convs and the motion modules' proj_out given small random weights
so that every part of the model reaches the loss), on a Sintel-layout
fixture at 28 px (two scenes of 8 frames, windows of 2 frames every 4,
half of them validation; XLA's compile of vdn's step grows steeply with
the frames), through a ``.json`` dataset config (vdn reads it with
yaml.safe_load: JSON is YAML).  Each vdn CLI runs once per module.

- ``train --from-pretrained`` for 2 epochs of 2 steps: every logged
  ``training/*`` and ``validation/*`` mean within rtol 1e-4 of vdn's (two
  fp32 implementations summing in another order, as the earlier port
  tests state it);
- the port's resume: 1 epoch, then ``--resume`` to 2, equals a straight
  2-epoch run bit for bit: the logged records, the saved model, AdamW's
  moments and the scheduler;
- ``evaluate``: the printed metrics within rtol 1e-4 (``--model-name
  dav2``, which scores the input maps and runs no model: 1e-12; the
  protocol's resize sits within 4.3e-16 of vdn's cv2);
- without ``--device cpu`` the CLIs raise: no fallback to the CPU.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch

from tests._torch_cli import short_vits

torch.set_num_threads(2)

RTOL = 1e-4
SIZE = 28


def write_sintel(root, rng, hw=(40, 56), scenes=("scene_a", "scene_b"),
                 frames=8):
    """Sintel's layout: rgb PNGs, .dpt depths, uint16 depth_anything_v2."""
    import cv2
    for scene in scenes:
        for sub in ("rgb", "depth", "depth_anything_v2"):
            os.makedirs(root / sub / scene, exist_ok=True)
        yy, xx = np.mgrid[0:hw[0], 0:hw[1]] / float(max(hw))
        for i in range(frames):
            base = np.sin(3 * xx + 2 * yy + 0.3 * i) * 0.5 + 0.5
            rgb = np.stack([base, 1 - base, base ** 2], -1) * 255
            rgb = rgb + rng.normal(0, 8, rgb.shape)
            cv2.imwrite(str(root / "rgb" / scene / f"f_{i:04d}.png"),
                        rgb.clip(0, 255).astype(np.uint8))
            depth = (1.0 + 9.0 * base + rng.random(hw) * 0.5).astype(
                np.float32)
            with open(root / "depth" / scene / f"f_{i:04d}.dpt", "wb") as f:
                f.write(struct.pack("<f", 202021.25)
                        + struct.pack("<ii", hw[1], hw[0]) + depth.tobytes())
            da = 60000.0 / depth * (1 + 0.05 * rng.standard_normal(hw))
            cv2.imwrite(str(root / "depth_anything_v2" / scene
                            / f"f_{i:04d}.png"),
                        da.clip(0, 65535).astype(np.uint16))


def sintel_config(path, root, seq_len=2, stride=4, size=SIZE):
    types = ["rgb", "depth", "depth_anything_v2", "mask"]
    cfg = {"dataset_common": {"sequence_length": seq_len,
                              "sequence_stride": stride,
                              "output_size": [size, size],
                              "use_random_crop": False},
           "datasets": {"Sintel": {"train_split": 0.5, "data_types": types,
                                   "params": {"root_dir": str(root)}}}}
    path.write_text(json.dumps(cfg))
    return str(path)


def save_refine_model(path) -> None:
    from vdn_torch.models.refine import build_refine_video_depth
    gen = torch.Generator().manual_seed(5)
    model = build_refine_video_depth(4, "vits", device="cpu", generator=gen)
    with torch.no_grad():
        for conv in (model.shift_head[0], model.scale_head.feat[1]):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              * 0.5)
        for mm in model.temporal_head.motion_modules:
            w = mm.temporal_transformer.proj_out.weight
            w.copy_(torch.randn(w.shape, generator=gen) * 0.5
                    * w.shape[1] ** -0.5)
    torch.save(model.state_dict(), str(path))


def read_log(log_dir):
    """The JSON-lines records of the one run under ``log_dir``."""
    names = [n for n in os.listdir(log_dir) if n.endswith(".metrics.jsonl")]
    assert len(names) == 1, names
    with open(os.path.join(log_dir, names[0])) as f:
        return [json.loads(line) for line in f]


def assert_records_close(got, want, rtol=RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The fixture data, its config and the .pth, with vits cut to 4
    blocks while the module's tests run."""
    root = tmp_path_factory.mktemp("train_cli")
    write_sintel(root / "sintel", np.random.default_rng(0))
    with short_vits():
        pth = root / "refine_v4_vits.pth"
        save_refine_model(pth)
        yield {"root": root, "pth": str(pth),
               "config": sintel_config(root / "cfg.json", root / "sintel")}


def train_argv(setup, out, epochs, *extra):
    return ["--dataset-config", setup["config"], "--datasets", "Sintel",
            "--encoder", "vits", "--model-version", "4",
            "--from-pretrained", setup["pth"], "--batch-size", "1",
            "--compute-dtype", "fp32", "--epochs", str(epochs),
            "--initial-lr", "1e-4", "--stable-scale", "1.0",
            "--checkpoint-dir", str(out / "ckpts"),
            "--log-dir", str(out / "logs"), *extra]


@pytest.fixture(scope="module")
def straight(setup):
    """The port's straight 2-epoch run."""
    from vdn_torch.cli.train import main
    out = setup["root"] / "port_straight"
    main(train_argv(setup, out, 2, "--device", "cpu"))
    return out


def test_train_cli_matches_vdn(setup, straight):
    """Two epochs of 2 steps from the same .pth: the logged training and
    validation means of each epoch within rtol 1e-4 of vdn's."""
    from vdn.cli.train import main as vdn_main
    out = setup["root"] / "vdn"
    vdn_main(train_argv(setup, out, 2))
    want = read_log(out / "logs")
    got = read_log(straight / "logs")
    assert [r["epoch"] for r in got] == [1.0, 2.0]
    assert "training/total_loss" in got[0]
    assert "validation/total_loss" in got[1]
    assert_records_close(got, want)


def test_train_cli_resume_is_bit_equal(setup, straight):
    """1 epoch, then --resume to 2: the records, and the model, AdamW and
    scheduler states saved at epoch 2, equal the straight run's."""
    from vdn_torch.cli.train import main
    out = setup["root"] / "port_resumed"
    main(train_argv(setup, out, 1, "--device", "cpu"))
    main(train_argv(setup, out, 2, "--device", "cpu", "--resume"))
    assert read_log(out / "logs") == read_log(straight / "logs")
    a = torch.load(straight / "ckpts" / "refine_v4" / "2.pt",
                   weights_only=True)
    b = torch.load(out / "ckpts" / "refine_v4" / "2.pt", weights_only=True)
    assert a["epoch"] == b["epoch"] == 2
    assert a["scheduler"] == b["scheduler"]
    assert sorted(a["model"]) == sorted(b["model"])
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    assert sorted(sa) == sorted(sb) and len(sa) >= 50
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    # the frozen temporal head is the .pth's
    pth = torch.load(setup["pth"], weights_only=True)
    k = "temporal_head.scratch.output_conv2.0.weight"
    assert torch.equal(a["model"][k], pth[k])


@pytest.mark.parametrize("name,extra", [("ours", ["--double-refine"]),
                                        ("dav2", [])])
def test_evaluate_cli_matches_vdn(setup, capsys, name, extra):
    """The printed metrics and frame count; TPF is a time and only
    printed."""
    from vdn.cli.evaluate import main as vdn_main
    from vdn_torch.cli.evaluate import main
    argv = ["--dataset-config", setup["config"], "--datasets", "Sintel",
            "--encoder", "vits", "--checkpoint", setup["pth"],
            "--compute-dtype", "fp32", "--model-name", name, *extra]
    vdn_main(argv)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    main(argv + ["--device", "cpu"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["frames"] == want["frames"] == 4
    assert sorted(got) == sorted(want)
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w,
                                   rtol=RTOL if name == "ours" else 1e-12,
                                   err_msg=k)


@pytest.mark.parametrize("cli", ["train", "evaluate", "train_v1",
                                 "train_metric"])
def test_training_cli_without_device_cpu_raises(cli, setup, tmp_path,
                                                monkeypatch):
    """``--device`` defaults to cuda; with no card the model's builder
    raises and no CLI falls back to the CPU."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lst = tmp_path / "list.txt"
    lst.write_text("")
    argv = {"train": train_argv(setup, tmp_path, 1),
            "evaluate": ["--dataset-config", setup["config"],
                         "--checkpoint", setup["pth"], "--encoder", "vits"],
            "train_v1": ["--dataset-config", setup["config"],
                         "--epochs", "1", "--log-dir", str(tmp_path),
                         "--checkpoint-dir", str(tmp_path)],
            "train_metric": ["--train-list", str(lst), "--dataset",
                             "vkitti2", "--log-dir", str(tmp_path),
                             "--checkpoint-dir", str(tmp_path)]}[cli]
    main = importlib.import_module(f"vdn_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)


def test_train_checkpointer_keeps_the_newest(tmp_path):
    """``TrainCheckpointer``: after five saves with max_to_keep 2 the files
    of steps 4 and 5 remain; ``restore_latest`` loads step 5's model,
    AdamW and LambdaLR into fresh ones and returns its epoch (None with no
    file); ``save_pytree`` / ``restore_pytree`` round-trip a module."""
    from vdn_torch.core.checkpoint import (TrainCheckpointer, restore_pytree,
                                           save_pytree)

    def make():
        torch.manual_seed(0)
        model = torch.nn.Linear(3, 2)
        opt = torch.optim.AdamW(model.parameters(), lr=1e-2)
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 0.5 ** s)
        return model, opt, sched

    ckpt = TrainCheckpointer(str(tmp_path / "run"), max_to_keep=2)
    assert ckpt.latest_step() is None
    assert ckpt.restore_latest(*make()) is None
    model, opt, sched = make()
    for step in range(1, 6):
        model(torch.ones(4, 3)).sum().backward()
        opt.step()
        sched.step()
        ckpt.save(step, {"model": model, "optimizer": opt,
                         "scheduler": sched, "epoch": 10 + step})
    ckpt.close()
    assert ckpt.steps() == [4, 5] and ckpt.latest_step() == 5
    fresh = make()
    assert TrainCheckpointer(str(tmp_path / "run")).restore_latest(
        *fresh) == 15
    for k, v in model.state_dict().items():
        assert torch.equal(fresh[0].state_dict()[k], v), k
    assert fresh[2].state_dict() == sched.state_dict()
    assert fresh[1].param_groups[0]["lr"] == opt.param_groups[0]["lr"]
    for p, q in zip(model.parameters(), fresh[0].parameters()):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opt.state[p][k], fresh[1].state[q][k])
    save_pytree(str(tmp_path / "w.pth"), model)
    other = make()[0]
    with torch.no_grad():
        other.weight.zero_()
    assert restore_pytree(str(tmp_path / "w.pth"), other) is other
    assert torch.equal(other.weight, model.weight)
    assert sorted(restore_pytree(str(tmp_path / "w.pth"))) == sorted(
        model.state_dict())
