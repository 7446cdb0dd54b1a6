"""The port's data layer, master config, metric logger, device prefetch and
visualization against vdn's, on the CPU.

Every comparison is bit-equal (both packages decode with cv2 and crop,
resize and split with the same numpy calls):

- items of each of the seven sequence dataset classes, written in its
  directory layout with cv2 here, with random crops from a seed, once
  cropped straight to the output and once through the pre-resize (frames
  smaller than the output);
- items of the three metric datasets (Hypersim from the committed h5
  fixture, VKITTI2, KITTI) in train mode (random square crop) and val;
- ``create_datasets``' splits from a YAML config and from its ``.json``
  twin, ``WeightedSampler``'s draws per (seed, epoch), ``BatchLoader``'s
  batches with random crops over two epochs (one worker each: the crop
  generator is shared by the loader's threads, so with several the order
  of the draws follows the threads);
- the master config overlay (``configs/config.yaml`` and a ``.json`` twin)
  through ``parse_with_master_config`` for both trainer families, and the
  dead v1 -> dino switch's error;
- ``MetricWriter``'s records, E### numbering and resume by name;
- ``prefetch_to_device`` on the CPU yields the loader's batches unchanged,
  and ``create_sample_visualizations`` draws vdn's grid (Agg).
"""

import argparse
import json
import os
import struct

import numpy as np
import pytest
import torch

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
HW = (20, 28)                      # the frames written
SIZES = {"crop": (16, 20), "upscale": (24, 36)}
SEED = 3


def _rgb(rng, hw=HW):
    return rng.integers(0, 255, (*hw, 3), np.uint8)


def _u16(rng, hw=HW, low=1):
    return rng.integers(low, 60000, hw).astype(np.uint16)


def _write_dpt(path, arr):
    with open(path, "wb") as f:
        f.write(struct.pack("<f", 202021.25)
                + struct.pack("<ii", arr.shape[1], arr.shape[0])
                + arr.astype(np.float32).tobytes())


def _mk(path):
    os.makedirs(path, exist_ok=True)
    return path


def _sintel(root, rng):
    import cv2
    for scene in ("alley", "cave"):
        dirs = {s: _mk(os.path.join(root, s, scene))
                for s in ("rgb", "depth", "depth_anything_v2")}
        for i in range(5):
            cv2.imwrite(os.path.join(dirs["rgb"], f"f{i}.png"), _rgb(rng))
            _write_dpt(os.path.join(dirs["depth"], f"f{i}.dpt"),
                       rng.random(HW).astype(np.float32) * 10 + 0.1)
            cv2.imwrite(os.path.join(dirs["depth_anything_v2"], f"f{i}.png"),
                        _u16(rng))
    return {}


def _pointodyssey(root, rng):
    import cv2
    for sub, scene in (("train", "s1"), ("test", "s2")):
        base = os.path.join(root, sub, scene)
        dirs = {s: _mk(os.path.join(base, s)) for s in
                ("rgbs", "depths", "depth_anything_v2", "masks")}
        for i in range(4):
            cv2.imwrite(os.path.join(dirs["rgbs"], f"rgb_{i}.jpg"),
                        _rgb(rng))
            d = _u16(rng, low=0)
            d[0, :3] = 0
            cv2.imwrite(os.path.join(dirs["depths"], f"depth_{i}.png"), d)
            cv2.imwrite(os.path.join(dirs["depth_anything_v2"],
                                     f"da_{i}.png"), _u16(rng))
            cv2.imwrite(os.path.join(dirs["masks"], f"mask_{i}.png"),
                        (rng.random(HW) > 0.2).astype(np.uint16) * 255)
    return {}


def _tartanair(root, rng):
    import cv2
    for env in ("EnvA", "EnvB"):
        base = os.path.join(root, env, "Data_easy", "P000")
        dirs = {s: _mk(os.path.join(base, f"{s}_left")) for s in
                ("image", "depth", "depth_anything_v2")}
        for i in range(4):
            cv2.imwrite(os.path.join(dirs["image"], f"{i}.png"), _rgb(rng))
            depth = (rng.random(HW) * 20 + 0.5).astype(np.float32)
            cv2.imwrite(os.path.join(dirs["depth"], f"{i}.png"),
                        depth[..., None].view(np.uint8))
            cv2.imwrite(os.path.join(dirs["depth_anything_v2"], f"{i}.png"),
                        _u16(rng))
    return {"difficulties": ["easy"]}


def _vkitti(root, rng):
    import cv2
    for var in ("clone", "fog"):
        base = os.path.join(root, "Scene01", var, "frames")
        dirs = {s: _mk(os.path.join(base, s, "Camera_0")) for s in
                ("rgb", "depth", "depth_anything_v2")}
        for i in range(4):
            cv2.imwrite(os.path.join(dirs["rgb"], f"rgb_{i:05d}.jpg"),
                        _rgb(rng))
            d = _u16(rng, low=0)
            d[1, :4] = 0
            cv2.imwrite(os.path.join(dirs["depth"], f"depth_{i:05d}.png"), d)
            cv2.imwrite(os.path.join(dirs["depth_anything_v2"],
                                     f"da_{i:05d}.png"), _u16(rng))
    return {}


def _nyuv2(root, rng):
    import cv2
    for scene in ("bedroom", "office"):
        dirs = {s: _mk(os.path.join(root, s, scene))
                for s in ("rgb", "depth", "depth_anything_v2")}
        for i in range(4):
            cv2.imwrite(os.path.join(dirs["rgb"], f"{i}.jpg"), _rgb(rng))
            d = (rng.random(HW) * 5).astype(np.float32)
            d[2, :5] = 0
            np.save(os.path.join(dirs["depth"], f"{i}.npy"), d.T)
            cv2.imwrite(os.path.join(dirs["depth_anything_v2"], f"{i}.png"),
                        _u16(rng))
    return {}


def _bonn(root, rng):
    import cv2
    scene = os.path.join(root, "balloon")
    for s in ("rgb", "depth", "depth_anything_v2"):
        _mk(os.path.join(scene, s))
    rgb_lines, depth_lines = ["# timestamp filename"], []
    for i in range(5):
        cv2.imwrite(os.path.join(scene, "rgb", f"{i}.png"), _rgb(rng))
        cv2.imwrite(os.path.join(scene, "depth", f"{i}.png"),
                    _u16(rng, low=0))
        cv2.imwrite(os.path.join(scene, "depth_anything_v2", f"{i}.png"),
                    _u16(rng))
        rgb_lines.append(f"{i * 0.1:.4f} rgb/{i}.png")
        depth_lines.append(f"{i * 0.1 + 0.01:.4f} depth/{i}.png")
    with open(os.path.join(scene, "rgb.txt"), "w") as f:
        f.write("\n".join(rgb_lines) + "\n")
    with open(os.path.join(scene, "depth.txt"), "w") as f:
        f.write("\n".join(depth_lines) + "\n")
    return {}


def _da2k(root, rng):
    import cv2
    for sub in ("indoor", "outdoor"):
        rgb = _mk(os.path.join(root, "rgb", sub))
        da = _mk(os.path.join(root, "depth_anything_v2", sub))
        for i in range(2):
            cv2.imwrite(os.path.join(rgb, f"{i}.jpg"), _rgb(rng))
            cv2.imwrite(os.path.join(da, f"{i}.png"), _u16(rng))
    return {}


# class -> (layout writer, sequence length, stride)
LAYOUTS = {"SintelDataset": (_sintel, 3, 1),
           "PointOdysseyDataset": (_pointodyssey, 2, 2),
           "TartanAirDataset": (_tartanair, 2, 1),
           "VKittiDataset": (_vkitti, 3, 1),
           "NYUv2Dataset": (_nyuv2, 2, 1),
           "BonnDataset": (_bonn, 2, 2),
           "DA2KDataset": (_da2k, 1, 1)}
TYPES = ["rgb", "depth", "depth_anything_v2", "mask"]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("layouts")
    out = {}
    for i, (name, (write, _, _)) in enumerate(LAYOUTS.items()):
        root = str(base / name)
        os.makedirs(root)
        out[name] = (root, write(root, np.random.default_rng(i)))
    return out


def assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_sequence_dataset_items_equal_vdn(roots, name, size):
    """Every item of the class, random crops drawn in order from one seed,
    bit-equal to vdn's."""
    import vdn.data.datasets as jd
    import vdn_torch.data.datasets as td
    root, extra = roots[name]
    _, seq, stride = LAYOUTS[name]
    kw = dict(root_dir=root, data_types=TYPES, sequence_length=seq,
              sequence_stride=stride, output_size=SIZES[size],
              use_random_crop=True, seed=SEED, **extra)
    want = jd.DATASET_REGISTRY[name](**kw)
    got = td.DATASET_REGISTRY[name](**kw)
    assert len(got) == len(want) >= 2
    for i in range(len(want)):
        w, g = want[i], got[i]
        assert w["rgb"].shape[1:3] == SIZES[size]
        assert_items_equal(g, w)


def test_read_dpt_and_windows_equal_vdn():
    from vdn.data.base import make_windows as jwin
    from vdn.data.base import read_dpt_file as jread
    from vdn_torch.data.base import make_windows, read_dpt_file
    path = os.path.join(FIX, "sintel.dpt")
    np.testing.assert_array_equal(read_dpt_file(path), jread(path))
    files = {"rgb": [f"r{i}" for i in range(7)],
             "depth": [f"d{i}" for i in range(6)]}
    for seq, stride in ((2, 1), (3, 2), (7, 1)):
        assert make_windows(files, seq, stride) == jwin(files, seq, stride)


@pytest.fixture(scope="module")
def metric_lists(tmp_path_factory):
    """File lists of the three metric datasets: Hypersim on the committed
    768 x 1024 distance fixture, VKITTI2 and KITTI on uint16 PNGs."""
    import cv2
    root = tmp_path_factory.mktemp("metric")
    rng = np.random.default_rng(11)
    img_big = str(root / "big.jpg")
    cv2.imwrite(img_big, rng.integers(0, 255, (768, 1024, 3), np.uint8))
    lists = {}
    hyp = [f"{img_big} {os.path.join(FIX, 'hypersim_dist.h5')}"] * 2
    vk, ki = [], []
    for i in range(2):
        img = str(root / f"img{i}.png")
        cv2.imwrite(img, rng.integers(0, 255, (30, 44, 3), np.uint8))
        d = str(root / f"vk{i}.png")
        cv2.imwrite(d, rng.integers(0, 12000, (30, 44)).astype(np.uint16))
        k = str(root / f"ki{i}.png")
        dk = rng.integers(0, 20000, (30, 44)).astype(np.uint16)
        dk[:3] = 0
        cv2.imwrite(k, dk)
        vk.append(f"{img} {d}")
        ki.append(f"{img} {k}")
    for name, lines in (("Hypersim", hyp), ("VKITTI2", vk), ("KITTI", ki)):
        path = root / f"{name}.txt"
        path.write_text("\n".join(lines) + "\n")
        lists[name] = str(path)
    return lists


@pytest.mark.parametrize("mode", ["train", "val"])
@pytest.mark.parametrize("name", ["Hypersim", "VKITTI2", "KITTI"])
def test_metric_dataset_items_equal_vdn(metric_lists, name, mode):
    """Each item (lower-bound resize to a multiple of 14, ImageNet norm, in
    train mode the depth resized and a random square crop) bit-equal to
    vdn's."""
    import vdn.data.metric_datasets as jm
    import vdn_torch.data.metric_datasets as tm
    if name == "KITTI" and mode == "train":
        for mod in (jm, tm):
            with pytest.raises(NotImplementedError):
                mod.KITTI(metric_lists[name], "train")
        return
    kw = dict(size=(28, 28), seed=SEED)
    want = getattr(jm, name)(metric_lists[name], mode, **kw)
    got = getattr(tm, name)(metric_lists[name], mode, **kw)
    assert len(got) == len(want) == 2
    for i in range(2):
        assert_items_equal(got[i], want[i])


def test_hypersim_distance_to_depth_equal_vdn():
    import h5py
    from vdn.data.metric_datasets import hypersim_distance_to_depth as jh
    from vdn_torch.data.metric_datasets import hypersim_distance_to_depth
    with h5py.File(os.path.join(FIX, "hypersim_dist.h5"), "r") as f:
        dist = np.array(f["dataset"])
    np.testing.assert_array_equal(hypersim_distance_to_depth(dist), jh(dist))


def _factory_config(roots, tmp_path, random_crop=True):
    """A two-dataset factory config (Sintel, VKitti) as YAML and as its
    .json twin."""
    import yaml
    cfg = {"dataset_common": {"sequence_length": 2, "sequence_stride": 1,
                              "output_size": list(SIZES["crop"]),
                              "use_random_crop": random_crop,
                              "ignored_key": 1},
           "datasets": {"Sintel": {"train_split": 0.6, "data_types": TYPES,
                                   "params": {"root_dir":
                                              roots["SintelDataset"][0]}},
                        "VKitti": {"train_split": 0.5, "data_types": TYPES,
                                   "sequence_stride": 2,
                                   "params": {"root_dir":
                                              roots["VKittiDataset"][0]}}}}
    y, j = tmp_path / "factory.yaml", tmp_path / "factory.json"
    y.write_text(yaml.safe_dump(cfg))
    j.write_text(json.dumps(cfg))
    return str(y), str(j)


def test_create_datasets_splits_equal_vdn(roots, tmp_path):
    """The train / val splits (indices, lengths, the first item of each)
    from YAML and from the .json twin, equal to vdn's from the YAML."""
    from vdn.data.factory import create_datasets as jcreate
    from vdn_torch.data.factory import create_datasets
    y, j = _factory_config(roots, tmp_path)
    names = ["Sintel", "VKitti"]
    for split in ("train", "val"):
        for path in (y, j):
            want = jcreate(names, y, split, 5)
            got = create_datasets(names, path, split, 5)
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                assert g.indices == w.indices
                assert g.dataset.use_random_crop == (split == "train")
                assert_items_equal(g[0], w[0])


def test_weighted_sampler_draws_equal_vdn(roots, tmp_path):
    from vdn.data.factory import ConcatDataset as JConcat
    from vdn.data.factory import WeightedSampler as JSampler
    from vdn.data.factory import create_datasets as jcreate
    from vdn_torch.data.factory import (ConcatDataset, WeightedSampler,
                                        create_datasets)
    y, _ = _factory_config(roots, tmp_path)
    want = JSampler(JConcat(jcreate(["Sintel", "VKitti"], y)), seed=9)
    got = WeightedSampler(ConcatDataset(create_datasets(["Sintel", "VKitti"],
                                                        y)), seed=9)
    for epoch in (0, 1, 5, None, None, 1):
        np.testing.assert_array_equal(got.sample(11, epoch),
                                      want.sample(11, epoch))


@pytest.mark.parametrize("sampled", [True, False])
def test_batch_loader_batches_equal_vdn(roots, tmp_path, sampled):
    """Two epochs of batches (random crops; the weighted sampler, or a
    seeded shuffle) with set_epoch, drop-last, one worker each."""
    import vdn.data.factory as jf
    import vdn_torch.data.factory as tf
    y, _ = _factory_config(roots, tmp_path)

    def loader(mod):
        concat = mod.ConcatDataset(mod.create_datasets(["Sintel", "VKitti"],
                                                       y))
        sampler = mod.WeightedSampler(concat, seed=4) if sampled else None
        return mod.BatchLoader(concat, 2, sampler=sampler,
                               shuffle=not sampled, num_workers=1, seed=4)

    want, got = loader(jf), loader(tf)
    assert len(got) == len(want) >= 2
    for epoch in (0, 1):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        wb, gb = list(want), list(got)
        assert len(gb) == len(wb) == len(want)
        for g, w in zip(gb, wb):
            assert_items_equal(g, w)


def test_prefetch_to_device_yields_loader_batches(roots, tmp_path):
    """On the CPU each array comes back as a tensor with the array's
    values and dtype, the path lists as they were."""
    from vdn_torch.data.factory import (BatchLoader, ConcatDataset,
                                        create_datasets, prefetch_to_device)
    y, _ = _factory_config(roots, tmp_path, random_crop=False)
    loader = BatchLoader(ConcatDataset(create_datasets(["Sintel"], y)), 2,
                         num_workers=2)
    host = list(loader)
    dev = list(prefetch_to_device(loader, size=2, device="cpu"))
    assert len(dev) == len(host) >= 1
    for h, d in zip(host, dev):
        assert sorted(h) == sorted(d)
        for k, v in h.items():
            if isinstance(v, np.ndarray):
                assert isinstance(d[k], torch.Tensor)
                assert d[k].device.type == "cpu"
                np.testing.assert_array_equal(d[k].numpy(), v)
            else:
                assert d[k] == v


def test_prefetch_to_device_cuda_without_card_raises(monkeypatch):
    """A CUDA target with no card raises at the first batch (no quiet
    host fallback)."""
    from vdn_torch.data.factory import prefetch_to_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    it = prefetch_to_device([{"x": np.zeros(3, np.float32)}],
                            device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        next(it)


CONFIG = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                      "configs", "config.yaml")


def _vdn_args(cli, argv, monkeypatch):
    """The args vdn's CLI ``cli`` parses from ``argv`` (its main stops at
    the parse)."""
    import importlib

    import vdn.cli._common as common
    seen = {}
    parse = common.parse_with_master_config

    class Parsed(Exception):
        pass

    def capture(parser, argv, family):
        seen["args"] = parse(parser, argv, family)
        raise Parsed

    monkeypatch.setattr(common, "parse_with_master_config", capture)
    with pytest.raises(Parsed):
        importlib.import_module(f"vdn.cli.{cli}").main(argv)
    monkeypatch.setattr(common, "parse_with_master_config", parse)
    return vars(seen["args"])


@pytest.mark.parametrize("cli,family", [("train", "refine"),
                                        ("train_v1", "v1")])
def test_master_config_args_equal_vdn(cli, family, tmp_path, monkeypatch):
    """``--config configs/config.yaml`` (and its .json twin, which vdn
    reads with yaml.safe_load) with and without explicit flags: the port's
    parsed args are vdn's, less the port's ``--device``."""
    import importlib

    import yaml

    from vdn_torch.cli._common import parse_with_master_config
    twin = tmp_path / "config.json"
    with open(CONFIG) as f:
        twin.write_text(json.dumps(yaml.safe_load(f)))
    parser = importlib.import_module(f"vdn_torch.cli.{cli}").build_parser
    for path in (CONFIG, str(twin)):
        for extra in ([], ["--batch-size", "3", "--seed", "7",
                           "--datasets", "Sintel"]):
            argv = ["--config", path, *extra]
            want = _vdn_args(cli, argv, monkeypatch)
            got = vars(parse_with_master_config(parser(), argv, family))
            assert got.pop("device") == "cuda"
            assert got == want
            assert got["dataset_config"] == path


def test_master_config_dead_v1_raises(tmp_path):
    """model.version 'v1' (the dead dino switch) raises for the v1 family
    in both packages; an unknown family raises."""
    from vdn.core.config import overlay_args as joverlay
    from vdn_torch.core.config import load_master_config, overlay_args
    path = tmp_path / "dead.json"
    path.write_text(json.dumps({"model": {"version": "v1"}}))
    cfg = load_master_config(str(path))
    for overlay in (overlay_args, joverlay):
        with pytest.raises(ValueError, match="dead"):
            overlay(argparse.ArgumentParser(), cfg, "v1", [])
        with pytest.raises(ValueError, match="family"):
            overlay(argparse.ArgumentParser(), cfg, "other", [])


def _writer_session(mod, log_dir, capsys):
    """The same sequence of runs through ``mod.MetricWriter``: two new
    runs, a resume of the latest, a resume by name, a resume of an
    unknown name; returns (names, the printed lines)."""
    names = []
    plan = [dict(), dict(run_name="exp-b"), dict(resume=True),
            dict(run_name="E001", resume=True),
            dict(run_name="nope", resume=True)]
    for i, kw in enumerate(plan):
        w = mod.MetricWriter(str(log_dir), **kw)
        w.add_metrics({"loss": 0.5 + i, "step_ms": np.float32(3.25)})
        w.add_images({"vis": ["a.png"]})
        w.send_log(step=i + 1)
        w.add_metrics({"epoch": i + 1})
        w.send_log(step=i + 2)
        w.finish()
        names.append(w.run_name)
    return names, capsys.readouterr().out


def test_metric_writer_equal_vdn(tmp_path, capsys):
    """Run names (E### numbering, resume by name and latest), the runs
    file (less its times) and every JSON-lines record equal vdn's."""
    import vdn.utils.logging as jl
    import vdn_torch.utils.logging as tl
    want = _writer_session(jl, tmp_path / "vdn", capsys)
    got = _writer_session(tl, tmp_path / "port", capsys)
    assert got == want
    assert want[0] == ["E001", "exp-b", "E001", "E001", "nope"]

    def runs(d):
        with open(d / "runs.json") as f:
            return [{k: v for k, v in r.items() if k != "time"}
                    for r in json.load(f)]
    assert runs(tmp_path / "port") == runs(tmp_path / "vdn")
    files = sorted(os.listdir(tmp_path / "vdn"))
    assert sorted(os.listdir(tmp_path / "port")) == files
    for name in files:
        if name == "runs.json":   # compared above, less the times
            continue
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "vdn" / name).read_text()), name


def test_visualization_equal_vdn(roots, tmp_path):
    """The 6-row grid of two Sintel samples (matplotlib Agg) has vdn's
    pixels; the forward may return a tensor."""
    import cv2

    from vdn.data.datasets import SintelDataset
    from vdn.utils.visualization import \
        create_sample_visualizations as jvis
    from vdn_torch.utils.visualization import create_sample_visualizations
    ds = SintelDataset(roots["SintelDataset"][0], data_types=TYPES,
                       sequence_length=2, output_size=SIZES["crop"])

    def fwd(x):
        return x * 0.9 + 100.0

    want = jvis(fwd, ds, [0, 1], str(tmp_path / "vdn"))
    got = create_sample_visualizations(
        lambda x: torch.from_numpy(fwd(x)), ds, [0, 1],
        str(tmp_path / "port"))
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == ["sample_000.png",
                                                "sample_001.png"]
    for g, w in zip(got, want):
        gi, wi = cv2.imread(g), cv2.imread(w)
        assert gi is not None and gi.shape == wi.shape
        np.testing.assert_array_equal(gi, wi)
