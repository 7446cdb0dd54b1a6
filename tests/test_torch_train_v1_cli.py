"""The port's v1 training CLI (``train_v1``) against vdn's, on the CPU
(``--device cpu``, fp32 as vdn trains v1).

vdn's CLI draws its weights from JAX's PRNG (``model.init(PRNGKey(seed),
...)`` on the first training item), so this test keeps the params vdn's
run drew (``captured_init``) and carries them into the port's model with
``load_flax_params`` (the head's parameters that flax never creates keep
the port's seeded values: no forward reads them), then drives the port
CLI's ``train`` on the CLI's own loaders.  vdn's CPU configuration
(``hiera_test``, 64 px, 2 frames, the head's attention on level 3 only, as
tests/test_torch_v1_train.py runs it: XLA's compile of the training step
grows with the stacks), a Sintel-layout fixture through a ``.json``
dataset config, batch 1, 2 epochs of 2 steps at LR 1e-6.  Tolerance:
every logged ``training/*`` and ``validation/*`` mean within rtol 1e-4 of
vdn's (two fp32 implementations summing in another order; at the recipe's
1e-4 Adam's first steps move a near-zero gradient's parameter by +-lr
whatever its sign noise, tests/test_torch_v1_train.py, and the median-based
losses after two epochs sit ~2e-3 apart).  The saved checkpoints of
each epoch hold the model, AdamW, the scheduler and the epoch.
"""

import contextlib

import numpy as np
import pytest
import torch

from tests.test_torch_train_cli import (assert_records_close, read_log,
                                        sintel_config, write_sintel)

torch.set_num_threads(2)

SIZE = 64


@contextlib.contextmanager
def captured_init(cls):
    """``cls.init`` jitted (vdn's CLIs call it eagerly, which compiles
    every primitive on its own: minutes on the CPU), its params kept in
    the yielded dict as numpy.  The draws are the same function of the
    key; the parity tolerance covers any rounding of the init's
    transcendentals under fusion."""
    import flax.linen as nn
    import jax
    out = {}

    def init(self, rngs, *args, **kw):
        params = jax.jit(lambda r, *a: nn.Module.init(self, r, *a, **kw))(
            rngs, *args)
        out["params"] = jax.tree.map(np.asarray, params)
        return params

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "init", init)
        yield out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_v1_cli")
    write_sintel(root / "sintel", np.random.default_rng(1), hw=(72, 80),
                 frames=4)
    config = sintel_config(root / "cfg.json", root / "sintel", seq_len=2,
                           stride=2, size=SIZE)
    return {"root": root, "config": config}


def argv(setup, out):
    return ["--dataset-config", setup["config"], "--datasets", "Sintel",
            "--encoder", "hiera_test", "--sequence-length", "2",
            "--attention-levels", "3", "--batch-size", "1", "--epochs", "2",
            "--initial-lr", "1e-6", "--normal-loss-scale", "0.5",
            "--stable-scale", "1.0", "--seed", "3",
            "--checkpoint-dir", str(out / "ckpts"),
            "--log-dir", str(out / "logs")]


def test_train_v1_cli_matches_vdn(setup):
    from vdn.cli.train_v1 import main as vdn_main
    from vdn.models.video_depth_v1 import VideoDepthEstimationModel as JV1
    from vdn_torch.cli import train_v1
    from vdn_torch.cli._common import parse_with_master_config
    from vdn_torch.cli.train import build_loaders
    from vdn_torch.core.convert import load_flax_params
    vdn_out, out = setup["root"] / "vdn", setup["root"] / "port"
    with captured_init(JV1) as params:
        vdn_main(argv(setup, vdn_out))
    want = read_log(vdn_out / "logs")

    args = parse_with_master_config(train_v1.build_parser(),
                                    argv(setup, out) + ["--device", "cpu"],
                                    "v1")
    _, *loaders = build_loaders(args.datasets, args.dataset_config,
                                args.batch_size, args.seed)
    model = train_v1.build_model(args)
    unset = load_flax_params(model, params["params"])
    assert unset and all(k.startswith("head.") for k in unset)
    got = train_v1.train(args, model, loaders)
    assert [r["epoch"] for r in got] == [1, 2]
    assert "training/normal_loss" in got[0]
    assert "validation/total_loss" in got[1]
    assert_records_close(read_log(out / "logs"), want)
    state = torch.load(out / "ckpts" / "video_depth_normal_v1" / "2.pt",
                       weights_only=True)
    assert state["epoch"] == 2 and state["optimizer"]["state"]
    assert state["scheduler"]["last_epoch"] == 4

