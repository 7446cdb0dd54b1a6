"""The v1 research model and its trainer in the port against vdn on the
CPU: VideoDepthEstimationModel in both feature layouts and two V1Trainer
steps (the kernels and modules of the slice: tests/test_torch_v1.py).

vdn's own CPU configuration (``hiera_test``, 64 px, 2 frames; the head's
attention on level 3 only, as vdn's tests/test_trainer.py runs it: XLA's
compile of the training step grows with the stacks, a minute at one
level).  One set of weights, drawn with numpy from a seed in vdn's flax
layout, goes to both packages through ``state_dict_from_flax``.  fp32.
Tolerances:

- the model: rtol 1e-4, atol 1e-4 of the output's scale, as the earlier
  port tests state them;
- the trainer: losses 1e-4 relative per step; step 1's gradients, read
  from both optimizers' first moments ((1 - beta1) g after one step),
  1e-4 relative L2 over every tensor together; the parameters after n
  AdamW steps within 2 lr n (Adam's first updates are about +-lr where |g|
  >> eps, so sign noise on a near-zero gradient moves a parameter by up
  to 2 lr per step); the parameters no forward reads (decay only) to
  1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_v1 import _close, _pair, _v1_inputs, _v1_models
from vdn.core.convert import convert_torch_state
from vdn_torch.core.convert import state_dict_from_flax

torch.set_num_threads(2)

LEVELS = (3,)


@pytest.mark.parametrize("scrambled", [True, False])
def test_video_depth_v1_matches_vdn(scrambled):
    """VideoDepthEstimationModel (hiera_test, 64 px, 2 frames) with the
    reference's scrambled feature layout and the consistent NHWC one."""
    jm, tm = _v1_models(2, scrambled_layout=scrambled,
                        attention_feature_levels=LEVELS)
    rng = np.random.default_rng(7)
    depth, img = _v1_inputs(rng, 1, 2)
    params = _pair(jm, tm, rng, depth, img)
    jd, jn = jax.jit(jm.apply)(params, depth, img)
    with torch.no_grad():
        td, tn = tm(torch.from_numpy(depth), torch.from_numpy(img))
    assert td.shape == (1, 2, 64, 64) and tn.shape == (1, 2, 64, 64, 3)
    _close(td, jd)
    _close(tn, jn)


def test_v1_trainer_matches_vdn():
    """Two V1Trainer steps (hiera_test, 64 px, b1 s2) against vdn's on the
    same weights and batch: the losses of each step, step 1's gradients,
    and every parameter after the steps, including those no forward reads
    (the head's stacks and pos-embeds of levels 0-2 and its fusion
    layers), which optax's adamw and the port decay by (1 - lr wd) per
    step."""
    from vdn.train.trainer import V1Trainer as JTrainer
    from vdn_torch.train.trainer import V1Trainer
    jm, tm = _v1_models(2, attention_feature_levels=LEVELS)
    rng = np.random.default_rng(8)
    b, s, hw = 1, 2, 64
    batch = {
        "rgb": rng.random((b, s, hw, hw, 3)).astype(np.float32),
        "depth_anything_v2": (rng.random((b, s, hw, hw)) * 65535
                              ).astype(np.float32),
        "depth": (rng.random((b, s, hw, hw)) * 10 + 0.5).astype(np.float32),
        "mask": (rng.random((b, s, hw, hw)) > 0.1).astype(np.float32),
    }
    _pair(jm, tm, rng, batch["depth_anything_v2"], batch["rgb"])
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    # vdn trains the port's whole tree, the parameters its flax modules
    # never create included
    params = convert_torch_state({k: v.numpy() for k, v in before.items()})
    lr, steps = 1e-4, 2
    jt = JTrainer(jm, initial_lr=lr)
    tt = V1Trainer(tm, initial_lr=lr)
    state = jt.init_state(jax.tree.map(jnp.asarray, {"params": params}))
    for step in range(steps):
        state, jloss = jt.train_step(state, batch)
        tloss = tt.train_step(batch)
        assert set(tloss) == set(jloss)
        for k in jloss:
            assert float(tloss[k]) == pytest.approx(float(jloss[k]),
                                                    rel=1e-4, abs=1e-6), k
        if step == 0:
            mu = state_dict_from_flax(jax.tree.map(
                np.asarray, state.opt_state[0].mu))
            names = sorted(mu)
            got = torch.cat([tt.optimizer.state[p]["exp_avg"].reshape(-1)
                             for p in (tm.get_parameter(n) for n in names)])
            want = torch.cat([mu[n].reshape(-1) for n in names])
            assert float((got - want).norm() / want.norm()) <= 1e-4
    sd = state_dict_from_flax(jax.tree.map(np.asarray, state.params))
    assert set(sd) == set(tm.state_dict())
    unused = [k for k in sd if k.startswith(
        ("head.temporal_layers_first.0.", "head.spatial_layers_second.2.",
         "head.pos_embeds.1", "head.fusion_layer."))]
    assert unused
    decay = (1 - lr * 0.01) ** steps
    for k, v in tm.state_dict().items():
        if k in unused:
            torch.testing.assert_close(v, before[k] * decay, rtol=1e-6,
                                       atol=1e-9)
        err = float((v - sd[k]).abs().max())
        assert err <= 2 * lr * steps, (k, err)
