"""The port's training slice against the JAX package on the CPU: select,
normals, the losses, the refinement models and both trainers (the kernels'
backwards: tests/test_torch_kernels.py).

Same inputs for both, drawn with numpy from a seed; weights in flax layout
for vdn and torch layout for the port.  Tolerances, with their reasons:

- losses, fp32: values and grads ``1e-5`` of scale (torch and XLA sum in
  different orders), ``1e-4`` where a closed-form alignment divides by a
  determinant that cancels;
- models fp32: ``2e-5`` of the output's scale; the trainers: losses per
  step ``1e-4`` relative, step 1's gradients ``1e-3`` relative L2 over all
  trainable tensors together (per tensor, selection-based losses make a
  few near-zero gradients noisy), parameters after n AdamW steps at
  ``2 lr n`` (Adam's first updates are about +-lr wherever |g| >> eps, so
  sign noise on a near-zero gradient moves a parameter by up to 2 lr per
  step), the frozen head bit-identical, the LR per step ``1e-6``
  relative.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vdn.ops import normals as jnormals
from vdn.ops import select as jselect
from vdn.train import losses as jl
from vdn.train import metric_depth as jmd
from vdn_torch.core.convert import load_flax_params, state_dict_from_flax
from vdn_torch.ops import normals as tnormals
from vdn_torch.ops import select as tselect
from vdn_torch.train import losses as tl
from vdn_torch.train import metric_depth as tmd

torch.set_num_threads(2)

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype="fp32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(np.asarray(a)).to(td)


def _close(got, want, dtype="fp32", ulps=4, rtol=2e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    tol = (rtol * scale if dtype == "fp32"
           else ulps * 2.0 ** (math.floor(math.log2(scale)) - 7))
    assert err <= tol, (err, tol, scale)


def _leaf(t):
    return t.detach().clone().requires_grad_(True)


# ------------------------------------------------- select, normals, losses
def test_kth_smallest_and_ties_match_vdn():
    rng = np.random.default_rng(15)
    x = rng.standard_normal((3, 101)).astype(np.float32)
    x[:, 10:20] = x[:, :1]            # exact ties with the row's first value
    jx, tx = _pair(x)
    for k in (1, 6, 51, 101, 500):
        want = jselect.kth_smallest(jx, k)
        _close(tselect.kth_smallest(tx, k), want, rtol=0)
        _close(tselect.kth_smallest(tx, torch.tensor(k)), want, rtol=0)
    # the value tied 11 times: the cotangent spreads over the ties
    v = jnp.asarray(x[:, 0])
    want = jax.grad(lambda a: jnp.sum(jselect.differentiable_value(a, v)
                                      ** 2))(jx)
    tx = _leaf(tx)
    (tselect.differentiable_value(tx, torch.from_numpy(x[:, 0])) ** 2
     ).sum().backward()
    _close(tx.grad, want)


def test_normals_match_vdn():
    rng = np.random.default_rng(16)
    d = rng.random((2, 3, 17, 23)).astype(np.float32)
    jd, td = _pair(d)
    g = rng.standard_normal((2, 3, 17, 23, 3)).astype(np.float32)
    out, vjp = jax.vjp(jnormals.normal_vector, jd)
    (want,) = vjp(jnp.asarray(g))
    td = _leaf(td)
    got = tnormals.normal_vector(td)
    _close(got, out)
    got.backward(torch.from_numpy(g))
    _close(td.grad, want)


def _loss_inputs(seed, shape=(2, 3, 16, 20)):
    """pred, target, mask with exact ties in |residual| straddling the
    trimmed losses' 80% cutoff: one tied pixel per row, never two in a
    column, so no two neighbours (at any stride) tie and no difference of
    residuals is exactly 0 (|x|'s derivative at 0 is a convention, XLA's 1
    and torch's 0, not a tie rule)."""
    rng = np.random.default_rng(seed)
    pred = (rng.random(shape) * 2 + 0.1).astype(np.float32)
    tgt = (rng.random(shape) * 3 + 0.2).astype(np.float32)
    mask = (rng.random(shape) > 0.2).astype(np.float32)
    res = np.abs(pred - tgt)[mask > 0]
    cut = np.float32(np.sort(res)[int(0.8 * res.size)])
    rows = np.arange(shape[2])
    cols = (7 * rows) % shape[3]
    sign = np.where(rng.random((*shape[:2], shape[2])) > 0.5, 1.0, -1.0)
    pred[..., rows, cols] = tgt[..., rows, cols] + cut * sign
    return pred, tgt, mask


def _flat(a):
    return a.reshape(-1, *a.shape[2:])


def _normals(m, depth, lanes, offsets):
    """A [..., 3] normal-like map from a depth map (loss module m's
    framework)."""
    xp = jnp if m is jl else torch
    return depth[..., None] * xp.asarray(lanes) + xp.asarray(offsets)


LOSSES = {
    "trimmed_mae": lambda m, p, t, k: m.trimmed_mae_loss(
        _flat(p), _flat(t), _flat(k), 0.2),
    "trimmed_absrel": lambda m, p, t, k: m.trimmed_absrel_loss(
        _flat(p), _flat(t), _flat(k), 0.2),
    "delta1": lambda m, p, t, k: m.delta1_loss(p, t, k),
    "normalize_robust": lambda m, p, t, k: m.normalize_prediction_robust(
        _flat(p), _flat(k))[0],
    "scale_shift": lambda m, p, t, k: m.compute_scale_and_shift(
        p.reshape(2, -1, 20), t.reshape(2, -1, 20), k.reshape(2, -1, 20))[0],
    "gradient": lambda m, p, t, k: m.gradient_loss(_flat(p), _flat(t),
                                                   _flat(k), 4, 1),
    "gradient_frames": lambda m, p, t, k: m.gradient_loss(
        _flat(p), _flat(t), _flat(k), 2, 2),
    "procrustes": lambda m, p, t, k: m.trimmed_procrustes_loss(
        _flat(p), _flat(t), _flat(k), trim=0.2),
    "temporal": lambda m, p, t, k: m.temporal_gradient_matching_loss(
        p, t, k, scales=2),
    "ssim": lambda m, p, t, k: m.ssim_cs_loss(p, t, k),
    "video_depth": lambda m, p, t, k: m.video_depth_loss(
        p, t, k, ssim_loss_scale=0.5)["total_loss"],
    "normal": lambda m, p, t, k: m.video_normal_loss(
        _normals(m, p, (1.0, -0.5, 2.0), (0.2, 1.0, -0.3)),
        _normals(m, t, (0.3, 1.0, 1.0), (0.0, 0.0, 0.5)),
        k)["normal_loss"],
    "silog": lambda m, p, t, k: (jmd if m is jl else tmd).silog_loss(
        abs(p) + 0.1, t, k > 0),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_vdn(name):
    """Values and prediction grads of every loss (and the eroded mask of
    the normal loss) on inputs with exact ties; delta1 is a count and has
    no gradient."""
    pred, tgt, mask = _loss_inputs(17)
    fn = LOSSES[name]
    rtol = 1e-4 if name in ("scale_shift", "video_depth") else 1e-5
    jp, tp = _pair(pred)
    want, vjp = jax.vjp(jax.jit(lambda a: fn(jl, a, jnp.asarray(tgt),
                                             jnp.asarray(mask))), jp)
    tp = _leaf(tp)
    got = fn(tl, tp, torch.from_numpy(tgt), torch.from_numpy(mask))
    _close(got, want, rtol=rtol)
    if name == "delta1":
        assert not got.requires_grad
        return
    g = np.ones(np.shape(want), np.float32)
    (jgrad,) = vjp(jnp.asarray(g))
    got.backward(torch.from_numpy(g))
    _close(tp.grad, jgrad, rtol=rtol)


def test_eroded_mask_and_eval_depth_match_vdn():
    _, tgt, mask = _loss_inputs(18)
    np.testing.assert_array_equal(
        tl.eroded_mask(torch.from_numpy(mask)).numpy(),
        np.asarray(jl.eroded_mask(jnp.asarray(mask))))
    pred = tgt * 1.1 + 0.05
    want = jmd.eval_depth(pred, tgt)
    got = tmd.eval_depth(pred, tgt)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k


def test_quantile_median_and_match_seq_match_vdn():
    from vdn.models import refine as jrefine
    from vdn_torch.models import refine as trefine
    rng = np.random.default_rng(19)
    x = rng.random((2, 3, 8, 9)).astype(np.float32)
    x[:, :, 0, :4] = x[:, :, 1, :4]                # ties
    jx, tx = _pair(x)
    for jf, tf in ((lambda a: jrefine.quantile_median(a.reshape(6, -1)),
                    lambda a: trefine.quantile_median(a.reshape(6, -1))),
                   (jrefine.match_seq_to_first_median,
                    trefine.match_seq_to_first_median)):
        want, vjp = jax.vjp(jf, jx)
        a = _leaf(tx)
        got = tf(a)
        _close(got, want)
        g = rng.standard_normal(np.shape(want)).astype(np.float32)
        (jg,) = vjp(jnp.asarray(g))
        got.backward(torch.from_numpy(g))
        _close(a.grad, jg)


def test_schedules_match_vdn():
    from vdn.train import trainer as jtrainer
    from vdn_torch.train import trainer as ttrainer
    jw = jtrainer.cosine_warm_restarts(1e-4, 10, 2, 1e-6)
    tw = ttrainer.cosine_warm_restarts(1e-4, 10, 2, 1e-6)
    jp, tp = jmd.poly_schedule(1e-4, 100), tmd.poly_schedule(1e-4, 100)
    # vdn evaluates its schedules in fp32
    for s in range(0, 100, 3):
        assert tw(s) == pytest.approx(float(jw(s)), rel=1e-5)
        assert tp(s) == pytest.approx(float(jp(s)), rel=1e-5, abs=1e-12)


def test_preprocess_and_rename_match_vdn():
    from vdn.train import trainer as jtrainer
    from vdn_torch.train import trainer as ttrainer
    rng = np.random.default_rng(20)
    d = (rng.random((2, 3, 8, 8)) * 100 - 10).astype(np.float32)
    m = (rng.random((2, 3, 8, 8)) > 0.3).astype(np.float32)
    m[1] = 0                                  # a clip with no valid pixel
    rgb = (rng.random((2, 3, 8, 8, 3)) * 1.2 - 0.1).astype(np.float32)
    for norm in (True, False):
        for mask in (m, None):
            want = jtrainer.preprocess_depth_sequences(
                jnp.asarray(d), None if mask is None else jnp.asarray(mask),
                norm)
            got = ttrainer.preprocess_depth_sequences(
                torch.from_numpy(d),
                None if mask is None else torch.from_numpy(mask), norm)
            _close(got, want, rtol=1e-6)
    _close(ttrainer.preprocess_rgb_sequences(torch.from_numpy(rgb)),
           jtrainer.preprocess_rgb_sequences(jnp.asarray(rgb)), rtol=1e-6)
    state = {"head.scratch.x": 1, "final_res2.0.weight": 2,
             "final_scale2.feat.1.bias": 3, "pretrained.norm.weight": 4}
    for k in state:
        assert ttrainer.rename_with_map(k, ttrainer.V4_RENAME_MAP) == (
            jtrainer.rename_with_map(k, jtrainer.V4_RENAME_MAP))


# ------------------------------------------------- models and trainers
TINY = dict(encoder="vits", features=32, out_channels=(32, 32, 64, 64))


@pytest.fixture(scope="module", autouse=True)
def _short_vits():
    """vits cut to its first 4 blocks (the DPT head reads blocks 0-3) in
    both packages, for CPU time: XLA's compile of the training step grows
    with the depth, the per-block math does not change."""
    import vdn.nn.vit as jvit
    import vdn_torch.nn.vit as tvit
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jvit, tvit):
            mp.setitem(mod.VIT_CONFIGS, "vits",
                       {**mod.VIT_CONFIGS["vits"], "depth": 4})
            mp.setitem(mod.INTERMEDIATE_LAYER_IDX, "vits", [0, 1, 2, 3])
        yield


def _vdn_params(model, x, rng, nonzero=True):
    """vdn's init, as numpy; with ``nonzero`` the zero-initialized convs
    (shift / scale heads and the motion modules' proj_out) get small random
    kernels, so the heads, the DPT head and the encoder all see a
    cotangent."""
    params = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), x))

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            p = path + (k,)
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif nonzero and k == "kernel" and any(
                    s in p for s in ("shift_head_0", "feat_1",
                                     "final_res2_0", "proj_out")):
                out[k] = (rng.standard_normal(v.shape)
                          * 0.5 / math.sqrt(v.shape[-2])).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(params, ())


@pytest.mark.parametrize("version", [2, 3, 5])
def test_refine_forward_matches_vdn(version):
    """RefineVideoDepth v2, v3 and v5 (v4: the trainer test below), fp32,
    at a tiny size, on the port's seeded weights (the zero convs made
    nonzero, v2's BatchNorm statistics moved off their init) carried to
    vdn by vdn's own converter."""
    from vdn.core.convert import convert_torch_state
    from vdn.models.refine import RefineVideoDepth as JRefine
    from vdn_torch.models.refine import RefineVideoDepth as TRefine
    from vdn_torch.nn.layers import init_parameters
    gen = torch.Generator().manual_seed(version)
    kw = dict(internal_size=28) if version == 5 else {}
    tm = TRefine(version=version, **TINY, **kw)
    init_parameters(tm, gen)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if any(s in name for s in ("feat.1.", "final_res2.0.",
                                       "shift_head.0.", "final_res.",
                                       "proj_out.")):
                p.add_(torch.rand(p.shape, generator=gen) * 0.5 + 0.1)
    params = convert_torch_state(
        {k: v.numpy() for k, v in tm.state_dict().items()})
    jm = JRefine(version=version, use_flash=False, **TINY, **kw)
    rng = np.random.default_rng(21)
    x = (rng.random((1, 2, 28, 28)) * 65535).astype(np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    _close(got, jax.jit(jm.apply)({"params": params}, x))


@pytest.mark.parametrize("version", [2, 3, 4, 5])
def test_refine_params_round_trip(version):
    """vdn's converter (reference layout -> flax) and the port's (flax ->
    reference layout) are inverses on every refinement model: the zero
    convs, the scale head's feat.1, v2's BatchNorm scale and running
    statistics."""
    from vdn.core.convert import convert_torch_state
    from vdn_torch.models.refine import RefineVideoDepth as TRefine
    from vdn_torch.nn.layers import init_parameters
    kw = dict(internal_size=28) if version == 5 else {}
    src = TRefine(version=version, **TINY, **kw)
    init_parameters(src, torch.Generator().manual_seed(version))
    state = {k: v.numpy() for k, v in src.state_dict().items()}
    dst = TRefine(version=version, **TINY, **kw)
    assert load_flax_params(dst, convert_torch_state(state)) == []
    for k, v in dst.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k


@pytest.fixture(scope="module")
def refine_setup():
    from vdn.models.refine import RefineVideoDepth as JRefine
    rng = np.random.default_rng(0)
    b, s, h, w = 2, 4, 56, 56
    batch = {
        "depth_anything_v2": (rng.random((b, s, h, w)) * 65535
                              ).astype(np.float32),
        "depth": (rng.random((b, s, h, w)) * 10 + 0.5).astype(np.float32),
        "mask": (rng.random((b, s, h, w)) > 0.1).astype(np.float32),
    }
    jm = JRefine(version=4, use_flash=False, **TINY)
    params = _vdn_params(jm, batch["depth_anything_v2"][:1, :2], rng)
    return jm, params, batch


def test_refine_trainer_matches_vdn(refine_setup):
    """Three RefineTrainer steps (v4, frozen temporal head) against vdn's
    on the same converted params and batch: step 1's gradients, the
    losses and LR of each step, the parameters after the steps, and the
    frozen head bit-identical.  vdn's step is its trainer's own loss and
    optimizer (``_loss``, ``tx``) with the gradients kept, which its jitted
    ``train_step`` does not return."""
    import optax
    from vdn.train.trainer import RefineTrainer as JTrainer
    from vdn.train.trainer import cosine_warm_restarts as jcwr
    from vdn.train.trainer import preprocess_depth_sequences as jpre
    from vdn_torch.models.refine import RefineVideoDepth as TRefine
    from vdn_torch.train.trainer import RefineTrainer as TTrainer
    from vdn_torch.nn.layers import init_parameters
    jm, params, batch = refine_setup
    lr, steps = 1e-4, 3
    tm = TRefine(version=4, **TINY)
    init_parameters(tm, torch.Generator().manual_seed(0))
    load_flax_params(tm, params)
    frozen = {k: v.clone() for k, v in tm.state_dict().items()
              if k.startswith("temporal_head.")}
    jt = JTrainer(jm, initial_lr=lr, stable_scale=1.0)
    tt = TTrainer(tm, initial_lr=lr, stable_scale=1.0)

    jparams = jax.tree.map(jnp.asarray, params)
    opt = jt.tx.init(jparams)
    value_and_grad = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))
    inp = jpre(jnp.asarray(batch["depth_anything_v2"]),
               jnp.asarray(batch["mask"]), norm=False)
    gt_disp = 1.0 / jnp.clip(jnp.asarray(batch["depth"]), 1e-8, None)
    mask = jnp.asarray(batch["mask"])
    for step in range(steps):
        (_, jloss), jgrads = value_and_grad(jparams, inp, gt_disp, mask)
        if step == 0:
            for k, v in tt.eval_step(batch).items():
                assert float(v) == pytest.approx(float(jloss[k]), rel=1e-4,
                                                 abs=1e-6), k
            # step 1's gradients: the port's, taken before its first step
            tt.loss(*tt._batch(batch))["total_loss"].backward()
            tgrads = {n: p.grad.clone() for n, p in tm.named_parameters()
                      if p.grad is not None}
            tm.zero_grad(set_to_none=True)
            want = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
            live = {k for k, v in want.items() if float(v.abs().max()) > 0}
            assert not any(k.startswith("temporal_head.") for k in live)
            assert live <= set(tgrads) <= set(want)
            assert not any(k.startswith("temporal_head.") for k in tgrads)
            for k in ("pretrained.blocks.0.attn.qkv.weight",
                      "pretrained.blocks.3.mlp.fc1.weight",
                      "shift_head.0.weight", "scale_head.feat.1.weight"):
                assert k in live, k
            a = torch.cat([tgrads[k].reshape(-1) for k in sorted(tgrads)])
            b = torch.cat([want[k].reshape(-1) for k in sorted(tgrads)])
            assert float((a - b).norm() / b.norm()) < 1e-3
        assert tt.optimizer.param_groups[0]["lr"] == pytest.approx(
            float(jcwr(lr)(step)), rel=1e-5)
        updates, opt = jt.tx.update(jgrads, opt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tloss = tt.train_step(batch)
        for k in jloss:
            assert float(tloss[k]) == pytest.approx(float(jloss[k]),
                                                    rel=1e-4, abs=1e-6), k
    sd = state_dict_from_flax(jax.tree.map(np.asarray, jparams))
    for k, v in tm.state_dict().items():
        if k.startswith("temporal_head."):
            assert torch.equal(v, frozen[k]), k
        elif k in sd:
            err = float((v - sd[k]).abs().max())
            assert err <= 2 * lr * steps, (k, err)


def test_metric_trainer_matches_vdn():
    """Two MetricDepthTrainer steps against vdn's (two AdamW groups, the
    head at 10x, the caller's rng for the flip): losses, parameters."""
    from vdn.models.metric_depth import MetricDepthAnythingV2 as JMetric
    from vdn_torch.models.metric_depth import MetricDepthAnythingV2
    rng = np.random.default_rng(22)
    batch = {
        "image": rng.standard_normal((2, 28, 28, 3)).astype(np.float32),
        "depth": (rng.random((2, 28, 28)) * 10 + 0.5).astype(np.float32),
        "valid_mask": (rng.random((2, 28, 28)) > 0.1).astype(np.float32),
    }
    jm = JMetric(max_depth=20.0, use_flash=False, **TINY)
    params = _vdn_params(jm, batch["image"], rng, nonzero=False)
    tm = MetricDepthAnythingV2(max_depth=20.0, **TINY)
    load_flax_params(tm, params)
    lr, steps = 1e-4, 2
    jt = jmd.MetricDepthTrainer(jm, base_lr=lr, total_iters=10)
    tt = tmd.MetricDepthTrainer(tm, base_lr=lr, total_iters=10)
    state = jt.init_state(jax.tree.map(np.array, params))
    jrng, trng = np.random.default_rng(5), np.random.default_rng(5)
    for step in range(steps):
        assert tt.optimizer.param_groups[1]["lr"] == pytest.approx(
            float(jmd.poly_schedule(lr * 10, 10)(step)), rel=1e-6)
        state, jloss = jt.train_step(state, batch, jrng)
        tloss = tt.train_step(batch, trng)
        assert tloss == pytest.approx(jloss, rel=1e-4)
    sd = state_dict_from_flax(jax.tree.map(np.asarray, state[0]))
    for k, v in tm.state_dict().items():
        if k in sd:
            # the head's LR is 10x
            tol = 2 * lr * steps * (1 if k.startswith("pretrained.") else 10)
            assert float((v - sd[k]).abs().max()) <= tol, k
