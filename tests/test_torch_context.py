"""Context parallelism over the frame axis: the port against vdn on the CPU.

vdn runs as its own tests run it (tests/test_context_parallel.py):
``shard_map`` on the conftest's virtual 8-device CPU mesh, E1 in Pallas
interpret mode.  The port runs in one gloo world of four spawned ranks
(tests/_torch_cp_ranks.py, which imports no jax; rendezvous through a file
store under the test's tmp directory), on a (1, 4, 1) and a (2, 2, 1) mesh
of the same ranks.  Inputs are drawn with numpy from seeds; the models
(vits cut to 4 blocks in both packages, features 32, 56 x 56) share one
set of numpy-seeded weights in vdn's layout.

Tolerances, vdn's own for the same comparisons:

- E1's plain version against vdn's ring_step: fp32 2e-6; bf16 one ulp at
  o's scale (the same rounding points; the fp32 sums run in another
  order);
- the attentions: 2e-5, their gradients 3e-4
  (tests/test_context_parallel.py:40, 105);
- the context-parallel clip and the two decodes: 2e-4 (:59, 155, 225),
  and the clip also against the port's own single-rank model.
"""

import math
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import PartitionSpec as P

from tests import _torch_cp_ranks as ranks
from tests.test_torch_slice import _numpy_params
from vdn.models.video_depth_anything import build_video_depth_anything as jbuild
from vdn.ops.attention import _xla_attention
from vdn.ops.pallas.ring_attention import ring_attention_pallas
from vdn.ops.pallas.ring_attention import ring_step as jring_step
from vdn.parallel.context import (distributed_kv_attention,
                                  make_context_parallel_forward,
                                  ring_attention, ulysses_attention)
from vdn.parallel.mesh import SEQ_AXIS, make_mesh
from vdn_torch.core.convert import load_flax_params
from vdn_torch.kernels import ring_attention as tring
from vdn_torch.models.video_depth_anything import (
    build_video_depth_anything as tbuild)

torch.set_num_threads(2)

SIZE = 56
CFG = dict(encoder="vits", **ranks.CLIP_CFG)
N, T, H, D = 8, 16, 2, 16          # the attentions: T shards 4 x 4, 2 x 8
SEQS = {"seq4": 4, "seq2": 2}
WORLD = 4


@pytest.fixture(scope="module")
def short_vits():
    import vdn.nn.vit as jvit
    import vdn_torch.nn.vit as tvit
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jvit, tvit):
            mp.setitem(mod.VIT_CONFIGS, "vits",
                       {**mod.VIT_CONFIGS["vits"], "depth": 4})
            mp.setitem(mod.INTERMEDIATE_LAYER_IDX, "vits", [0, 1, 2, 3])
        yield


@pytest.fixture(scope="module")
def params(short_vits):
    shapes = jax.eval_shape(jbuild(**CFG).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, SIZE, SIZE, 3)))
    return _numpy_params(shapes, np.random.default_rng(4))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"q": f32(N, T, H, D), "k": f32(N, T, H, D), "v": f32(N, T, H, D),
            "g": f32(N, T, H, D),
            "dq": f32(2, 1, H, D), "dk": f32(2, T, H, D),
            "dv": f32(2, T, H, D),
            "dbias": np.where(rng.random(T) < 0.25, -1e30,
                              0.1 * rng.standard_normal(T)).astype(np.float32),
            "clip": f32(2, 8, SIZE, SIZE, 3),
            "window": f32(1, 3, SIZE, SIZE, 3),
            "new": f32(1, 1, SIZE, SIZE, 3),
            "chunk_window": f32(1, 4, SIZE, SIZE, 3),
            "chunk": f32(1, 2, SIZE, SIZE, 3)}


def _cp(fn, mesh, n_in, out_specs=P(None, SEQ_AXIS)):
    return jax.jit(shard_map(fn, mesh=mesh,
                             in_specs=(P(None, SEQ_AXIS),) * n_in,
                             out_specs=out_specs, check_vma=False))


# ------------------------------------------------------------- vdn's side
@pytest.fixture(scope="module")
def decode_refs(params, inputs):
    """vdn's single-model window entries and its CP decodes (vdn's
    test_context_parallel_streaming_decode_matches and
    test_context_parallel_chunk_window_matches)."""
    single = jbuild(**CFG)
    parallel = jbuild(**CFG, seq_axis=SEQ_AXIS)
    mesh = make_mesh(data=2, seq=4)

    @jax.jit
    def window_entries(params, x):
        return single.apply(params, x, method=lambda m, x: m.forward_depth(
            m.forward_features(x), x.shape))[1]

    caches = window_entries(params, inputs["window"])
    padded = tuple(jnp.pad(c, ((0, 0), (0, 1), (0, 0))) for c in caches)

    def local_step(params, x, caches):
        def run(m, x):
            return m.forward_depth(m.forward_features(x), x.shape,
                                   caches=list(caches), cache_len=3)
        return parallel.apply(params, x, method=run)

    with mesh:
        cached = jax.jit(shard_map(
            local_step, mesh=mesh,
            in_specs=(P(), P(), P(None, SEQ_AXIS, None)),
            out_specs=(P(), P()), check_vma=False))(
                params, inputs["new"], padded)

    t0, k, cap_g, w = 4, 2, 8, 32
    entries = window_entries(params, inputs["chunk_window"])
    buffers = tuple(jnp.zeros((e.shape[0], cap_g, e.shape[2]), e.dtype)
                    .at[:, :t0].set(e) for e in entries)
    sel0 = [i % t0 for i in range(w - 1)] + [cap_g + 0]
    sel1 = [i % t0 for i in range(w - 2)] + [cap_g + 0, cap_g + 1]
    onehot = jax.nn.one_hot(jnp.asarray([sel0, sel1], jnp.int32),
                            cap_g + k, dtype=jnp.float32)

    def run_chunk(p_, x, bufs, oh):
        def run(m, x):
            ph, pw = x.shape[2] // 14, x.shape[3] // 14
            r1, r2, l3, l4 = m.head.decode_pre(m.forward_features(x), ph, pw)
            p3, ents = m.head.decode_temporal(
                l3, l4, tuple(r2.shape[-3:-1]), x.shape[1],
                caches=tuple((b, oh) for b in bufs))
            return m.head.decode_post(p3, r1, r2, (ph * 14, pw * 14)), ents
        return parallel.apply(p_, x, method=run)

    with mesh:
        chunk = jax.jit(shard_map(
            run_chunk, mesh=mesh,
            in_specs=(P(), P(), P(None, SEQ_AXIS, None), P()),
            out_specs=(P(), P()), check_vma=False))(
                params, inputs["chunk"], buffers, onehot)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    return {"padded": to_np(padded), "buffers": to_np(buffers),
            "onehot": np.asarray(onehot), "cached_cp": to_np(cached),
            "chunk": to_np(chunk)}


# ------------------------------------------------------------ the port's side
@pytest.fixture(scope="module")
def port_model(params):
    model = tbuild(**CFG, device="cpu")
    load_flax_params(model, params)
    return model


@pytest.fixture(scope="module")
def world(tmp_path_factory, port_model, inputs, decode_refs):
    """Every rank's results from one spawned gloo world of four."""
    work = tmp_path_factory.mktemp("cp_world")
    t = lambda a: torch.from_numpy(np.array(a))
    inp = {k: t(v) for k, v in inputs.items()}
    inp["padded"] = [t(c) for c in decode_refs["padded"]]
    inp["buffers"] = [t(b) for b in decode_refs["buffers"]]
    inp["onehot"] = t(decode_refs["onehot"])
    torch.save(inp, work / "inputs.pt")
    torch.save(port_model.state_dict(), work / "state.pt")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=ranks.run, args=(r, WORLD, str(work)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _gathered(world, mesh_name, key, index=None):
    """The seq blocks of data group 0, concatenated along T; the other
    data group must hold the same."""
    groups = {}
    for out in world:
        d, s, _ = out["coord"][mesh_name]
        y = out[mesh_name][key]
        groups.setdefault(d, {})[s] = y if index is None else y[index]
    cat = [torch.cat([g[s] for s in sorted(g)], dim=1).numpy()
           for _, g in sorted(groups.items())]
    for other in cat[1:]:
        np.testing.assert_array_equal(other, cat[0])
    return cat[0]


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


# ---------------------------------------------------------------- E1
@pytest.mark.parametrize("carry", ["zero", "carry"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_ring_step_plain_matches_vdn(dtype, carry):
    rng = np.random.default_rng(1)
    g, tq, tk, d = 16, 8, 12, 16
    q, k, v = (rng.standard_normal((g, t_, d)).astype(np.float32)
               for t_ in (tq, tk, tk))
    if carry == "zero":
        o = np.zeros((g, tq, d), np.float32)
        m = np.full((g, tq), -1e30, np.float32)
        l = np.zeros((g, tq), np.float32)
    else:   # the carry after an earlier block: the second step of a ring
        o = rng.standard_normal((g, tq, d)).astype(np.float32) * 3
        m = rng.standard_normal((g, tq)).astype(np.float32) + 2
        l = rng.random((g, tq)).astype(np.float32) * 4 + 1
    jd, td = ((jnp.float32, torch.float32) if dtype == "fp32"
              else (jnp.bfloat16, torch.bfloat16))
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = jring_step(*(jnp.asarray(a, jd) for a in (q, k, v)),
                          *(jnp.asarray(a) for a in (o, m, l)), scale)
    tq_, tk_, tv_ = (torch.from_numpy(a).to(td) for a in (q, k, v))
    to, tm, tl = (torch.from_numpy(a.copy()) for a in (o, m, l))
    got = tring.ring_step_plain(tq_, tk_, tv_, to, tm, tl, scale)
    # the wrapper on the CPU: the plain version, the carry updated in place
    tring.ring_step(tq_, tk_, tv_, to, tm, tl, scale)
    for a, b in zip(got, (to, tm, tl)):
        assert torch.equal(a, b)
    for a, b in zip(got, want):
        b = np.asarray(b, np.float32)
        if dtype == "fp32":
            _close(a.numpy(), b, 2e-6)
        else:
            ulp = 2.0 ** (math.floor(math.log2(np.abs(b).max())) - 7)
            assert np.abs(a.numpy() - b).max() <= ulp


# ---------------------------------------------------------------- attentions
def _jmesh(p):
    return make_mesh(data=8 // p, seq=p)


@pytest.mark.parametrize("mesh_name", ["seq4", "seq2"])
def test_ring_attention_matches_vdn(world, inputs, mesh_name):
    mesh = _jmesh(SEQS[mesh_name])
    with mesh:
        want = _cp(lambda q, k, v: ring_attention(q, k, v, SEQ_AXIS), mesh,
                   3)(inputs["q"], inputs["k"], inputs["v"])
    _close(_gathered(world, mesh_name, "ring"), want, 2e-5)


@pytest.mark.parametrize("mesh_name", ["seq4", "seq2"])
def test_ring_attention_kernel_matches_vdn(world, inputs, mesh_name):
    """The port's ring of E1 (its plain version on the CPU) against vdn's
    ring_attention_pallas in interpret mode; its gradients (the plain ring
    re-run under autograd) against jax.grad of vdn's ring."""
    mesh = _jmesh(SEQS[mesh_name])

    def pallas(q, k, v):
        with pltpu.force_tpu_interpret_mode():
            return ring_attention_pallas(q, k, v, SEQ_AXIS)

    qkv = [jnp.asarray(inputs[n]) for n in ("q", "k", "v")]
    ring = _cp(lambda q, k, v: ring_attention(q, k, v, SEQ_AXIS), mesh, 3)
    with mesh:
        want = pallas_out = _cp(pallas, mesh, 3)(*qkv)
        want_g = jax.grad(lambda *a: jnp.sum(ring(*a) * inputs["g"]),
                          argnums=(0, 1, 2))(*qkv)
    _close(_gathered(world, mesh_name, "ring_kernel"), pallas_out, 2e-5)
    _close(want, _xla_attention(*qkv, D ** -0.5), 2e-5)
    for i, w in enumerate(want_g):
        _close(_gathered(world, mesh_name, "ring_kernel_grads", i), w, 3e-4)


@pytest.mark.parametrize("mesh_name", ["seq4", "seq2"])
def test_ulysses_matches_vdn(world, inputs, mesh_name):
    mesh = _jmesh(SEQS[mesh_name])
    with mesh:
        want = _cp(lambda q, k, v: ulysses_attention(q, k, v, SEQ_AXIS),
                   mesh, 3)(inputs["q"], inputs["k"], inputs["v"])
    _close(_gathered(world, mesh_name, "ulysses"), want, 2e-5)


@pytest.mark.parametrize("mesh_name", ["seq4", "seq2"])
def test_distributed_kv_attention_matches_vdn(world, inputs, mesh_name):
    """Replicated queries over sharded K / V with a column bias (a quarter
    of the columns masked at -1e30)."""
    mesh = _jmesh(SEQS[mesh_name])
    fn = jax.jit(shard_map(
        lambda q, k, v, b: distributed_kv_attention(q, k, v, SEQ_AXIS, b),
        mesh=mesh, in_specs=(P(), P(None, SEQ_AXIS), P(None, SEQ_AXIS),
                             P(SEQ_AXIS)),
        out_specs=P(), check_vma=False))
    with mesh:
        want = fn(inputs["dq"], inputs["dk"], inputs["dv"], inputs["dbias"])
    for out in world:
        _close(out[mesh_name]["dkv"].numpy(), want, 2e-5)


# ---------------------------------------------------------------- the model
@pytest.mark.parametrize("pe", ["ape", "rope"])
def test_cp_clip_matches_vdn(world, params, port_model, inputs, pe):
    """The clip forward with its 8 frames sharded over seq: at (data 2,
    seq 2) and (1, 4), in modes ring and ring_pallas, against vdn's
    make_context_parallel_forward at (data 2, seq 4), and against the
    port's own single-rank model."""
    parallel = jbuild(**CFG, pe=pe, seq_axis=SEQ_AXIS)
    mesh = make_mesh(data=2, seq=4)
    with mesh:
        want = np.asarray(make_context_parallel_forward(parallel, mesh)(
            params, inputs["clip"]))
    single = tbuild(**CFG, pe=pe, device="cpu")
    single.load_state_dict(port_model.state_dict())
    with torch.no_grad():
        own = single(torch.from_numpy(inputs["clip"])).numpy()
    _close(own, want, 2e-4)
    for mesh_name in SEQS:
        for mode in ("ring", "ring_pallas"):
            for out in world:
                got = out[mesh_name, "clip"][pe, mode].numpy()
                _close(got, want, 2e-4)
                _close(got, own, 2e-4)


def _entries_close(got, want):
    """The packed contract: the first 2 * dh lanes of every entry (vdn's
    cache entries are packed K / V; queue 3 item 1 of ROADMAP.md)."""
    widths = [CFG["out_channels"][2]] * 2 + [CFG["out_channels"][3]] * 2 \
        + [CFG["features"]] * 4
    assert len(got) == len(want) == len(widths)
    for g, w, c in zip(got, want, widths):
        lanes = 2 * (c // 8)
        _close(g[..., :lanes].numpy(), np.asarray(w)[..., :lanes], 2e-4)


def test_cached_cp_matches_vdn(world, decode_refs):
    """One frame decoded against a 3-entry window zero-padded to 4 shards
    (cache_len 3), on the seq-4 mesh."""
    want_depth, want_entries = decode_refs["cached_cp"]
    for out in world:
        depth, entries = out["decode"]["cached_cp"]
        _close(depth.numpy(), want_depth, 2e-4)
        _entries_close(entries, want_entries)


def test_cp_chunk_window_matches_vdn(world, decode_refs):
    """Two frames decoded in one window attention with the rings' CAP 8
    sharded 2 per rank."""
    want_depth, want_entries = decode_refs["chunk"]
    for out in world:
        depth, entries = out["decode"]["chunk"]
        _close(depth.numpy(), want_depth, 2e-4)
        _entries_close(entries, want_entries)


def test_rope_clip_matches_vdn(params, port_model, inputs):
    """Temporal RoPE without seq_axis: vdn's generic attention path, plain
    attention over the clip."""
    jm = jbuild(**CFG, pe="rope")
    want = jax.jit(jm.apply)(params, inputs["clip"][:1])
    model = tbuild(**CFG, pe="rope", device="cpu")
    model.load_state_dict(port_model.state_dict())
    with torch.no_grad():
        got = model(torch.from_numpy(inputs["clip"][:1]))
    _close(got.numpy(), want, 2e-4)
    with pytest.raises(ValueError, match="no cache mode"):
        model.head.motion_modules[0].temporal_transformer.transformer_blocks[
            0].attention_blocks[0].forward_stream(
                torch.zeros(4, 1, 64), torch.zeros(32, 3, 128))


def test_no_card_raises():
    """On a box without a card the mesh and the launch raise rather than
    fall back to gloo."""
    from vdn_torch.parallel.launch import initialize_distributed
    from vdn_torch.parallel.mesh import make_mesh as tmake_mesh
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmake_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed(device="cuda")
