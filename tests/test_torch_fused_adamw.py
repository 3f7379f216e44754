"""Fused AdamW and the port's ``AdamW`` against the JAX package.

``fused_adamw_update`` on CPU tensors runs its plain version: JAX's
per-leaf update in the same f32 operations. Against JAX's
``fused_adamw_update`` (its Pallas kernel in interpret mode) and JAX's
``AdamW.step``, on the same seeded numpy inputs.

Tolerances: every value is a few f32 operations from the same inputs, in
the same order; XLA contracts ``b1 * m + (1 - b1) * g`` and the like into
FMAs, which round once where PyTorch rounds twice, so a result differs by
up to an ulp of its largest term, not of itself (m and v cancel to small
values): rtol 3e-7 plus 2 ulps of the output's largest value per step
(the three-step tree test: 8). With
stochastic rounding fed JAX's own noise bits the bf16 params are compared
bit for bit (a master one ulp off flips its param only if the noise's carry
lands exactly there). Params rounded from f32 masters by different noise
(the tree-level step, whose noise each side draws itself) are held to one
bf16 step of the master.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.kernels.fused_adamw import fused_adamw_update as j_fused
from mila_tpu.optim import AdamW as JAdamW
from mila_tpu.optim import AdamWConfig as JConfig
from mila_tpu.optim import schedules as jsched
from mila_tpu_torch.bridge import adamw_state_from_jax, params_from_jax
from mila_tpu_torch.kernels import fused_adamw as tfw
from mila_tpu_torch.optim import AdamW, AdamWConfig, global_norm
from mila_tpu_torch.optim import schedules as tsched
from mila_tpu_torch.utils.tree import tree_leaves

def _allclose(got, want, ulps=2):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=3e-7,
                               atol=ulps * 2 ** -23 * float(np.abs(want).max()))


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _f(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _jax_noise(n, seed):
    """The bits JAX's fused_adamw_update draws for a flat leaf of n elements
    (rows of 128 lanes, padded to 1024), in the leaf's order, as int32."""
    padded = -(-n // 1024) * 1024
    bits = jax.random.bits(jax.random.fold_in(jax.random.key(0), jnp.asarray(seed, jnp.int32)),
                           (padded // 128, 128), jnp.uint32)
    return torch.from_numpy(np.asarray(bits).reshape(-1)[:n].view(np.int32).copy())


@pytest.mark.parametrize("n,step,wd", [(1000, 1, 0.01), (4096, 5, 0.1), (3, 1000, 0.0)])
def test_plain_matches_jax_kernel_f32(n, step, wd):
    p, g = _np(n, n), _np(n + 1, n, scale=0.1)
    m, v = _np(n + 2, n, scale=0.01), np.abs(_np(n + 3, n, scale=0.01))
    want = j_fused(jnp.asarray(p), jnp.asarray(g), jnp.asarray(m), jnp.asarray(v), None,
                   step=jnp.int32(step), lr=3e-4, weight_decay=wd, interpret=True)
    calls = tfw.fused_adamw_update_plain.calls
    got = tfw.fused_adamw_update(*(torch.from_numpy(a) for a in (p, g, m, v)), None, step=step,
                                 lr=3e-4, weight_decay=wd)
    assert tfw.fused_adamw_update_plain.calls == calls + 1
    assert got[3] is None and want[3] is None
    for a, b in zip(got[:3], want[:3]):
        _allclose(a.numpy(), _f(b))


@pytest.mark.parametrize("seed", [0, 7])
def test_plain_matches_jax_kernel_stochastic_rounding(seed):
    n = 5000
    w, g = _np(seed, n), _np(seed + 1, n, scale=0.1)
    m, v = _np(seed + 2, n, scale=0.01), np.abs(_np(seed + 3, n, scale=0.01))
    p = jnp.asarray(w).astype(jnp.bfloat16)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    want = j_fused(p, gb, jnp.asarray(m), jnp.asarray(v), jnp.asarray(w), step=jnp.int32(3),
                   lr=1e-3, weight_decay=0.1, seed=seed, interpret=True)
    got = tfw.fused_adamw_update(
        torch.from_numpy(np.array(p.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(np.array(gb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(m), torch.from_numpy(v), torch.from_numpy(w), step=3, lr=1e-3,
        weight_decay=0.1, noise=_jax_noise(n, seed))
    for a, b in zip(got[1:], want[1:]):
        _allclose(a.numpy(), _f(b))
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(got[0].float().numpy(), _f(want[0]))
    # Stochastic, not nearest: some params round away from the nearest value.
    assert (got[0] != got[3].bfloat16()).any()


def test_plain_rounds_bf16_to_nearest_without_a_master():
    n = 2048
    p, g = jnp.asarray(_np(1, n)).astype(jnp.bfloat16), jnp.asarray(_np(2, n)).astype(
        jnp.bfloat16)
    z = jnp.zeros((n,), jnp.float32)
    want = j_fused(p, g, z, z, None, step=jnp.int32(1), lr=1e-2, interpret=True)
    got = tfw.fused_adamw_update(torch.from_numpy(_f(p).copy()).bfloat16(),
                                 torch.from_numpy(_f(g).copy()).bfloat16(), torch.zeros(n),
                                 torch.zeros(n), None, step=1, lr=1e-2)
    np.testing.assert_array_equal(got[0].float().numpy(), _f(want[0]))
    with pytest.raises(ValueError, match="noise"):
        tfw.fused_adamw_update(got[0], got[0], got[1], got[2], got[1], step=1, lr=1e-2)


def _tree(dtype):
    """A GPT-2-like tree: bf16 or f32 weights, f32 LayerNorm params."""
    return {"encoder": {"wte": _np(30, 64, 16, scale=0.02)},
            "h0": {"ln1": {"gamma": 1 + _np(31, 16, scale=0.1), "beta": _np(32, 16)},
                   "qkv": {"weight": _np(33, 16, 48, scale=0.2), "bias": _np(34, 48)}},
            "_dtype": dtype}


def _split(tree):
    dt = tree.pop("_dtype")
    is_w = {("encoder", "wte"), ("h0", "qkv", "weight"), ("h0", "qkv", "bias")}

    def conv(node, path=()):
        if isinstance(node, dict):
            return {k: conv(v, path + (k,)) for k, v in node.items()}
        return jnp.asarray(node).astype(dt if path in is_w else jnp.float32)

    return conv(tree)


def _to_np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)) if a.dtype ==
                                  jnp.bfloat16 else np.asarray(a), tree)


def _bridge(tree):
    """JAX tree -> port tree with each leaf in its JAX dtype."""
    out = params_from_jax(_to_np(tree), device="cpu")
    return jax.tree_util.tree_map(lambda t, a: t.to(torch.bfloat16) if a.dtype == jnp.bfloat16
                                  else t, out, tree)


@pytest.mark.parametrize("dtype,sr", [(jnp.float32, False), (jnp.bfloat16, True),
                                      (jnp.bfloat16, False)])
def test_adamw_step_over_a_tree_matches_jax(dtype, sr):
    # Three steps with a global-norm clip (active: grads of norm ~10) and a
    # warmup-cosine schedule, from one state bridged from JAX's init.
    cfg = dict(learning_rate=1e-3, weight_decay=0.1, grad_clip_norm=1.0, stochastic_rounding=sr)
    jopt, topt = JAdamW(JConfig(**cfg)), AdamW(AdamWConfig(**cfg))
    jp = _split(_tree(dtype))
    jstate = jopt.init(jp)
    tp = _bridge(jp)
    tstate = adamw_state_from_jax(jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    assert tstate.step == 0 and (tstate.master is None) == (not sr)
    js, ts = jsched.warmup_cosine(1e-3, 2, 10), tsched.warmup_cosine(1e-3, 2, 10)
    gen = torch.Generator().manual_seed(0)
    for step in range(3):
        jg = jax.tree_util.tree_map(
            lambda a, s=step: (jnp.asarray(_np(40 + s, *a.shape)) * 3.0).astype(a.dtype), jp)
        tg = _bridge(jg)
        np.testing.assert_allclose(float(global_norm(tg)), float(
            jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                         for g in jax.tree_util.tree_leaves(jg)))), rtol=1e-6)
        jp, jstate = jopt.step(jstate, jp, jg, lr=js(step))
        tp, tstate = topt.step(tstate, tp, tg, lr=ts(step), rng=gen)
    assert tstate.step == int(jstate.step) == 3
    # JAX's and the port's trees keep their own key orders; compare by path.
    # With SR the masters are compared (each side drew its own noise; the
    # update reads the master, not the rounded param).
    for tree_t, tree_j in ((tstate.m, jstate.m), (tstate.v, jstate.v)) + (
            ((tstate.master, jstate.master),) if sr else ((tp, jp),)):
        flat_j = dict(jax.tree_util.tree_flatten_with_path(tree_j)[0])
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree_t)[0]:
            _allclose(leaf.float().numpy(), _f(flat_j[path]), ulps=8)


def test_adamw_sr_params_are_a_bf16_neighbour_of_the_master():
    opt = AdamW(AdamWConfig(stochastic_rounding=True, learning_rate=1e-2))
    p = {"w": torch.from_numpy(_np(50, 4096)).bfloat16(),
         "ln": torch.ones(8)}
    st = opt.init(p)
    g = {"w": torch.from_numpy(_np(51, 4096)).bfloat16(), "ln": torch.ones(8)}
    p2, st2 = opt.step(st, p, g, rng=torch.Generator().manual_seed(3))
    w = st2.master["w"]
    lo = w.bfloat16().float()
    step = (lo.abs() * 2 ** -7).clamp_min(1e-38)
    assert ((p2["w"].float() - w).abs() <= step).all()
    assert torch.equal(p2["ln"], st2.master["ln"]) and p2["ln"].dtype == torch.float32
    # The same generator state draws the same noise; none draws JAX's
    # key(0) bits: leaf "w" is leaf 1 of JAX's sorted order ("ln", "w"), so
    # its noise is bits(split(key(0), 2)[1]).
    p3, _ = opt.step(st, p, g, rng=torch.Generator().manual_seed(3))
    assert torch.equal(p2["w"], p3["w"])
    p4, st4 = opt.step(st, p, g)
    assert torch.equal(st4.master["w"], w)
    bits = np.asarray(jax.random.bits(jax.random.split(jax.random.key(0), 2)[1], (4096,),
                                      jnp.uint32))
    want = tfw.stochastic_round_bf16(w, torch.from_numpy(bits.astype(np.int64)))
    assert torch.equal(p4["w"], want)


def test_adamw_fp16_stochastic_rounding_on_the_cpu():
    # JAX's fp16 route rounds to nearest (below): the masters, m and v equal
    # JAX's, and the params bit-equal to JAX's wherever the masters are.
    cfg = dict(stochastic_rounding=True, learning_rate=1e-2)
    w = _np(60, 512)
    jp = {"w": jnp.asarray(w).astype(jnp.float16)}
    jg = {"w": jnp.asarray(_np(61, 512)).astype(jnp.float16)}
    jopt, topt = JAdamW(JConfig(**cfg)), AdamW(AdamWConfig(**cfg))
    js = jopt.init(jp)
    jp2, js2 = jopt.step(js, jp, jg)
    tp = {"w": torch.from_numpy(np.array(jp["w"]))}
    ts = topt.init(tp)
    tp2, ts2 = topt.step(ts, tp, {"w": torch.from_numpy(np.array(jg["w"]))},
                         rng=torch.Generator().manual_seed(1))
    _allclose(ts2.master["w"].numpy(), js2.master["w"])
    _allclose(ts2.m["w"].numpy(), js2.m["w"])
    assert tp2["w"].dtype == torch.float16
    same = ts2.master["w"].numpy() == _f(js2.master["w"])
    assert same.mean() > 0.95
    np.testing.assert_array_equal(tp2["w"].numpy()[same], np.asarray(jp2["w"])[same])


def test_jax_fp16_stochastic_round_is_nearest():
    # JAX's fp16 branch of _stochastic_round steps from lo = fp16(x) to the
    # neighbouring f32 value, not fp16 value, and casts back: every value
    # lands on the nearest fp16 value, which the port's update gives on
    # both devices (ROADMAP §C.3; the reference is not fixed).
    from mila_tpu.optim.adamw import _stochastic_round

    x = jnp.asarray(_np(70, 200_000) * np.float32(3.0))
    x = jnp.concatenate([x, jnp.asarray([65504.0, 70000.0, -1e-7, 2 ** -24 * 1.5, 0.0],
                                        jnp.float32)])
    got = np.asarray(_stochastic_round(x, jax.random.key(3), jnp.float16))
    np.testing.assert_array_equal(got.view(np.uint16),
                                  np.asarray(x.astype(jnp.float16)).view(np.uint16))


@pytest.mark.parametrize("master", [True, False])
def test_plain_matches_jax_kernel_fp16(master):
    # JAX's kernel rounds an fp16 param to nearest, master or not (no noise
    # is read): the port's plain version bit-equal in the param, m, v and
    # the master to the usual f32 tolerance.
    n = 5000
    w, g = _np(80, n), _np(81, n, scale=0.1)
    m, v = _np(82, n, scale=0.01), np.abs(_np(83, n, scale=0.01))
    p, gh = jnp.asarray(w).astype(jnp.float16), jnp.asarray(g).astype(jnp.float16)
    want = j_fused(p, gh, jnp.asarray(m), jnp.asarray(v), jnp.asarray(w) if master else None,
                   step=jnp.int32(4), lr=1e-3, weight_decay=0.1, seed=2, interpret=True)
    got = tfw.fused_adamw_update(
        torch.from_numpy(np.array(p)), torch.from_numpy(np.array(gh)), torch.from_numpy(m),
        torch.from_numpy(v), torch.from_numpy(w) if master else None, step=4, lr=1e-3,
        weight_decay=0.1)
    assert got[0].dtype == torch.float16
    for a, b in zip(got[1:], want[1:]):
        if b is None:
            assert a is None
        else:
            _allclose(a.numpy(), _f(b))
    if master:
        # The param is fp16(master'): compare through the masters (an f32
        # ulp apart at most), bit-equal where the masters are.
        same = got[3].numpy() == _f(want[3])
        assert same.mean() > 0.99
        np.testing.assert_array_equal(got[0].numpy()[same], np.asarray(want[0])[same])
    else:
        np.testing.assert_array_equal(got[0].float().numpy(), _f(want[0]))


@pytest.mark.parametrize("sr", [True, False])
def test_adamw_step_over_a_mixed_fp16_tree_matches_jax(sr):
    # fp16 weights, a bf16 bias and f32 LayerNorm params in one tree, two
    # steps with a clip: the fp16 params bit-equal to JAX's wherever the
    # masters (or, without SR, the f32 updates) are, m, v and the masters to
    # the f32 tolerance; the bf16 leaf (whose noise each side draws itself)
    # within one bf16 step of its master.
    cfg = dict(learning_rate=1e-3, weight_decay=0.1, grad_clip_norm=1.0, stochastic_rounding=sr)
    jopt, topt = JAdamW(JConfig(**cfg)), AdamW(AdamWConfig(**cfg))
    jp = {"w": jnp.asarray(_np(90, 64, 32, scale=0.2)).astype(jnp.float16),
          "b": jnp.asarray(_np(91, 32)).astype(jnp.bfloat16),
          "ln": {"gamma": jnp.asarray(1 + _np(92, 32, scale=0.1)),
                 "beta": jnp.asarray(_np(93, 32))}}
    jstate = jopt.init(jp)
    to_t = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(  # noqa: E731
        {jnp.float16: torch.float16, jnp.bfloat16: torch.bfloat16}.get(a.dtype.type,
                                                                       torch.float32))
    tp = jax.tree_util.tree_map(to_t, jp)
    tstate = topt.init(tp)
    gen = torch.Generator().manual_seed(0)
    for step in range(2):
        jg = jax.tree_util.tree_map(
            lambda a, s=step: (jnp.asarray(_np(95 + s, *a.shape)) * 3.0).astype(a.dtype), jp)
        jp, jstate = jopt.step(jstate, jp, jg)
        tp, tstate = topt.step(tstate, tp, jax.tree_util.tree_map(to_t, jg), rng=gen)
    assert tp["w"].dtype == torch.float16 and tp["b"].dtype == torch.bfloat16
    for tree_t, tree_j in ((tstate.m, jstate.m), (tstate.v, jstate.v)) + (
            ((tstate.master, jstate.master),) if sr else ()):
        for key in ("w", "b"):
            _allclose(tree_t[key].float().numpy(), _f(tree_j[key]), ulps=8)
    w_j, w_t = np.asarray(jp["w"]), tp["w"].numpy()
    src_t = tstate.master["w"].numpy() if sr else w_t.astype(np.float32)
    src_j = _f(jstate.master["w"]) if sr else w_j.astype(np.float32)
    same = src_t == src_j
    assert same.mean() > 0.95
    np.testing.assert_array_equal(w_t[same], w_j[same])
    if sr:
        lo = tstate.master["b"].bfloat16().float()
        assert ((tp["b"].float() - tstate.master["b"]).abs()
                <= (lo.abs() * 2 ** -7).clamp_min(1e-38)).all()
    for key in ("gamma", "beta"):
        _allclose(tp["ln"][key].numpy(), _f(jp["ln"][key]), ulps=8)


def test_zero_grads_and_leaf_order():
    from mila_tpu_torch.optim import zero_grads

    p = {"b": torch.ones(2), "a": {"x": torch.ones(3, dtype=torch.bfloat16)}}
    z = zero_grads(p)
    assert [t.dtype for t in tree_leaves(z)] == [torch.float32, torch.bfloat16]
    assert all(float(t.abs().sum()) == 0 for t in tree_leaves(z))


def test_adamw_step_pairs_leaves_by_key():
    # JAX's AdamW pairs params, grads and state leaf by leaf through
    # tree_map, whose flatten sorts dict keys: a gradient dict built in
    # another key order than the params (JAX's own trees come back sorted)
    # pairs by key. Two leaves of one shape, so a pairing by position would
    # run and be wrong.
    cfg = dict(learning_rate=1e-2, stochastic_rounding=False)
    jopt, topt = JAdamW(JConfig(**cfg)), AdamW(AdamWConfig(**cfg))
    w = {"b": _np(100, 64), "a": _np(101, 64)}
    g = {"a": _np(102, 64), "b": _np(103, 64)}
    jp2, _ = jopt.step(jopt.init({k: jnp.asarray(x) for k, x in w.items()}),
                       {k: jnp.asarray(x) for k, x in w.items()},
                       {k: jnp.asarray(x) for k, x in g.items()})
    tp = {k: torch.from_numpy(x) for k, x in w.items()}
    tp2, ts2 = topt.step(topt.init(tp), tp, {k: torch.from_numpy(x) for k, x in g.items()})
    assert list(tp2) == ["b", "a"]
    for k in ("a", "b"):
        _allclose(tp2[k].numpy(), _f(jp2[k]))
        assert torch.equal(ts2.m[k], torch.from_numpy(g[k]) * np.float32(0.1))


# ---------------------------------------------------------------------------
# The kernel's draw (Threefry-2x32-20) and JAX's generator
# ---------------------------------------------------------------------------

def _words(key) -> tuple:
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("seed", [0, 7, -3, 2 ** 31 - 1])
def test_plain_threefry_matches_jax(seed):
    # The plain draw against jax.extend.random.threefry_2x32 on random keys
    # and counters, then the identities the kernel rests on: fold_in(k, s)
    # and split(k, n)[j] are threefry(k, (0, s mod 2^32)) and threefry(k,
    # (0, j)); bits(k, shape).ravel()[i] is x0 ^ x1 of threefry(k, (0, i)).
    from jax.extend.random import threefry_2x32

    rng = np.random.default_rng(abs(seed) + 5)
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    c = rng.integers(0, 2 ** 32, (2, 64), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(threefry_2x32(jnp.asarray(k), jnp.asarray(c.reshape(-1))))
    got = tfw.threefry2x32(int(k[0]), int(k[1]), torch.from_numpy(c[0].astype(np.int64)),
                           torch.from_numpy(c[1].astype(np.int64)))
    np.testing.assert_array_equal(np.concatenate([t.numpy() for t in got]),
                                  want.astype(np.int64))
    base = jax.random.fold_in(jax.random.key(1), 5)
    words = _words(base)
    assert tfw.leaf_key(words, seed) == _words(jax.random.fold_in(base, jnp.int32(seed)))
    split = jax.random.split(base, 6)
    for j in range(6):
        assert tfw.leaf_key(words, j) == _words(split[j])
    bits = np.asarray(jax.random.bits(split[3], (3, 50), jnp.uint32)).reshape(-1)
    np.testing.assert_array_equal(tfw.threefry_bits(words, 3, 150, "cpu").numpy().view(
        np.uint32), bits)
    # The card's int64 torch route (here on the CPU) and the CPU's numpy
    # route over several of its blocks: the same bits.
    lk = tfw.leaf_key(words, 3)
    n = 3 * tfw._NP_BLOCK + 5
    np.testing.assert_array_equal(tfw._bits_torch(*lk, n, "cpu").numpy(),
                                  tfw._bits_numpy(*lk, n).astype(np.int64))
    # A key as JAX's key data (uint32 words) or None (key(0)).
    kd = torch.from_numpy(np.array(jax.random.key_data(base)))
    assert tfw.key_words(kd) == words and tfw.key_words(None) == _words(jax.random.key(0))


@pytest.mark.parametrize("n,seed", [(5000, 0), (5000, 11), (3, -7), (1030, 2 ** 31 - 1)])
def test_update_with_a_seed_matches_jax_kernel(n, seed):
    # fused_adamw_update(seed=s) draws JAX's kernel's own bits,
    # bits(fold_in(key(0), s)) over its padded rows, and equals JAX's
    # kernel (interpret mode): the bf16 param bit for bit, m, v and the
    # master to the f32 tolerance.
    w, g = _np(seed % 97, n), _np(seed % 97 + 1, n, scale=0.1)
    m, v = _np(seed % 97 + 2, n, scale=0.01), np.abs(_np(seed % 97 + 3, n, scale=0.01))
    p = jnp.asarray(w).astype(jnp.bfloat16)
    gb = jnp.asarray(g).astype(jnp.bfloat16)
    want = j_fused(p, gb, jnp.asarray(m), jnp.asarray(v), jnp.asarray(w), step=jnp.int32(2),
                   lr=1e-3, weight_decay=0.1, seed=seed, interpret=True)
    got = tfw.fused_adamw_update(
        torch.from_numpy(np.array(p.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(np.array(gb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(m), torch.from_numpy(v), torch.from_numpy(w), step=2, lr=1e-3,
        weight_decay=0.1, seed=seed)
    for a, b in zip(got[1:], want[1:]):
        _allclose(a.numpy(), _f(b))
    np.testing.assert_array_equal(got[0].float().numpy(), _f(want[0]))
    # The same bits as the noise argument.
    fed = tfw.fused_adamw_update(
        torch.from_numpy(np.array(p.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(np.array(gb.astype(jnp.float32))).bfloat16(),
        torch.from_numpy(m), torch.from_numpy(v), torch.from_numpy(w), step=2, lr=1e-3,
        weight_decay=0.1, noise=_jax_noise(n, seed))
    assert torch.equal(fed[0], got[0])
