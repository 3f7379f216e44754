"""The port's ``AdamW.step`` and its kernels' wrappers against the JAX package.

On the CPU, ``grad_clip_scale`` and ``fused_adamw_step`` run their plain
versions: the clip's global norm and JAX's per-leaf update, each bf16 leaf
with a master rounded with JAX's own Threefry bits under the step key
(``split(key, n)[j]``, ``j`` the leaf's index in JAX's sorted tree order).
Against JAX's ``AdamW.step`` on the same seeded numpy inputs.

Tolerances: m, v and the masters as ``tests/test_torch_fused_adamw.py``
states them (XLA contracts some products into FMAs: rtol 3e-7 plus 8 ulps of
a leaf's largest value over three steps); each bf16 param bit-equal to
JAX's wherever its master is (the same noise, the same master: the same
rounding). The clip's norm and factor: 1e-6 relative (f32 sums in another
order).

The wrappers' launch path (leaf tables, groups, offsets, views) runs here
against a stand-in for the CUDA library that applies the same update to
the host addresses the tables name.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.optim import AdamW as JAdamW
from mila_tpu.optim import AdamWConfig as JConfig
from mila_tpu.optim.adamw import global_norm as j_global_norm
from mila_tpu_torch.kernels import _build
from mila_tpu_torch.kernels import fused_adamw as tfw
from mila_tpu_torch.optim import AdamW, AdamWConfig
from mila_tpu_torch.utils.tree import sorted_leaf_index, tree_leaves


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _f(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _allclose(got, want, ulps=8):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=3e-7,
                               atol=ulps * 2 ** -23 * float(np.abs(want).max()))


def _jax_tree():
    """bf16 weights and f32 norms, keys inserted out of sorted order (the
    port's leaf order is insertion order, JAX's sorted)."""
    return {"wte": jnp.asarray(_np(1, 64, 16, scale=0.02)).astype(jnp.bfloat16),
            "h0": {"qkv": {"weight": jnp.asarray(_np(2, 16, 48, scale=0.2)).astype(jnp.bfloat16),
                           "bias": jnp.asarray(_np(3, 48)).astype(jnp.bfloat16)},
                   "ln1": {"gamma": jnp.asarray(1 + _np(4, 16, scale=0.1)),
                           "beta": jnp.asarray(_np(5, 16))}},
            "a_head": jnp.asarray(_np(6, 37, scale=0.5)).astype(jnp.bfloat16)}


def _to_torch(tree):
    def leaf(a):
        t = torch.from_numpy(np.array(a.astype(jnp.float32)))
        return t.bfloat16() if a.dtype == jnp.bfloat16 else t

    def conv(node):
        return {k: conv(v) for k, v in node.items()} if isinstance(node, dict) else leaf(node)

    return conv(tree)


def _by_path(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def test_sorted_leaf_index_is_jax_order():
    tree = _to_torch(_jax_tree())
    paths = [p for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    mine = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(paths) == len(tree_leaves(tree)) == 6
    # Leaf i of the port's order is leaf sorted_leaf_index[i] of JAX's.
    port_paths = []

    def walk(node, prefix=()):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                port_paths.append(prefix + (k,))

    walk(tree)
    jax_paths = [tuple(e.key for e in p) for p, _ in mine]
    assert [jax_paths[j] for j in sorted_leaf_index(tree)] == port_paths


@pytest.mark.parametrize("key,clip", [("none", 1.0), ("jax", 1.0), ("jax", 0.0)])
def test_adamw_step_sr_and_clip_match_jax(key, clip):
    # Three steps with SR masters, with an active clip (gradients of norm
    # ~130) or none, with JAX's key(0) (rng None on both sides) or a JAX
    # key bridged as its two words, one per step: m, v and the masters as
    # JAX's, and every bf16 param bit-equal to JAX's wherever its master
    # is. The clip's norm sums in another order than XLA's (an f32 ulp or
    # two apart, test_clip_factor_matches_jax), so with it fewer masters are
    # bit-equal: at least 30 %, and 95 % without it.
    cfg = dict(learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=clip,
               stochastic_rounding=True)
    jopt, topt = JAdamW(JConfig(**cfg)), AdamW(AdamWConfig(**cfg))
    jp = _jax_tree()
    jstate, tp = jopt.init(jp), _to_torch(jp)
    tstate = topt.init(tp)
    for step in range(3):
        jg = jax.tree_util.tree_map(
            lambda a, s=step: (jnp.asarray(_np(20 + s, *a.shape)) * 3.0).astype(a.dtype), jp)
        jkey = None if key == "none" else jax.random.fold_in(jax.random.key(11), step)
        tkey = None if jkey is None else torch.from_numpy(np.array(jax.random.key_data(jkey)))
        jp, jstate = jopt.step(jstate, jp, jg, rng=jkey)
        tp, tstate = topt.step(tstate, tp, _to_torch(jg), rng=tkey)
    assert tstate.step == int(jstate.step) == 3
    for tree_t, tree_j in ((tstate.m, jstate.m), (tstate.v, jstate.v),
                           (tstate.master, jstate.master)):
        flat_j = _by_path(tree_j)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree_t)[0]:
            _allclose(leaf.numpy(), _f(flat_j[path]))
    flat_jp, flat_jw = _by_path(jp), _by_path(jstate.master)
    rounded, equal, total = 0, 0, 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tp)[0]:
        want, w_t = flat_jp[path], _by_path(tstate.master)[path].numpy()
        assert leaf.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16 else torch.float32)
        same = w_t == _f(flat_jw[path])
        equal, total = equal + int(same.sum()), total + same.size
        np.testing.assert_array_equal(leaf.float().numpy()[same], _f(want)[same])
        if leaf.dtype == torch.bfloat16:
            rounded += int((leaf != torch.from_numpy(w_t).bfloat16()).sum())
    # Stochastic rounding, not nearest.
    assert equal > (0.3 if clip else 0.95) * total and rounded > 0


@pytest.mark.parametrize("scale", [3.0, 1e-3])
def test_clip_factor_matches_jax(scale):
    # The clip over a bf16 + f32 tree, active (norm ~130) and not (the
    # factor 1): the norm and the factor within 1e-6 of JAX's.
    jg = jax.tree_util.tree_map(lambda a: (jnp.asarray(_np(30, *a.shape)) * scale).astype(
        a.dtype), _jax_tree())
    gn = j_global_norm(jg)
    want = jnp.minimum(1.0, 1.0 / (gn + 1e-6))
    factor, norm = tfw.grad_clip_scale(tree_leaves(_to_torch(jg)), 1.0)
    assert factor.dtype == norm.dtype == torch.float32 and factor.dim() == 0
    np.testing.assert_allclose(float(norm), float(gn), rtol=1e-6)
    np.testing.assert_allclose(float(factor), float(want), rtol=1e-6)
    assert (float(factor) == 1.0) == (scale < 1)


def test_step_with_a_generator_draws_a_key_a_step():
    # A torch.Generator gives two words a step: the same state, the same
    # params; the words it draws, passed as the key, the same params too.
    opt = AdamW(AdamWConfig(stochastic_rounding=True, learning_rate=1e-2))
    p = {"w": torch.from_numpy(_np(40, 3000)).bfloat16()}
    g = {"w": torch.from_numpy(_np(41, 3000)).bfloat16()}
    st = opt.init(p)
    a, _ = opt.step(st, p, g, rng=torch.Generator().manual_seed(9))
    words = torch.randint(-1 << 31, 1 << 31, (2,), generator=torch.Generator().manual_seed(9),
                          dtype=torch.int32)
    b, _ = opt.step(st, p, g, rng=words)
    c, _ = opt.step(st, p, g)
    assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], c["w"])


# ---------------------------------------------------------------------------
# The launch path against a stand-in for csrc/fused_adamw.cu
# ---------------------------------------------------------------------------

_TORCH = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}


def _at(addr: int, n: int, dtype) -> torch.Tensor:
    size = torch.tensor([], dtype=dtype).element_size() * n
    buf = (ctypes.c_char * max(size, 1)).from_address(addr)
    return torch.frombuffer(buf, dtype=dtype, count=n)


class _FakeLib:
    """The C entries of csrc/fused_adamw.cu in Python over host memory:
    check the leaf tables the wrapper builds (first chunks, alignment,
    output offsets), then apply the plain update at the addresses they
    name."""

    def __init__(self):
        self.launches, self.done = [], torch.zeros(1, dtype=torch.int32)

    def fused_adamw_step(self, table, nleaves, nchunks, chunk, p_dtype, g_half, p_out, m_out,
                         v_out, w_out, scale, gs, key, k0, k1, lr, b1, omb1, b2, omb2, eps, wd,
                         bc1, bc2, stream):
        tab = np.frombuffer((ctypes.c_char * (tfw.LEAF.itemsize * nleaves)).from_address(table),
                            tfw.LEAF).copy()
        assert 0 < nleaves <= tfw.MAX_LEAVES and not key
        assert chunk == tfw.chunk_size(int(tab["n"].sum())) and chunk % 2048 == 0
        chunks = -(-tab["n"] // chunk)
        assert list(tab["chunk0"]) == [0] + list(np.cumsum(chunks)[:-1])
        assert int(chunks.sum()) == nchunks
        assert (tab["out"] % tfw.ALIGN == 0).all() and (np.diff(tab["out"]) >= tab["n"][:-1]).all()
        for name in ("p", "g", "m", "v", "w", "noise"):
            assert (tab[name] % 16 == 0).all(), name
        self.launches.append((p_dtype, g_half, nleaves))
        pd = _TORCH[p_dtype]
        gs_t = _at(scale, 1, torch.float32)[0] if scale else gs
        bc1_t, bc2_t = torch.tensor(bc1), torch.tensor(bc2)
        for rec in tab:
            n, o = int(rec["n"]), int(rec["out"])
            p = _at(int(rec["p"]), n, pd)
            g = _at(int(rec["g"]), n, pd if g_half else torch.float32)
            m, v = _at(int(rec["m"]), n, torch.float32), _at(int(rec["v"]), n, torch.float32)
            w = _at(int(rec["w"]), n, torch.float32) if rec["w"] else p.float()
            g32 = g.float() * gs_t
            m2 = b1 * m + omb1 * g32
            v2 = b2 * v + omb2 * g32 * g32
            w2 = w - lr * ((m2 / bc1_t) / (torch.sqrt(v2 / bc2_t) + eps) + wd * w)
            if pd == torch.bfloat16 and rec["w"]:
                noise = (_at(int(rec["noise"]), n, torch.int32) if rec["noise"] else
                         tfw.threefry_bits((k0, k1), int(rec["id"]), n, "cpu"))
                p2 = tfw.stochastic_round_bf16(w2, noise)
            else:
                p2 = w2.to(pd)
            _at(p_out + o * p2.element_size(), n, pd).copy_(p2)
            _at(m_out + 4 * o, n, torch.float32).copy_(m2)
            _at(v_out + 4 * o, n, torch.float32).copy_(v2)
            if w_out:
                _at(w_out + 4 * o, n, torch.float32).copy_(w2)
        return 0

    def clip_norm_blocks(self, nchunks):
        return min(nchunks, 528)

    def clip_norm(self, table, nleaves, nchunks, chunk, clip, partial, done, out, stream):
        tab = np.frombuffer((ctypes.c_char * (tfw.NORM_LEAF.itemsize * nleaves)).from_address(
            table), tfw.NORM_LEAF).copy()
        assert (tab["g"] % 16 == 0).all() and _at(done, 1, torch.int32)[0] == 0
        assert chunk == tfw.chunk_size(int(tab["n"].sum()))
        assert int((-(-tab["n"] // chunk)).sum()) == nchunks
        s = sum(_at(int(r["g"]), int(r["n"]), _TORCH[int(r["dtype"])]).double().square().sum()
                for r in tab)
        norm = float(np.float32(np.sqrt(float(s))))
        _at(out, 2, torch.float32).copy_(torch.tensor([min(1.0, clip / (norm + 1e-6)), norm]))
        self.launches.append(("norm", nleaves))
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(tfw, "_lib", lambda: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: ctypes.c_void_p(0))
    return lib


def _leaves(rng, sizes, pdtypes, master=True):
    ps, gs, ms, vs, ws = [], [], [], [], []
    for n, pd in zip(sizes, pdtypes):
        w = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        ps.append(w.to(pd))
        gs.append(torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(pd))
        ms.append(torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.01))
        vs.append(torch.from_numpy(np.abs(rng.standard_normal(n).astype(np.float32)) * 0.01))
        ws.append(w if master else None)
    return ps, gs, ms, vs, ws


@pytest.mark.parametrize("master", [True, False])
def test_launch_path_with_a_stand_in_kernel(fake, master):
    # bf16, f32 and fp16 leaves of ragged sizes (one over a chunk), views of
    # a larger buffer at odd offsets among them: one launch per dtype group,
    # each output a view of its group's flat buffer at an aligned offset, and
    # every output equal to the plain step's with the same key and factor.
    rng = np.random.default_rng(50)
    sizes = [1, 3, 5, 2048, 40_003, 7, 100, 12, 33]  # chunks of 2048: the wide leaf in 20
    pds = [torch.bfloat16, torch.float32, torch.bfloat16, torch.bfloat16, torch.bfloat16,
           torch.float16, torch.float32, torch.float16, torch.bfloat16]
    ps, gs, ms, vs, ws = _leaves(rng, sizes, pds, master)
    big = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    ms[2] = big[1:6]  # 4 bytes into a buffer: the wrapper copies it aligned
    ids = [8, 0, 3, 1, 2, 7, 6, 5, 4]
    scale = torch.tensor(0.37)
    kw = dict(step=4, lr=3e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.1)
    out, launches = tfw._launch(ps, gs, ms, vs, ws, [None] * 9, ids, grad_scale=scale,
                                key=(12345, 678), **kw)
    assert launches == len(fake.launches) == 3
    assert sorted(fake.launches) == [(0, 0, 2), (1, 1, 5), (2, 1, 2)]
    want = tfw.fused_adamw_step_plain(ps, gs, ms, vs, ws, grad_scale=scale, key=(12345, 678),
                                      leaf_ids=ids, **kw)
    for k in range(4):
        for i in range(9):
            a, b = out[k][i], want[k][i]
            if b is None:
                assert a is None
                continue
            assert a.shape == b.shape and a.dtype == b.dtype and a.data_ptr() % 16 == 0
            assert torch.equal(a, b), (k, i)
    # One flat buffer a stream and group: the bf16 leaves' params share one.
    bf = [out[0][i] for i in range(9) if pds[i] == torch.bfloat16]
    assert len({t.untyped_storage().data_ptr() for t in bf}) == 1
    # The inputs are left as they were.
    assert torch.equal(ms[2], big[1:6])


def test_launch_path_noise_and_norm_with_a_stand_in_kernel(fake):
    # fused_adamw_update's noise argument reaches the table; the norm's
    # table covers every leaf of every dtype in one launch.
    rng = np.random.default_rng(51)
    ps, gs, ms, vs, ws = _leaves(rng, [70_001], [torch.bfloat16])
    noise = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, 70_001).astype(np.int32))
    out, _ = tfw._launch(ps, gs, ms, vs, ws, [noise], [0], grad_scale=None, key=None, step=2,
                         lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0)
    want = tfw.fused_adamw_update_plain(ps[0], gs[0], ms[0], vs[0], ws[0], step=2, lr=1e-3,
                                        weight_decay=0.0, noise=noise)
    for a, b in zip(out, want):
        assert torch.equal(a[0], b)
    grads = _leaves(rng, [5, 40_000, 3, 70_000], [torch.float32, torch.bfloat16, torch.float16,
                                                   torch.bfloat16])[1]
    (factor, norm), launches = tfw._launch_norm(grads, 1.0)
    wf, wn = tfw.grad_clip_scale_plain(grads, 1.0)
    assert launches == 1 and fake.launches[-1] == ("norm", 4)
    np.testing.assert_allclose(float(norm), float(wn), rtol=1e-6)
    np.testing.assert_allclose(float(factor), float(wf), rtol=1e-6)


def test_launch_path_counts_no_launch_for_empty_leaves(fake):
    # A group whose leaves are all empty launches nothing and counts nothing
    # (the C entry would return before its launch); its outputs are empty.
    # A norm over empty leaves only is 0 with the factor 1, and no launch.
    rng = np.random.default_rng(52)
    ps, gs, ms, vs, ws = _leaves(rng, [0, 0, 5, 0], [torch.bfloat16, torch.bfloat16,
                                                     torch.float32, torch.float16])
    kw = dict(step=2, lr=1e-3, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.0)
    out, launches = tfw._launch(ps, gs, ms, vs, ws, [None] * 4, [0, 1, 2, 3], grad_scale=None,
                                key=None, **kw)
    assert launches == len(fake.launches) == 1 and fake.launches[0][:2] == (0, 0)
    want = tfw.fused_adamw_step_plain(ps, gs, ms, vs, ws, **kw)
    for k in range(4):
        for a, b in zip(out[k], want[k]):
            assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
    _, launches = tfw._launch(ps[:2], gs[:2], ms[:2], vs[:2], ws[:2], [None] * 2, [0, 1],
                              grad_scale=None, key=None, **kw)
    assert launches == 0 and len(fake.launches) == 1
    (factor, norm), launches = tfw._launch_norm([gs[0], gs[3]], 1.0)
    assert launches == 0 and len(fake.launches) == 1
    assert float(factor) == 1.0 and float(norm) == 0.0


def test_chunk_size():
    # 32768 elements a block where a launch fills the card eight blocks an
    # SM deep (Llama's and GPT-2's steps), down to 2048 for small ones (the
    # MNIST MLP's 109,386 elements: 57 blocks, not 9).
    assert tfw.chunk_size(1_235_814_400) == tfw.chunk_size(124_475_904) == 32768
    assert tfw.chunk_size(109_386) == tfw.chunk_size(1) == 2048
    assert tfw.chunk_size(32768 * 132 * 8) == 32768
    assert tfw.chunk_size(32768 * 132 * 8 - 1) == 16384


def test_archive_writes_each_view_leafs_own_elements(tmp_path):
    # The step's outputs are views of one flat buffer a stream: the archive
    # writes each leaf's own elements (not the buffer it views), and
    # restore_tree reads them back in the tree's structure, bit-equal.
    from mila_tpu_torch.serialization.archive import ModelArchive, OpenMode, restore_tree

    buf = torch.from_numpy(_np(70, 8 + 48 + 3 + 5).astype(np.float32)).bfloat16()
    tree = {"w": buf.as_strided((8, 6), (6, 1), 0), "b": buf.as_strided((3,), (1,), 56),
            "g": buf.as_strided((5,), (1,), 59)}
    with ModelArchive(tmp_path / "a.mila", OpenMode.WRITE) as ar:
        ar.write_tree("params", tree)
    with ModelArchive(tmp_path / "a.mila", OpenMode.READ) as ar:
        sizes = {k: len(ar.read_bytes(f"params/{k}.bin")) for k in tree}
        back = restore_tree(ar.read_tree("params"), tree)
    for k, t in tree.items():
        assert sizes[k] == 2 * t.numel()
        assert back[k].shape == t.shape and torch.equal(back[k], t)
