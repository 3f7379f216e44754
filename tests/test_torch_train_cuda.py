"""The training paths this slice puts on the card, against their plain
versions and the port's CPU path.

Marked ``requires_cuda``: without a CUDA device these tests skip (decided in
a fixture, never at import). Run them on a GPU machine with
``python -m pytest --noconftest tests/test_torch_train_cuda.py -q``
(``tests/conftest.py`` imports JAX, which a GPU machine need not have).
``chip_smoke.py`` repeats these checks at Llama-3.2-1B's and the CNN's
training shapes.

- K13 at Llama-3.2-1B's vocabulary (128256): bf16 rows of 256 KB exceed
  the backward's shared-memory budget, so every row streams; each loss
  within 1e-4 + 1e-5 |ref| of the plain version's, each dlogit within one
  bf16 step (2^-7) of its own size, floored at 1e-8 of the largest.
- ``conv2d`` in f32 on the card against the CPU with TF32 allowed
  globally (PyTorch's default for cuDNN): forward and gradients within
  1e-5 of their largest value, which TF32's 2^-11 products would miss, and
  the global flag is as it was after the call.
- A 2-layer tiny-width Llama (H 128, NH 2 / NKV 1, D 64, T 128, bf16, the
  flash kernels forced): one ``Model`` step's loss within 1e-2 relative of
  the CPU path's, every gradient leaf with cosine >= 0.999 or within 2e-2
  of its largest value, as ``chip_smoke.py``'s ``parity train`` holds them.
- ``embedding_lookup``'s backward on the card: two calls bit-equal (the
  segment sum adds a token's rows in a fixed order), and within 1e-5 of
  the CPU's.
- ``max_pool2d``'s gradient over tied windows bit-equal to the CPU's
  (each window's first maximum takes it).
- ``AdamW.step`` with a clip and SR masters over a bf16 + f32 tree: one
  norm launch and one update launch per dtype group a step; m, v and the
  masters within 8 f32 ulps of a leaf's largest value of the CPU step's
  (the clip's norm sums in another order: its factor may be an ulp apart)
  and every bf16 param equal to the CPU's wherever its master is (the
  same JAX bits on both devices); the whole step captured in a CUDA graph
  (no host sync in it) and replayed equal to an eager step.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.requires_cuda


@pytest.fixture(autouse=True)
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the port's kernels run only on the GPU")
    return torch.device("cuda")


def _rand(shape, seed, scale=1.0, dtype=torch.float32, device="cuda"):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device, dtype)


@pytest.mark.parametrize("M", [16, 37])
def test_softmax_ce_streamed_at_llama_vocab(cuda, M):
    from mila_tpu_torch.kernels import softmax_ce as ce

    V = 128256
    assert ce.ce_bwd_variant(V, 2) == "streamed"
    x = _rand((M, V), 90, scale=3.0, dtype=torch.bfloat16)
    t = torch.from_numpy(np.random.default_rng(91).integers(0, V, M)).cuda()
    t[::5] = -100
    t32 = t.to(torch.int32)
    g = _rand((M,), 92)
    loss = ce.fused_softmax_cross_entropy(x, t)
    want = ce.fused_softmax_cross_entropy_plain(x, t32)
    assert ((loss - want).abs() <= 1e-4 + 1e-5 * want.abs()).all()
    before = ce.fused_softmax_cross_entropy_bwd.launches
    d = ce.fused_softmax_cross_entropy_bwd(x, t32, g)
    assert ce.fused_softmax_cross_entropy_bwd.launches == before + 1
    ref = ce.fused_softmax_cross_entropy_bwd_plain(x, t32, g)
    assert d.dtype == torch.bfloat16 and (d[::5] == 0).all()
    err = (d.float() - ref.float()).abs()
    assert (err <= 2 ** -7 * ref.float().abs() + 1e-8 * ref.float().abs().max()).all()
    assert torch.equal(d, ce.fused_softmax_cross_entropy_bwd(x, t32, g))


@pytest.mark.parametrize("stride,padding", [(1, "SAME"), (2, "SAME"), (1, "VALID")])
def test_conv2d_f32_on_the_card_runs_without_tf32(cuda, stride, padding):
    from mila_tpu_torch.ops import conv2d

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        x, w, b = _rand((8, 28, 28, 32), 93), _rand((3, 3, 32, 64), 94, 0.1), _rand((64,), 95)
        g = _rand((8, 28 // stride if padding == "SAME" else 26,
                   28 // stride if padding == "SAME" else 26, 64), 96)
        outs = []
        for dev in ("cuda", "cpu"):
            leaves = [t.to(dev).requires_grad_() for t in (x, w, b)]
            y = conv2d(*leaves, stride=stride, padding=padding)
            outs.append([y, *torch.autograd.grad(y, leaves, g.to(dev))])
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    for got, want in zip(*outs):
        err = (got.cpu() - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err


def test_llama_train_step_on_the_card_matches_the_cpu(cuda):
    from mila_tpu_torch import kernels
    from mila_tpu_torch.models.llama import Llama, LlamaConfig
    from mila_tpu_torch.models.model import Model, ModelConfig
    from mila_tpu_torch.optim import AdamW, AdamWConfig
    from mila_tpu_torch.utils.tree import tree_leaves, tree_map

    cfg = LlamaConfig.tiny().replace(num_heads=2, num_kv_heads=1, param_dtype="bfloat16",
                                     attention_impl="flash")
    toks = np.random.default_rng(97).integers(0, cfg.vocab_size, (2, 129))
    out, params = {}, None
    for dev in ("cpu", "cuda"):
        model = Model(Llama(cfg, device=dev),
                      AdamW(AdamWConfig(stochastic_rounding=True, grad_clip_norm=1.0)),
                      ModelConfig(epochs=1, verbose=False), device=dev)
        if params is None:
            model.build(0, (2, 128))
            params = model.params
        else:
            model.params = tree_map(lambda p: p.to(dev), params)
            model.opt_state = model.optimizer.init(model.params)
            model._compile()
        x, y = (torch.from_numpy(a).to(dev) for a in (toks[:, :-1], toks[:, 1:]))
        kernels.reset_launches()
        out[dev] = model._value_and_grad(model.params, x, y)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            assert counts == {"flash_attention_forward": 2, "flash_attention_bwd": 2,
                              "fused_softmax_cross_entropy": 1,
                              "fused_softmax_cross_entropy_bwd": 1}
    (l_c, g_c), (l_g, g_g) = out["cpu"], out["cuda"]
    assert abs(float(l_g) - float(l_c)) <= 1e-2 * abs(float(l_c))
    for a, b in zip(tree_leaves(g_g), tree_leaves(g_c)):
        a, b = a.double().cpu().reshape(-1), b.double().reshape(-1)
        cos = (a @ b / (a.norm() * b.norm()).clamp_min(1e-300)).item()
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()
        assert cos >= 0.999 or rel <= 2e-2, (cos, rel)


def test_embedding_lookup_backward_is_bit_reproducible(cuda):
    from mila_tpu_torch.ops import embedding_lookup

    toks = torch.from_numpy(np.random.default_rng(98).integers(0, 50, (8, 512))).cuda()
    table = _rand((1000, 256), 99).requires_grad_()
    g = _rand((8, 512, 256), 100)
    first, second = (torch.autograd.grad(embedding_lookup(toks, table), table, g)[0]
                     for _ in range(2))
    assert torch.equal(first, second)
    t_cpu = table.detach().cpu().requires_grad_()
    (want,) = torch.autograd.grad(embedding_lookup(toks.cpu(), t_cpu), t_cpu, g.cpu())
    assert (first.cpu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def test_max_pool_ties_on_the_card_match_the_cpu(cuda):
    # Windows tied several ways (values 0..2): each window's cotangent goes
    # to its first maximum on the card as on the CPU, bit for bit.
    from mila_tpu_torch.ops import max_pool2d

    x = torch.from_numpy(np.random.default_rng(101).integers(0, 3, (4, 28, 28, 32))
                         .astype(np.float32))
    g = _rand((4, 14, 14, 32), 102, device="cpu")
    grads = []
    for dev in ("cuda", "cpu"):
        xd = x.to(dev).requires_grad_()
        grads.append(torch.autograd.grad(max_pool2d(xd, 2), xd, g.to(dev))[0].cpu())
    assert torch.equal(*grads)


def _adamw_tree(device):
    gen = np.random.default_rng(60)

    def r(*shape, scale=1.0, dtype=torch.float32):
        return torch.from_numpy(gen.standard_normal(shape).astype(np.float32) * scale).to(
            device, dtype)

    return ({"wte": r(1000, 64, scale=0.02, dtype=torch.bfloat16),
             "h": {"w": r(64, 3000, scale=0.05, dtype=torch.bfloat16),
                   "norm": 1.0 + r(64, scale=0.1)},
             "b": r(77, dtype=torch.bfloat16)},
            {"wte": r(1000, 64, scale=3.0, dtype=torch.bfloat16),
             "h": {"w": r(64, 3000, scale=3.0, dtype=torch.bfloat16), "norm": r(64)},
             "b": r(77, dtype=torch.bfloat16)})


def _leaves_of(*trees):
    from mila_tpu_torch.utils.tree import tree_leaves

    return [leaf for t in trees for leaf in tree_leaves(t)]


def test_adamw_step_on_the_card_matches_the_cpu(cuda):
    from mila_tpu_torch import kernels
    from mila_tpu_torch.optim import AdamW, AdamWConfig
    from mila_tpu_torch.utils.tree import tree_leaves

    opt = AdamW(AdamWConfig(learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=1.0,
                            stochastic_rounding=True))
    out = {}
    for dev in ("cpu", "cuda"):
        params, grads = _adamw_tree(dev)
        state = opt.init(params)
        kernels.reset_launches()
        for _ in range(2):
            params, state = opt.step(state, params, grads)
        out[dev] = (params, state)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = {k: v for k, v in kernels.launch_counts().items() if v}
            assert counts == {"grad_clip_scale": 2, "fused_adamw_step": 4}
    (p_c, s_c), (p_g, s_g) = out["cpu"], out["cuda"]
    for a, b in zip(_leaves_of(s_g.m, s_g.v, s_g.master), _leaves_of(s_c.m, s_c.v, s_c.master)):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 8 * 2 ** -23 * b.abs().max().item(), err
    equal = 0
    for a, b, wa, wb in zip(tree_leaves(p_g), tree_leaves(p_c), tree_leaves(s_g.master),
                            tree_leaves(s_c.master)):
        same = wa.cpu() == wb
        equal += int(same.sum())
        assert torch.equal(a.cpu()[same], b[same])
    assert equal > 0.3 * sum(t.numel() for t in tree_leaves(p_c))


def test_adamw_step_captures_in_a_cuda_graph(cuda):
    # A captured step replays that step: each replay equals the eager step
    # it captured (the step count, learning rate and key are values in the
    # launch), never the next one.
    from mila_tpu_torch.optim import AdamW, AdamWConfig

    opt = AdamW(AdamWConfig(learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=1.0,
                            stochastic_rounding=True))
    params, grads = _adamw_tree("cuda")
    state = opt.init(params)
    want = opt.step(state, params, grads)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = opt.step(state, params, grads)
    nxt = opt.step(want[1], want[0], grads)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(_leaves_of(got[0], got[1].m, got[1].v, got[1].master),
                        _leaves_of(want[0], want[1].m, want[1].v, want[1].master)):
            assert torch.equal(a, b)
    assert not torch.equal(got[1].m["h"]["w"], nxt[1].m["h"]["w"])
