"""Flash attention under autograd against the JAX package: the row
statistics of the forward, the backward, and gradients end to end.

JAX's side runs its Pallas kernels in interpret mode (``interpret=True``),
tile by tile: ``_flash_attention_forward(save_stats=True)`` for the
statistics (lanes-padded; we compare column 0), ``flash_attention_bwd`` for
dq, dk, dv, and ``jax.grad`` through ``flash_attention``. The port's side
runs its plain versions on CPU tensors (``flash_attention_plain`` with
``save_stats``, ``flash_attention_bwd_plain``), all keys in one pass.
Causal and not, GQA (G 1, 2, 4), D 64, 128, 192, 256, 320 and 512, a ``kv_offset``
window and several KV tiles of 128 keys on JAX's side; f32, bf16 and fp16.

Tolerances: the same seeded inputs on both sides; f32 results differ by
summation order (tiles vs one pass, per-head dk/dv summed after the fact vs
inside one einsum): 2e-5 of the largest value of each output (1e-5
relative for l and m). In bf16 both sides round p and ds to bf16 before
their products, from maxima taken in another order, and round the outputs:
2e-2 of the largest value; in fp16 (8 times finer steps) 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu.kernels.flash_attention import _flash_attention_forward
from mila_tpu.kernels.flash_attention import flash_attention as j_flash
from mila_tpu.kernels.flash_attention_bwd import flash_attention_bwd as j_bwd
from mila_tpu_torch.kernels import flash_attention as tfa
from mila_tpu_torch.kernels import flash_attention_bwd as tfb

_TORCH = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
          jnp.float16: torch.float16}
_TOL = {jnp.float32: 2e-5, jnp.bfloat16: 2e-2, jnp.float16: 5e-3}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, dt, tol=None):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=(tol or _TOL[dt]) * float(np.abs(want).max()))


CASES = [  # B, Tq, Tkv, NH, NKV, D, kv_offset, causal
    (2, 256, 256, 2, 2, 64, 0, True),
    (1, 256, 256, 4, 1, 64, 0, True),  # G 4
    (1, 256, 256, 4, 2, 128, 0, True),  # D 128, G 2
    (1, 128, 512, 4, 2, 64, 384, True),  # kv_offset window over 4 KV tiles
    (2, 128, 256, 2, 1, 64, 0, False),  # not causal, Tq < Tkv
    (1, 256, 256, 4, 2, 192, 0, True),  # D 192 and 256: the card's two-warpgroup dK/dV
    (1, 128, 256, 2, 1, 256, 128, True),
    (1, 128, 256, 4, 2, 320, 128, True),  # past D 256: the card's column-part kernels
    (1, 128, 128, 4, 2, 512, 0, True),  # chip_smoke.py's timed D 512, G 2
]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16, jnp.float16])
def test_stats_and_backward_match_jax(case, dt):
    B, Tq, Tkv, NH, NKV, D, off, causal = case
    sm = D ** -0.5
    q, k, v, do = _arrays(Tq + D + NH, (B, NH, Tq, D), (B, NKV, Tkv, D), (B, NKV, Tkv, D),
                          (B, NH, Tq, D))
    jq, jk, jv, jdo = (jnp.asarray(a, dt) for a in (q, k, v, do))
    jo, jl, jm = _flash_attention_forward(jq, jk, jv, causal, sm, off, 128, 128, True,
                                          save_stats=True)
    # The port's forward takes the model layout [B, T, H, D].
    tq, tk, tv, tdo = (torch.from_numpy(a).to(_TORCH[dt]) for a in (q, k, v, do))
    calls = tfa.flash_attention_plain.calls
    to, tl, tm = tfa.flash_attention_forward(tq.transpose(1, 2), tk.transpose(1, 2),
                                             tv.transpose(1, 2), causal=causal, sm_scale=sm,
                                             kv_offset=off)
    assert tfa.flash_attention_plain.calls == calls + 1
    assert tl.dtype == tm.dtype == torch.float32 and tl.shape == (B, NH, Tq)
    _close(to.transpose(1, 2), jo, dt)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm[..., 0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl[..., 0]), rtol=1e-5 if dt ==
                               jnp.float32 else 1e-4, atol=1e-5)
    assert to.dtype == _TORCH[dt]

    # The backward on JAX's own (q, k, v, o, l, m, do).
    jdq, jdk, jdv = j_bwd(jq, jk, jv, jo, jl, jm, jdo, causal=causal, sm_scale=sm,
                          kv_offset=off, block_q=128, block_k=128, interpret=True)
    bridged = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(_TORCH[dt])
               for a in (jq, jk, jv, jo, jdo)]
    tl0, tm0 = (torch.from_numpy(np.array(a[..., 0])) for a in (jl, jm))
    calls = tfb.flash_attention_bwd_plain.calls
    got = tfb.flash_attention_bwd(*bridged[:4], tl0, tm0, bridged[4], causal=causal,
                                  sm_scale=sm, kv_offset=off)
    assert tfb.flash_attention_bwd_plain.calls == calls + 1
    for a, b in zip(got, (jdq, jdk, jdv)):
        assert a.dtype == _TORCH[dt]
        _close(a, b, dt)


@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16, jnp.float16])
@pytest.mark.parametrize("nkv,off,D", [(2, 0, 64), (1, 128, 64), (2, 0, 320)])
def test_autograd_through_flash_matches_jax_grad(dt, nkv, off, D):
    # torch.autograd.grad through the port's flash_attention (its Function:
    # the forward with statistics, then flash_attention_bwd) against
    # jax.grad of JAX's flash_attention (its custom VJP, interpret mode).
    B, Tq, NH = 2, 128, 4
    Tkv = Tq + off
    q, k, v, w = _arrays(7 + off, (B, Tq, NH, D), (B, Tkv, nkv, D), (B, Tkv, nkv, D),
                         (B, Tq, NH, D))

    def jloss(a, b, c):
        out = j_flash(a, b, c, causal=True, kv_offset=off, block_q=64, block_k=128,
                      interpret=True)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(w))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a, dt) for a in (q, k, v)))
    ts = [torch.from_numpy(a).to(_TORCH[dt]).requires_grad_() for a in (q, k, v)]
    calls = (tfa.flash_attention_plain.calls, tfb.flash_attention_bwd_plain.calls)
    out = tfa.flash_attention(*ts, causal=True, kv_offset=off)
    tg = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), ts)
    assert (tfa.flash_attention_plain.calls, tfb.flash_attention_bwd_plain.calls) == (
        calls[0] + 1, calls[1] + 1)
    for a, b in zip(tg, jg):
        _close(a, b, dt)


def test_no_grad_takes_the_primal_path():
    # Without grad the call writes no statistics and saves nothing; under
    # grad on a shape the tiling gate refuses, autograd runs through the
    # plain product instead (JAX's wrapper: its jnp reference).
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in
               _arrays(3, (1, 24, 2, 16), (1, 24, 2, 16), (1, 24, 2, 16)))
    with torch.no_grad():
        out = tfa.flash_attention(q, k, v)
    assert out.grad_fn is None
    out = tfa.flash_attention(q, k, v)
    assert "FlashFn" not in type(out.grad_fn).__name__
    g = torch.autograd.grad(out.sum(), q)[0]
    assert torch.isfinite(g).all()
