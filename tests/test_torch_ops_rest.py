"""The remaining functional ops of the port against the JAX package:
``rms_norm`` (and ``rms_norm_ref``) and ``swiglu`` with JAX's custom VJPs,
``embedding_lookup`` (repeated tokens), ``apply_rope_interleaved``,
``log_softmax``, ``cross_entropy_from_probs`` and ``linear_gelu``, each
forward and gradient against ``jax.vjp`` of the JAX function on the same
inputs and cotangent, in f32 and bf16; and the ``operations`` registry's
names against JAX's.

Tolerances, of each output's largest magnitude: f32 1e-5 (the same f32
formulas in other summation orders). bf16 2^-6: both sides compute in f32
and round once where the op says so (one bf16 step is 2^-8 of a value,
2^-7 of the largest where a rounding tie falls the other way), while
JAX's ``swiglu`` forward and ``jnp.take``'s scatter-add run in bf16 and
round after each operation, a few steps more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mila_tpu.ops as jops
from mila_tpu.utils.registry import operations as j_operations
from mila_tpu_torch import ops
from mila_tpu_torch.utils.registry import operations

TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
DTYPES = ("float32", "bfloat16")


def _arr(rng, shape, dtype, scale=1.0):
    """The same values on both sides: f32 draws rounded once to ``dtype``."""
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype, what=""):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=TOL[dtype] * max(np.abs(want).max(), 1e-30), err_msg=what)


def _check(jfn, tfn, jargs, targs, dtype, diff, seed=9):
    """Forward of both; then the VJP of JAX's function and autograd of the
    port's for the arguments at positions ``diff``, on one cotangent."""
    jout, vjp = jax.vjp(lambda *d: jfn(*[d[diff.index(i)] if i in diff else a
                                         for i, a in enumerate(jargs)]),
                        *[jargs[i] for i in diff])
    leaves = [targs[i].clone().requires_grad_() if i in diff else targs[i]
              for i in range(len(targs))]
    tout = tfn(*leaves)
    assert tout.shape == jout.shape and tout.dtype == getattr(torch, str(jout.dtype))
    _close(tout, jout, dtype, "forward")
    jg, tg = _arr(np.random.default_rng(seed), jout.shape, str(jout.dtype))
    jgrads = vjp(jg)
    tgrads = torch.autograd.grad(tout, [leaves[i] for i in diff], tg)
    for i, a, b in zip(diff, tgrads, jgrads):
        assert a.dtype == targs[i].dtype
        _close(a, b, dtype, f"gradient of argument {i}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ref", [False, True])
def test_rms_norm_forward_and_vjp(dtype, ref):
    rng = np.random.default_rng(0)
    jx, tx = _arr(rng, (3, 5, 64), dtype, 2.0)
    jg, tg = _arr(rng, (64,), dtype)
    jg, tg = jg + 1, tg + 1
    jfn, tfn = (jops.rms_norm_ref, ops.rms_norm_ref) if ref else (jops.rms_norm, ops.rms_norm)
    _check(lambda x, g: jfn(x, g, 1e-5), lambda x, g: tfn(x, g, 1e-5), (jx, jg), (tx, tg),
           dtype, diff=[0, 1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_swiglu_forward_and_vjp(dtype):
    rng = np.random.default_rng(1)
    jgate, tgate = _arr(rng, (4, 7, 96), dtype, 3.0)
    jup, tup = _arr(rng, (4, 7, 96), dtype)
    _check(jops.swiglu, ops.swiglu, (jgate, jup), (tgate, tup), dtype, diff=[0, 1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_embedding_lookup_forward_and_vjp(dtype):
    # Repeated tokens: the table's gradient sums their rows.
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 13, (3, 40)).astype(np.int32)
    jt, tt = _arr(rng, (13, 32), dtype)
    _check(lambda tab: jops.embedding_lookup(jnp.asarray(toks), tab),
           lambda tab: ops.embedding_lookup(torch.from_numpy(toks), tab), (jt,), (tt,),
           dtype, diff=[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope_interleaved_forward_and_vjp(dtype):
    rng = np.random.default_rng(3)
    jx, tx = _arr(rng, (2, 9, 4, 32), dtype)
    pos = np.arange(9)[None].repeat(2, 0)
    jc, js = jops.rope_cos_sin(jnp.asarray(pos), 32, 10000.0)
    tc, ts = ops.rope_cos_sin(torch.from_numpy(pos), 32, 10000.0)
    _check(lambda x: jops.apply_rope_interleaved(x, jc, js),
           lambda x: ops.apply_rope_interleaved(x, tc, ts), (jx,), (tx,), dtype, diff=[0])


@pytest.mark.parametrize("axis", [-1, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_log_softmax_forward_and_vjp(dtype, axis):
    rng = np.random.default_rng(4)
    jx, tx = _arr(rng, (3, 17, 33), dtype, 4.0)
    _check(lambda x: jops.log_softmax(x, axis), lambda x: ops.log_softmax(x, axis), (jx,),
           (tx,), dtype, diff=[0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_entropy_from_probs_forward_and_vjp(dtype):
    rng = np.random.default_rng(5)
    p = rng.dirichlet(np.ones(11), size=(4, 6)).astype(np.float32)
    t = rng.integers(0, 11, (4, 6)).astype(np.int32)
    jp, tp = jnp.asarray(p).astype(dtype), torch.from_numpy(p).to(getattr(torch, dtype))
    _check(lambda q: jops.cross_entropy_from_probs(q, jnp.asarray(t)),
           lambda q: ops.cross_entropy_from_probs(q, torch.from_numpy(t)), (jp,), (tp,),
           "float32", diff=[0])


@pytest.mark.parametrize("approximation", ["tanh", "exact", "sigmoid"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_linear_gelu_forward_and_vjp(dtype, approximation):
    rng = np.random.default_rng(6)
    jx, tx = _arr(rng, (5, 3, 24), dtype)
    jw, tw = _arr(rng, (24, 40), dtype, 0.3)
    jb, tb = _arr(rng, (40,), dtype, 0.1)
    _check(lambda x, w, b: jops.linear_gelu(x, w, b, approximation),
           lambda x, w, b: ops.linear_gelu(x, w, b, approximation), (jx, jw, jb),
           (tx, tw, tb), dtype, diff=[0, 1, 2])


def test_rms_norm_saves_f32_statistics_and_bf16_sums_in_f32():
    # dgamma over many rows is summed in f32 before its one rounding: a
    # bf16 running sum of 4096 rows of ~1 would stall near 256 + ... far
    # from the f32 sum.
    x = torch.ones(4096, 8, dtype=torch.bfloat16).requires_grad_()
    gamma = torch.ones(8, dtype=torch.bfloat16).requires_grad_()
    y = ops.rms_norm(x, gamma)
    (dg,) = torch.autograd.grad(y, gamma, torch.ones_like(y))
    assert dg.dtype == torch.bfloat16 and torch.all(dg == 4096)


def test_operations_registry_names_equal_jax():
    assert operations.names() == j_operations.names()
    assert operations.get("FusedOp") is ops.linear_gelu
    assert operations.get("Conv2DOp") is ops.conv2d
    assert operations.get("RMSNormOp") is ops.rms_norm
    assert operations.get("SwiGLUOp") is ops.swiglu
