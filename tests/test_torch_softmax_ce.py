"""Fused softmax cross-entropy against the JAX package: the port's
``fused_softmax_cross_entropy`` (on CPU tensors its plain versions, forward
and backward) and ``ops.softmax_cross_entropy`` (which routes to it)
against JAX's ``fused_softmax_cross_entropy`` (its Pallas kernels in
interpret mode; at shapes its tiling gate refuses, its jnp reference) and
JAX's ``ops.softmax_cross_entropy``, losses and dlogits, with
``ignore_index`` rows and 3-D logits.

Tolerances: the loss is logsumexp minus the picked logit in f32 on both
sides, sums in other orders over up to 1000 classes: rtol/atol 2e-5. The
f32 gradient (p - onehot) * g likewise (atol 1e-6 on values below 1). bf16
gradients are one rounding of those f32 values: one bf16 step, 1e-2 of the
largest value; fp16 gradients one fp16 step, 1e-3 of the largest value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mila_tpu import ops as jops
from mila_tpu.kernels.softmax_ce import fused_softmax_cross_entropy as j_fused
from mila_tpu_torch import ops as tops
from mila_tpu_torch.kernels import softmax_ce as tce

_TORCH = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
          jnp.float16: torch.float16}


def _case(lead, V, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((*lead, V)) * 3.0).astype(np.float32)
    t = rng.integers(0, V, lead).astype(np.int32)
    t.reshape(-1)[::3] = -100
    g = rng.standard_normal(lead).astype(np.float32)
    return logits, t, g


def _check(tl, td, jl, jd, dt):
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), rtol=2e-5, atol=2e-5)
    want = np.asarray(jd.astype(jnp.float32))
    got = td.float().numpy()
    assert td.dtype == _TORCH[dt] and got.shape == want.shape
    if dt == jnp.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        step = 1e-2 if dt == jnp.bfloat16 else 1e-3
        np.testing.assert_allclose(got, want, rtol=0, atol=step * np.abs(want).max())


@pytest.mark.parametrize("lead,V", [((16,), 256), ((2, 8), 384), ((3, 5), 1000), ((7,), 50),
                                    ((64,), 10), ((5, 3), 2), ((9,), 33)])
@pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16, jnp.float16])
@pytest.mark.parametrize("entry", ["fused", "ops"])
def test_loss_and_dlogits_match_jax(lead, V, dt, entry):
    # (16, 256) and (2, 8, 384) pass JAX's gate (its kernels run); (3, 5,
    # 1000), (7, 50) and the short rows (V 10, 2 and 33: the card's short
    # forward) do not (its jnp reference runs): the port's route is the same
    # op at every shape.
    logits, t, g = _case(lead, V, V + len(lead))
    jx = jnp.asarray(logits, dt)
    if entry == "fused":
        jf = lambda x: j_fused(x, jnp.asarray(t), -100, 8, True)  # noqa: E731
        tf = tce.fused_softmax_cross_entropy
    else:
        jf = lambda x: jops.softmax_cross_entropy(x, jnp.asarray(t))  # noqa: E731
        tf = tops.softmax_cross_entropy
    jl, vjp = jax.vjp(jf, jx)
    (jd,) = vjp(jnp.asarray(g))
    x = torch.from_numpy(logits).to(_TORCH[dt]).requires_grad_()
    calls = (tce.fused_softmax_cross_entropy_plain.calls,
             tce.fused_softmax_cross_entropy_bwd_plain.calls)
    tl = tf(x, torch.from_numpy(t))
    (td,) = torch.autograd.grad(tl, x, torch.from_numpy(g))
    assert (tce.fused_softmax_cross_entropy_plain.calls,
            tce.fused_softmax_cross_entropy_bwd_plain.calls) == (calls[0] + 1, calls[1] + 1)
    assert tl.dtype == torch.float32 and tl.shape == lead
    _check(tl, td, jl, jd, dt)
    ignored = torch.from_numpy(t) == -100
    assert (tl[ignored] == 0).all() and (td[ignored] == 0).all()


def test_int64_targets_and_other_ignore_index():
    logits, t, g = _case((12,), 128, 5)
    t[t == -100] = 3
    jl = j_fused(jnp.asarray(logits), jnp.asarray(t), 3, 4, True)
    tl = tce.fused_softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(t).long(),
                                         ignore_index=3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=2e-5, atol=2e-5)
    assert (tl[torch.from_numpy(t) == 3] == 0).all()


@pytest.mark.parametrize("V,itemsize,variant", [
    (50304, 2, "resident"),   # GPT-2's vocab in bf16: 100.6 KB, two rows an SM
    (50304, 4, "streamed"),   # f32: 201 KB, past the budget
    (57344, 2, "resident"),   # exactly the budget
    (57352, 2, "streamed"),   # one chunk past it
    (1000, 2, "resident"),
    (1001, 2, "scalar"),      # 2002 bytes: not whole 16-byte chunks
    (1027, 4, "scalar"),
    (4096, 4, "resident"),
])
def test_ce_bwd_variant_chooser(V, itemsize, variant):
    """The backward kernel's variant is a pure function of V, the element
    size and the shared-memory budget: rows of whole 16-byte chunks within
    the budget stay resident, larger ones stream, the others go one element
    at a time."""
    assert tce.ce_bwd_variant(V, itemsize) == variant
    assert tce.ce_bwd_variant(V, itemsize, smem=V * itemsize - 16) in ("streamed", "scalar")


@pytest.mark.parametrize("V,itemsize,variant", [
    (10, 4, "short"),     # the MNIST and CNN steps' rows: several a warp
    (2, 2, "short"),
    (33, 4, "short"),     # a warp a row
    (tce.CE_SHORT_MAX_V, 4, "short"),
    (tce.CE_SHORT_MAX_V + 1, 2, "row"),
    (50304, 2, "row"),    # GPT-2's vocab
    (128256, 2, "row"),   # Llama-3.2-1B's
])
def test_ce_fwd_variant_chooser(V, itemsize, variant):
    """The forward kernel's variant is a pure function of V: a warp per row
    (several rows a warp up to V 16) up to CE_SHORT_MAX_V elements, a block
    per row above."""
    assert tce.ce_fwd_variant(V, itemsize) == variant
