"""The port's flash-attention backward against the JAX package's, on the CPU.

The same numpy inputs (fixed seed) go through ``jax.vjp`` of the JAX
package's Pallas ``flash_attention`` in interpret mode (its ``_dq_kernel``
and ``_dkv_kernel`` behind the ``_flash_core`` custom VJP, as
``tests/test_ops.py`` runs them), and through the port's plain backward
``flash_attention_bwd_reference`` and the autograd Function behind the
port's ``flash_attention``, whose CPU path runs the plain versions.  fp32
throughout, the JAX side at ``highest`` matmul precision.

Tolerance: 2e-5 of the gradient's largest element.  Both sides compute
the same fp32 products and ``p = exp(s - lse)`` from the same formula;
only the summation order differs (the Pallas kernels sum key and query
blocks of up to 512 into fp32 scratch, the port sums whole rows), about
1e-6 relative at these lengths.

The CUDA kernels run only on the card: ``test_torch_port_gpu.py`` holds
them against the plain version there.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu.ops import attention as jax_attention
from distributed_training_comparison_tpu.ops import flash_attention as jax_flash

port = importlib.import_module("distributed_training_comparison_tpu_torch.ops.attention")

REL_TOL = 2e-5  # of max |grad|: fp32 summation order only


def _inputs(seed, b, h, s, d, layout="bhsd"):
    rng = np.random.default_rng(seed)
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(4))
    dlse = rng.standard_normal((b, h, s)).astype(np.float32)
    return q, k, v, do, dlse


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=REL_TOL * float(np.abs(want).max()), rtol=0)


def _jax_vjp(fn, q, k, v, do, dlse):
    with jax.default_matmul_precision("highest"):
        (out, lse), vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
        grads = vjp((jnp.asarray(do), jnp.asarray(dlse)))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


# (b, h, s, d, causal): a multiple of the Pallas blocks, a ragged causal
# length, head dim 128; then the shapes the bf16 CUDA kernels tile
# differently: a ragged causal length at head dim 128 (inside dq's second
# 128-key tile, past dk/dv's third 64-query tile) and S 320 (five 64-query
# tiles, two and a half 128-key tiles)
CASES = [
    (2, 2, 256, 64, False), (1, 2, 130, 64, True), (1, 2, 128, 128, False),
    (1, 2, 200, 128, True), (1, 1, 320, 64, False),
]


@pytest.mark.parametrize("b,h,s,d,causal", CASES)
@pytest.mark.parametrize("with_dlse", [False, True])
def test_backward_matches_jax_pallas_backward(b, h, s, d, causal, with_dlse):
    q, k, v, do, dlse = _inputs(s + d + causal, b, h, s, d)
    if not with_dlse:
        dlse = np.zeros_like(dlse)

    def jax_fn(q, k, v):
        return jax_flash(q, k, v, causal=causal, return_lse=True, interpret=True)

    out_j, lse_j, grads_j = _jax_vjp(jax_fn, q, k, v, do, dlse)

    # the plain backward on the port's own forward residuals
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    out_p, lse_p = port.mha_reference(*t[:3], causal=causal, return_lse=True)
    _close(out_p.numpy(), out_j)
    _close(lse_p.numpy(), lse_j)
    plain = port.flash_attention_bwd_reference(
        *t[:3], out_p, lse_p, t[3], torch.from_numpy(dlse) if with_dlse else None,
        causal=causal, scale=d**-0.5,
    )
    for g, w in zip(plain, grads_j):
        _close(g.numpy(), w)

    # the autograd Function: an unused lse gives it a dlse of None
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = port.flash_attention(qt, kt, vt, causal=causal, return_lse=True)
    loss = (out * t[3]).sum()
    if with_dlse:
        loss = loss + (lse * torch.from_numpy(dlse)).sum()
    for g, w in zip(torch.autograd.grad(loss, (qt, kt, vt)), grads_j):
        _close(g.numpy(), w)


def test_bshd_views_through_the_dispatcher_match_jax():
    """``attention(impl="kernel", layout="bshd")`` reads (B, S, H, D) through
    transposed views on both sides; the gradients come back in (B, S, H, D)."""
    q, k, v, do, _ = _inputs(7, 2, 2, 130, 64, layout="bshd")

    def jax_fn(q, k, v):
        return jax_attention(q, k, v, causal=True, impl="pallas", layout="bshd", interpret=True)

    with jax.default_matmul_precision("highest"):
        out_j, vjp = jax.vjp(jax_fn, *(jnp.asarray(a) for a in (q, k, v)))
        grads_j = vjp(jnp.asarray(do))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = port.attention(qt, kt, vt, causal=True, impl="kernel", layout="bshd")
    _close(out.detach().numpy(), np.asarray(out_j))
    grads = torch.autograd.grad((out * torch.from_numpy(do)).sum(), (qt, kt, vt))
    for g, w in zip(grads, grads_j):
        assert g.shape == qt.shape
        _close(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("causal", [False, True])
def test_function_gradients_equal_autograd_of_mha_reference(causal):
    """The Function's plain backward (``delta = rowsum(dO∘O)``) against
    torch's own autograd through ``mha_reference``'s softmax: the same
    gradients up to fp32 summation order, with an lse cotangent too."""
    q, k, v, do, dlse = _inputs(3 + causal, 2, 2, 96, 64)
    grads = []
    for fn in (port.flash_attention, port.mha_reference):
        qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
        out, lse = fn(qt, kt, vt, causal=causal, return_lse=True)
        loss = (out * torch.from_numpy(do)).sum() + (lse * torch.from_numpy(dlse)).sum()
        grads.append(torch.autograd.grad(loss, (qt, kt, vt)))
    for g, w in zip(*grads):
        _close(g.numpy(), w.numpy())


def test_cpu_backward_wrappers_take_the_plain_version():
    """On CPU tensors the kernel wrappers return the plain version's
    gradients and launch nothing."""
    q, k, v, do, dlse = (torch.from_numpy(a) for a in _inputs(5, 1, 2, 64, 64))
    out, lse = port.mha_reference(q, k, v, return_lse=True)
    adj = dlse - (do * out).sum(-1)
    before = (port.flash_attention_dq.launches, port.flash_attention_dkv.launches)
    dq = port.flash_attention_dq(q, k, v, do, lse, adj, causal=False, scale=0.125)
    dk, dv = port.flash_attention_dkv(q, k, v, do, lse, adj, causal=False, scale=0.125)
    assert (port.flash_attention_dq.launches, port.flash_attention_dkv.launches) == before
    want = port.flash_attention_bwd_reference(
        q, k, v, out, lse, do, dlse, causal=False, scale=0.125
    )
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
