"""The short-sequence attention past one key tile (bf16 S > 64: the tiled
``wgmma`` kernels ``attn_small_fwd_bf16``, ``attn_small_dq_bf16``,
``attn_small_dkv_bf16``) against the JAX package's, on the CPU.

``vit_small --patch-size 2`` (256 tokens) pinned to ``fused_small`` runs
them in every block on the card.  Here the model, reduced in depth, goes
through the port's plain versions against the JAX model; the rule on the
shape that picks the kernels' one or two sweeps over the keys is held
against the constants of ``ops/csrc/attention_small.cu``; and a torch
emulation of the kernels' arithmetic (64-query tiles, the keys a block
holds, exp2 of scores in units of scale·log2e, the online first sweep past
them, the correctly rounded quotient, P and dS rounded to bf16 where the
kernels round them) is held against JAX ``head_fwd``/``head_bwd``.  The
CUDA kernels themselves run only on the card (``test_torch_port_gpu.py``,
``chip_smoke.py``).
"""

import importlib
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_training_comparison_tpu import models as jax_models
from distributed_training_comparison_tpu.ops.attention_small import _head_probs
from distributed_training_comparison_tpu.ops.attention_small import head_bwd as jax_head_bwd
from distributed_training_comparison_tpu.ops.attention_small import head_fwd as jax_head_fwd
from distributed_training_comparison_tpu_torch import models as port_models
from distributed_training_comparison_tpu_torch.models import vit_from_jax

small = importlib.import_module("distributed_training_comparison_tpu_torch.ops.attention_small")
SRC = (Path(small.__file__).parent / "csrc" / "attention_small.cu").read_text()
LOG2E = 1.4426950408889634
NEG_INF = -1e30
TILE = 64  # query rows a block, keys a tile


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC).group(1))


def _row_share(got, want, rtol):
    """The least share of each row's rms under which ``got`` holds against
    ``want`` elementwise with ``rtol`` (a row: one token's D values)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rms = np.maximum(np.sqrt((want**2).mean(-1, keepdims=True)), 1e-30)
    return float(((np.abs(got - want) - rtol * np.abs(want)) / rms).max())


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _ce(logits, labels):
    return jnp.mean(-jax.nn.log_softmax(logits)[jnp.arange(len(labels)), labels])


def test_vit_small_p2_pinned_to_fused_small_matches_jax(monkeypatch):
    """A reduced ``vit_small --patch-size 2`` (depth 2 of 12; dim 384, 6
    heads of 64, 256 tokens at 32 px: the full width) pinned to
    ``attn_impl="fused_small"``, its weights carried across from a JAX ViT
    by ``vit_from_jax``: the logits, and one step's cross-entropy and every
    parameter gradient, against the JAX model with
    ``attn_impl="reference"`` at ``highest`` (the JAX pinned path needs a
    TPU, as ``test_vit_tiny_pinned_to_fused_small_matches_jax`` says).
    Both compute the same function in fp32, with the tolerances of that
    test: 2e-5 absolute on the logits, the loss to 1e-5 relative, each
    gradient within 2e-5 of its leaf's largest value."""
    kw = dict(depth=2, dim=384, heads=6, patch=2, image_size=32)
    model = jax_models.ViT(attn_impl="reference", **kw)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = np.array([3, 17, 0, 99])
    params = jax.device_get(model.init(jax.random.key(8), jnp.zeros((1, 32, 32, 3)))["params"])
    with jax.default_matmul_precision("highest"):
        logits_j = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
        loss_j, grads_j = jax.value_and_grad(
            lambda p: _ce(model.apply({"params": p}, jnp.asarray(x)), jnp.asarray(labels))
        )(params)
    port = port_models.ViT(attn_impl="fused_small", **kw)
    port.load_state_dict(vit_from_jax(params))  # strict: every key matches
    calls = []
    real = small._SmallMHA.apply

    def counted(*args):
        calls.append(args[3:6])  # (seq, heads, causal)
        return real(*args)

    monkeypatch.setattr(small._SmallMHA, "apply", counted)
    with torch.no_grad():
        logits = port(torch.from_numpy(x)).numpy()
    loss = torch.nn.functional.cross_entropy(port(torch.from_numpy(x)), torch.from_numpy(labels))
    loss.backward()
    assert calls == [(256, 6, False)] * 4  # every block, both passes, through fused_small
    assert small.kernel_symbols(torch.bfloat16, 256)["fwd"] == ("attn_small_fwd_bf16",)
    np.testing.assert_allclose(logits, logits_j, atol=2e-5, rtol=0)
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    want = vit_from_jax(jax.device_get(grads_j))
    for name, p in port.named_parameters():
        # the k bias's true gradient is 0 (softmax is shift invariant): held
        # against k's weight's scale, as in the vit_tiny test
        scale = want[name.replace("k_proj.bias", "k_proj.weight")].numpy()
        err = np.abs(p.grad.numpy() - want[name].numpy()).max() / np.abs(scale).max()
        assert err <= 2e-5, (name, err)


def _dq_resident_keys(head_dim, seq):
    """Keys whose S and dP the tiled bf16 dq kernel holds in registers for
    items of ``seq`` tokens at ``head_dim`` (``kernel_symbols``' rule)."""
    if head_dim == 64 and seq <= small.LONG_ITEM:
        return small.DQ_RESIDENT_KEYS
    return small.DQ_RESIDENT_KEYS_LONG


def test_the_c_source_holds_the_resident_key_rule():
    """``FWD_RESIDENT_KEYS``, ``DQ_RESIDENT_KEYS``, ``DQ_RESIDENT_KEYS_LONG``
    and ``LONG_ITEM`` are the C constants; the dq build's resident keys and
    the launches' choice of build follow them; the warpgroup counts they
    imply are those the kernels launch with."""
    assert _const("kFwdResidentKeys") == small.FWD_RESIDENT_KEYS == 256
    assert _const("kDqResidentKeys") == small.DQ_RESIDENT_KEYS == 256
    assert _const("kDqResidentKeysLong") == small.DQ_RESIDENT_KEYS_LONG == 128
    assert _const("kLongItem") == small.LONG_ITEM == 256
    assert _const("kTileRows") == TILE == small.ONE_TILE
    assert _const("kFwdWarpgroups") * 2 * TILE == small.FWD_RESIDENT_KEYS  # two tiles a warpgroup
    assert "kResident = D == 64 && !LONG ? kDqResidentKeys : kDqResidentKeysLong;" in SRC
    assert "kWarpgroups = kResident / kTileRows;" in SRC
    for kernel in ("fwd", "bwd"):
        assert re.search(rf"return p\.seq > kLongItem \? launch_{kernel}_tiled<D, true>\(p, batch, s\) "
                         rf": launch_{kernel}_tiled<D, false>\(p, batch, s\);", SRC), kernel
    assert _dq_resident_keys(64, 256) == 256
    assert _dq_resident_keys(64, 264) == _dq_resident_keys(128, 256) == 128


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float()


def _div(x, d):
    """The kernels' correctly rounded quotient (div_by), in fp32."""
    return x / d


def _scores(q, k, rows, keys, scale, causal):
    """Scores of query rows ``rows`` against keys ``[0, keys)`` in units of
    scale·log2e, keys a row does not see at -1e30."""
    s = (q[rows] @ k[:keys].T) * np.float32(scale * LOG2E)
    if causal:
        seen = torch.arange(keys)[None, :] <= torch.as_tensor(rows)[:, None]
        s = torch.where(seen, s, torch.full((), NEG_INF))
    return s


def _stats(s, resident):
    """Each row's max and sum of exp2(s - max): from the whole row where it
    has at most ``resident`` keys, else online over chunks of that many (the
    first sweep: the running sum rescaled by exp2(old max - new max))."""
    keys = s.shape[1]
    if keys <= resident:
        m = s.max(1, keepdim=True).values
        return m, torch.exp2(s - m).sum(1, keepdim=True)
    m = torch.full((s.shape[0], 1), NEG_INF)
    l = torch.zeros((s.shape[0], 1))
    for c0 in range(0, keys, resident):
        chunk = s[:, c0:c0 + resident]
        m_new = torch.maximum(m, chunk.max(1, keepdim=True).values)
        l = l * torch.exp2(m - m_new) + torch.exp2(chunk - m_new).sum(1, keepdim=True)
        m = m_new
    return m, l


def _emulate(q, k, v, do, scale, causal, fwd_resident, dq_resident):
    """One (item, head) through the tiled kernels' arithmetic: the forward
    and the dq kernel a 64-query tile at a time over the keys it sees, the
    dk/dv kernel from the dq kernel's statistics.  fp32 tensors holding bf16
    values; returns fp32 (out, dq, dk, dv), each to be rounded once."""
    seq = q.shape[0]
    out, dq = torch.zeros_like(q), torch.zeros_like(q)
    stats = torch.zeros((seq, 3))
    for m0 in range(0, seq, TILE):
        rows = list(range(m0, min(seq, m0 + TILE)))
        keys = min(seq, m0 + TILE) if causal else seq
        s = _scores(q, k, rows, keys, scale, causal)
        m, l = _stats(s, fwd_resident)
        p = _div(torch.exp2(s - m), l)
        out[rows] = p.to(torch.bfloat16).float() @ v[:keys]
        # dq: its own statistics (its resident keys may be fewer) and
        # delta, online as sum_j e dp / sum past them
        m, l = _stats(s, dq_resident)
        p = _div(torch.exp2(s - m), l)
        dp = do[rows] @ v[:keys].T
        if keys <= dq_resident:
            delta = (p * dp).sum(1, keepdim=True)
        else:
            delta = (torch.exp2(s - m) * dp).sum(1, keepdim=True) / l
        ds = (p * (dp - delta) * np.float32(scale)).to(torch.bfloat16).float()
        dq[rows] = ds @ k[:keys]
        stats[rows] = torch.cat([m / LOG2E, l, delta], 1)
    # dk/dv: P^T and dS^T by column from the statistics, every query tile
    s = _scores(q, k, list(range(seq)), seq, scale, causal)
    m2 = (stats[:, :1] * LOG2E)
    p = _div(torch.exp2(s - m2), stats[:, 1:2])
    dp = do @ v.T
    ds = (p * (dp - stats[:, 2:3]) * np.float32(scale)).to(torch.bfloat16).float()
    dv = p.to(torch.bfloat16).float().T @ do
    dk = ds.T @ q
    return out, dq, dk, dv


@pytest.mark.parametrize(
    "seq,head_dim,causal",
    [(256, 64, False), (200, 64, True), (72, 64, False), (328, 64, False), (328, 64, True),
     (256, 128, True), (200, 128, False)],
)
def test_tiled_kernel_arithmetic_matches_jax_head_fwd_and_bwd(seq, head_dim, causal):
    """The emulation (``_emulate``) of the tiled bf16 kernels, once over the
    keys up to what a block holds and twice past it (S 328 at head dim 64,
    and the dq kernel's 128 keys at head dim 128), against JAX ``head_fwd``
    and ``head_bwd`` in bf16 at one item a tile, per row: 2^-5 of the row's
    rms plus 2^-6·|x|, the bound of the port's bf16 tests (the same
    rounding points, P exact before its rounding; the two sides differ by
    summation order and exp2 against exp, which flip one P or ds rounding
    now and then, and by each result's own rounding)."""
    rng = np.random.default_rng(seq + head_dim + causal)
    b = 2
    qh, kh, vh, doh = (rng.standard_normal((b * seq, head_dim)).astype(np.float32) for _ in range(4))
    scale = head_dim**-0.5
    fwd_resident = small.FWD_RESIDENT_KEYS
    dq_resident = _dq_resident_keys(head_dim, seq)
    for i in range(b):
        rows = [x[i * seq:(i + 1) * seq] for x in (qh, kh, vh, doh)]
        got = _emulate(*(_bf16(x) for x in rows), scale, causal, fwd_resident, dq_resident)
        jrows = [jnp.asarray(x).astype(jnp.bfloat16) for x in rows]
        with jax.default_matmul_precision("highest"):
            o, _ = jax_head_fwd(*jrows[:3], 1, seq, scale, causal)
            pf = _head_probs(jrows[0], jrows[1], 1, seq, scale, causal)
            grads = jax_head_bwd(*jrows, pf, 1, seq, scale)
        for name, g, w in zip(("out", "dq", "dk", "dv"), got, (o, *grads)):
            g = g.to(torch.bfloat16).float().numpy()
            share = _row_share(g, _np(w), 2**-6)
            assert share <= 2**-5, (name, i, share)


def test_the_emulation_rejects_a_dropped_chunk():
    """The bound above needs each chunk of the first sweep: a first sweep
    that left out the last chunk of keys (its sum short of them) breaks the
    forward by more than the bound at S 328."""
    rng = np.random.default_rng(3)
    seq, d = 328, 64
    q, k, v = (_bf16(rng.standard_normal((seq, d)).astype(np.float32)) for _ in range(3))
    scale = d**-0.5
    s = _scores(q, k, list(range(seq)), seq, scale, False)
    m, l = _stats(s[:, :256], 256)  # the chunk [256, 328) left out of the sum
    bad = _div(torch.exp2(s - torch.maximum(m, s.max(1, keepdim=True).values)), l)
    out_bad = bad.to(torch.bfloat16).float() @ v
    jq, jk, jv = (jnp.asarray(x.numpy()).astype(jnp.bfloat16) for x in (q, k, v))
    with jax.default_matmul_precision("highest"):
        o, _ = jax_head_fwd(jq, jk, jv, 1, seq, scale, False)
    assert _row_share(out_bad.to(torch.bfloat16).float().numpy(), _np(o), 2**-6) > 2**-5
    assert math.isfinite(float(out_bad.abs().max()))
