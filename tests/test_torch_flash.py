"""The port's attention core against the JAX package's, on the CPU.

The plain ``flash_attention`` (the CPU side of ``ops.flash_attention``,
and what the CUDA kernel is held to on the card) is run on the
reference's ``FLASH_CASES`` against ``repro.kernels.ref.flash_attention_ref``
and the Pallas kernel in interpret mode, at the reference's tolerances
(2e-5 for float32, 2e-2 for bfloat16, ``tests/test_kernels.py``). With a
key-padding mask, GQA and a fully masked row it is held, like the port's
``multihead_attention``, to ``repro.models.attention.multihead_attention``
on both of its paths: dense, and chunked at ``SMOKE``'s threshold of 64.
Inputs come from a numpy seed; bf16 inputs are rounded once from float32
on both sides, so both see the same bits.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.configs import thistle_sbert as jcfg  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs import thistle_sbert as pcfg  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention as pattn  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (BH, Sq, Sk, dh, causal, blk_q, blk_k, dtype): the reference's FLASH_CASES
FLASH_CASES = [
    (2, 128, 128, 64, True, 64, 64, "float32"),
    (1, 256, 256, 128, True, 128, 128, "float32"),
    (3, 128, 128, 32, False, 64, 32, "float32"),
    (2, 192, 192, 64, True, 64, 64, "float32"),
    (2, 128, 128, 64, True, 128, 64, "bfloat16"),
    (1, 64, 64, 80, False, 64, 64, "float32"),
]


def _pair(x, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    return (jnp.asarray(x, JDT[dtype]),
            torch.tensor(x).to(TDT[dtype]))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32), np.float32)


@pytest.mark.parametrize("BH,Sq,Sk,dh,causal,bq,bk,dtype", FLASH_CASES)
def test_plain_flash_matches_reference_oracle_and_pallas(BH, Sq, Sk, dh,
                                                         causal, bq, bk,
                                                         dtype):
    rng = np.random.default_rng(BH * 1000 + Sq + dh)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.normal(size=(BH, S, dh)).astype(np.float32), dtype)
        for S in (Sq, Sk, Sk))
    # the port's layout: (B, S, H, dh) with H = 1
    got = ops.flash_attention(tq[:, :, None], tk[:, :, None], tv[:, :, None],
                              causal=causal)[:, :, 0]
    assert got.dtype == TDT[dtype] and ops.launch_counts()["flash_attention"] == 0
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    pallas = jops.flash_attention(jq[:, :, None], jk[:, :, None],
                                  jv[:, :, None], causal=causal, blk_q=bq,
                                  blk_k=bk, interpret=True)[:, :, 0]
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(got), _f32(pallas), atol=tol, rtol=tol)
    # the port's copy of the oracle is the reference's
    np.testing.assert_allclose(
        _f32(ref.flash_attention_ref(tq, tk, tv, causal=causal)), _f32(want),
        atol=tol, rtol=tol)


def _masked_inputs(rng, B, S, H, KV, dh, dtype):
    q = rng.normal(size=(B, S, H, dh)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, dh)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, dh)).astype(np.float32)
    lengths = rng.integers(1, S + 1, size=B)
    lengths[0] = S
    lengths[-1] = 0  # an empty text: every key masked
    mask = np.arange(S)[None, :] < lengths[:, None]
    return q, k, v, mask


MASK_CASES = [
    # (B, S, H, KV, dh, causal, dtype); S = 64 goes chunked in the reference
    (4, 16, 4, 4, 16, False, "float32"),
    (4, 64, 4, 4, 16, False, "float32"),
    (3, 40, 8, 2, 32, False, "float32"),
    (3, 64, 8, 2, 32, True, "float32"),
    (4, 24, 4, 4, 80, True, "float32"),
    (4, 16, 4, 4, 16, False, "bfloat16"),
    (4, 64, 4, 4, 16, False, "bfloat16"),
    (3, 64, 8, 2, 32, True, "bfloat16"),
]


@pytest.mark.parametrize("B,S,H,KV,dh,causal,dtype", MASK_CASES)
def test_masked_gqa_attention_matches_reference(B, S, H, KV, dh, causal, dtype):
    """Key-padding mask, GQA and a fully masked row (the mean of v): the
    port's multihead_attention and plain flash_attention against the
    reference's multihead_attention at SMOKE's chunk threshold."""
    rng = np.random.default_rng(B * 100 + S + H + dh)
    q, k, v, mask = _masked_inputs(rng, B, S, H, KV, dh, dtype)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (q, k, v))
    jcf = dataclasses.replace(jcfg.SMOKE, dtype=dtype)
    pcf = dataclasses.replace(pcfg.SMOKE, dtype=dtype)
    want = _f32(jattn.multihead_attention(jq, jk, jv, jcf, causal=causal,
                                          window=None,
                                          kv_mask=jnp.asarray(mask)))
    tmask = torch.tensor(mask)
    got = pattn.multihead_attention(tq, tk, tv, pcf, causal=causal,
                                    window=None, kv_mask=tmask)
    plain = ops.flash_attention(tq, tk, tv, causal=causal, kv_mask=tmask)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(got), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(plain), want, atol=tol, rtol=tol)
    # the empty row averages v over every key, as the reference's softmax
    # of equal scores does
    vm = np.repeat(_f32(tv)[-1].mean(axis=0), H // KV, axis=0)
    np.testing.assert_allclose(_f32(plain)[-1], np.broadcast_to(vm, (S, H, dh)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_and_chunked_plain_versions_agree_with_window(dtype):
    """The two plain paths of the CPU rule agree with each other and with
    the reference's under a sliding window and a query offset."""
    rng = np.random.default_rng(7)
    q, k, v, mask = _masked_inputs(rng, 2, 64, 4, 2, 16, dtype)
    qr = q.reshape(2, 64, 2, 2, 16)
    kw = dict(scale=0.25, causal=True, window=9, q_offset=0)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(x, dtype) for x in (qr, k, v))
    dense = pattn._dense_attention(tq, tk, tv, kv_mask=torch.tensor(mask), **kw)
    chunked = pattn._chunked_attention(tq, tk, tv, q_chunk=16, k_chunk=32,
                                       kv_mask=torch.tensor(mask), **kw)
    want = jattn._chunked_attention(jq, jk, jv, q_chunk=16, k_chunk=32,
                                    kv_mask=jnp.asarray(mask), **kw)
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(chunked), _f32(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(_f32(dense), _f32(want), atol=tol, rtol=tol)


def test_kernel_limits_are_named():
    """The kernel wrapper refuses a head dim it does not take, a window
    below one key and mixed dtypes before anything touches the card; a
    window of one key or more passes its checks."""
    q = torch.zeros((1, 8, 2, 64))
    for dh in (8, 72, 272):
        x = torch.zeros((1, 8, 2, dh))
        with pytest.raises(ValueError, match=f"up to {FA.MAX_HEAD_DIM}"):
            FA.flash_attention_cuda(x, x, x, causal=False, scale=1.0)
    for window in (0, -4, 2.5):
        with pytest.raises(ValueError, match="window of at least 1 key"):
            FA.flash_attention_cuda(q, q, q, causal=True, scale=1.0,
                                    window=window)
    for window in (None, 1, 16, 4096):
        FA._check(q, q, q, None, window)
    with pytest.raises(ValueError, match="bfloat16"):
        FA.flash_attention_cuda(q, q.to(torch.bfloat16), q, causal=False,
                                scale=1.0)
    with pytest.raises(ValueError, match="multiple of KV"):
        FA.flash_attention_cuda(q, torch.zeros((1, 8, 3, 64)),
                                torch.zeros((1, 8, 3, 64)), causal=False,
                                scale=1.0)
