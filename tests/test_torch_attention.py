"""Port parity of the attention kernels' plain versions — what a CPU
tensor runs, and what the CUDA kernels are held against on the card —
against the reference: the Pallas kernels in interpret mode (as
tests/test_kernels.py runs them), their `ref.py` oracles, and the XLA
flash of `repro.models.flash`.

Inputs come from a numpy seed. Tolerances are the reference's own
(tests/test_kernels.py:25,42): 1e-5 for fp32, 2e-2 for bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import \
    decode_attention as pallas_decode
from repro.kernels.decode_attention.ref import decode_ref as jax_decode_ref
from repro.kernels.flash_attention.kernel import \
    flash_attention as pallas_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attn_ref
from repro.models import flash as xla_flash
from repro_torch.kernels import cuda_build
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops as flash_ops

DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def inputs(seed, dtype, *shapes):
    """The same normal draws as JAX arrays and torch tensors of dtype."""
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    out = []
    for shape in shapes:
        j = jnp.asarray(rng.normal(0, 1, shape).astype(np.float32), jdt)
        out.append((j, torch.from_numpy(
            np.array(j.astype(jnp.float32))).to(tdt)))
    return out


def close(port, ref, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("b,h,kv,s,d,bq,bk", [
    (1, 2, 1, 32, 16, 16, 16),
    (2, 4, 2, 64, 32, 16, 32),
    (1, 8, 8, 128, 64, 64, 64),   # MHA
])
def test_flash_plain_matches_pallas_and_xla_flash(b, h, kv, s, d, bq, bk,
                                                  dtype):
    (jq, tq), (jk, tk), (jv, tv) = inputs(s + h, dtype, (b, h, s, d),
                                          (b, kv, s, d), (b, kv, s, d))
    before = dict(cuda_build.LAUNCHES)
    got = flash_ops.flash_attention(tq, tk, tv)
    assert cuda_build.LAUNCHES == before    # CPU: the plain version
    assert got.dtype == tq.dtype and got.shape == (b, h, s, d)
    close(got, pallas_flash(jq, jk, jv, block_q=bq, block_k=bk,
                            interpret=True), dtype)
    close(got, jax_attn_ref(jq, jk, jv), dtype)
    # the model's own XLA flash takes the [B, S, heads, Dh] layout
    xla = xla_flash.flash_attention(jq.transpose(0, 2, 1, 3),
                                    jk.transpose(0, 2, 1, 3),
                                    jv.transpose(0, 2, 1, 3), bk)
    close(fk.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                             tv.transpose(1, 2)), xla, dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("s", [16, 48, 100])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (8, 2)])
def test_flash_plain_at_engine_lengths(s, h, kv, dtype):
    """Lengths that are not multiples of a Pallas block (the engine's
    buckets start at 16), GQA groups 1, 2 and 4."""
    (jq, tq), (jk, tk), (jv, tv) = inputs(s * h + kv, dtype, (2, h, s, 32),
                                          (2, kv, s, 32), (2, kv, s, 32))
    close(flash_ops.flash_attention(tq, tk, tv), jax_attn_ref(jq, jk, jv),
          dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("kv_len", [1, 17, 32, 128])
@pytest.mark.parametrize("h,kv", [(8, 8), (8, 4), (8, 2)])
def test_decode_plain_matches_pallas_and_ref(kv_len, h, kv, dtype):
    b, s, d = 2, 128, 32
    (jq, tq), (jk, tk), (jv, tv) = inputs(kv_len + h * kv, dtype,
                                          (b, h, d), (b, kv, s, d),
                                          (b, kv, s, d))
    before = dict(cuda_build.LAUNCHES)
    got = decode_ops.decode_attention(tq, tk, tv, kv_len)
    assert cuda_build.LAUNCHES == before
    assert got.dtype == tq.dtype and got.shape == (b, h, d)
    close(got, pallas_decode(jq, jk, jv, jnp.int32(kv_len), block_k=32,
                             interpret=True), dtype)
    close(got, jax_decode_ref(jq, jk, jv, jnp.int32(kv_len)), dtype)


def test_decode_reads_the_flat_cache_view():
    """The engine hands decode one layer of its [B, S, KV*Dh] cache
    viewed as [B, S, KV, Dh]; the result equals the reference's on the
    [B, KV, S, Dh] layout, and kv_len outside [1, S] is refused."""
    b, s, kv, d, h = 2, 40, 2, 16, 4
    rng = np.random.default_rng(3)
    flat_k = rng.normal(0, 1, (b, s, kv * d)).astype(np.float32)
    flat_v = rng.normal(0, 1, (b, s, kv * d)).astype(np.float32)
    q = rng.normal(0, 1, (b, h, d)).astype(np.float32)
    tk = torch.as_tensor(flat_k).view(b, s, kv, d)
    tv = torch.as_tensor(flat_v).view(b, s, kv, d)
    got = dk.decode_attention(torch.as_tensor(q), tk, tv, 23)
    want = jax_decode_ref(jnp.asarray(q),
                          jnp.asarray(flat_k.reshape(b, s, kv, d)
                                      ).transpose(0, 2, 1, 3),
                          jnp.asarray(flat_v.reshape(b, s, kv, d)
                                      ).transpose(0, 2, 1, 3),
                          jnp.int32(23))
    close(got, want, "fp32")
    for bad in (0, s + 1):
        with pytest.raises(ValueError, match="kv_len"):
            dk.decode_attention(torch.as_tensor(q), tk, tv, bad)


def test_flash_wrapper_refuses_mismatched_lengths():
    q = torch.zeros(1, 2, 16, 16)
    with pytest.raises(NotImplementedError):
        flash_ops.flash_attention(q, q[:, :, :8], q[:, :, :8])
