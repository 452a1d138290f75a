"""The port's bf16 and f16 attention against the JAX package, on the CPU.

Both packages get the same 16-bit inputs, made with numpy from a seed.
The port's ``flash_attention`` / ``flash_attention_bwd`` on CPU tensors
run their plain versions, which follow the Pallas kernels' roundings (S
from upcast q and k, ``p`` rounded to v's type for P V, ``l`` from the
f32 ``p``, the output rounded once; every backward operand in f32 and
the gradients rounded once); the 16-bit CUDA kernels are held against
those plain versions on the card (``tests/test_torch_cuda_kernels.py``,
``chip_smoke.py``).  The JAX side runs its Pallas kernels in interpret
mode.

Tolerances, tightened from the defaults 2^-7 / 2^-10 (forward, of
max|ref|) and 2^-6 / 2^-9 (backward, of max|g|) to what these cases
allow with a 4x margin: the forward within 2^-8 (bf16) and 2^-11 (f16)
of max|ref| (measured: 0 and 2^-12.3; the JAX kernel rounds each ``p``
against the running max of the key blocks it has seen, the plain
version against the row's max, so a rounded ``p`` and the output may
differ by an ulp), the lse within 2e-5 (f32 in both); dq, dk and dv
within 2^-9 (bf16) and 2^-11 (f16) of max|g| (measured 2^-11 and 2^-13:
one rounding of each gradient on top of f32 products in another
order).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.kernels.flash_bwd import flash_attention_bwd_pallas
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu_torch.kernels import flash_bwd as tfb
from mxnet_tpu_torch.ops import attention as tatt

HALF = {"bf16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -8, 2.0 ** -9),
        "f16": (torch.float16, jnp.float16, 2.0 ** -11, 2.0 ** -11)}

# (Tq, Tk, d, causal, per-row key lengths of the B = 2 rows)
CASES = {
    "dense_64": (64, 64, 64, False, [0, 37]),
    "dense_q64_k128": (64, 128, 32, False, [128, 70]),
    "causal_128": (128, 128, 64, True, [100, 0]),
    "causal_q128_k64": (128, 64, 32, True, [64, 9]),
}


def _inputs(tq, tk, d, dtype, seed):
    rs = np.random.RandomState(seed)
    q = (rs.rand(2, 3, tq, d) - 0.5) * 4
    k, v = ((rs.rand(2, 3, tk, d) - 0.5) * 2 for _ in range(2))
    g = rs.rand(2, 3, tq, d) - 0.5
    tq16 = [torch.from_numpy(x.astype("float32")).to(dtype)
            for x in (q, k, v, g)]
    return tq16, [jnp.asarray(x.float().numpy()) for x in tq16]


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("half", sorted(HALF))
@pytest.mark.parametrize("name", sorted(CASES))
def test_half_forward_and_backward_match_pallas_kernels(name, half):
    tdt, jdt, ftol, btol = HALF[half]
    tq, tk, d, causal, lens = CASES[name]
    (q, k, v, g), jx = _inputs(tq, tk, d, tdt, seed=tq + tk + d)
    jq, jk, jv, jg = (x.astype(jdt) for x in jx)
    jl = jnp.asarray(lens, jnp.int32)
    scale = 1.0 / np.sqrt(d)
    jout, jlse = jatt._flash_forward_pallas(
        jq, jk, jv, causal, scale, kv_len=jl, interpret=True,
        return_lse=True)
    assert jout.dtype == jdt
    lens_t = torch.tensor(lens, dtype=torch.int32)
    out, lse = tatt.flash_attention(q, k, v, causal=causal,
                                    kv_valid_length=lens_t, return_lse=True)
    assert out.dtype == tdt and lse.dtype == torch.float32
    want = _np(jout)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=0,
                               atol=ftol * np.abs(want).max())
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-5,
                               atol=2e-5)
    for r, n in enumerate(lens):
        if n == 0:                             # nothing to attend: zeros
            assert not out[r].any() and torch.isinf(lse[r]).all()

    # the backward from the JAX forward's (out, lse), as the kernels take
    wants = flash_attention_bwd_pallas(
        jq, jk, jv, jg, jout, jlse, jl, causal, scale,
        bq=jatt._pick_block(tq), bk=jatt._pick_block(tk), interpret=True)
    got = tfb.flash_attention_bwd(
        q, k, v, g, torch.from_numpy(want).to(tdt),
        torch.from_numpy(np.array(jlse)), lens_t, causal, scale)
    atol = btol * float(np.abs(jx[3]).max())
    for a, w in zip(got, wants):
        assert a.dtype == tdt and w.dtype == jdt
        np.testing.assert_allclose(a.float().numpy(), _np(w), rtol=0,
                                   atol=atol)
    for r, n in enumerate(lens):               # exact zeros past lengths
        assert not got[1][r, :, n:].any() and not got[2][r, :, n:].any()
        if n == 0:
            assert not got[0][r].any()


def test_half_kernels_refuse_mixed_types_and_f64():
    from mxnet_tpu_torch.base import MXNetError

    ok = torch.zeros(1, 1, 4, 8, device="meta", dtype=torch.bfloat16)
    with pytest.raises(MXNetError, match="bfloat16|one|must be"):
        tatt._check_flash_args(ok, ok.half(), ok, None)
    with pytest.raises(MXNetError, match="float32, bfloat16 or float16"):
        tatt._check_flash_args(ok.double(), ok.double(), ok.double(), None)
    lse = torch.zeros(1, 1, 4, device="meta")
    with pytest.raises(MXNetError):
        tfb._check_args(ok, ok, ok, ok, ok.float(), lse, None)
