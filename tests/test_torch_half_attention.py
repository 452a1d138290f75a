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

Cases off the Pallas kernels' tiling (Tk = 129) hold the plain backward
against ``jax.grad`` of the JAX package's ``attention_reference`` in f32
on the same 16-bit values, its gradients rounded to the 16-bit type as
the kernels' ``acc.astype(dtype)`` rounds: within 2^-6 (bf16) and 2^-9
(f16) of the larger of max|g| and max|ref|, the card's bars (measured
2^-8 and 2^-11: one rounding of a gradient near max|g| apart).  The
``large_ds`` case puts |dS| above 65504, f16's largest value, while dq,
dk and dv are nonzero and fit in f16, and |dS| rises from one 64-query
tile to the next (``mxnet_tpu_torch.test_utils``); the plain version and
the Pallas kernels agree there bit for bit.  ``_emulate_bwd`` repeats
the 16-bit CUDA kernels' arithmetic (P and dS split as hi + lo in the
16-bit type, f16's power-of-two scale) on the CPU and is held against
JAX at those cases at the same bars (measured as the plain version:
2^-8 / 2^-11 at Tk = 129, 0 at ``large_ds``).

The split's low term is held by ``test_half_split_keeps_its_low_term``,
where a one-term split would show.  Measured against the Pallas kernels
(bf16 / f16): dq on keys 1 + e, rounded, of max|dq|: two terms 2^-8.0
/ 2^-11.1 (the plain version 2^-9.0 / 2^-11.1), one term 2^-2.3 /
2^-2.7 or more, bar 2^-6 / 2^-9; dk and dv before rounding, of max|ref|:
two terms 2^-18.0 / 2^-18.1 or less, one term 2^-8.6 / 2^-11.8 or more,
bar 2^-14 / 2^-15.
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
from mxnet_tpu_torch.test_utils import (attention_large_ds_inputs,
                                       attention_p_ds,
                                       attention_split_probe_inputs)

HALF = {"bf16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -8, 2.0 ** -9),
        "f16": (torch.float16, jnp.float16, 2.0 ** -11, 2.0 ** -11)}

# (Tq, Tk, d, causal, per-row key lengths of the B = 2 rows)
CASES = {
    "dense_64": (64, 64, 64, False, [0, 37]),
    "dense_q64_k128": (64, 128, 32, False, [128, 70]),
    "causal_128": (128, 128, 64, True, [100, 0]),
    "causal_q128_k64": (128, 64, 32, True, [64, 9]),
    "large_ds_q96_k128": (96, 128, 64, False, [128, 2]),
}
F16_MAX = 65504.0


def _inputs(tq, tk, d, dtype, seed):
    rs = np.random.RandomState(seed)
    q = (rs.rand(2, 3, tq, d) - 0.5) * 4
    k, v = ((rs.rand(2, 3, tk, d) - 0.5) * 2 for _ in range(2))
    g = rs.rand(2, 3, tq, d) - 0.5
    tq16 = [torch.from_numpy(x.astype("float32")).to(dtype)
            for x in (q, k, v, g)]
    return tq16, [jnp.asarray(x.float().numpy()) for x in tq16]


def _large_ds_inputs(tq, tk, d, dtype, seed=None):
    """``attention_large_ds_inputs`` (|dS| past 65504; dq, dk, dv nonzero
    within f16) in ``_inputs``' form; ``seed`` is unused."""
    x = [t.to(dtype) for t in attention_large_ds_inputs(2, 3, tk, d, tq)]
    return x, [jnp.asarray(t.float().numpy()) for t in x]


def _np(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _split(x, dtype, terms=2):
    """x = hi + lo + (rest), hi and lo in ``dtype``, as the kernels split
    (``terms=1``: lo = 0, x rounded once)."""
    hi = x.to(dtype).float()
    return hi, (x - hi).to(dtype).float() if terms == 2 else 0 * hi


def _pow2(m):
    """2^(14 - e), e the exponent of m (at least 2^-112): f16's split
    scale for values up to m, which it keeps below 2^15."""
    _, e = torch.frexp(torch.clamp(m, min=2.0 ** -112))
    return torch.ldexp(torch.ones_like(m), (15 - e).to(m.dtype))


def _emulate_bwd(q, k, v, g, out, lse, lens, causal, scale, terms=2,
                 rounded=True):
    """The 16-bit CUDA kernels' arithmetic on the CPU: S, dP and delta
    in f32 (exact products of 16-bit values); P and dS split as hi + lo
    in the inputs' type, two products each (lo, then hi) for dV = P^T G,
    dK = dS^T Q and dQ = dS K; under f16 dS is scaled by a power of two
    first: one scale a block, raised tile by tile (64 queries), where a
    head's keys fit one block (Tk <= 128, the fused mode), else one a row
    (a query for dQ, a key for dK).  Gradients rounded once (in f32 with
    ``rounded=False``); ``terms=1`` keeps only each split's high term."""
    dt = q.dtype
    p, ds = attention_p_ds(q, k, v, g, out, lse, lens, causal, scale)
    qf, kf, gf = q.float(), k.float(), g.float()

    def prod(a, b):
        hi, lo = _split(a, dt, terms)
        return lo @ b + hi @ b

    dv = prod(p.transpose(-1, -2), gf)
    if dt != torch.float16:
        dq, dk = prod(ds, kf), prod(ds.transpose(-1, -2), qf)
    elif k.shape[2] <= tfb.FUSED_TK:
        dq, dk = torch.empty_like(qf), torch.zeros_like(kf)
        top = torch.full(q.shape[:2] + (1, 1), 2.0 ** -112)
        for i in range(0, q.shape[2], 64):
            t = ds[:, :, i:i + 64]
            m = torch.maximum(top, t.abs().amax((-1, -2), keepdim=True))
            dk = dk * (_pow2(m) / _pow2(top))
            top, f = m, _pow2(m)
            dq[:, :, i:i + 64] = prod(t * f, kf) / f
            dk = dk + prod((t * f).transpose(-1, -2), qf[:, :, i:i + 64])
        dk = dk / _pow2(top)
    else:
        fq = _pow2(ds.abs().amax(-1, keepdim=True))
        fk = _pow2(ds.abs().amax(-2, keepdim=True))
        dq = prod(ds * fq, kf) / fq
        dk = prod((ds * fk).transpose(-1, -2), qf) / fk.transpose(-1, -2)
    res = (dq * scale, dk * scale, dv)
    return tuple(x.to(dt) for x in res) if rounded else res


@pytest.mark.parametrize("half", sorted(HALF))
@pytest.mark.parametrize("name", sorted(CASES))
def test_half_forward_and_backward_match_pallas_kernels(name, half):
    tdt, jdt, ftol, btol = HALF[half]
    tq, tk, d, causal, lens = CASES[name]
    make = _large_ds_inputs if name.startswith("large_ds") else _inputs
    (q, k, v, g), jx = make(tq, tk, d, tdt, seed=tq + tk + d)
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
    if name.startswith("large_ds"):            # what the case is for
        _, ds = attention_p_ds(q, k, v, g, out, lse, lens_t, causal, scale)
        assert ds.abs().max() > F16_MAX
        assert all(bool(torch.isfinite(a).all()) for a in got)


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


def _jax_grad(x, jx, lens, causal, scale, rounded=True):
    """dq, dk, dv by ``jax.grad`` of the JAX package's
    ``attention_reference`` in f32 on the 16-bit values, rounded to their
    type (with ``rounded``)."""
    import jax

    tq, tk = x[0].shape[2], x[1].shape[2]
    m = jatt._merge_mask(None, jnp.asarray(lens), tq, tk, causal)

    def f(q_, k_, v_):
        return (jatt.attention_reference(q_, k_, v_, mask=m, scale=scale)
                * jx[3]).sum()

    jdt = jnp.bfloat16 if x[0].dtype == torch.bfloat16 else jnp.float16
    return [_np(w.astype(jdt) if rounded else w)
            for w in jax.grad(f, (0, 1, 2))(*jx[:3])]


# Tk = 129: the fused / two-launch boundary of the CUDA kernels, which
# the Pallas kernels cannot tile
TK129 = {"dense": (100, 129, 64, False, [129, 70]),
         "causal": (100, 129, 64, True, [129, 70])}
BAR = {"bf16": 2.0 ** -6, "f16": 2.0 ** -9}


def _check_grads(got, want, g, half):
    top_g = float(g.float().abs().max())
    for a, w in zip(got, want):
        top = max(top_g, float(np.abs(w).max()))
        np.testing.assert_allclose(a.float().numpy(), w, rtol=0,
                                   atol=BAR[half] * top)


@pytest.mark.parametrize("half", sorted(HALF))
@pytest.mark.parametrize("name", sorted(TK129))
def test_half_backward_at_tk_129_matches_jax_grad(name, half):
    tdt = HALF[half][0]
    tq, tk, d, causal, lens = TK129[name]
    x, jx = _inputs(tq, tk, d, tdt, seed=tq + tk + d)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    scale = 1.0 / np.sqrt(d)
    out, lse = tatt.flash_attention(*x[:3], causal=causal,
                                    kv_valid_length=lens_t, return_lse=True)
    got = tfb.flash_attention_bwd(*x, out, lse, lens_t, causal, scale)
    assert all(a.dtype == tdt for a in got)
    _check_grads(got, _jax_grad(x, jx, lens, causal, scale), x[3], half)


@pytest.mark.parametrize("half", sorted(HALF))
@pytest.mark.parametrize("name", ["large_ds_q96_k128", "tk129_dense",
                                  "tk129_causal"])
def test_half_kernel_split_emulation_matches_jax(name, half):
    """The CUDA kernels' split products, emulated, against JAX: its
    Pallas kernels (interpret mode) at ``large_ds``, ``jax.grad`` at Tk =
    129 (the two-launch side of the boundary)."""
    tdt, jdt = HALF[half][:2]
    if name.startswith("large_ds"):
        tq, tk, d, causal, lens = CASES[name]
        x, jx = _large_ds_inputs(tq, tk, d, tdt)
    else:
        tq, tk, d, causal, lens = TK129[name.split("_")[1]]
        x, jx = _inputs(tq, tk, d, tdt, seed=tq + tk + d)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    scale = 1.0 / np.sqrt(d)
    out, lse = tatt.flash_attention(*x[:3], causal=causal,
                                    kv_valid_length=lens_t, return_lse=True)
    got = _emulate_bwd(*x, out, lse, lens_t, causal, scale)
    if name.startswith("large_ds"):
        jq, jk, jv, jg = (a.astype(jdt) for a in jx)
        jl = jnp.asarray(lens, jnp.int32)
        jout, jlse = jatt._flash_forward_pallas(
            jq, jk, jv, causal, scale, kv_len=jl, interpret=True,
            return_lse=True)
        want = [_np(w) for w in flash_attention_bwd_pallas(
            jq, jk, jv, jg, jout, jlse, jl, causal, scale,
            bq=jatt._pick_block(tq), bk=jatt._pick_block(tk),
            interpret=True)]
    else:
        want = _jax_grad(x, jx, lens, causal, scale)
    assert all(bool(torch.isfinite(a).all()) for a in got)
    _check_grads(got, want, x[3], half)


# dq's low-term probe (``attention_split_probe_inputs``): Tk = 128 takes
# the fused mode's split (one f16 scale a block), 192 the two-launch one
PROBE_TK = (128, 192)
PROBE_BAR = {"bf16": 2.0 ** -6, "f16": 2.0 ** -9}      # of max|dq|
PRE_ROUND_BAR = {"bf16": 2.0 ** -14, "f16": 2.0 ** -15}  # of max|dk|, |dv|


@pytest.mark.parametrize("half", sorted(HALF))
@pytest.mark.parametrize("tk", PROBE_TK)
def test_half_split_keeps_its_low_term(tk, half):
    """The two-term split against the Pallas kernels (interpret mode),
    where one term would show: dq on keys 1 + e, rounded, within
    PROBE_BAR x max|dq| (the plain version too: it is the card's
    reference), and dk, dv before their rounding within PRE_ROUND_BAR x
    max|ref| of the Pallas kernels run in f32 on the same values.  The
    split with only its high term misses both by 4x or more, so a kernel
    that dropped the low term fails the card's probe."""
    tdt, jdt = HALF[half][:2]
    tq, d, lens = 96, 64, [tk, tk - 30]
    x = [t.to(tdt) for t in attention_split_probe_inputs(2, 3, tq, tk, d,
                                                         tdt, seed=tk)]
    jx = [jnp.asarray(t.float().numpy()) for t in x]
    jl = jnp.asarray(lens, jnp.int32)
    lens_t = torch.tensor(lens, dtype=torch.int32)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jg = (a.astype(jdt) for a in jx)
    jout, jlse = jatt._flash_forward_pallas(
        jq, jk, jv, False, scale, kv_len=jl, interpret=True, return_lse=True)
    blocks = dict(bq=jatt._pick_block(tq), bk=jatt._pick_block(tk),
                  interpret=True)
    w16 = [_np(w) for w in flash_attention_bwd_pallas(
        jq, jk, jv, jg, jout, jlse, jl, False, scale, **blocks)]
    w32 = [_np(w) for w in flash_attention_bwd_pallas(
        *jx, jout.astype(jnp.float32), jlse, jl, False, scale, **blocks)]
    out = torch.from_numpy(_np(jout)).to(tdt)
    lse = torch.from_numpy(np.array(jlse))
    args = (*x, out, lse, lens_t, False, scale)

    def err(a, w):
        return float(np.abs(a.float().numpy() - w).max() / np.abs(w).max())

    plain = tfb.flash_attention_bwd_reference(*args)
    two = _emulate_bwd(*args)
    one = _emulate_bwd(*args, terms=1)
    bar = PROBE_BAR[half]
    assert err(plain[0], w16[0]) <= bar and err(two[0], w16[0]) <= bar
    assert err(one[0], w16[0]) > 4 * bar
    two, one = (_emulate_bwd(*args, terms=n, rounded=False) for n in (2, 1))
    bar = PRE_ROUND_BAR[half]
    for i in (1, 2):
        assert err(two[i], w32[i]) <= bar < err(one[i], w32[i]) / 4
