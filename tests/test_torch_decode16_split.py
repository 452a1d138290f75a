"""The numerics of the decode kernel's tensor-core split-K path (every
16-bit cache under any query type, and an int8 cache under 16-bit
queries) against the JAX package, on the CPU.

The CUDA kernel runs only on the card, so its arithmetic is emulated here
in plain PyTorch as ``csrc/decode_attention.cuh`` computes it: the
wrapper's split plan (:func:`split_plan` on a 132-SM card), each split's
64-position tiles dealt to its warps in turn (4 warps at d <= 64, 2 at
d <= 128, 1 above), each warp's online softmax, the warps merged in order
and then the splits in rank order by the cluster merge's formula; the
output rounded to q's type once.  Over a 16-bit cache, q is brought into
the cache's type as terms that sum back to it (f32 three, f16 into bf16
two, bf16 into f16 one, f16's after a power-of-two row scale that the
scores take back), S is the sum of their products with k, and P is
rounded to the cache's type at that tile's running max (the TPU kernel's
``p.astype(v.dtype)``); over int8, S is q times the int8 keys, each score
then times its position's k_scale, and P stays f32: w = p * v_scale as
three bf16 terms (exact) times the int8 values.  The sum l comes from the
f32 P.  The JAX side runs its Pallas kernel in interpret mode, as its own
tests run it on the CPU.

Bars: the output within 2^-7 (bf16) / 2^-10 (f16) x max|ref|, the 16-bit
side's type (bf16 where both sides are 16-bit), the 16-bit forward's bars
(two roundings of each probability at other running maxes may differ by
one 16-bit ulp); the f32 lse within 1e-5 (other summation orders).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu_torch.ops import attention as tatt

TILE16 = 64
FRAC = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
_JT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
       torch.float16: jnp.float16}
_NEG_INF = float("-inf")
_NAME = {torch.float32: "f32", torch.bfloat16: "bf16",
         torch.float16: "f16", torch.int8: "int8"}
# the pairs whose split-K moved from CUDA cores onto tensor cores: q's type
# other than a 16-bit cache's, and 16-bit queries over int8
MIXED = [(torch.float32, torch.bfloat16), (torch.float32, torch.float16),
         (torch.bfloat16, torch.float16), (torch.float16, torch.bfloat16),
         (torch.bfloat16, torch.int8), (torch.float16, torch.int8)]


def _warps(d: int) -> int:
    """Warps a block of the tensor-core path: rows of d rounded up to 32,
    64, 128 or 256 columns, 4 warps up to 64, 2 up to 128, 1 above."""
    return 4 if d <= 64 else 2 if d <= 128 else 1


def _merge(parts):
    """(max, sum, unnormalized output) of partials merged in order by the
    kernel's formula: weights exp(m - M), 0 for a partial with max -inf."""
    big = torch.stack([p[0] for p in parts]).amax(0)
    tot = torch.zeros_like(big)
    acc = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = torch.where(m == _NEG_INF, torch.zeros_like(m),
                        torch.exp(m - big))
        tot = tot + l * w
        acc = acc + a * w[..., None]
    return big, tot, acc


def _terms(x, dtype, n):
    """f32 ``x`` as ``n`` terms of ``dtype`` (as f32 tensors), largest
    first: each the rest rounded to ``dtype``, the rest after it exact."""
    out = []
    for _ in range(n):
        t = x.to(dtype).float()
        out.append(t)
        x = x - t
    return out


def _row_pow2(x):
    """The kernel's power-of-two scale of each row (last axis) of f32 ``x``
    before an f16 split, and its inverse: 2^(14 - e) for e the exponent of
    the row's max |x| (at least -112), so the row lies below 2^15."""
    top = x.abs().amax(-1)
    _, e = torch.frexp(top)                  # top = m 2^e, m in [0.5, 1)
    eb = torch.where(top > 0, e + 126, torch.zeros_like(e)).clamp(min=15)
    return (torch.exp2((141 - eb).float()), torch.exp2((eb - 141).float()))


def _query_terms(q, kv_dtype):
    """q's terms in the cache's type as split_tiles16 forms them, and the
    factor each row's scores are multiplied back by: q's own values where
    it is the cache's type (or the cache is int8); f32 three terms, f16
    into bf16 two, bf16 into f16 one, those into f16 after the row's
    power-of-two scale."""
    qf = q.float()
    one = torch.ones(qf.shape[:-1])
    if kv_dtype == torch.int8 or q.dtype == kv_dtype:
        return [qf], one
    if kv_dtype == torch.float16:
        f, one = _row_pow2(qf)
        qf = qf * f[..., None]
    n = {torch.float32: 3, torch.float16: 2, torch.bfloat16: 1}[q.dtype]
    return _terms(qf, kv_dtype, n), one


def _kernel16_emulation(q, k, v, lens, scale, k_scale=None, v_scale=None):
    """The tensor-core split-K path in plain PyTorch (module docstring);
    ``k_scale`` / ``v_scale`` (B, H, C) f32 with an int8 cache."""
    b, h, tq, d = q.shape
    c = k.shape[2]
    kv_dtype = torch.int8 if k_scale is not None else k.dtype
    length, splits = tatt.split_plan(b * h, tq, c, d, 132, grouped=(
        q.dtype != kv_dtype))
    assert 1 <= splits <= 8 and length % 32 == 0
    nw = _warps(d)
    terms, back = _query_terms(q, kv_dtype)
    kf, vf = k.float(), v.float()
    out = torch.zeros(b, h, tq, d, dtype=q.dtype)
    lse = torch.zeros(b, h, tq)
    for r in range(b):
        lim = int(lens[r]) + torch.arange(tq)     # each row's last position
        end = min(c, int(lens[r]) + tq)
        parts = []
        for sp in range(splits):
            p0, p1 = sp * length, min((sp + 1) * length, end)
            if p0 >= p1:                          # wholly past: weight 0
                continue
            tiles = list(range(p0, p1, TILE16))
            warps = []
            for w in range(nw):
                m = torch.full((h, tq), _NEG_INF)
                l = torch.zeros(h, tq)
                acc = torch.zeros(h, tq, d)
                for t0 in tiles[w::nw]:
                    t1 = min(t0 + TILE16, p1)
                    s = torch.zeros(h, tq, t1 - t0)
                    for qt in reversed(terms):    # the smallest term first
                        s = s + torch.einsum("hqd,hkd->hqk", qt[r],
                                             kf[r, :, t0:t1])
                    if k_scale is not None:       # each column's k_scale
                        s = s * k_scale[r][:, None, t0:t1]
                    s = s * back[r][..., None] * scale
                    live = torch.arange(t0, t1)[None, :] <= lim[:, None]
                    s = s.masked_fill(~live, _NEG_INF)
                    mn = torch.maximum(m, s.amax(-1))
                    z = torch.where(mn == _NEG_INF, torch.zeros_like(mn), mn)
                    corr = torch.where(m == _NEG_INF, torch.zeros_like(m),
                                       torch.exp(m - z))
                    p = torch.where(s == _NEG_INF, torch.zeros_like(s),
                                    torch.exp(s - z[..., None]))
                    l = l * corr + p.sum(-1)
                    if v_scale is None:           # P rounded to v's type
                        pw = p.to(kv_dtype).float()
                    else:                         # w = p v_scale, 3 terms
                        pw = sum(_terms(p * v_scale[r][:, None, t0:t1],
                                        torch.bfloat16, 3))
                    acc = acc * corr[..., None] + torch.einsum(
                        "hqk,hkd->hqd", pw, vf[r, :, t0:t1])
                    m = mn
                warps.append((m, l, acc))
            parts.append(_merge(warps))
        big, tot, acc = _merge(parts)
        safe = torch.where(tot == 0, torch.ones_like(tot), tot)
        out[r] = torch.where(tot[..., None] == 0, torch.zeros_like(acc),
                             acc / safe[..., None]).to(q.dtype)
        lse[r] = torch.where(tot == 0, torch.full_like(tot, _NEG_INF),
                             big + torch.log(safe))
    return out, lse


def _inputs(dt, b, h, tq, c, d, seed):
    """Seeded q / k / v in ``dt`` for both packages (JAX arrays, and torch
    tensors of the same values)."""
    rs = np.random.RandomState(seed)
    arrs = [jnp.asarray((rs.rand(b, h, n, d) - 0.5).astype("f4")).astype(
        _JT[dt]) for n in (tq, c, c)]
    return arrs, [torch.from_numpy(np.asarray(a).astype("f4")).to(dt)
                  for a in arrs]


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("tq,d", [(1, 64), (3, 64), (8, 64), (1, 36),
                                  (5, 128), (2, 200)])
def test_tensor_core_split_emulation_matches_jax(dt, tq, d):
    """Lengths 0 (an inert row), 1, ending mid-split and at the capacity's
    edge, at C = 512 (4 splits of 128: two 64-position tiles, so two of
    the four warps idle at d <= 64) over the interpret-mode Pallas
    kernel."""
    b, h, c = 4, 2, 512
    length, splits = tatt.split_plan(b * h, tq, c, d, 132)
    assert (length, splits) == (128, 4)
    lens = np.asarray([0, 1, length + length // 2, c - tq], np.int32)
    (jq, jk, jv), (q, k, v) = _inputs(dt, b, h, tq, c, d, seed=tq * 100 + d)
    scale = 1.0 / np.sqrt(d)
    want, want_lse = jatt._decode_forward_pallas(
        jq, jk, jv, jnp.asarray(lens), scale=scale, interpret=True,
        return_lse=True)
    got, got_lse = _kernel16_emulation(q, k, v, lens, scale)
    ref = np.asarray(want).astype("f4")
    err = np.abs(got.float().numpy() - ref).max()
    top = np.abs(ref).max()
    assert got.dtype == dt and torch.isfinite(got).all()
    assert err <= FRAC[dt] * top, (err, FRAC[dt] * top)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=1e-5, atol=1e-5)
    # the inert row attends its own position: p = 1, exact in every type
    assert torch.equal(got[0, :, 0], v[0, :, 0])


def _pair_inputs(q_dtype, kv_dtype, b, h, tq, c, d, seed):
    """Seeded inputs of a (query type, cache type) pair for both packages:
    ``(jax args, jax kwargs), (torch q, k, v, k_scale, v_scale)``; an int8
    cache quantized once by the JAX package's ``quantize_kv`` (scales
    (B, H, C, 1) for JAX, (B, H, C) for the emulation)."""
    rs = np.random.RandomState(seed)
    q, k, v = ((rs.rand(b, h, n, d) - 0.5).astype("f4") for n in (tq, c, c))
    jq = jnp.asarray(q).astype(_JT[q_dtype])
    tq_ = torch.from_numpy(np.array(jq.astype(jnp.float32))).to(q_dtype)
    if kv_dtype == torch.int8:
        (jk, jks), (jv, jvs) = (jatt.quantize_kv(jnp.asarray(x))
                                for x in (k, v))
        kw = dict(k_scale=jks, v_scale=jvs)
        tk, tv = (torch.from_numpy(np.array(x)) for x in (jk, jv))
        ks, vs = (torch.from_numpy(np.array(x))[..., 0] for x in (jks, jvs))
    else:
        jk, jv = (jnp.asarray(x).astype(_JT[kv_dtype]) for x in (k, v))
        kw, ks, vs = {}, None, None
        tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(kv_dtype) for x in (jk, jv))
    return ((jq, jk, jv), kw), (tq_, tk, tv, ks, vs)


@pytest.mark.parametrize("pair", MIXED,
                         ids=[f"{_NAME[q]}_{_NAME[k]}" for q, k in MIXED])
@pytest.mark.parametrize("tq,d", [(1, 64), (3, 64), (8, 64), (1, 36),
                                  (5, 128), (2, 200)])
def test_mixed_and_int8_pairs_emulation_matches_jax(pair, tq, d):
    """The six pairs redesigned onto tensor cores (q's terms in a 16-bit
    cache's type; int8 widened, each score times its k_scale after the
    dot, w = p v_scale in three bf16 terms), emulated as the kernel
    computes them, against the interpret-mode Pallas kernel at the
    16-bit side's bar: lengths 0 (an inert row), 1, ending mid-split and
    at the capacity's edge, C = 512 (4 splits of 128)."""
    q_dtype, kv_dtype = pair
    b, h, c = 4, 2, 512
    lens = np.asarray([0, 1, 192, c - tq], np.int32)
    ((jq, jk, jv), kw), (q, k, v, ks, vs) = _pair_inputs(
        q_dtype, kv_dtype, b, h, tq, c, d, seed=tq * 100 + d + 7)
    scale = 1.0 / np.sqrt(d)
    want, want_lse = jatt._decode_forward_pallas(
        jq, jk, jv, jnp.asarray(lens), scale=scale, interpret=True,
        return_lse=True, **kw)
    got, got_lse = _kernel16_emulation(q, k, v, lens, scale, ks, vs)
    ref = np.asarray(want.astype(jnp.float32))
    frac = FRAC[torch.bfloat16 if torch.bfloat16 in pair else torch.float16]
    err = np.abs(got.float().numpy() - ref).max()
    assert got.dtype == q_dtype and torch.isfinite(got).all()
    assert err <= frac * np.abs(ref).max(), (err, frac * np.abs(ref).max())
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=1e-5, atol=1e-5)
    # the inert row attends its own position: p = 1, and v (dequantized
    # once, as the plain version's) comes out exactly in q's type
    v0 = v[0, :, 0].float() if vs is None else \
        v[0, :, 0].float() * vs[0, :, 0, None]
    assert torch.equal(got[0, :, 0], v0.to(q_dtype))


def test_splits_and_widening_sum_back_exactly():
    """The kernel's operand splits and int8 widening are exact: f32 as
    three bf16 terms, every finite f16 as two bf16 terms, bf16 rows into
    f16 after the row's power-of-two scale (the scaled row below 2^15),
    f32 as three f16 terms after it within 2^-39 of the row's largest
    |x| (f16's subnormal floor), and the byte tricks that widen int8:
    0x4B000000 | (k + 128) as f32 less 2^23 + 128 is k with 16 low zero
    bits (its high half k in bf16), 0x6400 | (k + 128) as f16 less 1152
    is k."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy((rs.randn(64, 200) * np.exp2(
        rs.randint(-40, 40, (64, 1)))).astype("f4"))
    assert torch.equal(sum(t.double() for t in _terms(x, torch.bfloat16, 3)),
                       x.double())
    f16 = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16) \
        .view(torch.float16)
    f16 = f16[torch.isfinite(f16)].float()
    assert torch.equal(sum(t.double() for t in _terms(f16, torch.bfloat16,
                                                      2)), f16.double())
    bf = (x * torch.exp2(torch.from_numpy(rs.randint(
        -14, 6, x.shape)).float())).bfloat16().float()
    f, back = _row_pow2(bf)
    scaled = bf * f[:, None]
    assert float(scaled.abs().max()) < 2.0 ** 15
    assert torch.equal(scaled.half().float(), scaled)
    assert torch.equal(scaled.half().float() * back[:, None], bf)
    f, back = _row_pow2(x)
    three = sum(t.double() for t in _terms(x * f[:, None], torch.float16, 3))
    err = (three * back[:, None].double() - x.double()).abs().amax(-1)
    assert bool((err <= 2.0 ** -39 * x.abs().amax(-1).double()).all())
    k = np.arange(-128, 128)
    u = (k + 128).astype(np.uint32)
    wide = (u | 0x4B000000).view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(wide, k.astype(np.float32))
    assert not (wide.view(np.uint32) & 0xFFFF).any()
    half = (u.astype(np.uint16) | 0x6400).view(np.float16) - \
        np.float16(1152)
    assert np.array_equal(half, k.astype(np.float16))


@pytest.mark.parametrize("sms", [132, 114, 1000])
def test_split_plan_never_exceeds_a_portable_cluster(sms):
    """The splits of one (b, h, query group) are one thread-block cluster,
    at most 8 blocks: every plan has 1 <= S <= 8 splits of a multiple of
    128 positions that cover the capacity, and a plan the cap cut (C =
    1,500 at few heads) holds longer splits."""
    for bh in (1, 2, 4, 8, 12, 96, 384):
        for c in (1, 100, 256, 1024, 1500, 4096, 100_000):
            for tq in (1, 4, 8, 9, 64):
                for grouped in (False, True):
                    length, splits = tatt.split_plan(bh, tq, c, 64, sms,
                                                     grouped=grouped)
                    if splits == 0:
                        assert tq > tatt.SPLIT_TQ and not grouped
                        continue
                    assert 1 <= splits <= 8, (bh, c, tq, splits)
                    assert length % 128 == 0 and length * splits >= c
                    assert length * (splits - 1) < c
    assert tatt.split_plan(4, 1, 1500, 64, 132) == (256, 6)
