"""The numerics of the decode kernel's tensor-core split-K path (q and the
cache of one 16-bit type: bf16 over bf16, f16 over f16) against the JAX
package, on the CPU.

The CUDA kernel runs only on the card, so its arithmetic is emulated here
in plain PyTorch as ``csrc/decode_attention.cuh`` computes it: the
wrapper's split plan (:func:`split_plan` on a 132-SM card), each split's
64-position tiles dealt to its warps in turn (4 warps at d <= 64, 2 at
d <= 128, 1 above), each warp's online softmax with P rounded to the
cache's type at that tile's running max (the TPU kernel's
``p.astype(v.dtype)``) and the sum l from the f32 P, the warps merged in
order and then the splits in rank order by the cluster merge's formula;
the output rounded to q's type once.  The JAX side runs its Pallas kernel
in interpret mode, as its own tests run it on the CPU.

Bars: the output within 2^-7 (bf16) / 2^-10 (f16) x max|ref|, the 16-bit
forward's bars (two roundings of each probability at other running maxes
may differ by one 16-bit ulp); the f32 lse within 1e-5 (other summation
orders).
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
_JT = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
_NEG_INF = float("-inf")


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


def _kernel16_emulation(q, k, v, lens, scale):
    """The tensor-core split-K path in plain PyTorch (module docstring)."""
    b, h, tq, d = q.shape
    c = k.shape[2]
    length, splits = tatt.split_plan(b * h, tq, c, d, 132)
    assert 1 <= splits <= 8 and length % 32 == 0
    nw = _warps(d)
    qf, kf, vf = q.float(), k.float(), v.float()
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
                    s = torch.einsum("hqd,hkd->hqk", qf[r],
                                     kf[r, :, t0:t1]) * scale
                    live = torch.arange(t0, t1)[None, :] <= lim[:, None]
                    s = s.masked_fill(~live, _NEG_INF)
                    mn = torch.maximum(m, s.amax(-1))
                    z = torch.where(mn == _NEG_INF, torch.zeros_like(mn), mn)
                    corr = torch.where(m == _NEG_INF, torch.zeros_like(m),
                                       torch.exp(m - z))
                    p = torch.where(s == _NEG_INF, torch.zeros_like(s),
                                    torch.exp(s - z[..., None]))
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[..., None] + torch.einsum(
                        "hqk,hkd->hqd", p.to(k.dtype).float(),
                        vf[r, :, t0:t1])
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
