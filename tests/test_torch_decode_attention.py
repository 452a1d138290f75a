"""The port's decode attention and KV-cache primitives against the JAX
package, on the CPU.

Both packages get the same inputs, made with numpy from a seed.  The
port's ``flash_attention_decode`` on CPU tensors runs its plain version
(the CUDA kernel is held against that plain version on the card by
``chip_smoke.py``); the JAX side runs both its dispatch path and its
Pallas kernel in interpret mode, as ``tests/test_decode.py`` does.
Tolerance for attention: ``rtol = atol = 2e-5``, the bar of
``tests/test_decode.py`` (f32, different summation order).  The cache
primitives must match bit for bit.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import attention as jatt
from mxnet_tpu_torch.ops import attention as tatt

TOL = dict(rtol=2e-5, atol=2e-5)
GRID = [(32, 1), (32, 8), (64, 1), (64, 8), (128, 1)]


def _boundaries(c, tq):
    """cache_len values at kv-block edges plus the extremes (the
    off-by-one sites), as tests/test_decode.py picks them."""
    bk = jatt._pick_block(c)
    cand = {0, 1, bk - 1, bk, bk + 1, c - tq - 1, c - tq}
    return sorted(x for x in cand if 0 <= x <= c - tq)


def _inputs(c, tq, quantized, b=2, h=2, d=8):
    rs = np.random.RandomState(c * 10 + tq + (1000 if quantized else 0))
    q = (rs.rand(b, h, tq, d) - 0.5).astype("float32")
    k = (rs.rand(b, h, c, d) - 0.5).astype("float32")
    v = (rs.rand(b, h, c, d) - 0.5).astype("float32")
    if not quantized:
        return q, k, v, None, None
    kq, ks = jatt.quantize_kv(jnp.asarray(k))
    vq, vs = jatt.quantize_kv(jnp.asarray(v))
    return q, np.asarray(kq), np.asarray(vq), np.asarray(ks), np.asarray(vs)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("c,tq", GRID)
def test_decode_attention_matches_jax(c, tq, quantized):
    q, k, v, ks, vs = _inputs(c, tq, quantized)
    scale = 1.0 / np.sqrt(q.shape[-1])
    for lo in _boundaries(c, tq):
        # rows get DIFFERENT lengths: per-row masking must not leak
        lens = np.asarray([lo, min(lo + 3, c - tq)], np.int32)
        got, got_lse = tatt.flash_attention_decode(
            _t(q), _t(k), _t(v), _t(lens), return_lse=True,
            k_scale=_t(ks), v_scale=_t(vs))
        want, want_lse = jatt.flash_attention_decode(
            _j(q), _j(k), _j(v), _j(lens), return_lse=True,
            k_scale=_j(ks), v_scale=_j(vs))
        kern, kern_lse = jatt._decode_forward_pallas(
            _j(q), _j(k), _j(v), _j(lens), scale=scale, interpret=True,
            return_lse=True, k_scale=_j(ks), v_scale=_j(vs))
        for ref, ref_lse, what in ((want, want_lse, "dispatch"),
                                   (kern, kern_lse, "interpret kernel")):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL,
                                       err_msg=f"{what}, cache_len={lens}")
            np.testing.assert_allclose(got_lse.numpy(), np.asarray(ref_lse),
                                       **TOL, err_msg=f"{what} lse, {lens}")


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("d,c,tq", [(4, 37, 3), (36, 100, 7), (100, 21, 1),
                                    (4, 530, 520), (320, 40, 3),
                                    (512, 33, 9)])
def test_decode_attention_any_width_and_chunk_matches_jax(d, c, tq,
                                                          quantized):
    """Shapes the decode kernel now takes: d not a multiple of 8, a cache
    capacity C not a multiple of 8, a chunk of Tq > 512 queries; against
    the JAX package's jnp path."""
    q, k, v, ks, vs = _inputs(c, tq, quantized, d=d)
    lens = np.asarray([0, c - tq], np.int32)
    got, got_lse = tatt.flash_attention_decode(
        _t(q), _t(k), _t(v), _t(lens), return_lse=True,
        k_scale=_t(ks), v_scale=_t(vs))
    want, want_lse = jatt.flash_attention_decode(
        _j(q), _j(k), _j(v), _j(lens), return_lse=True,
        k_scale=_j(ks), v_scale=_j(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


def test_decode_attention_inert_row_with_nan_garbage():
    # a freed serve slot: cache_len = 0, NaN keys past position 0 — the
    # fresh token attends only itself and the result IS row 0's value
    b, h, d, c = 1, 2, 8, 32
    rs = np.random.RandomState(0)
    q = rs.rand(b, h, 1, d).astype("float32")
    k = np.full((b, h, c, d), np.nan, np.float32)
    k[:, :, 0] = rs.rand(b, h, d)
    v = rs.rand(b, h, c, d).astype("float32")
    lens = np.zeros((b,), np.int32)
    got = tatt.flash_attention_decode(_t(q), _t(k), _t(v), _t(lens)).numpy()
    want = np.asarray(jatt.flash_attention_decode(_j(q), _j(k), _j(v),
                                                  _j(lens)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[:, :, 0], v[:, :, 0], rtol=1e-6, atol=1e-6)


def test_decode_attention_argument_rules():
    q = torch.zeros(1, 1, 1, 8)
    k = torch.zeros(1, 1, 8, 8)
    with pytest.raises(ValueError):
        tatt.flash_attention_decode(q, k, k, torch.zeros(1, dtype=torch.int32),
                                    k_scale=torch.ones(1, 1, 8, 1))


@pytest.mark.parametrize("d", [1, 4, 36, 100, 256, 264, 320, 512])
def test_kernel_wrappers_take_every_width_to_256(d):
    """The checks each wrapper runs before it launches take every head
    width, those above 256 included (fault C2, repaired): any chunk length
    Tq (1024, a prompt bucket's prefill) and cache capacity C (100, not a
    multiple of 8), and views that are not 16-byte aligned.  The decode
    plan sends d > 256 to the tensor-core chunk path.  What stays refused:
    an empty key axis."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.kernels import flash_bwd as tfb

    lens = torch.zeros(2, dtype=torch.int32)
    for tq, c in ((1024, 1100), (7, 100)):
        q, k = torch.zeros(2, 1, tq, d), torch.zeros(2, 1, c, d)
        tatt._check_cuda_args(q, k, k, lens, None, None)
        k8, ks = torch.zeros(2, 1, c, d, dtype=torch.int8), \
            torch.ones(2, 1, c, 1)
        tatt._check_cuda_args(q, k8, k8, lens, ks, ks)
        length, splits = tatt.split_plan(2, tq, c, d, 132)
        assert (splits == 0) == (tq > tatt.SPLIT_TQ or d > 256)
    x = torch.zeros(2 * 1 * 37 * d + 1)[1:].view(2, 1, 37, d)
    tatt._check_flash_args(x, x, x, lens)
    tfb._check_args(x, x, x, x, x, torch.zeros(2, 1, 37), lens)
    empty = torch.zeros(2, 1, 0, d)
    with pytest.raises(MXNetError):
        tatt._check_cuda_args(x, empty, empty, lens, None, None)
    with pytest.raises(MXNetError):
        tatt._check_flash_args(x, empty, empty, lens)


def _split_emulation(q, k, v, lens, ks, vs, scale):
    """Split-K decode in plain PyTorch: the wrapper's own plan
    (:func:`split_plan` on a 132-SM card), then per split the masked
    softmax partial (max, sum, unnormalized output) over the positions it
    holds below min(C, len + Tq), reading no row past that, merged in
    split order by the combine's formula.  int8 caches dequantized."""
    b, h, tq, d = q.shape
    c = k.shape[2]
    length, splits = tatt.split_plan(b * h, tq, c, d, 132)
    assert splits > 1 and length % 32 == 0
    out = torch.zeros(b, h, tq, d)
    lse = torch.zeros(b, h, tq)
    for r in range(b):
        end = min(c, int(lens[r]) + tq)
        kk, vv = k[r, :, :end].float(), v[r, :, :end].float()
        if ks is not None:
            kk, vv = kk * ks[r, :, :end], vv * vs[r, :, :end]
        parts = []
        for sp in range(splits):
            p0, p1 = sp * length, min((sp + 1) * length, end)
            if p0 >= p1:
                parts.append(None)            # wholly past: weight 0
                continue
            s = torch.einsum("hqd,hkd->hqk", q[r], kk[:, p0:p1]) * scale
            pos = torch.arange(p0, p1)
            live = pos[None, :] <= int(lens[r]) + torch.arange(tq)[:, None]
            s = s.masked_fill(~live[None], float("-inf"))
            m = s.amax(-1)
            e = torch.where(live[None], torch.exp(s - m.clamp_min(-1e30)
                                                 [..., None]), 0.0)
            parts.append((m, e.sum(-1), e @ vv[:, p0:p1]))
        ms = torch.stack([p[0] if p else torch.full((h, tq), float("-inf"))
                          for p in parts])
        big = ms.amax(0)
        tot, acc = torch.zeros(h, tq), torch.zeros(h, tq, d)
        for p in parts:                       # in split order
            if p is None:
                continue
            w = torch.where(p[0] == float("-inf"), 0.0, torch.exp(p[0] - big))
            tot = tot + p[1] * w
            acc = acc + p[2] * w[..., None]
        out[r] = acc / tot[..., None]
        lse[r] = big + torch.log(tot)
    return out, lse


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("tq", [1, 4, 7])
def test_split_k_emulation_matches_jax(tq, quantized):
    """The split-K plan and combine against the JAX package's
    ``flash_attention_decode``, within 1e-5: lengths 0, 1, mid-split and
    ending on a split boundary, NaN garbage past each row's window (the
    JAX side gets those rows zeroed: its matmul multiplies them by 0)."""
    c, d = 1024, 16
    q, k, v, ks, vs = _inputs(c, tq, quantized, b=4, h=2, d=d)
    length, _ = tatt.split_plan(4 * 2, tq, c, d, 132)
    lens = np.asarray([0, 1, length + length // 2, 2 * length - tq],
                      np.int32)
    past = np.arange(c)[None, :] >= (lens[:, None] + tq)
    past = past[:, None, :, None]
    clean = [x if x is None else np.where(past, 0, x).astype(x.dtype)
             for x in (k, v, ks, vs)]
    if quantized:
        garbage = [k, v, np.where(past, np.nan, ks).astype("float32"),
                   np.where(past, np.nan, vs).astype("float32")]
    else:
        garbage = [np.where(past, np.nan, x).astype("float32")
                   for x in (k, v)] + [None, None]
    got, got_lse = _split_emulation(_t(q), *(_t(x) for x in garbage[:2]),
                                    lens, *(_t(x) for x in garbage[2:]),
                                    1.0 / np.sqrt(d))
    want, want_lse = jatt.flash_attention_decode(
        _j(q), *(_j(x) for x in clean[:2]), _j(lens), return_lse=True,
        k_scale=_j(clean[2]), v_scale=_j(clean[3]))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lens", [[0, 0], [1, 5], [3, 0]])
def test_cache_append_bit_exact(lens):
    b, h, d, c, t = 2, 2, 4, 16, 3
    rs = np.random.RandomState(sum(lens) + 7)
    base = rs.rand(b, h, c, d).astype("float32")
    new = rs.rand(b, h, t, d).astype("float32")
    want = np.asarray(jatt.cache_append(_j(base), _j(new), _j(lens)))
    cache = _t(base)
    out = tatt.cache_append(cache, _t(new), lens)
    assert out is cache                       # updated in place
    np.testing.assert_array_equal(out.numpy(), want)


def test_cache_append_refuses_overflow():
    cache = torch.zeros(1, 1, 8, 4)
    with pytest.raises(Exception, match="capacity"):
        tatt.cache_append(cache, torch.zeros(1, 1, 2, 4), [7])


@pytest.mark.parametrize("n,src_start,dst_start,dst_row",
                         [(8, 0, 0, 0), (5, 2, 1, 1), (16, 0, 0, 2)])
def test_cache_page_copy_bit_exact(n, src_start, dst_start, dst_row):
    rs = np.random.RandomState(n + dst_row)
    dst = rs.rand(3, 2, 16, 4).astype("float32")
    src = rs.rand(1, 2, 16, 4).astype("float32")
    want = np.asarray(jatt.cache_page_copy(
        _j(dst), _j(src), n, src_start=src_start, dst_start=dst_start,
        dst_row=dst_row))
    got = tatt.cache_page_copy(_t(dst), _t(src), n, src_start=src_start,
                               dst_start=dst_start, dst_row=dst_row)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_dequantize_bit_exact():
    rs = np.random.RandomState(11)
    x = (rs.randn(2, 3, 17, 16) * 2.0).astype("float32")
    x[0, 0, 3] = 0.0                          # all-zero row: 1/127 scale
    x[1, 2, 5, :4] = [1.5, -2.5, 0.5, 127.0]  # exact halves at scale 1
    jq, js = jatt.quantize_kv(jnp.asarray(x))
    tq, ts = tatt.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tatt.dequantize_kv(tq, ts).numpy(),
        np.asarray(jatt.dequantize_kv(jq, js)))
