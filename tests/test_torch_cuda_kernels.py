"""The port's CUDA kernels on the card, against their plain versions:
decode attention (f32 and int8 caches under f32 queries, and since the
16-bit serving slice every pair of f32 / bf16 / f16 queries over f32 /
int8 / bf16 / f16 caches: ``-k decode16``), the flash-attention forward and backward (dq, dk/dv)
in f32 and in their bf16 / f16 variants, the flat-arena optimizer
update, the batch-norm stats and apply kernels (f32, and their bf16 /
f16 variants: y bit for bit, scale and shift equal to the plain
version's) and the extension
example's squared ReLU (forward, backward) and ``a * x + b``.  Also
the recurrent family (``-k rnn``: ``ops.rnn``, the ``gluon.rnn`` cells
and layers, ``LSTMLM``), which has no kernel, on the card against the
same code on the CPU; and so the detection slice's PyTorch code (``-k
"boxes or ssd or loss"``): every ``ops.boxes`` operator of the SSD path
(masks, classes, indices and NMS fill equal; floats within 1e-6 x
max|ref|), every loss with its gradients (within 1e-5 x max|ref|), the
tiny SSD's forward, targets, detections and gradients and
``ssd_512_resnet50_v1`` built with no device (within 1e-4).  And
``hybridize()`` (``-k hybridize``): captured CUDA graphs against the eager
blocks (every zoo model the serving tiers and the verify drive run, SSD
and its detections; outputs and gradients within 1e-6), launch counts on
replay, the raise on a host read, a background warmup racing a
dispatcher, the batch-norm workspace made by the warm run.  And the
network slice (``-k "edge or fleet or prefetch"``): two fleet replicas'
answers equal in-process answers, the edge's stream and deadline on the
card, the prefetcher's batches equal to their sources after the
consumer's stream waited, and no staging buffer reused under a copy in
flight.

These tests need a CUDA device and ``nvcc``; they carry the ``cuda``
marker and skip without a card.  On the card::

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

Tolerance atol = rtol = 1e-4 with TF32 off (f32, different summation
order), the bar of ``chip_smoke.py``; the 16-bit variants at 16-bit
scale (the constants above their tests); the batch-norm statistics within
1e-5 of the channel's scale (sqrt(E[x^2]) for the mean, E[x^2] for the
variance) of a float64 reference; the extension kernels equal bit for
bit, except f32 ``axpb`` within 1 ulp (the plain version rounds a
float64 result once, the kernel one fused multiply-add).
"""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.ops import attention as att
from mxnet_tpu_torch.test_utils import DECODE_PAIRS, xavier_init

pytestmark = pytest.mark.cuda
HALF_DECODE = [torch.bfloat16, torch.float16]
TOL = 1e-4


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("b,h,tq,c,d", [
    (2, 3, 1, 64, 8), (3, 2, 19, 96, 40), (1, 1, 200, 256, 256),
    (2, 2, 5, 64, 4), (3, 2, 17, 100, 36), (2, 3, 1, 100, 100),
    (2, 2, 1024, 1100, 64), (2, 2, 7, 100, 64), (2, 1, 9, 50, 37),
    (2, 3, 1, 300, 264), (2, 2, 4, 100, 320), (2, 2, 19, 96, 512)])
def test_kernel_matches_plain(dev, quantized, b, h, tq, c, d):
    g = torch.Generator().manual_seed(b * 100 + tq)
    q = torch.rand(b, h, tq, d, generator=g) - 0.5
    k = torch.rand(b, h, c, d, generator=g) - 0.5
    v = torch.rand(b, h, c, d, generator=g) - 0.5
    kw = {}
    if quantized:
        k, ks = att.quantize_kv(k)
        v, vs = att.quantize_kv(v)
        kw = dict(k_scale=ks.to(dev), v_scale=vs.to(dev))
    lens = torch.tensor([(c - tq) * i // max(1, b - 1) for i in range(b)],
                        dtype=torch.int32)
    args = [t.to(dev) for t in (q, k, v, lens)]
    name = "flash_attention_decode_int8" if quantized \
        else "flash_attention_decode"
    before = registry.launches()[name]
    out, lse = att.flash_attention_decode(*args, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert registry.launches()[name] == before + 1
    ref, ref_lse = att.flash_attention_decode_reference(*args,
                                                        return_lse=True, **kw)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, ref_lse, atol=TOL, rtol=TOL)


def test_kernel_refuses_what_it_does_not_take(dev):
    q = torch.zeros(1, 1, 1, 264, device=dev)
    k = torch.zeros(1, 1, 0, 264, device=dev)       # an empty cache
    lens = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(MXNetError):
        att.flash_attention_decode(q, k, k, lens)
    q = torch.zeros(1, 1, 1, 8, device=dev)
    k = torch.zeros(1, 1, 16, 8, device=dev)
    with pytest.raises(MXNetError):                  # cache_len on the CPU
        att.flash_attention_decode(q, k, k, lens.cpu())
    with pytest.raises(MXNetError):                  # non-contiguous q
        att.flash_attention_decode(
            torch.zeros(1, 1, 8, 2, device=dev).transpose(2, 3)[..., :1, :],
            k, k, lens)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("tq", [1, 4, 7, 8, 9])
@pytest.mark.parametrize("c,d", [(100, 36), (1024, 64), (4096, 64),
                                 (1024, 264), (300, 320)])
def test_decode_split_cases_match_plain(dev, quantized, tq, c, d):
    """Split-K at the threshold's edges (Tq 8 splits, 9 takes the chunk
    path; d > 256 always the chunk path): lengths 0, 1, ending mid-split
    and on a split boundary, NaN past each row's window (in the values, or
    in an int8 cache's scales); within 1e-4 of the plain version, the same
    bits on a second call, one launch a call."""
    b, h = 4, 3
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    length, splits = att.split_plan(b * h, tq, c, d, sms)
    step = length if splits else 64
    lens = [0, 1, min(c - tq, step + step // 2),
            max(0, min(c, 2 * step) - tq)]
    g = torch.Generator().manual_seed(c + tq + d)
    q = torch.rand(b, h, tq, d, generator=g) - 0.5
    k = torch.rand(b, h, c, d, generator=g) - 0.5
    v = torch.rand(b, h, c, d, generator=g) - 0.5
    lens_t = torch.tensor(lens, dtype=torch.int32)
    past = (torch.arange(c)[None, :] >= lens_t[:, None] + tq)[:, None, :, None]
    kw, ref_kw = {}, {}
    if quantized:
        k, ks = att.quantize_kv(k)
        v, vs = att.quantize_kv(v)
        kw = dict(k_scale=ks.masked_fill(past, float("nan")).to(dev),
                  v_scale=vs.masked_fill(past, float("nan")).to(dev))
        ref_kw = dict(k_scale=kw["k_scale"],
                      v_scale=torch.nan_to_num(kw["v_scale"]))
        ref_v = v
    else:
        k = k.masked_fill(past, float("nan"))
        v = v.masked_fill(past, float("nan"))
        ref_v = torch.nan_to_num(v)
    q, k, v, ref_v, lens_d = (t.to(dev) for t in (q, k, v, ref_v, lens_t))
    name = "flash_attention_decode_int8" if quantized \
        else "flash_attention_decode"
    before = registry.launches()[name]
    out, lse = att.flash_attention_decode(q, k, v, lens_d, return_lse=True,
                                          **kw)
    again, again_lse = att.flash_attention_decode(q, k, v, lens_d,
                                                  return_lse=True, **kw)
    torch.cuda.synchronize()
    assert registry.launches()[name] == before + 2
    ref, ref_lse = att.flash_attention_decode_reference(
        q, k, ref_v, lens_d, return_lse=True, **ref_kw)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, ref_lse, atol=TOL, rtol=TOL)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


_DT = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
       torch.int8: "int8"}


def _decode16(dev, q_dtype, kv_dtype, b, h, tq, c, d, lens, seed):
    """One decode case of a (query type, cache type) pair on the card:
    output and lse against the plain version at ``test_utils.decode_bar``
    (lse within 1e-4), finite everywhere (NaN past every window is never
    read), one launch under the pair's name a call, the same bits on a
    second call.  Returns the kernel's inputs and output."""
    from mxnet_tpu_torch.test_utils import decode_bar, decode_case

    kern, plain = decode_case(q_dtype, kv_dtype, b, h, tq, c, d, lens, seed,
                              dev)
    name = att.decode_kernel_name(q_dtype, kv_dtype)
    before = registry.launches()[name]
    out, lse = att.flash_attention_decode(**kern, return_lse=True)
    again, again_lse = att.flash_attention_decode(**kern, return_lse=True)
    torch.cuda.synchronize()
    assert registry.launches()[name] == before + 2
    ref, ref_lse = att.flash_attention_decode_reference(**plain,
                                                        return_lse=True)
    assert out.dtype == q_dtype and lse.dtype == torch.float32
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    bar = decode_bar(q_dtype, kv_dtype, ref)
    err = (out.float() - ref.float()).abs()
    if bar is None:
        assert (err <= TOL + TOL * ref.abs()).all(), float(err.max())
    else:
        assert float(err.max()) <= bar, (float(err.max()), bar)
    torch.testing.assert_close(lse, ref_lse, atol=TOL, rtol=TOL)
    assert torch.equal(out, again) and torch.equal(lse, again_lse)
    return kern, out


@pytest.mark.parametrize("pair", DECODE_PAIRS,
                         ids=[f"{_DT[q]}_{_DT[k]}" for q, k in DECODE_PAIRS])
@pytest.mark.parametrize("d", [36, 64, 128])
@pytest.mark.parametrize("tq,c", [(1, 100), (3, 1024), (8, 100), (9, 1024),
                                  (64, 100), (256, 1024)])
def test_decode16_pairs_match_plain(dev, pair, d, tq, c):
    """Every (query type, cache type) pair at ``chip_smoke.py`` phase
    35's shapes: Tq either side of the split-K edge and at prefill
    chunks, C 100 and 1024, d 36 / 64 / 128; an inert row (cache_len 0:
    it attends its own position, so its output is v[0] in q's type), a
    row at the capacity's edge (cache_len + Tq = C) and two between."""
    q_dtype, kv_dtype = pair
    lens = [0, 1, (c - tq) // 2, c - tq]
    kern, out = _decode16(dev, q_dtype, kv_dtype, 4, 3, tq, c, d, lens,
                          seed=tq * 1000 + c + d)
    v0 = kern["v"][0, :, 0].float()
    if kv_dtype == torch.int8:
        v0 = v0 * kern["v_scale"][0, :, 0]
    if q_dtype == torch.float32:      # the f32 chunk path's 3xTF32 P V
        torch.testing.assert_close(out[0, :, 0], v0, atol=TOL, rtol=0)
    else:                             # p = 1 is exact in every type
        assert torch.equal(out[0, :, 0], v0.to(q_dtype))


@pytest.mark.parametrize("pair", DECODE_PAIRS,
                         ids=[f"{_DT[q]}_{_DT[k]}" for q, k in DECODE_PAIRS])
@pytest.mark.parametrize("tq,d", [(1, 37), (9, 37), (5, 8), (1, 256)])
def test_decode16_pairs_at_odd_widths_match_plain(dev, pair, tq, d):
    """Widths whose 16-bit rows take 4-byte copies (d = 8 bytes apart),
    byte copies (d = 37) and the widest split-K rows (d = 256)."""
    _decode16(dev, *pair, 2, 2, tq, 130, d, [0, 130 - tq], seed=tq + d)


@pytest.mark.parametrize("dtype", HALF_DECODE, ids=["bf16", "f16"])
@pytest.mark.parametrize("tq", [9, 64, 127, 256])
@pytest.mark.parametrize("d", [64, 320])
def test_decode16_chunk_path_at_tile_edges(dev, dtype, tq, d):
    """The 16-bit forward core as decode's chunk path (``q_off`` =
    cache_len): Tq 9, 64, 127, 256 with cache lengths that are no
    multiple of 64, so the causal diagonal crosses a key tile inside it,
    at d = 64 (``wgmma``) and d = 320 (WIDE)."""
    c = 1024
    _decode16(dev, dtype, dtype, 3, 2, tq, c, d, [0, 37, c - tq - 5],
              seed=tq * 7 + d)


def test_decode16_refuses_pairs_it_cannot_launch(dev):
    """Mismatched k / v types, an int8 cache with 16-bit scales, a mixed
    pair wider than 256 (no chunk path for it) and an f64 query raise on
    the card; nothing falls back to the plain version."""
    lens = torch.zeros(1, dtype=torch.int32, device=dev)
    q = torch.zeros(1, 1, 1, 8, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(1, 1, 16, 8, dtype=torch.bfloat16, device=dev)
    with pytest.raises(MXNetError):
        att.flash_attention_decode(q, k, k.half(), lens)
    ki = torch.zeros(1, 1, 16, 8, dtype=torch.int8, device=dev)
    sc = torch.ones(1, 1, 16, 1, dtype=torch.bfloat16, device=dev)
    with pytest.raises(MXNetError):
        att.flash_attention_decode(q, ki, ki, lens, k_scale=sc, v_scale=sc)
    wide = torch.zeros(1, 1, 1, 264, dtype=torch.bfloat16, device=dev)
    with pytest.raises(MXNetError):
        att.flash_attention_decode(wide, wide.float().expand(1, 1, 16, 264)
                                   .contiguous(), wide.float().expand(
                                       1, 1, 16, 264).contiguous(), lens)
    with pytest.raises(MXNetError):
        att.flash_attention_decode(q.double(), k, k, lens)


# ------------------------------------------ split-K decode in one launch
_PAIR_IDS = [f"{_DT[q]}_{_DT[k]}" for q, k in DECODE_PAIRS]
_GROUPED = [p for p in DECODE_PAIRS if not att._has_chunk_path(*p)]


def _split_call(kern, plan=None):
    """One decode call of the kernel on ``decode_case``'s inputs, the plan
    forced where ``plan`` is given; returns (output, lse)."""
    d = kern["q"].shape[-1]
    return att._launch_cuda(kern["q"], kern["k"], kern["v"],
                            kern["cache_len"], 1.0 / d ** 0.5, True,
                            kern.get("k_scale"), kern.get("v_scale"), plan)


def _split_check(q_dtype, kv_dtype, kern, plain, plan=None):
    """The kernel's output and lse (plan forced or the wrapper's) against
    the plain version at ``decode_bar`` (lse within 1e-4), finite
    everywhere; returns the output."""
    from mxnet_tpu_torch.test_utils import decode_bar

    out, lse = _split_call(kern, plan)
    torch.cuda.synchronize()
    ref, ref_lse = att.flash_attention_decode_reference(**plain,
                                                        return_lse=True)
    assert out.dtype == q_dtype and torch.isfinite(out).all()
    err = (out.float() - ref.float()).abs()
    bar = decode_bar(q_dtype, kv_dtype, ref)
    if bar is None:
        assert (err <= TOL + TOL * ref.abs()).all(), float(err.max())
    else:
        assert float(err.max()) <= bar, (plan, float(err.max()), bar)
    torch.testing.assert_close(lse, ref_lse, atol=TOL, rtol=TOL)
    return out


def _kernels_a_call(fn, calls=10):
    """Kernels the card ran a call of ``fn``, from ``torch.profiler``'s
    kernel records: each kernel's records over the calls, a whole number
    within 10% (CUPTI now and then loses records; a profile further off
    is taken again)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = 0
        for e in prof.key_averages():
            if e.device_time_total <= 0:
                continue
            k = round(e.count / calls)
            if k == 0 or abs(e.count - k * calls) > 0.1 * k * calls:
                n = 0
                break
            n += k
        if n:
            return n
    raise AssertionError("five profiles lost kernel records")


@pytest.mark.parametrize("pair", DECODE_PAIRS, ids=_PAIR_IDS)
def test_decode_split_is_one_launch_with_the_same_bits(dev, pair):
    """Split-K at the decode step's shape (C = 1024, d = 64, S = 4 of the
    card's plan): one kernel a call by the profiler (the splits merge
    inside the launch), the output and lse the same bits over 20 calls."""
    from mxnet_tpu_torch.test_utils import decode_case

    kern, plain = decode_case(*pair, 8, 12, 1, 1024, 64,
                              [1000 - 3 * i for i in range(8)], seed=3,
                              device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert att.split_plan(96, 1, 1024, 64, sms)[1] > 1
    out = _split_check(*pair, kern, plain)
    lse = _split_call(kern)[1]
    for _ in range(20):
        again, again_lse = _split_call(kern)
        assert torch.equal(out, again) and torch.equal(lse, again_lse)
    assert _kernels_a_call(lambda: _split_call(kern)) == 1


@pytest.mark.parametrize("pair", DECODE_PAIRS, ids=_PAIR_IDS)
@pytest.mark.parametrize("splits", range(1, 9))
def test_decode_forced_splits_match_plain(dev, pair, splits):
    """S forced to 1-8 (one cluster of S blocks; at S >= 6 the last splits
    lie wholly past C = 300 and every row) with Tq = S: an inert row (the
    splits past its own position wholly past it), a row whose window ends
    on a split boundary, one ending mid-split and one at the capacity's
    edge; NaN past every window."""
    from mxnet_tpu_torch.test_utils import decode_case

    c, tq = 300, splits
    length = 32 * -(-c // (32 * splits))
    lens = [min(x, c - tq) for x in (0, length - tq,
                                     length + length // 2 - tq, c - tq)]
    kern, plain = decode_case(*pair, 4, 3, tq, c, 40, lens,
                              seed=splits * 31, device=dev)
    out = _split_check(*pair, kern, plain, plan=(length, splits))
    assert torch.equal(out, _split_call(kern, (length, splits))[0])


@pytest.mark.parametrize("pair", _GROUPED,
                         ids=[f"{_DT[q]}_{_DT[k]}" for q, k in _GROUPED])
@pytest.mark.parametrize("tq", [9, 64])
@pytest.mark.parametrize("forced", [False, True], ids=["plan", "S8"])
def test_decode_grouped_chunks_in_clusters(dev, pair, tq, forced):
    """A mixed pair's chunk (no chunk path: query groups of 8 rows on the
    grid's third axis, each group's splits one cluster), at the card's
    plan and at 8 splits of 64 (the last lie past C = 300)."""
    from mxnet_tpu_torch.test_utils import decode_case

    c = 300
    lens = [0, 1, (c - tq) // 2, c - tq]
    kern, plain = decode_case(*pair, 4, 3, tq, c, 64, lens, seed=tq,
                              device=dev)
    _split_check(*pair, kern, plain, plan=(64, 8) if forced else None)


@pytest.mark.parametrize("pair", DECODE_PAIRS, ids=_PAIR_IDS)
@pytest.mark.parametrize("tq", [1, 8])
def test_decode_split_cap_of_eight(dev, pair, tq):
    """C = 1,500 at B * H = 4, where the cap of 8 splits (a portable
    cluster) changes the plan: 6 splits of 256, not 12 of 128."""
    from mxnet_tpu_torch.test_utils import decode_case

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = att.split_plan(4, tq, 1500, 64, sms)
    assert plan == (256, 6)
    kern, plain = decode_case(*pair, 2, 2, tq, 1500, 64,
                              [1500 - tq, 700], seed=tq, device=dev)
    _split_check(*pair, kern, plain)


def _offset_view(x, elems):
    """``x`` copied into a view at storage offset ``elems`` elements."""
    flat = torch.empty(x.numel() + elems, dtype=x.dtype, device=x.device)
    flat[elems:] = x.reshape(-1)
    return flat[elems:].view(x.shape)


@pytest.mark.parametrize("pair", DECODE_PAIRS, ids=_PAIR_IDS)
@pytest.mark.parametrize("d,align", [(8, 4), (8, 1), (37, 1)],
                         ids=["d8_4byte", "d8_byte", "d37_byte"])
def test_decode_split_copy_paths_through_offset_views(dev, pair, d, align):
    """The cache's 4-byte copies (rows and views 4-byte aligned, not 16)
    and byte copies (2 d or d bytes no multiple of 4, or views at a 1- or
    2-byte offset; an f32 cache takes 4-byte copies there) on q, k and v
    at a storage offset."""
    from mxnet_tpu_torch.test_utils import decode_case

    kern, plain = decode_case(*pair, 3, 2, 3, 130, d, [0, 64, 127],
                              seed=d + align, device=dev)
    for name in ("q", "k", "v"):
        t = kern[name]
        elems = max(1, align // t.element_size())
        kern[name] = _offset_view(t, elems)
        assert kern[name].data_ptr() % 16
    plain = dict(plain, q=kern["q"])
    _split_check(*pair, kern, plain)


# the pairs whose split-K runs on mma.sync: every 16-bit cache, and int8
# under 16-bit queries; the other four (an f32 cache, f32 over int8) run on
# CUDA cores
_MMA_PAIRS = [(q, k) for q, k in DECODE_PAIRS
              if k in HALF_DECODE or (k == torch.int8 and q != torch.float32)]


def test_decode_split_kernels_take_their_pairs_branch(dev):
    """The SASS of ``decode_split_kernel``, each of its 48 instantiations
    (12 pairs x 4 widths) by ``tools/torch_sass_counts.py``'s counting:
    HMMA in every width of the eight tensor-core pairs, none in the four
    CUDA-core pairs'."""
    import importlib.util
    import pathlib
    import re
    import subprocess

    from mxnet_tpu_torch.kernels import _build

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
        "torch_sass_counts.py"
    spec = importlib.util.spec_from_file_location("torch_sass_counts", path)
    sass_counts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass_counts)
    q_of = {"decode_attention.cu": torch.float32,
            "decode_attention_bf16.cu": torch.bfloat16,
            "decode_attention_f16.cu": torch.float16}
    kv_of = {"0": torch.float32, "1": torch.int8, "2": torch.bfloat16,
             "3": torch.float16}
    hmma = {}
    for src, q_dtype in q_of.items():
        _build.load(src)
        sass = subprocess.run(
            [sass_counts._cuobjdump(), "-sass",
             str(_build._target(_build.CSRC / src))],
            capture_output=True, text=True, check=True).stdout
        for fn, c in sass_counts.counts(sass, ["HMMA"]).items():
            m = re.search(r"decode_split_kernelILi(\d)ELi(\d)E", fn)
            if m:
                hmma[(q_dtype, kv_of[m.group(2)], m.group(1))] = c["HMMA"]
    assert len(hmma) == 48, sorted(hmma)
    for (q_dtype, kv_dtype, ncol), n in hmma.items():
        label = f"{_DT[q_dtype]}_{_DT[kv_dtype]} NCOL={ncol}"
        if (q_dtype, kv_dtype) in _MMA_PAIRS:
            assert n > 0, label
        else:
            assert n == 0, (label, n)


# f16 queries take 2^8 at most (their own range)
_SHIFTS = [(p, s) for p in _MMA_PAIRS
           for s in ((-16, 8) if p[0] == torch.float16 else (-16, 8, 17))]


@pytest.mark.parametrize("pair,shift", _SHIFTS,
                         ids=[f"{_DT[p[0]]}_{_DT[p[1]]}-{s}"
                              for p, s in _SHIFTS])
def test_decode_mma_pairs_take_queries_of_any_scale(dev, pair, shift):
    """Queries times 2^shift on the tensor-core pairs: at 2^17 an f32 or
    bf16 query passes f16's range (the f16 cache's pairs scale q by a
    power of two a row before their split), at 2^-16 it lies below f16's
    normal range; scores of 10^4 and more at 2^8 and 2^17, so the softmax
    is sharp and an inexact term would show."""
    from mxnet_tpu_torch.test_utils import decode_case

    q_dtype = pair[0]
    kern, plain = decode_case(*pair, 3, 2, 4, 300, 64, [0, 150, 296],
                              seed=shift + 40, device=dev)
    q = (kern["q"].float() * 2.0 ** shift).to(q_dtype)
    assert torch.isfinite(q).all()
    kern, plain = dict(kern, q=q), dict(plain, q=q)
    out = _split_check(*pair, kern, plain)
    assert torch.equal(out, _split_call(kern)[0])


def _flash_case(b, h, tq, tk, d, lens, seed):
    """q/k/v with NaN garbage in k/v past each row's length; the plain
    version gets the values with the garbage zeroed (it multiplies a
    masked position by 0, the kernel never reads it)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.rand(b, h, tq, d, generator=g) - 0.5
    k = torch.rand(b, h, tk, d, generator=g) - 0.5
    v = torch.rand(b, h, tk, d, generator=g) - 0.5
    if lens is not None:
        lens = torch.tensor(lens, dtype=torch.int32)
        garbage = (torch.arange(tk)[None, :] >= lens[:, None])
        garbage = garbage[:, None, :, None]
        k = k.masked_fill(garbage, float("nan"))
        v = v.masked_fill(garbage, float("nan"))
    return q, k, v, lens


@pytest.mark.parametrize("causal", [False, True], ids=["dense", "causal"])
@pytest.mark.parametrize("b,h,tq,tk,d,lens", [
    (2, 3, 1, 1, 8, None), (2, 2, 37, 37, 64, [0, 37]),
    (3, 2, 70, 130, 40, [1, 64, 129]), (2, 1, 129, 65, 128, [65, 63]),
    (1, 2, 200, 200, 256, [200]), (4, 2, 64, 64, 64, None),
    (2, 2, 37, 37, 4, [0, 37]), (3, 2, 70, 130, 36, [1, 64, 129]),
    (2, 1, 129, 65, 100, [65, 63]), (2, 2, 33, 33, 7, [5, 33]),
    (2, 2, 37, 37, 264, [0, 37]), (3, 1, 70, 130, 320, [1, 64, 129]),
    (2, 2, 65, 33, 512, [33, 17])])
def test_flash_kernel_matches_plain(dev, causal, b, h, tq, tk, d, lens):
    q, k, v, lens_t = _flash_case(b, h, tq, tk, d, lens, seed=tq * 7 + d)
    q, k, v = (t.to(dev) for t in (q, k, v))
    lens_d = None if lens_t is None else lens_t.to(dev)
    before = registry.launches()["flash_attention"]
    out, lse = att.flash_attention(q, k, v, causal=causal,
                                   kv_valid_length=lens_d, return_lse=True)
    torch.cuda.synchronize()
    assert registry.launches()["flash_attention"] == before + 1
    ref, ref_lse = att.flash_attention_reference(
        q, k, torch.nan_to_num(v), causal=causal, kv_valid_length=lens_d,
        return_lse=True)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lse, ref_lse, atol=TOL, rtol=TOL)
    again = att.flash_attention(q, k, v, causal=causal,
                                kv_valid_length=lens_d)
    assert torch.equal(out, again)            # the same bits, run to run


def test_flash_kernel_refuses_what_it_does_not_take(dev):
    ok = torch.zeros(1, 1, 4, 8, device=dev)
    for bad in (torch.zeros(1, 1, 0, 8, device=dev),        # no key
                ok.double(),                                # not f32
                torch.zeros(1, 1, 8, 4, device=dev).transpose(2, 3)):
        with pytest.raises(MXNetError):
            att.flash_attention(bad, bad, bad)
    with pytest.raises(MXNetError):                          # mixed types
        att.flash_attention(ok.bfloat16(), ok.bfloat16(), ok)
    with pytest.raises(MXNetError):                          # lengths shape
        att.flash_attention(ok, ok, ok,
                            kv_valid_length=torch.zeros(2, device=dev))


def _bwd_lens(t):
    """Per-row key lengths 0, 1, 63, 64 and T, each at most T."""
    return [min(n, t) for n in (0, 1, 63, 64, t)]


def _bwd_run(q, k, v, g, lens_d, causal):
    from mxnet_tpu_torch.kernels import flash_bwd as fb

    out, lse = att.flash_attention(q, k, v, causal=causal,
                                   kv_valid_length=lens_d, return_lse=True)
    got = fb.flash_attention_bwd(q, k, v, g, out, lse, lens_d, causal)
    torch.cuda.synchronize()
    return out, lse, got


def _bwd_check(got, ref, lens, again):
    """Within atol = rtol = 1e-4 of the plain version, exact zeros past
    each length (dq too for a 0-length row), the same bits again."""
    for a, r in zip(got, ref):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, r, atol=TOL, rtol=TOL)
    for row, n in enumerate(lens or []):      # exact zeros past lengths
        assert not got[1][row, :, n:].any() and not got[2][row, :, n:].any()
        if n == 0:
            assert not got[0][row].any()
    for a, b in zip(got, again):              # the same bits, run to run
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True], ids=["dense", "causal"])
@pytest.mark.parametrize("b,h,tq,tk,d,lens", [
    (2, 3, 1, 1, 8, None), (2, 2, 37, 37, 64, [0, 37]),
    (3, 2, 70, 130, 40, [1, 64, 129]), (2, 1, 129, 65, 128, [65, 63]),
    (1, 2, 200, 200, 256, [200]), (2, 2, 96, 96, 192, [33, 96]),
    (2, 2, 50, 90, 32, [0, 90]), (2, 2, 130, 33, 32, None),
    (2, 2, 37, 37, 264, [0, 37]), (3, 1, 70, 130, 320, [1, 64, 129]),
    (2, 2, 65, 65, 512, [65, 17]), (2, 1, 40, 90, 320, None)])
def test_flash_bwd_kernels_match_plain(dev, causal, b, h, tq, tk, d, lens):
    """Tq != Tk, no lengths (every row attends all Tk keys), d = 32 and
    d = 192 (the runtime-width kernels of the widest class), and d = 264,
    320, 512 (the slab and group kernels)."""
    from mxnet_tpu_torch.kernels import flash_bwd as fb

    q, k, v, lens_t = _flash_case(b, h, tq, tk, d, lens, seed=tq * 5 + d)
    g = torch.rand(b, h, tq, d, generator=torch.Generator().manual_seed(d))
    q, k, v, g = (t.to(dev) for t in (q, k, v, g - 0.5))
    lens_d = None if lens_t is None else lens_t.to(dev)
    before = registry.launches()
    out, lse, got = _bwd_run(q, k, v, g, lens_d, causal)
    after = registry.launches()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1
    ref = fb.flash_attention_bwd_reference(
        q, torch.nan_to_num(k), torch.nan_to_num(v), g, out, lse, lens_d,
        causal)
    again = fb.flash_attention_bwd(q, k, v, g, out, lse, lens_d, causal)
    torch.cuda.synchronize()
    _bwd_check(got, ref, lens, again)


@pytest.mark.parametrize("causal", [False, True], ids=["dense", "causal"])
@pytest.mark.parametrize("t", [1, 37, 128, 512])
@pytest.mark.parametrize("d", [8, 36, 64, 100, 128, 256])
def test_flash_bwd_kernels_grid_match_plain(dev, causal, t, d):
    """The tensor-core pair against the plain version at atol = rtol =
    1e-4 (TF32 off globally: the 3xTF32 split is the kernels' own), exact
    zeros past each length, and the same bits from a second call."""
    from mxnet_tpu_torch.kernels import flash_bwd as fb

    lens = _bwd_lens(t)
    q, k, v, lens_t = _flash_case(len(lens), 2, t, t, d, lens,
                                  seed=t * 5 + d)
    g = torch.rand(len(lens), 2, t, d,
                   generator=torch.Generator().manual_seed(d)) - 0.5
    q, k, v, g = (x.to(dev) for x in (q, k, v, g))
    lens_d = lens_t.to(dev)
    before = registry.launches()
    out, lse, got = _bwd_run(q, k, v, g, lens_d, causal)
    after = registry.launches()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert after[name] == before[name] + 1
    ref = fb.flash_attention_bwd_reference(
        q, torch.nan_to_num(k), torch.nan_to_num(v), g, out, lse, lens_d,
        causal)
    again = fb.flash_attention_bwd(q, k, v, g, out, lse, lens_d, causal)
    torch.cuda.synchronize()
    _bwd_check(got, ref, lens, again)


@pytest.mark.parametrize("d", [36, 64])
def test_attention_kernels_take_unaligned_inputs(dev, d):
    """Views at storage offset 1 (not 16-byte aligned) take the scalar
    copies of the forward, backward and decode kernels."""
    from mxnet_tpu_torch.kernels import flash_bwd as fb

    def view(x):
        flat = torch.empty(x.numel() + 1, device=dev)
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)

    lens = [0, 1, 63, 64]
    q, k, v, lens_t = _flash_case(4, 2, 64, 64, d, lens, seed=d)
    g = torch.rand(4, 2, 64, d, generator=torch.Generator().manual_seed(1))
    q, k, v, g = (view(x.to(dev)) for x in (q, k, v, g - 0.5))
    assert q.data_ptr() % 16
    lens_d = lens_t.to(dev)
    out, lse, got = _bwd_run(q, k, v, g, lens_d, True)
    ref_out, ref_lse = att.flash_attention_reference(
        q, k, torch.nan_to_num(v), causal=True, kv_valid_length=lens_d,
        return_lse=True)
    torch.testing.assert_close(out, ref_out, atol=TOL, rtol=TOL)
    ref = fb.flash_attention_bwd_reference(
        q, torch.nan_to_num(k), torch.nan_to_num(v), g, out, lse, lens_d,
        True)
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, atol=TOL, rtol=TOL)
    qd = view(q[:, :, :3].contiguous())
    cache = view(torch.nan_to_num(v))
    cache_len = torch.tensor([5, 0, 20, 61], dtype=torch.int32, device=dev)
    dec = att.flash_attention_decode(qd, cache, cache, cache_len)
    torch.testing.assert_close(dec, att.flash_attention_decode_reference(
        qd, cache, cache, cache_len), atol=TOL, rtol=TOL)


def test_autograd_through_flash_attention_launches_both_kernels(dev):
    x = [torch.rand(2, 2, 40, 64, device=dev, requires_grad=True)
         for _ in range(3)]
    lens = torch.tensor([40, 7], dtype=torch.int32, device=dev)
    before = registry.launches()
    out = att.flash_attention(*x, kv_valid_length=lens)
    grads = torch.autograd.grad(out.square().sum(), x)
    torch.cuda.synchronize()
    after = registry.launches()
    assert [after[n] - before[n] for n in
            ("flash_attention", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")] == [1, 1, 1]
    leaves = [t.detach().clone().requires_grad_() for t in x]
    mask = att._merge_mask(None, lens, 40, 40, False, dev)
    ref = torch.autograd.grad(
        att.attention_reference(*leaves, mask=mask).square().sum(), leaves)
    for a, r in zip(grads, ref):
        torch.testing.assert_close(a, r, atol=TOL, rtol=TOL)


def test_flash_bwd_refuses_what_it_does_not_take(dev):
    from mxnet_tpu_torch.kernels import flash_bwd as fb

    ok = torch.zeros(1, 1, 4, 8, device=dev)
    lse = torch.zeros(1, 1, 4, device=dev)
    for bad in (torch.zeros(1, 1, 0, 8, device=dev),        # no key
                ok.double(),                                # not f32
                torch.zeros(1, 1, 8, 4, device=dev).transpose(2, 3)):
        with pytest.raises(MXNetError):
            fb.flash_attention_bwd(ok, bad, bad, ok, ok, lse)
    with pytest.raises(MXNetError):                         # lse on the CPU
        fb.flash_attention_bwd(ok, ok, ok, ok, ok, lse.cpu())


# ------------------------------------------------------ 16-bit variants
# Tolerances against the plain version (the TPU kernel's roundings, in
# f32 on the card): the forward within 2^-7 (bf16) and 2^-10 (f16) of
# max|ref| (a rounded p and the rounded output may each flip one 16-bit
# ulp: the kernel's running max over key tiles against the plain
# version's max over the row), the lse within 1e-4; dq, dk and dv within
# 2^-6 (bf16) and 2^-9 (f16) of the larger of max|g| and max|ref| (their
# products keep f32 accuracy and the gradients are rounded once at the
# end, at their own scale where that is above g's: dv of a key that
# every query attends with p ~ 1 sums T rows of g).
HALF = [torch.bfloat16, torch.float16]
FWD16_TOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
BWD16_TOL = {torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -9}


def _half_inputs(b, h, tq, tk, d, lens, dtype, seed, dev):
    """16-bit q, k, v (NaN past each row's length in k and v), g, the
    lengths, and v with the garbage zeroed for the plain version."""
    q, k, v, lens_t = _flash_case(b, h, tq, tk, d, lens, seed)
    g = torch.rand(b, h, tq, d, generator=torch.Generator().manual_seed(d))
    q, k, v, g = ((2 * x).to(dtype).to(dev) for x in (q, k, v, g - 0.5))
    lens_d = None if lens_t is None else lens_t.to(dev)
    return q, k, v, g, lens_d, torch.nan_to_num(v)


def _half_check(dtype, q, k, v, g, lens_d, ref_v, causal, lens):
    from mxnet_tpu_torch.kernels import flash_bwd as fb

    sfx = "bf16" if dtype == torch.bfloat16 else "f16"
    names = [f"{n}.{sfx}" for n in ("flash_attention",
                                    "flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkv")]
    before = registry.launches()
    out, lse = att.flash_attention(q, k, v, causal=causal,
                                   kv_valid_length=lens_d, return_lse=True)
    got = fb.flash_attention_bwd(q, k, v, g, out, lse, lens_d, causal)
    torch.cuda.synchronize()
    after = registry.launches()
    # Tk <= 128 and d <= 64: the dk/dv kernel's fused mode, one launch
    assert [after[n] - before[n] for n in names] == \
        [1, 0 if fb.fused(q, k) else 1, 1]
    for n in ("flash_attention", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        assert after[n] == before[n]          # never the f32 kernels
    assert out.dtype == dtype and lse.dtype == torch.float32
    ref, ref_lse = att.flash_attention_reference(
        q, k, ref_v, causal=causal, kv_valid_length=lens_d, return_lse=True)
    assert torch.isfinite(out).all()
    tol = FWD16_TOL[dtype] * float(ref.float().abs().max())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    want = fb.flash_attention_bwd_reference(
        q, torch.nan_to_num(k), ref_v, g, out, lse, lens_d, causal)
    gmax = float(g.float().abs().max())
    for a, r in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        tol = BWD16_TOL[dtype] * max(gmax, float(r.float().abs().max()))
        torch.testing.assert_close(a.float(), r.float(), atol=tol, rtol=0)
    for row, n in enumerate(lens or []):      # exact zeros past lengths
        assert not got[1][row, :, n:].any() and not got[2][row, :, n:].any()
        if n == 0:
            assert not got[0][row].any() and not out[row].any()
    again = att.flash_attention(q, k, v, causal=causal,
                                kv_valid_length=lens_d)
    again_g = fb.flash_attention_bwd(q, k, v, g, out, lse, lens_d, causal)
    torch.cuda.synchronize()
    assert torch.equal(out, again)            # the same bits, run to run
    for a, b in zip(got, again_g):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "f16"])
@pytest.mark.parametrize("causal", [False, True], ids=["dense", "causal"])
@pytest.mark.parametrize("b,h,tq,tk,d,lens", [
    (2, 3, 1, 1, 8, None), (2, 2, 37, 37, 64, [0, 37]),
    (3, 2, 70, 130, 36, [1, 64, 129]), (2, 1, 129, 65, 128, [65, 63]),
    (2, 2, 96, 96, 192, [33, 96]), (3, 1, 70, 130, 320, [1, 64, 129]),
    (2, 2, 33, 33, 7, [5, 33]), (2, 2, 130, 33, 64, None)])
def test_half_kernels_match_plain(dev, dtype, causal, b, h, tq, tk, d, lens):
    """bf16 and f16 forward, dq and dk/dv against their plain versions:
    one launch each of the 16-bit kernels and none of the f32 ones,
    outputs in the input type, exact zeros past each length, the same
    bits from a second call."""
    args = _half_inputs(b, h, tq, tk, d, lens, dtype, tq * 3 + d, dev)
    _half_check(dtype, *args, causal, lens)


@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "f16"])
@pytest.mark.parametrize("b,t,lens", [
    (32, 128, [64 + (64 * i) // 31 for i in range(32)]),
    (16, 512, [24 + (488 * i) // 15 for i in range(16)])],
    ids=["train", "serve"])
@pytest.mark.parametrize("d", [36, 64, 128, 320])
def test_half_kernels_at_main_path_shapes(dev, dtype, b, t, lens, d):
    """The training shape (B=32, H=12, T=128, kv_len 64-128) and the
    serving shape (B=16, H=12, T=512, kv_len 24-512) at d = 36, 64, 128
    and 320 (64 is BERT's width)."""
    if t == 512 and d == 320:
        b, lens = 4, lens[::4]                # the plain version's memory
    args = _half_inputs(b, 12, t, t, d, lens, dtype, b + d, dev)
    _half_check(dtype, *args, False, lens)


@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "f16"])
@pytest.mark.parametrize("d", [36, 64, 320])
def test_half_kernels_take_unaligned_inputs(dev, dtype, d):
    """Views at storage offset 1 (2-byte aligned) take the element copies
    and the scalar stores."""
    def view(x):
        flat = torch.empty(x.numel() + 1, device=dev, dtype=x.dtype)
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)

    lens = [0, 1, 63, 64]
    q, k, v, g, lens_d, ref_v = _half_inputs(4, 2, 64, 64, d, lens, dtype,
                                             d, dev)
    q, k, v, g = (view(x) for x in (q, k, v, g))
    assert q.data_ptr() % 4
    _half_check(dtype, q, k, v, g, lens_d, ref_v, True, lens)


@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "f16"])
@pytest.mark.parametrize("causal", [False, True], ids=["dense", "causal"])
@pytest.mark.parametrize("d", [36, 64, 128, 320])
@pytest.mark.parametrize("tk", [1, 64, 127, 128, 129, 200, 512])
def test_half_bwd_at_the_fused_boundary_matches_plain(dev, dtype, causal, d,
                                                      tk):
    """Either side of the fused mode's edge (Tk <= 128 and d <= 64: one
    launch of the dk/dv kernel; else dq, then dk/dv): Tq != Tk, key
    lengths 0, 1 and Tk."""
    tq = max(1, tk - 5) if causal else tk + 37
    lens = [0, 1, tk]
    args = _half_inputs(3, 2, tq, tk, d, lens, dtype, tq + tk + d, dev)
    _half_check(dtype, *args, causal, lens)


@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "f16"])
@pytest.mark.parametrize("tk,d", [(128, 36), (128, 64), (129, 36),
                                  (129, 64)])
def test_half_bwd_at_the_fused_boundary_takes_unaligned_inputs(dev, dtype,
                                                               tk, d):
    def view(x):
        flat = torch.empty(x.numel() + 1, device=dev, dtype=x.dtype)
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)

    lens = [0, 1, tk]
    q, k, v, g, lens_d, ref_v = _half_inputs(3, 2, 100, tk, d, lens, dtype,
                                             tk + d, dev)
    q, k, v, g = (view(x) for x in (q, k, v, g))
    _half_check(dtype, q, k, v, g, lens_d, ref_v, True, lens)


@pytest.mark.parametrize("tk,d", [(128, 64), (200, 64), (128, 320),
                                  (200, 320)])
def test_half_bwd_f16_past_its_range_in_ds(dev, tk, d):
    """|dS| above 65504, f16's largest value, while dq, dk and dv are
    nonzero and fit in f16, |dS| rising from one query tile to the next
    (``test_utils.attention_large_ds_inputs``): finite gradients within
    the bar of the plain version's, where a split of dS in f16 without a
    scale gives inf and a scale unmade by a wrong power of two misses by
    half a gradient."""
    from mxnet_tpu_torch.kernels import flash_bwd as fb
    from mxnet_tpu_torch.test_utils import (attention_large_ds_inputs,
                                            attention_p_ds)

    q, k, v, g = (x.half().to(dev)
                  for x in attention_large_ds_inputs(2, 2, tk, d))
    lens = torch.tensor([tk, 2], dtype=torch.int32, device=dev)
    out, lse = att.flash_attention(q, k, v, kv_valid_length=lens,
                                   return_lse=True)
    got = fb.flash_attention_bwd(q, k, v, g, out, lse, lens)
    again = fb.flash_attention_bwd(q, k, v, g, out, lse, lens)
    want = fb.flash_attention_bwd_reference(q, k, v, g, out, lse, lens)
    assert attention_p_ds(q, k, v, g, out, lse, lens)[1].abs().max() > 65504
    gmax = float(g.float().abs().max())
    for a, r in zip(got, want):
        assert a.dtype == torch.float16 and torch.isfinite(a).all()
        assert r.float().abs().max() > 1000
        tol = BWD16_TOL[torch.float16] * max(gmax,
                                             float(r.float().abs().max()))
        torch.testing.assert_close(a.float(), r.float(), atol=tol, rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("tk", [128, 192])
def test_half_bwd_keeps_the_split_low_term(dev, dtype, tk):
    """dq on keys 1 + e (``test_utils.attention_split_probe_inputs``),
    where it is one ulp's size of dS: within 2^-6 (bf16) / 2^-9 (f16) of
    max|dq| of the plain version's, which a split of dS that kept only
    its high term misses by 4x or more (``tests/test_torch_half_attention
    .py::test_half_split_keeps_its_low_term``); Tk = 128 on the fused
    mode, 192 on two launches."""
    from mxnet_tpu_torch.kernels import flash_bwd as fb
    from mxnet_tpu_torch.test_utils import attention_split_probe_inputs

    q, k, v, g = (x.to(dtype).to(dev) for x in attention_split_probe_inputs(
        2, 2, 96, tk, 64, dtype, seed=tk))
    assert fb.fused(q, k) == (tk <= 128)
    lens = torch.tensor([tk, tk - 30], dtype=torch.int32, device=dev)
    out, lse = att.flash_attention(q, k, v, kv_valid_length=lens,
                                   return_lse=True)
    dq = fb.flash_attention_bwd(q, k, v, g, out, lse, lens)[0]
    ref = fb.flash_attention_bwd_reference(q, k, v, g, out, lse, lens)[0]
    top = float(ref.float().abs().max())
    err = float((dq.float() - ref.float()).abs().max())
    assert err <= BWD16_TOL[dtype] * top, (err, top)


# the 16-bit forward's edges: (B, H, Tq, Tk, d, key lengths, causal,
# unaligned views, scale or None for 1/sqrt(d))
FWD16_EDGES = [
    (4, 2, 128, 128, 64, [0, 1, 63, 128], False, False, None),
    (3, 2, 100, 129, 64, [0, 129, 70], True, False, None),
    (3, 2, 200, 64, 36, [64, 1, 0], True, False, None),
    (2, 2, 1, 129, 64, [129, 0], False, False, None),
    (2, 3, 65, 65, 8, [65, 3], True, False, None),
    (2, 2, 129, 200, 1, [200, 129], False, False, None),
    (2, 2, 200, 200, 64, [0, 200], True, True, None),
    (2, 2, 129, 129, 36, [5, 129], False, True, None),
    (2, 2, 100, 129, 64, [129, 70], False, False, -0.125)]


@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "f16"])
@pytest.mark.parametrize("b,h,tq,tk,d,lens,causal,unaligned,scale",
                         FWD16_EDGES)
def test_half_forward_at_its_edges_matches_plain(dev, dtype, b, h, tq, tk, d,
                                                 lens, causal, unaligned,
                                                 scale):
    """The 16-bit forward alone where its tiles end: ragged lengths with a
    0-length row (out 0, lse -inf), causal with Tq != Tk, Tq off the 64-
    and 128-row blocks, d in {1, 8, 36, 64}, views at storage offset 1,
    a negative scale; one launch, out within 2^-7 / 2^-10 x max|ref| and
    the lse within 1e-4 of the plain version's, the same bits twice."""
    sfx = "bf16" if dtype == torch.bfloat16 else "f16"
    q, k, v, _, lens_d, ref_v = _half_inputs(b, h, tq, tk, d, lens, dtype,
                                             tq + tk + d, dev)
    if unaligned:
        def view(x):
            flat = torch.empty(x.numel() + 1, device=dev, dtype=x.dtype)
            flat[1:] = x.reshape(-1)
            return flat[1:].view(x.shape)

        q, k, v = (view(x) for x in (q, k, v))
        assert q.data_ptr() % 4
    before = registry.launches()
    out, lse = att.flash_attention(q, k, v, causal=causal, scale=scale,
                                   kv_valid_length=lens_d, return_lse=True)
    again, again_lse = att.flash_attention(q, k, v, causal=causal,
                                           scale=scale,
                                           kv_valid_length=lens_d,
                                           return_lse=True)
    torch.cuda.synchronize()
    after = registry.launches()
    assert after[f"flash_attention.{sfx}"] - \
        before[f"flash_attention.{sfx}"] == 2
    ref, ref_lse = att.flash_attention_reference(
        q, torch.nan_to_num(k), ref_v, causal=causal, scale=scale,
        kv_valid_length=lens_d, return_lse=True)
    assert out.dtype == dtype and torch.isfinite(out).all()
    tol = FWD16_TOL[dtype] * float(ref.float().abs().max())
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
    for row, n in enumerate(lens):
        if n == 0:                            # nothing to attend
            assert not out[row].any() and torch.isinf(lse[row]).all()
            assert (lse[row] < 0).all()
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


@pytest.mark.parametrize("dtype", HALF, ids=["bf16", "f16"])
@pytest.mark.parametrize("t", [128, 512])
def test_half_grads_through_the_forward_lse_match_plain(dev, dtype, t):
    """Gradients of q, k and v through autograd: the backward kernels run
    on the lse the 16-bit forward saved (T = 128: the fused launch; 512:
    dq, then dk/dv), against autograd through the plain version, within
    2^-6 / 2^-9 x the larger of max|g| and max|ref|."""
    b, h, d = 4, 3, 64
    lens = [t, t // 2, 1, t - 9]
    q, k, v, g, lens_d, ref_v = _half_inputs(b, h, t, t, d, lens, dtype,
                                             t + 3, dev)
    k, v = torch.nan_to_num(k), ref_v
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = att.flash_attention(*leaves, kv_valid_length=lens_d)
    got = torch.autograd.grad(out, leaves, g)
    plain = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    ref = att.flash_attention_reference(*plain, kv_valid_length=lens_d)
    want = torch.autograd.grad(ref, plain, g)
    gmax = float(g.float().abs().max())
    for a, r in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        tol = BWD16_TOL[dtype] * max(gmax, float(r.float().abs().max()))
        torch.testing.assert_close(a.float(), r.float(), atol=tol, rtol=0)


def test_half_autograd_launches_the_16bit_kernels(dev):
    x = [(torch.rand(2, 2, 40, 64, device=dev) - 0.5).bfloat16()
         .requires_grad_() for _ in range(3)]
    lens = torch.tensor([40, 7], dtype=torch.int32, device=dev)
    before = registry.launches()
    out = att.flash_attention(*x, kv_valid_length=lens)
    grads = torch.autograd.grad(out.float().square().sum(), x)
    torch.cuda.synchronize()
    after = registry.launches()
    assert [after[n] - before[n] for n in
            ("flash_attention.bf16", "flash_attention_bwd_dq.bf16",
             "flash_attention_bwd_dkv.bf16", "flash_attention")] == \
        [1, 0, 1, 0]                          # Tk = 40: the fused mode
    assert all(gr.dtype == torch.bfloat16 for gr in grads)


@pytest.mark.parametrize("dtype,opt,kw", [
    (torch.bfloat16, "adamw", {}), (torch.float16, "adamw", {}),
    (torch.float16, "sgd", {"momentum": 0.9})],
    ids=["bf16_adamw", "f16_adamw", "f16_sgd_arena"])
def test_16bit_trainer_step_never_syncs_the_host(dev, dtype, opt, kw):
    """A 16-bit step (f16: the loss scale, the finite check and the skip's
    select on the card) queues its work without a host sync, so the
    in-flight window stays deep; under ``set_sync_debug_mode("error")``
    a sync raises."""
    from mxnet_tpu_torch.gluon.model_zoo import BERTForPretrain, get_bert
    from mxnet_tpu_torch.gluon.model_zoo.bert import pretrain_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer

    net = xavier_init(BERTForPretrain(get_bert(
        num_layers=2, units=64, hidden_size=128, num_heads=4, vocab_size=97,
        max_length=32, dropout=0.1, device=dev)), 0)
    tr = ShardedTrainer(net, pretrain_loss, optimizer=opt,
                        learning_rate=1e-3, compute_dtype=dtype, **kw)
    g = torch.Generator().manual_seed(0)
    x = (torch.randint(0, 97, (4, 32), generator=g),
         torch.zeros(4, 32, dtype=torch.int64),
         torch.tensor([32, 20, 9, 32]), torch.randint(0, 9, (4, 5),
                                                       generator=g))
    y = (torch.randint(0, 97, (4, 5), generator=g), torch.arange(4) % 2)
    x, y = tuple(t.to(dev) for t in x), tuple(t.to(dev) for t in y)
    tr.step(x, y, block=True)
    before = tr.loss_scale
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = tr.step(x, y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tr.drain()
    assert torch.isfinite(loss) and tr.loss_scale == before


@pytest.mark.parametrize("t", [1, 7])
@pytest.mark.parametrize("variant,kw", [
    ("sgd", {}), ("momentum", dict(momentum=0.9)),
    ("momentum", dict(momentum=0.9, nesterov=True)), ("adam", {})],
    ids=["sgd", "momentum", "nesterov", "adam"])
def test_arena_kernel_matches_plain(dev, variant, kw, t):
    from mxnet_tpu_torch.kernels import opt_arena as oa

    lay = oa.build_layout([(37,), (5, 3), (20000,)])
    gen = torch.Generator().manual_seed(t)
    g = torch.zeros(lay.padded)
    g[:lay.total] = torch.rand(lay.total, generator=gen) - 0.5
    states = []
    for _ in range(oa.VARIANT_STATES[variant]):
        s = torch.zeros(lay.padded)
        s[:lay.total] = torch.rand(lay.total, generator=gen) * 0.1
        states.append(s.to(dev))
    g = g.to(dev)
    ref_states = [s.clone() for s in states]
    before = registry.launches()["opt_arena"]
    d, states = oa.arena_update(variant, g, states, 1e-3, t, **kw)
    torch.cuda.synchronize()
    assert registry.launches()["opt_arena"] == before + 1
    d_ref, ref_states = oa.arena_update_reference(variant, g, ref_states,
                                                  1e-3, t, **kw)
    for a, r in [(d, d_ref)] + list(zip(states, ref_states)):
        assert ((a - r).abs() <= 1e-6 * r.abs()).all()
        assert not a[lay.total:].any()


def test_arena_kernel_refuses_what_it_does_not_take(dev):
    from mxnet_tpu_torch.kernels import opt_arena as oa

    g = torch.zeros(8192, device=dev)
    with pytest.raises(MXNetError):                          # state on CPU
        oa.arena_update("momentum", g, [torch.zeros(8192)], 0.1, 1)
    with pytest.raises(MXNetError):                          # misaligned
        oa.arena_update("sgd", torch.zeros(8193, device=dev)[1:], [], 0.1, 1)


@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("rows,c", [(1, 3), (9, 8), (4097, 64), (6272, 512),
                                    (33, 2048), (1000, 1), (777, 6)])
def test_bn_act_kernels_match_plain(dev, act, rows, c):
    from mxnet_tpu_torch.kernels import bn_act as kbn

    gen = torch.Generator().manual_seed(rows + c)
    x = torch.rand(rows, c, generator=gen) * 2 - 1
    if c > 1:
        x[:, 0] = 0.1                                   # constant channel
        x[:, -1] += 3.0                                 # offset mean
    x = x.to(dev)
    gamma = (torch.rand(c, generator=gen) + 0.5).to(dev)
    beta = (torch.rand(c, generator=gen) - 0.5).to(dev)
    before = registry.launches()
    mean, var, scale, shift = kbn.bn_stats(x, gamma, beta, 1e-5)
    y = kbn.bn_apply(x, scale, shift, act)
    torch.cuda.synchronize()
    after = registry.launches()
    assert after["bn_act_stats"] == before["bn_act_stats"] + 1
    assert after["bn_act_apply"] == before["bn_act_apply"] + 1
    x64 = x.double()
    ms = (x64 * x64).mean(0).clamp_min(1e-30)
    ref_mean = x64.mean(0)
    ref_var = (x64 - ref_mean).square().mean(0)
    assert ((mean.double() - ref_mean).abs() <= 1e-5 * ms.sqrt()).all()
    assert ((var.double() - ref_var).abs() <= 1e-5 * ms).all()
    # the fold against the plain version's on the kernel's mean and var,
    # within 1e-6 of its terms (shift = beta - mean * gamma * inv)
    inv = torch.rsqrt(var + 1e-5)
    torch.testing.assert_close(scale, gamma * inv, atol=0, rtol=1e-6)
    big = torch.maximum(beta.abs(), (mean * gamma * inv).abs())
    assert ((shift - (beta - mean * gamma * inv)).abs() <= 1e-6 * big).all()
    torch.testing.assert_close(
        y, kbn.bn_apply_plain(x, scale, shift, act), atol=TOL, rtol=TOL)
    again = kbn.bn_stats(x, gamma, beta, 1e-5)          # the same bits
    assert all(torch.equal(a, b) for a, b in
               zip(again, (mean, var, scale, shift)))


@pytest.mark.parametrize("rows,c", [(128 * 112 * 112, 64),
                                    (128 * 56 * 56, 64),
                                    (128 * 28 * 28, 128),
                                    (128 * 14 * 14, 256), (128 * 7 * 7, 512),
                                    (4097, 77)])
def test_bn_stats_are_the_same_bits_over_ten_calls(dev, rows, c):
    """The one-launch statistics and fold at ResNet-50's five
    BatchNormReLU shapes (B=128) and an odd C: ten calls, one set of
    bits, whichever block of a column block arrives last."""
    from mxnet_tpu_torch.kernels import bn_act as kbn

    gen = torch.Generator(device=dev).manual_seed(rows + c)
    x = torch.rand(rows, c, generator=gen, device=dev) * 2 - 1 + 0.5
    gamma = torch.rand(c, generator=gen, device=dev) + 0.5
    beta = torch.rand(c, generator=gen, device=dev) - 0.5
    first = kbn.bn_stats(x, gamma, beta, 1e-5)
    for _ in range(9):
        again = kbn.bn_stats(x, gamma, beta, 1e-5)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.isfinite(a).all() for a in first)


def test_bn_act_train_autograd_launches_both_kernels(dev):
    from mxnet_tpu_torch.kernels import bn_act as kbn

    gen = torch.Generator().manual_seed(3)
    x = (torch.rand(2, 5, 5, 16, generator=gen) - 0.3).to(dev)
    gamma = torch.ones(16, device=dev, requires_grad=True)
    beta = torch.zeros(16, device=dev, requires_grad=True)
    leaf = x.clone().requires_grad_()
    before = registry.launches()
    y, mean, var = kbn.bn_act_train(leaf, gamma, beta, 1e-5, "relu")
    (y * y).sum().backward()
    after = registry.launches()
    assert after["bn_act_stats"] == before["bn_act_stats"] + 1
    assert after["bn_act_apply"] == before["bn_act_apply"] + 1
    cpu = [t.detach().cpu().requires_grad_() for t in (x, gamma, beta)]
    ry, _, _ = kbn.bn_act_train(*cpu, 1e-5, "relu")
    (ry * ry).sum().backward()
    torch.testing.assert_close(y.cpu(), ry, atol=TOL, rtol=TOL)
    for a, b in zip((leaf, gamma, beta), cpu):
        torch.testing.assert_close(a.grad.cpu(), b.grad, atol=TOL, rtol=TOL)


def test_bn_act_kernels_refuse_what_they_do_not_take(dev):
    from mxnet_tpu_torch.kernels import bn_act as kbn

    x = torch.zeros(8, 4, 4, 16, device=dev)
    with pytest.raises(MXNetError, match="contiguous"):      # NCHW storage
        kbn.bn_act_train(x.permute(0, 3, 1, 2).contiguous().permute(
            0, 2, 3, 1), torch.ones(16, device=dev),
            torch.zeros(16, device=dev), 1e-5, "relu")
    with pytest.raises(MXNetError):                          # scale on CPU
        kbn.bn_apply(x.view(-1, 16), torch.ones(16), torch.zeros(16), "relu")
    with pytest.raises(MXNetError):                          # f64 input
        kbn.bn_stats(x.view(-1, 16).double(), torch.ones(16, device=dev),
                     torch.zeros(16, device=dev), 1e-5)


# ------------------------------------- the 16-bit batch-norm kernels
BN16 = [(torch.bfloat16, "bf16"), (torch.float16, "f16")]


def _bn16_inputs(rows, c, dtype, seed, dev, offset=False):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(rows, c, generator=gen) * 2 - 1
    if c > 1:
        x[:, 0] = 0.1                                   # constant channel
        x[:, -1] += 3.0                                 # offset mean
    gamma = torch.rand(c, generator=gen) + 0.5
    beta = torch.rand(c, generator=gen) - 0.5
    x, gamma, beta = (t.to(dtype).to(dev) for t in (x, gamma, beta))
    if offset:                           # a view at a 2-byte offset
        flat = torch.empty(rows * c + 1, dtype=dtype, device=dev)
        flat[1:] = x.reshape(-1)
        x = flat[1:].view(rows, c)
    return x, gamma, beta


def _bn16_check(x, gamma, beta, act, sfx):
    """One stats and one apply launch of the dtype's kernels; y bit for
    bit with the plain apply, scale and shift equal to the plain fold's,
    mean and var within 1e-5 of the channel's scale of float64."""
    from mxnet_tpu_torch.kernels import bn_act as kbn

    before = registry.launches()
    mean, var, scale, shift = kbn.bn_stats(x, gamma, beta, 1e-5)
    y = kbn.bn_apply(x, scale, shift, act)
    torch.cuda.synchronize()
    after = registry.launches()
    assert after[f"bn_act_stats.{sfx}"] == before[f"bn_act_stats.{sfx}"] + 1
    assert after[f"bn_act_apply.{sfx}"] == before[f"bn_act_apply.{sfx}"] + 1
    assert sum(after.values()) == sum(before.values()) + 2
    assert mean.dtype == var.dtype == torch.float32
    assert scale.dtype == shift.dtype == y.dtype == x.dtype
    x64 = x.double()
    ms = (x64 * x64).mean(0).clamp_min(1e-30)
    ref_mean = x64.mean(0)
    ref_var = (x64 - ref_mean).square().mean(0)
    assert ((mean.double() - ref_mean).abs() <= 1e-5 * ms.sqrt()).all()
    assert ((var.double() - ref_var).abs() <= 1e-5 * ms).all()
    _, _, p_scale, p_shift = kbn.bn_stats_plain(x, gamma, beta, 1e-5)
    bits = torch.int16
    assert torch.equal(scale.view(bits), p_scale.view(bits))
    assert torch.equal(shift.view(bits), p_shift.view(bits))
    ref = kbn.bn_apply_plain(x, scale, shift, act)
    assert torch.equal(y.view(bits), ref.view(bits))
    again = kbn.bn_stats(x, gamma, beta, 1e-5)
    assert all(torch.equal(a, b) for a, b in
               zip(again, (mean, var, scale, shift)))
    return y


@pytest.mark.parametrize("dtype,sfx", BN16, ids=["bf16", "f16"])
@pytest.mark.parametrize("act", ["relu", "identity"])
@pytest.mark.parametrize("rows,c", [(128 * 112 * 112, 64),
                                    (128 * 56 * 56, 64),
                                    (128 * 28 * 28, 128),
                                    (128 * 14 * 14, 256), (128 * 7 * 7, 512),
                                    (4097, 3), (4097, 12), (1, 64), (1, 8),
                                    (9, 2048), (4097, 77), (1000, 1)])
def test_bn16_kernels_match_plain(dev, dtype, sfx, act, rows, c):
    x, gamma, beta = _bn16_inputs(rows, c, dtype, rows + c, dev)
    y = _bn16_check(x, gamma, beta, act, sfx)
    assert torch.isfinite(y).all()


@pytest.mark.parametrize("dtype,sfx", BN16, ids=["bf16", "f16"])
@pytest.mark.parametrize("rows,c", [(4097, 64), (4097, 12), (100352, 128)])
def test_bn16_kernels_take_views_at_a_2_byte_offset(dev, dtype, sfx, rows,
                                                    c):
    x, gamma, beta = _bn16_inputs(rows, c, dtype, c, dev, offset=True)
    assert x.data_ptr() % 16 == 2
    _bn16_check(x, gamma, beta, "relu", sfx)


@pytest.mark.parametrize("dtype,sfx", BN16, ids=["bf16", "f16"])
def test_bn16_apply_past_f16_range_gives_inf(dev, dtype, sfx):
    """An outlier whose normalized value (about 64) times gamma 2048 is
    past 65,504: inf in f16, as the JAX op gives, finite in bf16."""
    x = torch.zeros(4097, 8)
    x[0, 1] = 1000.0
    gamma = torch.ones(8)
    gamma[1] = 2048.0
    x, gamma, beta = (t.to(dtype).to(dev) for t in (x, gamma,
                                                    torch.zeros(8)))
    y = _bn16_check(x, gamma, beta, "identity", sfx)
    assert bool(torch.isinf(y[0, 1])) == (dtype == torch.float16)
    from mxnet_tpu_torch.kernels import bn_act as kbn
    big = torch.full((3, 8), 60000.0, device=dev).to(dtype)
    two = torch.full((8,), 2.0, device=dev).to(dtype)
    out = kbn.bn_apply(big, two, torch.zeros(8, device=dev, dtype=dtype),
                       "relu")
    ref = kbn.bn_apply_plain(big, two, torch.zeros_like(two), "relu")
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    assert bool(torch.isinf(out).all()) == (dtype == torch.float16)


def test_bn16_kernels_refuse_mixed_dtypes(dev):
    from mxnet_tpu_torch.kernels import bn_act as kbn

    x = torch.zeros(64, 16, device=dev, dtype=torch.bfloat16)
    f32 = torch.ones(16, device=dev)
    with pytest.raises(MXNetError, match="gamma"):           # f32 gamma
        kbn.bn_stats(x, f32, f32, 1e-5)
    with pytest.raises(MXNetError, match="scale"):           # f32 scale
        kbn.bn_apply(x, f32, f32, "relu")
    with pytest.raises(MXNetError, match="scale"):           # f16 scale
        kbn.bn_apply(x, f32.half(), f32.half(), "relu")
    h = torch.ones(16, device=dev, dtype=torch.float16)
    with pytest.raises(MXNetError, match="beta"):
        kbn.bn_stats(x.half(), h, h.bfloat16(), 1e-5)


@pytest.mark.parametrize("dtype,sfx", BN16, ids=["bf16", "f16"])
def test_bn16_autograd_launches_the_16bit_kernels(dev, dtype, sfx):
    from mxnet_tpu_torch.kernels import bn_act as kbn

    gen = torch.Generator().manual_seed(5)
    x = (torch.rand(4, 6, 6, 32, generator=gen) - 0.3).to(dtype)
    gamma = (torch.rand(32, generator=gen) + 0.5).to(dtype)
    beta = (torch.rand(32, generator=gen) - 0.5).to(dtype)
    leaves = [t.to(dev).requires_grad_() for t in (x, gamma, beta)]
    before = registry.launches()
    y, mean, var = kbn.bn_act_train(*leaves, 1e-5, "relu")
    (y.float() * y.float()).sum().backward()
    after = registry.launches()
    assert after[f"bn_act_stats.{sfx}"] == before[f"bn_act_stats.{sfx}"] + 1
    assert after[f"bn_act_apply.{sfx}"] == before[f"bn_act_apply.{sfx}"] + 1
    cpu = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    ry, _, _ = kbn.bn_act_train(*cpu, 1e-5, "relu")
    (ry.float() * ry.float()).sum().backward()
    assert torch.equal(y.cpu().view(torch.int16), ry.view(torch.int16))
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 2.0 ** -9
    for a, b in zip(leaves, cpu):
        assert a.grad.dtype == dtype
        top = b.grad.float().abs().max()
        assert (a.grad.cpu().float() - b.grad.float()).abs().max() <= \
            tol * top


# ------------------------------------------------- the extension kernels
EXT_DTYPES = [torch.float32, torch.float16, torch.bfloat16]


def _ext_inputs(n, dtype, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(n + 1, generator=gen) * 3).to(dtype).to(dev)


def _same_bits(a, b):
    return torch.equal(a.float().view(torch.int32), b.float().view(torch.int32))


@pytest.mark.parametrize("dtype", EXT_DTYPES, ids=str)
@pytest.mark.parametrize("n", [1, 3, 4, 4097, 1000003])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
def test_ext_kernels_match_plain(dev, n, dtype, offset):
    from mxnet_tpu_torch.kernels import ext_ops

    x = _ext_inputs(n, dtype, dev, n)[offset:offset + n]
    g = _ext_inputs(n, dtype, dev, n + 7)[offset:offset + n]
    assert (x.data_ptr() % 16 != 0) == bool(offset)
    before = registry.launches()
    y = ext_ops.sqrelu(x)
    dx = ext_ops.sqrelu_grad(g, x)
    outs = [ext_ops.axpb(x, a, b) for a, b in ((1 / 0.3081, -0.1307 / 0.3081),
                                               (3.0, 1.0))]
    torch.cuda.synchronize()
    after = registry.launches()
    for name, k in (("ext_sqrelu_fwd", 1), ("ext_sqrelu_bwd", 1),
                    ("ext_axpb", 2)):
        assert after[name] == before[name] + k
    xc, gc = x.cpu(), g.cpu()
    assert _same_bits(y.cpu(), ext_ops.sqrelu_plain(xc))
    assert _same_bits(dx.cpu(), ext_ops.sqrelu_grad_plain(gc, xc))
    for out, (a, b) in zip(outs, ((1 / 0.3081, -0.1307 / 0.3081), (3.0, 1.0))):
        want = ext_ops.axpb_plain(xc, a, b)
        if dtype == torch.float32:
            w = want.numpy()
            ulp = np.spacing(np.maximum(np.abs(w), np.abs(out.cpu().numpy())))
            assert (np.abs(out.cpu().numpy() - w) <= ulp).all()
        else:
            assert _same_bits(out.cpu(), want)


def test_ext_kernels_take_empty_0d_and_strided_inputs(dev):
    from mxnet_tpu_torch.kernels import ext_ops

    before = registry.launches()
    empty = torch.zeros(0, 5, device=dev)
    assert ext_ops.sqrelu(empty).shape == (0, 5)
    assert ext_ops.axpb(empty, 2.0, 1.0).shape == (0, 5)
    assert registry.launches() == before               # nothing launched
    s = torch.tensor(-1.5, device=dev)
    assert ext_ops.axpb(s, 2.0, 1.0).item() == -2.0
    assert ext_ops.sqrelu(s).shape == ()
    m = torch.randn(64, 48, device=dev).t()             # not contiguous
    assert torch.equal(ext_ops.sqrelu(m), ext_ops.sqrelu_plain(m.cpu()).to(dev))
    with pytest.raises(MXNetError):
        ext_ops.sqrelu(torch.zeros(4, device=dev, dtype=torch.float64))
    with pytest.raises(MXNetError):
        ext_ops.sqrelu_grad(torch.zeros(4, device=dev), torch.zeros(4))


def test_ext_ops_through_rtc_launch_each_kernel_once(dev):
    import os

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, library

    if not hasattr(mx.npx, "pallas_squared_relu"):
        library.load(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "example", "extensions",
            "torch_ops.py"))
    x = torch.randn(64, 500, device=dev, requires_grad=True)
    before = registry.launches()
    with autograd.record():
        y = mx.npx.pallas_squared_relu(mx.npx.pallas_axpb(x, a=2.0, b=0.5))
    autograd.backward(y)
    torch.cuda.synchronize()
    after = registry.launches()
    assert [after[k] - before[k] for k in
            ("ext_axpb", "ext_sqrelu_fwd", "ext_sqrelu_bwd")] == [1, 1, 1]
    ref = torch.clamp_min(2 * x.detach() + 0.5, 0) * 4
    torch.testing.assert_close(x.grad, ref, atol=1e-5, rtol=1e-5)


# ------------------------------------- the trainer's options on the card
def _tiny_bert(dev, seed=0):
    from mxnet_tpu_torch.gluon.model_zoo import bert as tbert

    return xavier_init(tbert.BERTForPretrain(tbert.get_bert(
        num_layers=2, units=64, hidden_size=128, num_heads=4, vocab_size=97,
        max_length=64, dropout=0.0, device=dev)), seed)


def _bert_batch(dev, seed):
    rs = np.random.RandomState(seed)
    b, t, n = 4, 64, 6
    lens = rs.randint(16, t + 1, size=b).astype(np.int32)
    pos = np.stack([rs.choice(m, n, replace=False) for m in lens])
    x = (rs.randint(0, 97, (b, t)), np.zeros((b, t)), lens, pos)
    y = (rs.randint(0, 97, (b, n)), np.arange(b) % 2)
    return (tuple(torch.as_tensor(a, dtype=torch.int32, device=dev)
                  for a in x),
            tuple(torch.as_tensor(a, dtype=torch.int32, device=dev)
                  for a in y))


def test_arena_kernel_under_a_schedule_and_grad_accum(dev):
    """The trainer's arena update with ``PolyScheduler`` warmup and
    ``grad_accum=2`` on the card against the same on the CPU (the
    kernel's plain version): losses within TOL over 4 windows, and
    ``opt_arena`` launched once a window."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import pretrain_loss
    from mxnet_tpu_torch.lr_scheduler import PolyScheduler
    from mxnet_tpu_torch.parallel import ShardedTrainer

    runs = {}
    for where in (dev, torch.device("cpu")):
        tr = ShardedTrainer(_tiny_bert(where), pretrain_loss,
                            optimizer="adam", learning_rate=1e-3,
                            weight_decay=0.01, grad_accum=2,
                            lr_scheduler=PolyScheduler(
                                max_update=10, base_lr=1e-3, pwr=1,
                                warmup_steps=2))
        assert tr.uses_arena
        registry.reset_launches()
        losses = [tr.step(*_bert_batch(where, s), block=True)
                  for s in range(8)]
        runs[where.type] = (losses, registry.launches()["opt_arena"],
                            tr.learning_rate)
    assert runs["cuda"][1] == 4 and runs["cpu"][1] == 0
    assert runs["cuda"][2] == runs["cpu"][2]
    np.testing.assert_allclose(runs["cuda"][0], runs["cpu"][0], rtol=TOL,
                               atol=0)


@pytest.mark.parametrize("opt", ["adamw", "lamb"])
def test_multi_tensor_equals_per_parameter_on_the_card(dev, opt):
    """``multi_tensor=True`` against the per-parameter trainer on the
    card from the same weights: adamw's parameters and states bit for bit
    after 3 steps; lamb's states bit for bit after one step and its
    parameters within 1e-6 of each tensor's max, since its per-tensor
    norms reduce a stacked group's rows in another order than a lone
    tensor's (``chip_smoke.py`` phase 31, ROADMAP C).  One step: in f32
    that last-bit difference reaches the next step's gradients, which
    LAMB's normalized update then magnifies where a gradient is near 0."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import pretrain_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer

    trs = []
    for multi in (False, True):
        tr = ShardedTrainer(_tiny_bert(dev), pretrain_loss, optimizer=opt,
                            learning_rate=1e-3, weight_decay=0.01,
                            multi_tensor=multi)
        for s in range(1 if opt == "lamb" else 3):
            tr.step(*_bert_batch(dev, s), block=True)
        trs.append(tr)
    for a, b in zip(trs[0]._adapter.leaves(), trs[1]._adapter.leaves()):
        assert torch.equal(a, b)
    for a, b in zip(trs[0].params, trs[1].params):
        if opt == "lamb":
            top = b.detach().abs().max()
            assert (a.detach() - b.detach()).abs().max() <= 1e-6 * top
        else:
            assert torch.equal(a, b)


# ------------------------------------- the recurrent family (-k rnn)
# No kernel of the port: ops.rnn, gluon.rnn and LSTMLM are PyTorch code,
# held on the card against the same code on the CPU at chip_smoke.py
# phase 40's bar, 1e-4 x max|ref| (TF32 off).
RNN_T, RNN_B, RNN_C, RNN_H = 11, 5, 24, 32


def _rnn_close(got, want, what):
    err = (got.detach().cpu() - want.detach()).abs().max().item()
    scale = want.detach().abs().max().item()
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL} x {scale:.3e}"


@pytest.mark.parametrize("seq", [False, True], ids=["full", "lengths"])
@pytest.mark.parametrize("bidir", [False, True], ids=["uni", "bidir"])
@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_relu", "rnn_tanh"])
def test_rnn_fused_on_the_card_matches_the_cpu(dev, mode, bidir, seq):
    from mxnet_tpu_torch.ops import rnn as ops_rnn

    g = torch.Generator().manual_seed(3)
    d = 2 if bidir else 1
    n = ops_rnn.param_size(mode, RNN_C, RNN_H, 2, bidir)
    state = (2 * d, RNN_B, RNN_H)
    inputs = dict(x=torch.rand(RNN_T, RNN_B, RNN_C, generator=g) * 2 - 1,
                  params=torch.rand(n, generator=g) * 0.4 - 0.2,
                  h0=torch.rand(state, generator=g) - 0.5,
                  c0=torch.rand(state, generator=g) - 0.5)
    lens = torch.tensor([RNN_T, 1, 4, 7, 10], dtype=torch.int32)
    heads = [torch.rand(RNN_T, RNN_B, d * RNN_H, generator=g) - 0.5,
             torch.rand(state, generator=g) - 0.5,
             torch.rand(state, generator=g) - 0.5]
    runs = []
    for where in (dev, "cpu"):
        ts = {k: v.to(where).requires_grad_() for k, v in inputs.items()}
        outs = ops_rnn.rnn_fused(
            ts["x"], ts["params"], ts["h0"],
            ts["c0"] if mode == "lstm" else None, mode=mode,
            state_size=RNN_H, num_layers=2, bidirectional=bidir,
            sequence_length=lens.to(where), use_sequence_length=seq)
        names = ["x", "params", "h0"] + (["c0"] if mode == "lstm" else [])
        grads = torch.autograd.grad(
            sum((o * h.to(where)).sum() for o, h in zip(outs, heads)),
            [ts[k] for k in names])
        assert all(o.device.type == torch.device(where).type for o in outs)
        runs.append(list(outs) + list(grads))
    for i, (got, want) in enumerate(zip(*runs)):
        _rnn_close(got, want, f"output or gradient {i}")


def _rnn_cells(dev):
    from mxnet_tpu_torch.gluon import rnn

    def seq():
        s = rnn.SequentialRNNCell()
        s.add(rnn.LSTMCell(RNN_H, input_size=RNN_C, device=dev))
        s.add(rnn.ResidualCell(rnn.GRUCell(RNN_H, input_size=RNN_H,
                                           device=dev)))
        return s

    return {
        "rnn": lambda: rnn.RNNCell(RNN_H, input_size=RNN_C, device=dev),
        "lstm": lambda: rnn.LSTMCell(RNN_H, input_size=RNN_C, device=dev),
        "gru": lambda: rnn.GRUCell(RNN_H, input_size=RNN_C, device=dev),
        "lstmp": lambda: rnn.LSTMPCell(RNN_H, 12, input_size=RNN_C,
                                       device=dev),
        "sequential": seq,
        "bidirectional": lambda: rnn.BidirectionalCell(
            rnn.LSTMCell(RNN_H, input_size=RNN_C, device=dev),
            rnn.GRUCell(RNN_H, input_size=RNN_C, device=dev)),
    }


@pytest.mark.parametrize("name", ["rnn", "lstm", "gru", "lstmp",
                                  "sequential", "bidirectional"])
def test_rnn_cells_unroll_on_the_card_as_on_the_cpu(dev, name):
    cpu = xavier_init(_rnn_cells("cpu")[name](), 5)
    card = _rnn_cells(dev)[name]()
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(RNN_T, RNN_B, RNN_C,
                   generator=torch.Generator().manual_seed(6)) * 2 - 1
    lens = torch.tensor([RNN_T, 2, 5, 9, 1])
    want, want_st = cpu.unroll(RNN_T, x, layout="TNC", valid_length=lens)
    got, got_st = card.unroll(RNN_T, x.to(dev), layout="TNC",
                              valid_length=lens.to(dev))
    assert got.device.type == "cuda"
    _rnn_close(got, want, f"{name} outputs")
    for i, (g, w) in enumerate(zip(got_st, want_st)):
        _rnn_close(g, w, f"{name} state {i}")


@pytest.mark.parametrize("layer", ["LSTM", "GRU", "RNN"])
def test_rnn_layers_on_the_card_as_on_the_cpu(dev, layer):
    from mxnet_tpu_torch.gluon import rnn

    def make(where):
        return getattr(rnn, layer)(RNN_H, num_layers=2, bidirectional=True,
                                   input_size=RNN_C, layout="NTC",
                                   use_sequence_length=True, device=where)

    cpu = xavier_init(make("cpu"), 7)
    card = make(dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(RNN_B, RNN_T, RNN_C,
                   generator=torch.Generator().manual_seed(8)) * 2 - 1
    lens = torch.tensor([RNN_T, 3, 6, 1, 8])
    want, want_st = cpu(x, cpu.begin_state(RNN_B), sequence_length=lens)
    got, got_st = card(x.to(dev), card.begin_state(RNN_B),
                       sequence_length=lens.to(dev))
    assert all(s.device.type == "cuda" for s in card.begin_state(RNN_B))
    _rnn_close(got, want, f"{layer} outputs")
    for g, w in zip(got_st, want_st):
        _rnn_close(g, w, f"{layer} states")


def test_rnn_lstm_lm_decodes_on_the_card_as_on_the_cpu(dev):
    from mxnet_tpu_torch.gluon.model_zoo import LSTMLM

    cpu = xavier_init(LSTMLM(vocab_size=500, units=64, num_layers=2,
                             device="cpu"), 9)
    card = LSTMLM(vocab_size=500, units=64, num_layers=2)
    assert card.device == dev
    card.load_state_dict(cpu.state_dict())
    toks = np.random.RandomState(10).randint(0, 500, (3, 8))
    n_tok = [8, 5, 2]
    want, want_c = cpu(toks, cpu.begin_cache(3), [0] * 3, n_tok)
    got, got_c = card(toks, card.begin_cache(3), [0] * 3, n_tok)
    _rnn_close(got, want, "prefill logits")
    for t in range(4):
        step = toks[:, t:t + 1]
        want, want_c = cpu(step, want_c, [0] * 3, [1] * 3)
        got, got_c = card(step, got_c, [0] * 3, [1] * 3)
        _rnn_close(got, want, f"step {t} logits")


# ------------- the detection slice (-k "boxes or ssd or loss")
# No kernel of the port: ops.boxes, ops.ctc, gluon.loss and the SSD are
# PyTorch code, held on the card against the same code on the CPU.
BOX_TOL, LOSS_TOL = 1e-6, 1e-5


def _scaled_close(got, want, tol, what):
    err = (got.double() - want.double()).abs().max().item()
    scale = max(want.abs().max().item(), 1e-30)
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def _box_ops():
    from mxnet_tpu_torch.test_utils import box_op_runs

    return box_op_runs()


@pytest.mark.parametrize("op", sorted(_box_ops()))
def test_boxes_on_the_card_match_the_cpu(dev, op):
    from mxnet_tpu_torch.test_utils import box_exact_parts

    run = _box_ops()[op]
    got, want = run(dev), run("cpu")
    for g, w in zip(box_exact_parts(op, got), box_exact_parts(op, want)):
        assert torch.equal(g, w), op
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        _scaled_close(g, w, BOX_TOL, f"{op} output {i}")


def test_boxes_forced_match_takes_the_last_gt_on_the_card(dev):
    from mxnet_tpu_torch.test_utils import box_op_runs

    for _ in range(5):                  # the same winner every call
        _, _, cls_t = box_op_runs()["multibox_target_colliding"](dev)
        assert cls_t[0, 0].item() == 8.0 and cls_t[1, 1].item() == 4.0


def _loss_cases():
    from mxnet_tpu_torch.test_utils import LOSS_CASES

    return LOSS_CASES


@pytest.mark.parametrize("case", _loss_cases(), ids=lambda c: c[0])
def test_loss_on_the_card_matches_the_cpu(dev, case):
    from mxnet_tpu_torch.test_utils import loss_run

    for i, (g, w) in enumerate(zip(loss_run(case, dev),
                                   loss_run(case, "cpu"))):
        _scaled_close(g, w, LOSS_TOL, f"{case[0]} output {i}")


def _tiny_ssd(where):
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo.ssd import SSD

    backbone = nn.HybridSequential().add(
        nn.Conv2D(16, 3, strides=2, padding=1, activation="relu",
                  in_channels=3, device=where),
        nn.Conv2D(32, 3, strides=2, padding=1, activation="relu",
                  in_channels=16, device=where))
    return SSD([backbone], num_classes=3,
               sizes=[[0.2, 0.3], [0.4, 0.5], [0.6, 0.7]],
               ratios=[[1, 2, 0.5]] * 3, num_extras=2, device=where)


def test_ssd_tiny_on_the_card_matches_the_cpu(dev):
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.model_zoo.ssd import (detections,
                                                     training_targets)

    cpu = xavier_init(_tiny_ssd("cpu"), 3)
    card = _tiny_ssd(dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(4))
    labels = np.array([[[1.0, 0.1, 0.1, 0.4, 0.4], [-1, 0, 0, 0, 0]],
                       [[2.0, 0.5, 0.5, 0.9, 0.9], [0.0, 0.0, 0.0, 0.3, 0.3]]],
                      "f4")
    runs = []
    for net, where in ((card, dev), (cpu, "cpu")):
        with autograd.record():
            cls_p, box_p, anchors = net(x.to(where))
            bt, bm, ct = training_targets(anchors, labels)
            lp = torch.log_softmax(cls_p, -1)
            loss = (-lp.gather(-1, ct.long()[..., None])[..., 0]).mean() + \
                ((box_p - bt).abs() * bm).mean()
        grads = torch.autograd.grad(loss, list(net.parameters()))
        assert anchors.device.type == torch.device(where).type
        runs.append([cls_p, box_p, anchors, bt, bm, ct, loss] + list(grads)
                    + [detections(cls_p.detach(), box_p.detach(), anchors)])
    for i, (g, w) in enumerate(zip(*runs)):
        _scaled_close(g.detach().cpu(), w.detach(), TOL, f"output {i}")
    for i in (4, 5):                                 # mask, classes
        assert torch.equal(runs[0][i].cpu(), runs[1][i])
    det_g, det_w = runs[0][-1].cpu(), runs[1][-1]
    assert torch.equal(det_g[..., 0], det_w[..., 0])


def test_ssd_512_builds_on_the_card_by_default(dev):
    from mxnet_tpu_torch.gluon.model_zoo import get_model

    card = xavier_init(get_model("ssd_512_resnet50_v1", classes=20), 5)
    assert {p.device for p in card.parameters()} == {dev}
    cpu = get_model("ssd_512_resnet50_v1", classes=20, device="cpu")
    cpu.load_state_dict(card.state_dict())
    x = torch.rand(2, 3, 128, 128, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        got, want = card(x.to(dev)), cpu(x)
    for i, (g, w) in enumerate(zip(got, want)):
        _scaled_close(g.cpu(), w, TOL, f"output {i}")


# ------------------------------- hybridize(): CUDA-graph capture and replay
def _hyb_seq(dev, dropout=0.0, seed=0):
    from mxnet_tpu_torch.gluon import nn

    net = nn.HybridSequential().add(
        nn.Dense(32, activation="relu", in_units=16, device=dev),
        nn.BatchNorm(in_channels=32, device=dev), nn.Dropout(dropout),
        nn.Dense(8, in_units=32, device=dev))
    return xavier_init(net, seed)


def _twin_hyb(make, dev):
    """An eager block and a hybridized one with the same state."""
    eager, hyb = make(dev), make(dev)
    hyb.load_state_dict(eager.state_dict())
    hyb.hybridize()
    return eager, hyb


def _hyb_grads(net, x, record):
    from mxnet_tpu_torch import autograd

    if not record:
        with torch.no_grad():
            return [net(x)]
    with autograd.record():
        out = net(x)
        loss = (out * out).sum()
    autograd.backward(loss)
    return [out.detach()] + [p.grad.clone() for p in net.parameters()]


@pytest.mark.parametrize("record", [False, True], ids=["infer", "record"])
def test_hybridize_seq_captures_and_matches_eager(dev, record):
    """HybridSequential(Dense, BatchNorm, Dropout, Dense): inference and
    autograd.record() replays against the eager block, the BatchNorm
    running statistics moved inside the graph, misses == signatures."""
    from mxnet_tpu_torch import telemetry as tel

    eager, hyb = _twin_hyb(_hyb_seq, dev)
    x = torch.rand(64, 16, generator=torch.Generator().manual_seed(1)).to(dev)
    tel.set_enabled(True)
    tel.reset()
    for step in range(4):                 # the first call runs eagerly
        want = _hyb_grads(eager, x + step, record)
        got = _hyb_grads(hyb, x + step, record)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
        eager.zero_grad()
        hyb.zero_grad()
    for a, b in zip(eager.buffers(), hyb.buffers()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    snap = tel.snapshot()
    assert snap["hybridize.cache_misses"]["value"] == 1
    assert snap["hybridize.cache_hits"]["value"] == 2
    assert len(hyb._cached_op._traced) == 1


def _hyb_bert(dev):
    from mxnet_tpu_torch.gluon.model_zoo import get_bert

    return xavier_init(get_bert(num_layers=2, units=64, hidden_size=128,
                                num_heads=4, vocab_size=97, max_length=64,
                                dropout=0.0, device=dev), 3)


def test_hybridize_launch_counts_on_replay_equal_eager(dev):
    eager, hyb = _twin_hyb(_hyb_bert, dev)
    rs = np.random.RandomState(2)
    args = (torch.as_tensor(rs.randint(0, 97, (4, 32)), device=dev),
            torch.zeros(4, 32, dtype=torch.int32, device=dev),
            torch.as_tensor([32, 17, 5, 30], dtype=torch.int32, device=dev))
    with torch.no_grad():
        hyb(*args)
        hyb(*args)                          # eager first call, then capture
        counts = []
        for net in (eager, hyb):
            registry.reset_launches()
            for _ in range(3):
                out = net(*args)
            counts.append({k: v for k, v in registry.launches().items() if v})
            torch.testing.assert_close(out[0], eager(*args)[0], atol=1e-6,
                                       rtol=1e-6)
    assert counts[0] == counts[1] == {"flash_attention": 6}


def test_hybridize_host_read_raises_and_leaves_capture_clean(dev):
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.gluon import HybridBlock

    class Reads(HybridBlock):
        def forward(self, x):
            return x * float(x.sum().item())

    net = Reads()
    net.hybridize()
    x = torch.ones(4, device=dev)
    net(x)                                   # eager: fine
    for _ in range(2):                       # no fallback, every call
        with pytest.raises(MXNetError, match="cannot be captured"):
            net(x)
    assert not torch.cuda.is_current_stream_capturing()
    eager, hyb = _twin_hyb(_hyb_seq, dev)    # the next capture works
    y = torch.rand(8, 16, device=dev)
    with torch.no_grad():
        hyb(y)
        torch.testing.assert_close(hyb(y), eager(y), atol=1e-6, rtol=1e-6)


def test_hybridize_dropout_masks_differ_between_replays(dev):
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn

    net = xavier_init(nn.HybridSequential().add(
        nn.Dense(32, in_units=16, device=dev), nn.Dropout(0.5)), 0)
    net.hybridize()
    x = torch.ones(64, 16, device=dev)
    masks = []
    for _ in range(4):                     # eager, capture, two replays
        with autograd.record():
            out = net(x)
        masks.append((out == 0).clone())
    assert not torch.equal(masks[2], masks[3])
    assert 0.4 < float(masks[3].float().mean()) < 0.6


def test_hybridize_cast_and_load_cast_dtype_recapture(dev, tmp_path):
    from mxnet_tpu_torch import telemetry as tel

    eager, hyb = _twin_hyb(_hyb_seq, dev)
    x = torch.rand(8, 16, device=dev)
    path = str(tmp_path / "seq.params")
    eager.cast("float16").save_parameters(path)
    eager.cast("float32")
    tel.set_enabled(True)
    with torch.no_grad():
        hyb(x)
        hyb(x)
        tel.reset()
        hyb.load_parameters(path, cast_dtype=True)   # rebinds storage
        got = hyb(x.half())
        eager.load_parameters(path, cast_dtype=True)
        want = eager(x.half())
    assert tel.snapshot()["hybridize.cache_misses"]["value"] == 1
    torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


def test_hybridize_sees_storage_rebound_without_a_call_of_the_port(dev):
    """``p.data = ...`` (as ``amp.convert_hybrid_block`` and the
    multi-tensor trainer rebind) and a buffer replaced in its module are
    seen on the next call: one new capture each, outputs equal the eager
    block's after the same change, the old graphs dropped."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch import telemetry as tel

    eager, hyb = _twin_hyb(_hyb_seq, dev)
    x = torch.rand(8, 16, device=dev)
    tel.set_enabled(True)
    with torch.no_grad():
        hyb(x)
        hyb(x)
        tel.reset()
        for net in (eager, hyb):
            w = net[0].weight
            w.data = w.data * 2                  # new storage, same spec
        torch.testing.assert_close(hyb(x), eager(x), atol=1e-6, rtol=1e-6)
        for net in (eager, hyb):
            bn = net[1]
            bn._buffers["running_mean"] = bn.running_mean + 0.5
        torch.testing.assert_close(hyb(x), eager(x), atol=1e-6, rtol=1e-6)
        for net in (eager, hyb):
            amp.convert_hybrid_block(net, "bfloat16")
        xb = x.to(torch.bfloat16)
        torch.testing.assert_close(hyb(xb).float(), eager(xb).float(),
                                   atol=0, rtol=0)
        hyb(xb)
    assert tel.snapshot()["hybridize.cache_misses"]["value"] == 3
    assert tel.snapshot()["hybridize.cache_hits"]["value"] == 1
    assert len(hyb._cached_op._graphs) == 1


def test_hybridize_cast_of_another_block_leaves_this_ones_graphs(dev):
    """Each block's signature reads its own tensors: casting (or
    loading into) another block makes no capture here."""
    from mxnet_tpu_torch import telemetry as tel

    _, a = _twin_hyb(_hyb_seq, dev)
    _, b = _twin_hyb(_hyb_seq, dev)
    x = torch.rand(8, 16, device=dev)
    tel.set_enabled(True)
    with torch.no_grad():
        a(x)
        a(x)
        tel.reset()
        b.cast(torch.bfloat16)
        a(x)
    assert tel.snapshot().get("hybridize.cache_misses",
                              {}).get("value", 0) == 0


def test_hybridize_sharded_trainer_bf16_matches_the_unhybridized_net(dev):
    """A hybridized net under ``ShardedTrainer(compute_dtype=bf16)``
    trains as the same net unhybridized: the trainer's step runs the
    forward on its own 16-bit copies, eagerly (losses and weights equal
    bit for bit over 4 steps)."""
    from mxnet_tpu_torch.parallel import ShardedTrainer

    def ce(pred, y):
        return torch.nn.functional.cross_entropy(pred.float(), y)

    eager, hyb = _twin_hyb(lambda d: _hyb_seq(d, dropout=0.0), dev)
    x = torch.rand(32, 16, generator=torch.Generator().manual_seed(2))
    y = torch.randint(0, 8, (32,), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        hyb(x.to(dev))
        hyb(x.to(dev))                          # a graph captured before
    runs = []
    for net in (eager, hyb):
        tr = ShardedTrainer(net, ce, optimizer="sgd", learning_rate=0.1,
                            compute_dtype=torch.bfloat16)
        losses = [float(tr.step(x, y, block=True)) for _ in range(4)]
        runs.append((losses, [p.detach().clone() for p in net.parameters()]))
    (le, we), (lh, wh) = runs
    assert le == lh
    for a, b in zip(we, wh):
        assert torch.equal(a, b)


def _decode_lm(dev):
    from mxnet_tpu_torch.gluon.model_zoo import transformer_lm

    return xavier_init(transformer_lm(vocab_size=64, units=64, num_heads=4,
                                      num_layers=2, max_length=96,
                                      device=dev), 5)


_DECODE_CFG = dict(slots=2, prompt_buckets=(8, 16), capacity_buckets=(32, 64),
                   max_new_tokens=24)


def _decode_prompts(n, seed):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, 64, size=k).tolist()
            for k in rs.randint(3, 17, size=n)]


def test_hybridize_donated_buffers_are_keyed_by_address(dev):
    """Two caches passed alternately to one hybridized LM: each is a
    signature of its own, neither is copied into the other, and each
    decodes as the eager LM does on its own cache."""
    lm = _decode_lm(dev)
    gen = torch.Generator().manual_seed(6)
    prompts = [torch.randint(1, 64, (2, 5), generator=gen).to(dev)
               for _ in range(2)]
    lens = torch.zeros(2, dtype=torch.int64, device=dev)
    n = torch.full((2,), 5, dtype=torch.int64, device=dev)

    def run(hybrid):
        lm.hybridize(hybrid, donate_args=(1,) if hybrid else None)
        caches = [lm.begin_cache(2, 32), lm.begin_cache(2, 32)]
        outs = []
        with torch.no_grad():
            for step in range(4):
                for i in (0, 1):
                    logits, caches[i] = lm(prompts[i], caches[i],
                                           lens + 5 * step, n)
                    outs.append(logits.clone())
        return outs, caches

    want, wc = run(False)
    got, gc_ = run(True)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
    for g, w in zip(_leaves(gc_), _leaves(wc)):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
    assert len(lm._cached_op._graphs) == 2


def _submit_all(srv, prompts, **kw):
    """Every prompt queued before the worker admits any, so admission
    and growth do not depend on timing."""
    with srv._cv:
        return [srv.submit(p, **kw) for p in prompts]


def _serve_alone(dev, prompts):
    from mxnet_tpu_torch import serve

    entry = serve.DecodeEntry("alone", _decode_lm(dev), **_DECODE_CFG)
    srv = serve.DecodeServer(entry)
    try:
        return [f.result(300.0) for f in _submit_all(srv, prompts)]
    finally:
        srv.close(60.0)


def test_hybridize_reregistered_decode_model_keeps_the_old_answers(dev):
    """``serve.register_decode`` of a name whose server still decodes:
    the new entry captures its own grid over its own buffers while the
    old server drains, and the old requests' tokens equal those of a
    server that ran alone; so do the new server's."""
    from mxnet_tpu_torch import serve

    old_p, new_p = _decode_prompts(8, 11), _decode_prompts(4, 12)
    want_old, want_new = _serve_alone(dev, old_p), _serve_alone(dev, new_p)
    lm = _decode_lm(dev)
    serve.register_decode("re", lm, **_DECODE_CFG)
    old = _submit_all(serve.decode_server("re"), old_p)
    serve.register_decode("re", lm, **_DECODE_CFG)
    new = _submit_all(serve.decode_server("re"), new_p)
    try:
        assert [f.result(300.0) for f in old] == want_old
        assert [f.result(300.0) for f in new] == want_new
    finally:
        serve.shutdown_decode(60.0)


def test_hybridize_decode_warmup_beside_its_server(dev):
    """``DecodeEntry.warmup()`` called while the entry's server decodes
    (here from a request's token sink, on the worker, between a prefill
    and its move) writes to none of the live caches: every answer
    equals that of a server that ran alone."""
    from mxnet_tpu_torch import serve

    prompts = _decode_prompts(4, 13)
    want = _serve_alone(dev, prompts)
    entry = serve.DecodeEntry("beside", _decode_lm(dev), **_DECODE_CFG)
    srv = serve.DecodeServer(entry)
    fired = []

    def sink(tok):
        if not fired:
            fired.append(entry.warmup())

    try:
        with srv._cv:
            futs = [srv.submit(p, on_token=sink if i == 1 else None)
                    for i, p in enumerate(prompts)]
        got = [f.result(300.0) for f in futs]
    finally:
        srv.close(60.0)
    assert fired == [0] and got == want


def _zoo(name, dev):
    from mxnet_tpu_torch.gluon.model_zoo import get_model, lstm_lm
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_resnet

    if name == "lenet":
        return xavier_init(get_model("lenet", device=dev), 0), \
            (torch.rand(16, 1, 28, 28, device=dev),)
    if name == "resnet50_nhwc":
        net = get_resnet(1, 50, layout="NHWC", device=dev)
        return xavier_init(net, 0), (torch.rand(4, 64, 64, 3, device=dev),)
    if name == "bert":
        return _hyb_bert(dev), (
            torch.randint(0, 97, (2, 32), device=dev),
            torch.zeros(2, 32, dtype=torch.int32, device=dev),
            torch.as_tensor([32, 9], dtype=torch.int32, device=dev))
    if name == "lstm_lm":
        lm = xavier_init(lstm_lm(vocab_size=50, units=32, num_layers=2,
                                 device=dev), 0)
        return lm, (torch.randint(0, 50, (3, 5), device=dev),
                    lm.begin_cache(3), torch.zeros(3, device=dev),
                    torch.as_tensor([5, 2, 4], device=dev))
    from mxnet_tpu_torch.gluon.model_zoo import transformer_lm

    cache_dtype = "int8" if name.endswith("int8") else None
    dt = {"transformer_lm_bf16": torch.bfloat16,
          "transformer_lm_f16": torch.float16}.get(name, torch.float32)
    lm = xavier_init(transformer_lm(vocab_size=64, units=64, num_heads=4,
                                    num_layers=2, max_length=64,
                                    cache_dtype=cache_dtype, dtype=dt,
                                    device=dev), 0)
    return lm, (torch.randint(0, 64, (2, 7), device=dev),
                lm.begin_cache(2, 32),
                torch.as_tensor([0, 3], device=dev),
                torch.full((2,), 7, device=dev))


def _clone_tree(o):
    if torch.is_tensor(o):
        return o.clone()
    if isinstance(o, (tuple, list)):
        return type(o)(_clone_tree(v) for v in o)
    return o


def _leaves(o):
    if torch.is_tensor(o):
        return [o]
    if isinstance(o, (tuple, list)):
        return [x for v in o for x in _leaves(v)]
    return []


@pytest.mark.parametrize("name", [
    "lenet", "resnet50_nhwc", "bert", "lstm_lm", "transformer_lm",
    "transformer_lm_bf16", "transformer_lm_f16", "transformer_lm_int8"])
def test_hybridize_zoo_models_capture_and_match_eager(dev, name):
    """Every zoo model the serving tiers and the verify drive run, captured
    (the decode LMs with their cache donated) against the eager model on
    the same inputs: outputs within 1e-6 of max|ref| (bit for bit
    expected; cuBLAS may choose another algorithm on the capture stream),
    kernel launches on replay equal the eager ones."""
    net, args = _zoo(name, dev)
    decode = name.endswith("lm") or "_lm_" in name
    # a donated cache is one buffer, given the same values before each
    # call: its address is part of the signature
    buf = _clone_tree(args[1]) if decode else None

    def call():
        if not decode:
            return net(*_clone_tree(args))
        for b, a in zip(_leaves(buf), _leaves(args[1])):
            b.copy_(a)
        return net(args[0], buf, *args[2:])

    with torch.no_grad():
        runs = []
        for hybrid in (False, True):
            if hybrid:
                net.hybridize(donate_args=(1,) if decode else None)
                call()                              # the eager first call
                call()                              # warm run + capture
            registry.reset_launches()
            outs = [call() for _ in range(2)]
            runs.append((_leaves(outs[-1]), registry.launches()))
    (want, n_e), (got, n_h) = runs
    assert n_e == n_h
    for g, w in zip(got, want):
        scale = float(w.float().abs().max()) or 1.0
        assert float((g.float() - w.float()).abs().max()) <= 1e-6 * scale
    assert len(net._cached_op._traced) == 1


def test_hybridize_background_warmup_races_a_dispatcher(dev):
    """serve.register(background=True): the grid captures on its own
    thread while the dispatcher already replays (or captures) requests;
    every answer equals the eager block's."""
    from mxnet_tpu_torch import serve

    eager, hyb = _twin_hyb(_hyb_bert, dev)
    hyb.hybridize(False)
    # buckets that no output width (64) equals: slice_out would cut it
    buckets = {0: [1, 2, 4, 8], 1: ("pow2", 16, 32)}
    entry = serve.register("race", hyb, bucketer=buckets, background=True,
                           sample=(np.zeros(16, np.int32),
                                   np.zeros(16, np.int32),
                                   np.asarray(16, np.int32)))
    rs = np.random.RandomState(4)
    reqs = []
    for n in rs.randint(3, 33, size=24):
        reqs.append((rs.randint(0, 97, n).astype(np.int32),
                     np.zeros(n, np.int32), np.asarray(n, np.int32)))
    try:
        futs = [serve.submit("race", *r) for r in reqs]
        outs = [f.result(300.0) for f in futs]
        entry.warmup_handle.wait(300)
    finally:
        serve.shutdown()
        serve.unregister("race")
    assert entry.warmup_done()
    for (tok, seg, vl), (seq, pooled) in zip(reqs, outs):
        with torch.no_grad():
            ref = eager(torch.as_tensor(tok[None], device=dev),
                        torch.as_tensor(seg[None], device=dev),
                        torch.as_tensor(vl[None], device=dev))
        np.testing.assert_allclose(seq, ref[0][0].cpu().numpy(),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(pooled, ref[1][0].cpu().numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_hybridize_ssd_records_what_capture_does(dev):
    """SSD's forward captures (its anchors are made at construction), and
    so does its ``detections``: NMS's loop runs to ``min(n, topk)``, a
    bound known from shapes, and reads nothing back.  Both equal eager."""
    from mxnet_tpu_torch.gluon import HybridBlock
    from mxnet_tpu_torch.gluon.model_zoo.ssd import detections

    eager = xavier_init(_tiny_ssd(dev), 3)
    hyb = _tiny_ssd(dev)
    hyb.load_state_dict(eager.state_dict())
    hyb.hybridize()
    x = torch.rand(2, 3, 64, 64, device=dev)
    with torch.no_grad():
        hyb(x)
        got = hyb(x)
        want = eager(x)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)

    class Detect(HybridBlock):
        def forward(self, c, b, a):
            return detections(c, b, a)

    det = Detect()
    det.hybridize()
    with torch.no_grad():
        det(*want)
        got = det(*want)
        ref = detections(*want)
    assert len(det._cached_op._traced) == 1
    assert torch.equal(got[..., 0], ref[..., 0])      # classes and fill
    torch.testing.assert_close(got, ref, atol=1e-6, rtol=1e-6)


def test_hybridize_bn_act_workspace_made_by_the_warm_run(dev):
    """A fused BatchNormReLU (channel-last, training) captured under
    record(): its statistics kernel's workspace, kept per (device,
    stream), is made by the warm run on the block's capture stream
    (never inside the graph), and the replays launch the kernels as
    often as the eager block, with the same outputs and gradients."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.kernels import bn_act

    def make(where):
        return xavier_init(nn.BatchNormReLU(axis=-1, in_channels=64,
                                            device=where), 0)

    eager, hyb = _twin_hyb(make, dev)
    x = torch.rand(8, 14, 14, 64, device=dev)
    runs = []
    for net in (eager, hyb):
        for _ in range(3):
            registry.reset_launches()
            with autograd.record():
                out = net(x)
                loss = (out * out).sum()
            loss.backward()
        runs.append(([out.detach()] + [p.grad.clone() for p in
                                       net.parameters()],
                     {k: v for k, v in registry.launches().items() if v}))
    (want, n_e), (got, n_h) = runs
    assert n_e == n_h == {"bn_act_stats": 1, "bn_act_apply": 1}
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
    streams = {cs.cuda_stream for cs in hyb._cached_op._streams.values()}
    assert streams and all((dev.index, st) in bn_act._WORKSPACE
                           for st in streams)


def test_hybridize_bn_workspace_outlives_its_growth(dev):
    """A hybridized channel-last ``BatchNormReLU`` (its training forward
    runs ``bn_act_stats``) captured under ``autograd.record()`` at B = 2,
    then at B = 16 (the statistics workspace of the capture stream grows),
    then at B = 8; other work on that stream then takes what memory is
    free there, and the B = 2 graph replays on new values: its outputs,
    gradients and running statistics equal an eager twin's.  The B = 2 graph still
    reads and writes the workspace it was captured over, so that
    workspace must never be freed."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.kernels import bn_act

    def make(where):
        return xavier_init(nn.BatchNormReLU(axis=-1, in_channels=64,
                                            device=where), 0)

    eager, hyb = _twin_hyb(make, dev)
    gen = torch.Generator().manual_seed(14)
    # "2": new values at B = 2 for the last replay, so stale statistics
    # from the graph's earlier replays cannot pass for right ones
    xs = {b: (torch.rand(int(b), 14, 14, 64, generator=gen) - 0.3).to(dev)
          for b in (2, 16, 8, "2")}
    runs = {}

    def step(net, b):
        with autograd.record():
            out = net(xs[b])
            loss = (out * out).sum()
        loss.backward()
        return [out.detach().clone()] + \
            [p.grad.clone() for p in net.parameters()] + \
            [t.clone() for t in net.buffers()]

    order = [2, 2, 16, 16, 8, 8]
    for name, net in (("eager", eager), ("hyb", hyb)):
        runs[name] = [step(net, b) for b in order]
        if name == "hyb":
            (cs,) = hyb._cached_op._streams.values()
            key = (dev.index, cs.cuda_stream)
            grown = bn_act._WORKSPACE[key]
            # later work on the capture stream: small blocks, nonzero
            with torch.cuda.stream(cs):
                junk = [torch.full((256 * (i % 8 + 1),), 7, dtype=torch.int32,
                                   device=dev) for i in range(512)]
            cs.synchronize()
            del junk
        runs[name].append(step(net, "2"))
    assert len(hyb._cached_op._graphs) == 3
    assert grown[1].numel() >= bn_act.plan(
        16 * 14 * 14, 64, torch.cuda.get_device_properties(dev)
        .multi_processor_count, bn_act.STATS_COLS).splits * 2 * 64
    for i, (got, want) in enumerate(zip(runs["hyb"], runs["eager"])):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6,
                                       msg=lambda m: f"call {i}: {m}")


def test_prefill_pool_answers_ownership_and_hits(dev):
    """The disaggregated server on the card: 2 prefill workers and 32
    requests of one prompt bucket sharing an 8-token prefix, all queued
    at once into 2 slots (prefills run ahead of free slots, the batch
    grows, cross-capacity moves).  Every answer equals the unified
    server's, or leaves it only at a near tie (top two logits within
    1e-4 x max|logit|); each shipment's row cache is as its prefill left
    it when the loop takes it; no capture happens after warmup; and the
    prefix hits run the remainder at cache_len > 0."""
    from mxnet_tpu_torch import serve, telemetry
    from mxnet_tpu_torch.test_utils import near_tie

    rs = np.random.RandomState(20)
    head = rs.randint(1, 64, size=8).tolist()
    prompts = [head + rs.randint(1, 64, size=int(k)).tolist()
               for k in rs.randint(1, 9, size=32)]
    lm = _decode_lm(dev)
    uni = serve.DecodeServer(serve.DecodeEntry("uni", lm, **_DECODE_CFG))
    try:
        want = [f.result(300.0) for f in _submit_all(uni, prompts)]
    finally:
        uni.close(60.0)
    entry = serve.DecodeEntry("pool", lm, **_DECODE_CFG)
    srv = serve.DecodeServer(entry, prefill_workers=2)
    shipped, intact, windows = {}, [], []
    run_prefill, admit, window = (srv._run_prefill, srv._admit_ready,
                                  entry.prefill_window)

    def spy_prefill(req):
        ready = run_prefill(req)
        if ready is not None:
            shipped[req.id] = [x.clone() for x in _leaves(ready.row_cache)]
        return ready

    def spy_admit(ready):
        intact.append(all(torch.equal(a, b) for a, b in zip(
            _leaves(ready.row_cache), shipped[ready.req.id])))
        return admit(ready)

    def spy_window(tokens, cache, cache_len, n_new):
        windows.append(cache_len)
        return window(tokens, cache, cache_len, n_new)

    srv._run_prefill, srv._admit_ready = spy_prefill, spy_admit
    entry.prefill_window = spy_window
    telemetry.set_enabled(True)
    telemetry.reset()
    registry.reset_launches()
    try:
        got = [f.result(300.0) for f in _submit_all(srv, prompts)]
        stats = srv.prefix.stats()
    finally:
        srv.close(60.0)
    snap = telemetry.snapshot()
    assert snap.get("hybridize.cache_misses", {}).get("value", 0) == 0
    assert len(intact) == len(prompts) and all(intact)
    hits = [c for c in windows if c > 0]
    assert stats["hits"] == len(hits) >= 1 and all(c == 8 for c in hits)
    assert snap["serve.prefix_fill_seconds"]["count"] == len(hits)
    assert snap["serve.prefill_seconds"]["count"] == len(prompts) - len(hits)
    assert snap["serve.cache_grows"]["value"] >= 1
    steps = snap["serve.decode_step_seconds"]["count"]
    assert registry.launches()["flash_attention_decode"] >= \
        2 * (steps + len(prompts))
    ties = [(i, near_tie(lm, p, w, g)) for i, (p, w, g) in
            enumerate(zip(prompts, want, got)) if w != g]
    assert all(t[1][3] for t in ties), ties
    assert len(ties) <= 2, ties


def _kernel_events(doc, symbols):
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"
            and e.get("cat") == "kernel"
            and any(s in e.get("name", "") for s in symbols)]


def test_trace_profiler_kernels_inside_decode_step_spans(dev, tmp_path):
    """``mx.trace``'s export with a ``torch.profiler`` session merged: the
    decode kernels a served step launches (replayed in its CUDA graph)
    land inside that step's ``serve.decode_step`` span once the
    profiler's clock is aligned on the marker; the capture records
    ``kernels.dispatch`` once per kernel of a graph."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch import serve, trace
    from mxnet_tpu_torch.trace import export

    trace.set_enabled(True)
    trace.reset()
    # the instants are recorded once a (kernel, signature) in a process:
    # forget what earlier tests dispatched, so the warm runs' eager
    # launches record theirs here whatever ran before
    registry._DISPATCHED.clear()
    entry = serve.DecodeEntry("traced", _decode_lm(dev), **_DECODE_CFG)
    events = [e["attrs"] for e in trace.events()
              if e["name"] == "kernels.dispatch"]
    graph = [a for a in events if a["mode"] == "graph"]
    eager = [(a["kernel"], str(a["shapes"]), str(a["dtypes"]))
             for a in events if a["mode"] == "cuda"]
    assert graph and all(a["launches"] >= 1 for a in graph)
    assert {a["mode"] for a in events} <= {"graph", "cuda"}
    # the warm runs: once a kernel and signature, never once a launch
    assert len(eager) == len(set(eager)), eager
    srv = serve.DecodeServer(entry)
    try:
        trace.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            export.mark_profiler()
            got = [f.result(300.0)
                   for f in _submit_all(srv, _decode_prompts(2, 3))]
            torch.cuda.synchronize()
    finally:
        srv.close(60.0)
    assert all(len(g) == _DECODE_CFG["max_new_tokens"] for g in got)
    # serving replays the graphs: no capture, no new signature, no instant
    assert not [e for e in trace.events() if e["name"] == "kernels.dispatch"]
    raw = str(tmp_path / "prof.json")
    prof.export_chrome_trace(raw)
    doc = json.loads(export.dumps(profiler_trace=raw))
    align = doc["metadata"]["profiler_alignment"]
    steps = [e for e in doc["traceEvents"]
             if e["name"] == "serve.decode_step"]
    kernels = _kernel_events(doc, ("decode_split_kernel",))
    assert steps and len(kernels) >= 2 * len(steps)  # 2 layers a step
    slack = align["error_us"] + 20.0
    outside = [k for k in kernels if not any(
        s["ts"] - slack <= k["ts"] and k["ts"] + k["dur"] <= s["ts"]
        + s["dur"] + slack for s in steps)]
    assert not outside, (align, outside[:3])


def test_obs_c15_step_error_on_the_card(dev, tmp_path):
    """C15 on the card: a decode step that raises ``MXNetError`` with the
    flight recorder armed ends the loop (``alive`` False, ``/readyz`` 503
    naming it), fails the resident futures, and leaves a parseable dump
    that names the error."""
    import os

    from mxnet_tpu_torch import serve, trace
    from mxnet_tpu_torch.obs import http as obs_http
    from mxnet_tpu_torch.trace import flight

    serve.register_decode("c15_card", _decode_lm(dev), **_DECODE_CFG)
    srv = serve.decode_server("c15_card")
    real = srv.entry.step
    calls = []

    def failing(*args):
        calls.append(1)
        if len(calls) == 3:
            raise MXNetError("injected decode step fault on the card")
        return real(*args)

    srv.entry.step = failing
    flight.arm(str(tmp_path))
    try:
        futs = _submit_all(srv, _decode_prompts(2, 4))
        for f in futs:
            with pytest.raises(MXNetError, match="injected decode step"):
                f.result(300.0)
        srv._thread.join(60.0)
        assert not srv.alive
        ready, checks = obs_http.readiness()
        assert not ready
        assert "c15_card" in checks["decode_loops_alive"]["dead"]
    finally:
        flight.disarm()
        serve.shutdown_decode(60.0)
    dumps = [f for f in os.listdir(tmp_path)
             if f.startswith("flight-") and f.endswith(".json")]
    assert dumps
    doc = json.loads((tmp_path / dumps[0]).read_text())
    assert "injected decode step fault" in doc["metadata"]["flight"]["reason"]
    # the dump is taken as the error is made: the two steps before it
    assert sum(e["name"] == "serve.decode_step"
               for e in doc["traceEvents"]) >= 2
    trace.reset()


# -- trace.cost, mx.profiler and mx.np on the card ------------------------------
def _small_bert(device, dropout=0.0):
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon.model_zoo import BERTForPretrain, get_bert

    mx.random.seed(0)
    return BERTForPretrain(get_bert(
        num_layers=2, units=64, hidden_size=128, num_heads=4, vocab_size=97,
        max_length=64, dropout=dropout, device=device)).initialize(
            mx.init.Xavier())


def _small_bert_batch(b=4, t=32, p=5, lens=(32, 20, 32, 9)):
    rs = np.random.RandomState(3)
    x = (rs.randint(0, 97, (b, t)).astype("int32"),
         np.zeros((b, t), "int32"), np.asarray(lens, "int32"),
         rs.randint(0, t, (b, p)).astype("int32"))
    y = (rs.randint(0, 97, (b, p)).astype("int32"),
         rs.randint(0, 2, b).astype("int32"))
    return x, y


@pytest.mark.parametrize("dtype", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_cost_card_and_cpu_counts_of_one_bert_are_equal(dev, dtype):
    """The kernels' reported work stands for their plain versions' products
    exactly: the card's count of a small BERT's step equals the CPU's."""
    from mxnet_tpu_torch.gluon.model_zoo.bert import pretrain_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer
    from mxnet_tpu_torch.trace import cost

    x, y = _small_bert_batch()
    opt = "adam" if dtype is None else "adamw"
    infos = []
    for device in ("cpu", dev):
        tr = ShardedTrainer(_small_bert(device), pretrain_loss,
                            optimizer=opt, learning_rate=1e-3,
                            weight_decay=0.01, compute_dtype=dtype)
        infos.append(tr.xla_cost((x, y)))
        cost.reset()
    cpu, card = infos
    assert card["flops"] == cpu["flops"] > 0


def test_profiler_bf16_step_kernels_inside_trainer_step(dev, tmp_path):
    """``mx.profiler`` around two bf16 steps of a small BERT: the merged
    document holds the flash kernels' events inside ``trainer.step``
    spans, at the alignment's bound."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import trace
    from mxnet_tpu_torch.gluon.model_zoo.bert import pretrain_loss
    from mxnet_tpu_torch.parallel import ShardedTrainer

    x, y = _small_bert_batch()
    tr = ShardedTrainer(_small_bert(dev, dropout=0.1), pretrain_loss,
                        optimizer="adamw", learning_rate=1e-3,
                        compute_dtype=torch.bfloat16)
    tr.step(x, y, block=True)
    trace.set_enabled(True)
    trace.reset()
    mx.profiler.set_config(filename=str(tmp_path / "p.json"))
    mx.profiler.set_state("run")
    for _ in range(2):
        tr.step(x, y)
    tr.drain()
    mx.profiler.set_state("stop")
    with open(mx.profiler._state["trace"]) as f:
        doc = json.load(f)
    steps = [e for e in doc["traceEvents"] if e.get("name") == "trainer.step"]
    kern = _kernel_events(doc, ("flash_fwd16_kernel", "flash_bwd16_dkv"))
    assert len(steps) == 2 and len(kern) >= 2 * 2 * 2
    align = doc["metadata"]["profiler_alignment"]
    slack = align["error_us"]
    outside = [k for k in kern if not any(
        s["ts"] - slack <= k["ts"] and k["ts"] + k["dur"] <= s["ts"]
        + s["dur"] + slack for s in steps)]
    assert not outside, outside[:3]


def test_numpy_on_card_by_default(dev):
    """``mx.np`` creates on ``cuda:0`` by default, with the JAX package's
    types, and computes where its arrays are, as on the CPU."""
    import mxnet_tpu_torch as mx

    a = np.random.RandomState(0).rand(7, 5).astype("f4")
    g, c = mx.np.array(a), mx.np.array(a, device="cpu")
    assert g.device == dev and mx.np.zeros(2).device == dev
    assert mx.np.arange(4).dtype == torch.int32
    for fn in (lambda P, t: P.sum(t, axis=0), lambda P, t: P.argsort(t),
               lambda P, t: P.linalg.norm(t),
               lambda P, t: P.fft.rfft(t).abs(),
               lambda P, t: P.pad(t, 2, mode="reflect")):
        r, w = fn(mx.np, g), fn(mx.np, c)
        assert r.device == dev and r.dtype == w.dtype
        np.testing.assert_allclose(r.cpu().numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6)
    mx.random.seed(1)
    u = mx.np.random.uniform(size=4096)
    assert u.device == dev and u.dtype == torch.float32


# ------------------------------------------- the edge, the fleet, prefetch
_FLEET_SPEC = """import numpy as np
import torch
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serve
from mxnet_tpu_torch.gluon.model_zoo import transformer_lm
from mxnet_tpu_torch.kernels import registry
from mxnet_tpu_torch.test_utils import xavier_init


def models():
    lm = xavier_init(transformer_lm(vocab_size=64, units=64, num_heads=4,
                                    num_layers=2, max_length=96,
                                    device="cuda:0"), 5)
    lin = torch.nn.Linear(8, 4).to("cuda:0")
    with torch.no_grad():
        g = torch.Generator().manual_seed(2)
        lin.weight.copy_(torch.rand(4, 8, generator=g))
        lin.bias.copy_(torch.rand(4, generator=g))
    return lm, lin


def build():
    lm, lin = models()
    serve.register_decode("lm", lm, slots=2, prompt_buckets=(8, 16),
                          capacity_buckets=(32, 64), max_new_tokens=12)
    serve.register("lin", lin, bucketer={0: [1, 2, 4]},
                   sample=np.zeros(8, "float32"))
    return {"launches": registry.launches()}
"""


def test_fleet_two_replicas_answer_as_in_process_on_the_card(dev, tmp_path):
    """Two port replicas on the card, spawned by ``Fleet``: routed
    predicts and streamed greedy generates equal the same models served
    in this process, and each replica's READY shows the decode kernel
    launched by its warmup."""
    import importlib.util
    import threading

    from mxnet_tpu_torch import serve

    spec = tmp_path / "fleet_spec.py"
    spec.write_text(_FLEET_SPEC)
    loaded = importlib.util.spec_from_file_location("_card_fleet_spec", spec)
    local = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(local)
    lm, lin = local.models()
    prompts = _decode_prompts(4, 11)
    entry = serve.DecodeEntry("lm_ref", lm, slots=2, prompt_buckets=(8, 16),
                              capacity_buckets=(32, 64), max_new_tokens=12)
    srv = serve.DecodeServer(entry)
    try:
        want = [srv.generate(p, timeout=300.0) for p in prompts]
    finally:
        srv.close(60.0)
    rows = [np.random.RandomState(i).rand(8).astype("f4") for i in range(6)]
    with torch.no_grad():
        want_rows = lin(torch.from_numpy(np.stack(rows)).to(dev)).cpu().numpy()
    fleet = serve.Fleet(f"{spec}:build", min_replicas=2, max_replicas=2,
                        spawn_timeout=600.0)
    try:
        reps = fleet.ready_replicas()
        assert len(reps) == 2 and reps[0].pid != reps[1].pid
        for rep in reps:
            assert rep.doc["launches"]["flash_attention_decode"] > 0
            assert rep.doc["persistent_cache_hits"] == 0
        for p, w in zip(prompts, want):
            out = fleet.router.generate("lm", p, stream=True, timeout=300.0)
            assert out["tokens"] == w and out["finish_reason"] == "length"
        out = fleet.router.predict("lin", rows, timeout=300.0)
        np.testing.assert_allclose(np.asarray(out["outputs"], "f4"),
                                   want_rows, rtol=TOL, atol=TOL)
    finally:
        fleet.close(60.0)
    assert fleet.replicas() == []
    assert not [t.name for t in threading.enumerate()
                if t.is_alive() and t.name.startswith("mx-fleet")]


def test_edge_on_the_card_streams_the_in_process_tokens(dev):
    """One ``EdgeServer`` over a decode model on the card: the SSE tokens
    equal a direct submit's, and a deadline mid-generate answers 504 and
    frees the slot."""
    import json as _json
    import urllib.error
    import urllib.request

    from mxnet_tpu_torch import serve, telemetry
    from mxnet_tpu_torch.serve.edge import DEADLINE_HEADER, EdgeServer

    serve.register_decode("edge_card", _decode_lm(dev), **_DECODE_CFG)
    edge = EdgeServer(port=0)
    try:
        prompt = _decode_prompts(1, 12)[0]
        want = serve.generate("edge_card", prompt, timeout=300.0)
        req = urllib.request.Request(
            edge.url + "/v1/generate", data=_json.dumps(
                {"model": "edge_card", "prompt": prompt,
                 "stream": False}).encode())
        with urllib.request.urlopen(req, timeout=300.0) as r:
            assert _json.loads(r.read())["tokens"] == want

        def slow(tok):
            if tok is not None:
                time.sleep(0.03)

        anchor = serve.decode_server("edge_card").submit(
            [9], max_new_tokens=20, on_token=slow)
        req = urllib.request.Request(
            edge.url + "/v1/generate", data=_json.dumps(
                {"model": "edge_card", "prompt": [3], "stream": False,
                 "max_new_tokens": 20}).encode(),
            headers={DEADLINE_HEADER: "200"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=300.0)
        assert ei.value.code == 504
        anchor.result(300.0)
        deadline = time.monotonic() + 30.0
        while telemetry.snapshot().get("serve.decode_slots_active", {
                "value": 0})["value"] and time.monotonic() < deadline:
            time.sleep(0.02)
        assert telemetry.snapshot()["serve.decode_slots_active"]["value"] == 0
    finally:
        edge.close(60.0)
        serve.shutdown_decode(60.0)


def test_prefetch_batch_equals_its_source_after_the_consumer_waits(dev):
    """Batches placed by the prefetcher's own stream, read at once on the
    consumer's stream: every value equals its source (the consumer's
    stream waited on the copy), over batches of 64 MiB."""
    from mxnet_tpu_torch.gluon.data import DevicePrefetcher

    rs = np.random.RandomState(0)
    src = [(rs.rand(16, 1024, 1024).astype("f4"),
            np.full(16, i, "i4")) for i in range(6)]
    with DevicePrefetcher(src, placement=dev, pin_memory=True,
                          depth=2) as pf:
        for (x, y), (wx, wy) in zip(pf, src):
            assert x.device == dev and x.dtype == torch.float32
            s = (x * 1.0).sum()             # read on the consumer stream
            assert torch.equal(y.cpu(), torch.from_numpy(wy))
            assert torch.equal(x.cpu(), torch.from_numpy(wx))
            assert s.item() == pytest.approx(float(wx.sum(dtype="f8")),
                                             rel=1e-4)


def test_prefetch_staging_not_reused_under_an_in_flight_copy(dev):
    """The prefetcher's stream held busy (a sleep kernel queued on it)
    while its thread stages the next batches page-locked: no staging
    buffer is handed to a later batch before the copy that reads it ran,
    so every placed batch equals its own source."""
    from mxnet_tpu_torch.gluon.data import DevicePrefetcher

    src = [(np.full((4, 1 << 20), i, "f4"),) for i in range(8)]
    pf = DevicePrefetcher(src, placement=dev, pin_memory=True, depth=4)
    torch.cuda._sleep(200_000_000)          # the consumer's stream busy
    with torch.cuda.stream(pf._put.stream):
        torch.cuda._sleep(400_000_000)      # the copies queue behind this
    got = [b[0] for b in pf]
    torch.cuda.synchronize()
    pf.close()
    for i, x in enumerate(got):
        assert torch.all(x == float(i)).item(), i


# ------------------------------------------------ data parallelism (dp)
DP_DTYPES = [(torch.float32, ""), (torch.bfloat16, ".bf16"),
             (torch.float16, ".f16")]


@pytest.mark.parametrize("dtype,sfx", DP_DTYPES, ids=["f32", "bf16", "f16"])
@pytest.mark.parametrize("rows,c", [(7, 3), (3136, 64), (6272, 512),
                                    (200, 1001)])
def test_dist_bn_sums_and_fold_match_plain(dev, dtype, sfx, rows, c):
    """The dp mode of ``bn_act.cu``: the sums launch against the plain
    float64 sums (a summation order apart), the fold launch against the
    plain fold of the same sums, and on one rank the two launches give
    the one-launch statistics' bits."""
    from mxnet_tpu_torch.kernels import bn_act as kbn

    g = torch.Generator().manual_seed(rows + c)
    x = (torch.randn(rows, c, generator=g) * 3 + 1).to(dtype)
    gamma = (torch.rand(c, generator=g) + 0.5).to(dtype)
    beta = torch.randn(c, generator=g).to(dtype)
    xd, gd, bd = x.to(dev), gamma.to(dev), beta.to(dev)
    registry.reset_launches()
    sums = kbn.bn_sums(xd)
    torch.cuda.synchronize()
    want = kbn.bn_sums_plain(x)
    np.testing.assert_allclose(sums.cpu().numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-9 * float(want.abs().max()))
    packed = torch.cat([sums.reshape(-1), sums.new_full((1,), float(rows))])
    got = kbn.bn_fold(packed, gd, bd, 1e-5, dtype)
    ref = kbn.bn_fold_plain(packed.cpu(), gamma, beta, 1e-5, dtype)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6 if b.dtype ==
                                   torch.float32 else 2 ** -8, atol=1e-6)
    one = kbn.bn_stats(xd, gd, bd, 1e-5)
    for a, b in zip(got, one):
        assert torch.equal(a, b), "dp mode on one rank != one launch"
    n = registry.launches()
    assert n[f"bn_act_sums{sfx}"] == 1 and n[f"bn_act_fold{sfx}"] == 1


def test_zero1_arena_shard_matches_plain(dev):
    """A rank's zero1 shard of the arena (8192 * k elements) through the
    kernel against the plain version."""
    from mxnet_tpu_torch.kernels import opt_arena as oa

    for variant, kw in (("momentum", dict(momentum=0.9)), ("adam", {})):
        n = oa.BLOCK * 3
        g = torch.Generator().manual_seed(n)
        grad = torch.randn(n, generator=g)
        states = [torch.randn(n, generator=g).abs()
                  for _ in range(oa.VARIANT_STATES[variant])]
        dref, sref = oa.arena_update_reference(
            variant, grad.clone(), [s.clone() for s in states], 0.05, 3, **kw)
        sd = [s.to(dev) for s in states]
        d, _ = oa.arena_update(variant, grad.to(dev), sd, 0.05, 3, **kw)
        torch.testing.assert_close(d.cpu(), dref, rtol=1e-6, atol=1e-7)
        for a, b in zip(sd, sref):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=1e-7)


def _dp_job(workdir, device="cuda"):
    from mxnet_tpu_torch import test_utils as tu

    net, _ = tu.dp_model("mlp", None)
    rs = np.random.RandomState(1)
    params = {k: rs.uniform(-0.5, 0.5, v.shape).astype("f4")
              if "running" not in k else v.detach().numpy().copy()
              for k, v in list(net.named_parameters())
              + list(net.named_buffers())}
    rs = np.random.RandomState(5)
    batches = [(rs.rand(16, 16).astype("f4"),
                rs.randint(0, 8, size=(16,)).astype("i4")) for _ in range(3)]
    opt = dict(optimizer="sgd", learning_rate=0.05, momentum=0.9)
    modes = {"replicated": {}, "zero1": {"partition": "zero1",
                                         "fused_opt": "off"},
             "zero1_arena": {"partition": "zero1"},
             "overlap": {"partition": "zero1", "overlap": True}}
    cases = [{"name": m, "kind": "train", "model": "mlp", "device": device,
              "env": {"MXNET_ZERO1_MIN_SIZE": "64",
                      "MXNET_OVERLAP_BUCKET_BYTES": "4096"},
              "trainer": dict(opt, **kw), "fatal": False}
             for m, kw in modes.items()]
    cases += [{"name": "collectives", "kind": "collectives",
               "device": device, "fatal": False},
              {"name": "bn_f32", "kind": "bn_act", "device": device,
               "fatal": False},
              {"name": "bn_bf16", "kind": "bn_act", "device": device,
               "dtype": "bfloat16", "fatal": False}]
    return {"cases": cases, "params": {"mlp": params},
            "batches": {"mlp": batches}, "dir": str(workdir)}, modes


@pytest.mark.parametrize("n,backend", [(1, "nccl"), (2, "gloo")])
def test_dist_world_on_the_card(dev, tmp_path, n, backend):
    """Ranks on the card: one over NCCL, two sharing the card over gloo
    (whose CUDA collectives the port stages where gloo has none).  Every
    layout trains the MLP with BatchNorm as one rank of the whole batch
    in this process does (1e-5); the collectives' values; the bn_act dp
    mode's statistics and gradients (bf16 within 2^-7 of the channel's
    scale)."""
    from mxnet_tpu_torch import test_utils as tu
    from mxnet_tpu_torch.parallel import ShardedTrainer

    job, modes = _dp_job(tmp_path)
    ranks = tu.spawn_world(n, job, str(tmp_path / "w"), timeout=300,
                           backend=backend)
    net, loss = tu.dp_model("mlp", job["params"]["mlp"], device=dev)
    ref = ShardedTrainer(net, loss, **job["cases"][0]["trainer"])
    want = [ref.step(x, y, block=True) for x, y in job["batches"]["mlp"]]
    wp = {k: v.detach().cpu().numpy() for k, v in net.named_parameters()}
    for r in range(n):
        for m in modes:
            got = ranks[r][m]
            assert "error" not in got, got.get("error")
            assert got["device"] == "cuda:0"
            np.testing.assert_allclose(got["losses"], want, rtol=1e-5,
                                       atol=1e-5, err_msg=m)
            for k, v in wp.items():
                np.testing.assert_allclose(got["params"][k], v, rtol=1e-5,
                                           atol=1e-5, err_msg=(m, k))
        col = ranks[r]["collectives"]
        assert "error" not in col, col.get("error")
        xs = [np.arange(8, dtype=np.float32) + 10 * q for q in range(n)]
        np.testing.assert_array_equal(col["all_reduce"], sum(xs))
        np.testing.assert_array_equal(col["all_gather"], np.concatenate(xs))
        np.testing.assert_array_equal(col["ring_all_gather"],
                                      np.concatenate(xs))
        np.testing.assert_array_equal(col["reduce_scatter"],
                                      np.split(sum(xs), n)[r])
        np.testing.assert_array_equal(col["reduce_scatter_out"],
                                      np.split(sum(xs), n)[r])
        np.testing.assert_array_equal(col["all_gather_out"],
                                      np.concatenate(xs))
        for case, tol in (("bn_f32", 1e-5), ("bn_bf16", 2 ** -7)):
            got = ranks[r][case]
            assert "error" not in got, got.get("error")
            for k in ("mean", "var", "y", "dx", "dgamma", "dbeta"):
                want_k = got[f"want_{k}"]
                scale = max(1.0, float(np.abs(want_k).max()))
                np.testing.assert_allclose(got[k], want_k, rtol=tol,
                                           atol=tol * scale,
                                           err_msg=(case, k))
    # the arena's zero1 launch covers this rank's shard
    z1 = ranks[0]["zero1_arena"]
    assert z1["launches"]["opt_arena"] == 3
    assert z1["state_numel"] == [z1["arena_padded"] // n]


# ---------------------------------------------------- the other mesh axes
def _axes_job(workdir):
    """Two gloo ranks on the card: the MLP with batch norm on {"dp": 1,
    "mp": 2} (mp_spec_fn) and {"dp": 2} (fsdp_spec_fn), the three-Dense
    stack on {"dp": 1, "pp": 2} (grad_accum 2), ring attention on
    {"sp": 2}, experts on {"ep": 2}."""
    from mxnet_tpu_torch import test_utils as tu

    job, _ = _dp_job(workdir)
    opt = dict(optimizer="sgd", learning_rate=0.05, momentum=0.9)
    base = dict(kind="spmd", model="mlp", device="cuda", batches="mlp",
                env={"MXNET_ZERO1_MIN_SIZE": "64"}, fatal=False)
    cases = [dict(base, name="spmd/mp", mesh={"dp": 1, "mp": 2},
                  spec=("mp", {"min_size": 64}), trainer=opt),
             dict(base, name="spmd/fsdp", mesh={"dp": 2},
                  spec=("fsdp", {"axis": "dp", "min_size": 64}),
                  trainer=dict(opt, partition="zero1")),
             dict(base, name="pipeline", model="dense3", params="dense3",
                  batches="dense3", mesh={"dp": 1, "pp": 2}, repeat=2,
                  trainer=dict(opt, grad_accum=2, partition="zero1")),
             dict(name="ring", kind="ring", device="cuda",
                  spec=dict(b=1, h=2, t=256, d=32, seed=3), fatal=False),
             dict(name="moe", kind="moe", device="cuda", mesh={"ep": 2},
                  spec=dict(tokens=64, d=16, h=32, e=4, seed=5), k=2,
                  cf=8.0, fatal=False)]
    net, _ = tu.dp_model("dense3", None)
    rs = np.random.RandomState(2)
    job["params"]["dense3"] = {k: v.detach().numpy() for k, v in
                               net.named_parameters()}
    job["batches"]["dense3"] = [(rs.rand(16, 8).astype("f4"),
                                 rs.randint(0, 4, 16).astype("i4"))] * 3
    job["cases"] = cases
    job["allow_tf32"] = False
    return job


_AXES = {}


@pytest.fixture()
def axes_world(dev, tmp_path_factory):
    """The world of ``_axes_job``, spawned once for the tests below (a
    failure is replayed to each)."""
    from mxnet_tpu_torch import test_utils as tu

    if "run" not in _AXES:
        _AXES["dir"] = str(tmp_path_factory.mktemp("axes_world"))
        _AXES["run"] = tu.cached_world(
            lambda d: (tu.spawn_world(2, _axes_job(d), f"{d}/w",
                                      timeout=300, backend="gloo"),
                       _axes_job(d)))
    return _AXES["run"](_AXES["dir"])


def _one_rank(dev, job, case, steps_each=1):
    from mxnet_tpu_torch import test_utils as tu
    from mxnet_tpu_torch.parallel import ShardedTrainer

    net, loss = tu.dp_model(case["model"], job["params"][case["model"]],
                            device=dev)
    tr = ShardedTrainer(net, loss, optimizer="sgd", learning_rate=0.05,
                        momentum=0.9)
    want = [tr.step(x, y, block=True) for x, y in
            job["batches"][case["batches"]]]
    return want, {k: v.detach().cpu().numpy()
                  for k, v in net.named_parameters()}


@pytest.mark.parametrize("name", ["spmd/mp", "spmd/fsdp"])
def test_spmd_world_on_the_card(dev, axes_world, name):
    """Parameters sharded by mp_spec_fn / fsdp_spec_fn on two ranks of the
    card train as one rank of the whole batch (1e-5), each rank storing
    its shards."""
    ranks, job = axes_world
    case = next(c for c in job["cases"] if c["name"] == name)
    want, wp = _one_rank(dev, job, case)
    for r in range(2):
        got = ranks[r][name]
        assert "error" not in got, got.get("error")
        assert got["device"] == "cuda:0"
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5, atol=1e-5)
        for k, v in wp.items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-5,
                                       atol=1e-5, err_msg=(name, k))
        assert sum(got["numel"].values()) < sum(int(np.prod(s)) for s in
                                                 got["full"].values())


def test_pipeline_world_on_the_card(dev, axes_world):
    """The pp schedule on two ranks of the card: each window's loss as one
    rank's step on the window's (repeated) batch, one update a window."""
    ranks, job = axes_world
    case = next(c for c in job["cases"] if c["name"] == "pipeline")
    want, wp = _one_rank(dev, job, case)
    for r in range(2):
        got = ranks[r]["pipeline"]
        assert "error" not in got, got.get("error")
        np.testing.assert_allclose(got["losses"][1::2], want, rtol=1e-5,
                                   atol=1e-6)
        assert got["t"] == len(want) and got["bubble"] == pytest.approx(
            1 / 3)
        for k, v in wp.items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_ring_world_on_the_card(dev, axes_world):
    """Ring attention over two ranks of the card against
    attention_reference on the whole sequence, outputs and gradients."""
    from mxnet_tpu_torch import test_utils as tu
    from mxnet_tpu_torch.parallel.ring import attention_reference

    ranks, job = axes_world
    spec = next(c for c in job["cases"] if c["name"] == "ring")["spec"]
    arr = tu.ring_arrays(**spec)
    for causal in (False, True):
        q, k, v = (torch.tensor(arr[n], device=dev).requires_grad_()
                   for n in "qkv")
        t = q.shape[2]
        mask = (torch.arange(t, device=dev)[:, None]
                >= torch.arange(t, device=dev)[None]) if causal else None
        o = attention_reference(q, k, v, mask=mask)
        (o * torch.tensor(arr["w"], device=dev)).sum().backward()
        tag = "causal" if causal else "full"
        for key, ref in (("out", o), ("dq", q.grad), ("dk", k.grad),
                         ("dv", v.grad)):
            got = np.concatenate([ranks[r]["ring"][tag][key]
                                  for r in range(2)], axis=2)
            np.testing.assert_allclose(got, ref.detach().cpu().numpy(),
                                       atol=2e-5, err_msg=(tag, key))


def test_moe_world_on_the_card(dev, axes_world):
    """Experts over two ranks of the card against moe_reference shard by
    shard: outputs at 2e-4, aux the mean of the shards'."""
    from mxnet_tpu_torch import test_utils as tu
    from mxnet_tpu_torch.parallel.moe import moe_reference

    ranks, job = axes_world
    case = next(c for c in job["cases"] if c["name"] == "moe")
    arr = tu.moe_arrays(**case["spec"])
    t = {n: torch.tensor(arr[n], device=dev) for n in arr}
    n = t["x"].shape[0] // 2
    auxes = []
    for r in range(2):
        got = ranks[r]["moe"]
        assert "error" not in got, got.get("error")
        i = got["index"]
        o, aux = moe_reference(t["x"][i * n:(i + 1) * n], t["gate"],
                               t["up"], t["down"], k=case["k"],
                               capacity_factor=case["cf"])
        np.testing.assert_allclose(got["out"], o.cpu().numpy(), atol=2e-4)
        auxes.append(float(aux))
    for r in range(2):
        assert ranks[r]["moe"]["aux"] == pytest.approx(sum(auxes) / 2,
                                                       rel=1e-5)


# ------------------------------------------------ deferred shapes (A6c)
def _deferred_net(device):
    from mxnet_tpu_torch.gluon import nn

    return nn.HybridSequential().add(
        nn.Conv2D(16, 3, padding=1, device=device),
        nn.BatchNorm(device=device), nn.Activation("relu"),
        nn.GroupNorm(4, device=device), nn.PReLU(device=device),
        nn.AvgPool2D(3, 2, ceil_mode=True),
        nn.Conv2DTranspose(8, 2, strides=2, device=device),
        nn.Dense(10, device=device))


def test_deferred_block_captured_after_its_eager_first_call(dev):
    """A net built on the CPU with its widths deferred, moved to the card
    by ``initialize(device=)`` before its first call (the tensors
    materialize there), hybridized: the eager first call infers the
    widths, the next captures, and the captured scores, the recorded
    forward and the gradients equal the eager ones within 1e-6 x max."""
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon.parameter import is_deferred

    net = _deferred_net("cpu")
    tmx.random.seed(26)
    net.initialize(tmx.init.Xavier(), device=dev)
    assert all(is_deferred(p) for p in (net[0].weight, net[7].weight))
    assert net[0].weight.device == dev and net[1].running_var.device == dev
    x = torch.rand(4, 3, 15, 15, generator=torch.Generator().manual_seed(0))
    x = x.to(dev)

    def run(record):
        if not record:
            with torch.no_grad():
                return [net(x)]
        with autograd.record():
            y = net(x)
        y.square().sum().backward()
        out = [y.detach()] + [p.grad.clone() for p in net.parameters()]
        net.zero_grad()
        return out

    net.hybridize()
    first = run(False)                          # the eager first call
    assert not any(is_deferred(t) for t in net.state_dict().values())
    assert all(t.device == dev for t in net.state_dict().values())
    got = [run(False) for _ in range(2)][-1]    # capture, then replay
    stats = [b.clone() for b in net.buffers()]
    got_rec = [run(True) for _ in range(2)][-1]
    for b, s in zip(net.buffers(), stats):      # put the statistics back
        b.copy_(s)
    assert len(net._cached_op._traced) >= 2
    net.hybridize(False)
    want = run(False)
    want_rec = [run(True) for _ in range(2)][-1]
    for g, w in zip(first + got + got_rec, want + want + want_rec):
        scale = float(w.float().abs().max()) or 1.0
        assert float((g.float() - w.float()).abs().max()) <= 1e-6 * scale


def test_inception_v3_bf16_scores_match_the_cpu(dev):
    """``inception_v3`` cast to bf16 on the card against the same values
    on the CPU at B = 2 on 299^2, at ``chip_smoke.py`` phase 38's bar:
    the larger of 2^-4 x max|cpu| and 3 x the CPU's own bf16-f32
    distance; the card's f32 scores within 1e-4 x max of the CPU's."""
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch.gluon.model_zoo import get_model

    net = get_model("inceptionv3", classes=100, layout="NHWC", device=dev)
    xavier_init(net, 3)
    xs = np.random.RandomState(1).rand(2, 299, 299, 3).astype(np.float32)
    with torch.no_grad():
        got32 = net(torch.from_numpy(xs).to(dev)).cpu()
    cpu = convert.load_into(
        get_model("inceptionv3", classes=100, layout="NHWC", device="cpu"),
        {k: v.cpu().numpy() for k, v in net.state_dict().items()})
    net.cast(torch.bfloat16)
    with torch.no_grad():
        got = net(torch.from_numpy(xs).to(dev).to(torch.bfloat16))
        ref32 = cpu(torch.from_numpy(xs))
        ref16 = cpu.cast(torch.bfloat16)(
            torch.from_numpy(xs).to(torch.bfloat16)).float()
    got = got.float().cpu()
    assert float((got32 - ref32).abs().max()) <= \
        1e-4 * float(ref32.abs().max())
    own = float((ref16 - ref32).abs().max())
    bar = max(2.0 ** -4 * float(ref16.abs().max()), 3 * own)
    assert bool(torch.isfinite(got).all())
    assert float((got - ref16).abs().max()) <= bar
