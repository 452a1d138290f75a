"""Test utilities (ref: python/mxnet/test_utils.py): inputs that probe
the numerics of the 16-bit attention backward, and the decode kernel's
cases in every (query type, cache type) pair, shared by the card tests,
the CPU tests and ``chip_smoke.py``.

Each builder returns f32 CPU tensors (B, H, T, d) whose values are exact
in the 16-bit type they name; the caller casts and moves them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["attention_large_ds_inputs", "attention_split_probe_inputs",
           "attention_p_ds", "DECODE_PAIRS", "decode_case", "decode_bar"]


def attention_large_ds_inputs(b, h, tk, d, tq=96):
    """q, k, v, g whose dS passes 65504 (f16's largest value) while dq,
    dk and dv are nonzero and fit in f16.

    Every query is u (a unit vector) and puts its weight on keys 0 and 1
    (scores 0.5 apart, p = 0.62 and 0.38; every other key is -192 u,
    e^-21 or less of it); v_0 = s and v_1 = -s (s a sign vector), and
    g_i = 3000 m_i a_i s with a_i = (-1)^i except a_{tq-1} = +1, and
    m_i = 1/4 on the first 64 queries, 1 after them.  So dP = +-3000 m d
    on the two keys and dS = +-2 p_0 p_1 3000 m d: 90,000 at d = 64,
    raised from one 64-query tile to the next (an f16 scale must rise
    with it).  dq = scale dS_0 (k_0 - k_1) is 6,800 at d = 64 and 15,000
    at d = 320; the a_{tq-1} flip leaves sum_i m_i a_i = 2, so dk_0 =
    -dk_1 = 2,800 u sqrt(d) and dv = p 6,000 s.  ``tq`` even, > 64."""
    u = torch.full((d,), 1.0 / math.sqrt(d))
    sign = torch.from_numpy(
        np.random.RandomState(d).choice([-1.0, 1.0], size=d)).float()
    w = 0.05 * torch.tensor([(-1.0) ** c for c in range(d)])   # w . u = 0
    q = u.expand(b, h, tq, d).clone()
    k = (-192.0 * u).expand(b, h, tk, d).clone()
    k[:, :, 0] = (192.0 + 0.5 * math.sqrt(d)) * u + w
    k[:, :, 1] = 192.0 * u - w
    v = torch.from_numpy(np.random.RandomState(tk).choice(
        [-1.0, 1.0], size=(b, h, tk, d))).float()
    v[:, :, 0], v[:, :, 1] = sign, -sign
    a = torch.tensor([(-1.0) ** i for i in range(tq)])
    a[-1] = 1.0
    m = torch.where(torch.arange(tq) < 64, 0.25, 1.0)
    g = (3000.0 * (m * a)[:, None] * sign).expand(b, h, tq, d).clone()
    return [x.half().float() for x in (q, k, v, g)]


def attention_split_probe_inputs(b, h, tq, tk, d, dtype, seed):
    """q, k, v, g on which dq shows the low term of a two-term split of
    dS: every key is 1 + e (e entries +-1 ulp of ``dtype`` at 1).

    dQ_i = scale sum_j dS_ij k_j, and sum_j dS_ij = 0 up to the
    rounding of out, so the common 1 cancels and dq_i = scale sum_j
    dS_ij e_j, one ulp's size of dS.  A split that keeps only dS's high
    16-bit term errs by 2^-9 (bf16) or 2^-12 (f16) of each dS_ij times
    the 1, a quarter or more of dq; the two-term split errs by 2^-17 or
    2^-23.  q, v, g uniform in [-1, 1)."""
    rs = np.random.RandomState(seed)
    ulp = torch.finfo(dtype).eps
    q, v, g = ((rs.rand(b, h, t, d) - 0.5) * 2 for t in (tq, tk, tq))
    k = 1.0 + ulp * rs.choice([-1.0, 1.0], size=(b, h, tk, d))
    return [torch.from_numpy(x.astype("float32")).to(dtype).float()
            for x in (q, k, v, g)]


def attention_p_ds(q, k, v, g, out, lse, kv_len=None, causal=False,
                   scale=None):
    """p and dS of an attention backward in f32 from its (16-bit) inputs,
    entries past ``kv_len`` or the causal diagonal 0: the plain version's
    arithmetic (``kernels.flash_bwd.flash_attention_bwd_reference``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v, g, out = (t.float() for t in (q, k, v, g, out))
    tq, tk = q.shape[2], k.shape[2]
    live = torch.ones(1, 1, tq, tk, dtype=torch.bool, device=q.device)
    if kv_len is not None:
        live = live & (torch.arange(tk, device=q.device)[None, :]
                       < kv_len[:, None])[:, None, None, :]
    if causal:
        live = live & (torch.arange(tq, device=q.device)[:, None]
                       >= torch.arange(tk, device=q.device)[None, :])
    lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    zero = torch.zeros((), device=q.device)
    p = torch.where(live, torch.exp(q @ k.transpose(-1, -2) * scale
                                    - lse[..., None]), zero)
    dp = g @ v.transpose(-1, -2) - (g * out).sum(-1)[..., None]
    return p, torch.where(live, p * dp, zero)


# every (query type, cache type) pair of the decode kernel; torch.int8 is
# the quantized cache (int8 pages with f32 row scales)
DECODE_PAIRS = [(q, kv) for q in (torch.float32, torch.bfloat16,
                                  torch.float16)
                for kv in (torch.float32, torch.int8, torch.bfloat16,
                           torch.float16)]


def decode_case(q_dtype, kv_dtype, b, h, tq, c, d, lens, seed, device):
    """The decode kernel's inputs and its plain version's for one pair:
    ``(kernel kwargs, plain kwargs)`` on ``device``, q (B, H, Tq, d) in
    ``q_dtype``, a (B, H, C, d) cache in ``kv_dtype`` (int8 with its
    scales), ``cache_len`` = ``lens``.  Past each row's window (positions
    >= lens + Tq) the cache holds NaN (a 16-bit or f32 cache's values, an
    int8 cache's scales), which the kernel must never read; the plain
    version gets those zeroed where it multiplies them by 0."""
    from .ops import attention as att

    g = torch.Generator(device="cpu").manual_seed(seed)
    q = (torch.rand(b, h, tq, d, generator=g) - 0.5).to(q_dtype)
    k = torch.rand(b, h, c, d, generator=g) - 0.5
    v = torch.rand(b, h, c, d, generator=g) - 0.5
    lens_t = torch.tensor(lens, dtype=torch.int32)
    past = (torch.arange(c)[None, :] >= lens_t[:, None] + tq)
    past = past[:, None, :, None]
    if kv_dtype == torch.int8:
        k, ks = att.quantize_kv(k)
        v, vs = att.quantize_kv(v)
        ks = ks.masked_fill(past, float("nan"))
        vs = vs.masked_fill(past, float("nan"))
        kern = dict(q=q, k=k, v=v, cache_len=lens_t, k_scale=ks, v_scale=vs)
        plain = dict(kern, v_scale=torch.nan_to_num(vs))
    else:
        k = k.to(kv_dtype).masked_fill(past, float("nan"))
        v = v.to(kv_dtype).masked_fill(past, float("nan"))
        kern = dict(q=q, k=k, v=v, cache_len=lens_t)
        plain = dict(kern, v=torch.nan_to_num(v))
    return ({n: t.to(device) for n, t in kern.items()},
            {n: t.to(device) for n, t in plain.items()})


def decode_bar(q_dtype, kv_dtype, ref):
    """The decode kernel's bar against its plain version, as an absolute
    error: 2^-7 (bf16) / 2^-10 (f16) x max|ref| where the output (q's
    type) or the cache is 16-bit, the 16-bit forward's bars, taking the
    16-bit side's type (bf16 where both are, as the coarser); None where
    q, the output and the cache are f32 or int8, whose bar is atol = rtol
    = 1e-4.  An f32 output over a 16-bit cache takes the cache type's
    bar: P V rounds P to v's type at the kernel's running max, which the
    plain version (the row's max) cannot reproduce, so two roundings of
    each probability may differ by one 16-bit ulp."""
    kinds = {q_dtype, kv_dtype}
    top = float(ref.float().abs().max()) if ref.numel() else 0.0
    if torch.bfloat16 in kinds:
        return 2.0 ** -7 * top
    if torch.float16 in kinds:
        return 2.0 ** -10 * top
    return None
