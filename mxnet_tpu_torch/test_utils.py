"""Test utilities (ref: python/mxnet/test_utils.py): inputs that probe
the numerics of the 16-bit attention backward, the decode kernel's
cases in every (query type, cache type) pair, seeded Xavier weights
(:func:`xavier_init`), the losses' cases (:data:`LOSS_CASES`) and the
bounding-box operators' runs (:func:`box_op_runs`), shared by the card
tests, the CPU tests and ``chip_smoke.py``.

Each builder returns f32 CPU tensors (B, H, T, d) whose values are exact
in the 16-bit type they name; the caller casts and moves them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["attention_large_ds_inputs", "attention_split_probe_inputs",
           "attention_p_ds", "DECODE_PAIRS", "decode_case", "decode_bar",
           "xavier_init", "LOSS_CASES", "loss_inputs", "loss_run",
           "box_op_runs", "box_exact_parts", "COLLIDING_TARGETS",
           "near_tie"]


def xavier_init(block, seed: int):
    """``mx.random.seed(seed)`` then ``block.initialize(mx.init.Xavier())``,
    as ``bench.py`` builds its nets; returns the block."""
    from . import initializer, random

    random.seed(seed)
    return block.initialize(initializer.Xavier())


def near_tie(lm, prompt, want, got, rel: float = 1e-4):
    """Hold a served greedy answer ``got`` to a reference answer ``want``
    of the same ``prompt`` by the near-tie rule: None where they are
    equal, else ``(k, gap, scale, tie)`` at the first token ``k`` where
    they differ.  One eager forward of ``prompt + want[:k]`` through
    ``lm`` (a decode LM: ``lm(tokens, cache, cache_len, n_tokens)``)
    gives the logits there: ``gap`` is the reference token's logit minus
    the served one's, ``scale`` max|logit|, and ``tie`` whether both
    tokens lie within ``rel * scale`` of the top logit (an answer may
    leave the reference only there).  A length mismatch is no tie."""
    k = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if k is None:
        return None if len(want) == len(got) else \
            (min(len(want), len(got)), float("inf"), 0.0, False)
    seq = list(prompt) + list(want[:k])
    with torch.no_grad():
        logits, _ = lm(np.asarray([seq]), lm.begin_cache(1, len(seq)), [0],
                       [len(seq)])
    row = logits[0, -1].float()
    scale = float(row.abs().max())
    top = float(row.max())
    low = min(float(row[want[k]]), float(row[got[k]]))
    return (k, float(row[want[k]] - row[got[k]]), scale,
            top - low <= rel * scale)


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


# ------------------------------------------------------------- losses
def _u(rs, *shape, lo=-1.0, hi=1.0):
    return rs.uniform(lo, hi, size=shape).astype("f4")


def _signs(rs, *shape):
    return rs.choice([-1.0, 1.0], size=shape).astype("f4")


def _dist(rs, *shape):
    e = np.exp(rs.randn(*shape))
    return (e / e.sum(-1, keepdims=True)).astype("f4")


def _ctc_labels(rs, n, nl, c):
    lab = np.zeros((n, nl), "i4")
    for i in range(n):
        k = rs.randint(1, nl + 1)
        lab[i, :k] = rs.randint(1, c, k)
    lab[0, :2] = 3                      # a repeated label: no skip there
    return lab


#: ``(id, gluon.loss class name, constructor kwargs, inputs(rs) -> (args,
#: kwargs) as numpy, positions of the floating args that take a
#: gradient)``: every loss but ``SoftmaxCrossEntropyLoss``, with its
#: options; the JAX losses take the same arguments
LOSS_CASES = [
    ("l2", "L2Loss", {}, lambda rs: ([_u(rs, 4, 5), _u(rs, 4, 5)], {}),
     (0, 1)),
    ("l2-weight-sw", "L2Loss", dict(weight=0.7),
     lambda rs: ([_u(rs, 4, 3, 2), _u(rs, 4, 6)],
                 dict(sample_weight=_u(rs, 4, 1, 1, lo=0))), (0,)),
    ("l2-batch-axis-1", "L2Loss", dict(batch_axis=1),
     lambda rs: ([_u(rs, 3, 4), _u(rs, 3, 4)], {}), (0,)),
    ("l1", "L1Loss", {}, lambda rs: ([_u(rs, 4, 5), _u(rs, 4, 5)], {}),
     (0,)),
    ("l1-weight-sw", "L1Loss", dict(weight=2.0),
     lambda rs: ([_u(rs, 4, 5), _u(rs, 4, 5)],
                 dict(sample_weight=_u(rs, 4, 1, lo=0))), (0,)),
    ("bce", "SigmoidBinaryCrossEntropyLoss", {},
     lambda rs: ([_u(rs, 4, 5, lo=-4, hi=4),
                  rs.randint(0, 2, (4, 5)).astype("f4")], {}), (0,)),
    ("bce-weight-sw-posweight", "SigmoidBinaryCrossEntropyLoss",
     dict(weight=0.5),
     lambda rs: ([_u(rs, 4, 5, lo=-4, hi=4), _u(rs, 4, 5, lo=0)],
                 dict(sample_weight=_u(rs, 4, 1, lo=0),
                      pos_weight=_u(rs, 5, lo=1, hi=3))), (0,)),
    ("bce-from-sigmoid", "SigmoidBinaryCrossEntropyLoss",
     dict(from_sigmoid=True),
     lambda rs: ([_u(rs, 4, 5, lo=0.02, hi=0.98),
                  rs.randint(0, 2, (4, 5)).astype("f4")], {}), (0,)),
    ("kldiv", "KLDivLoss", {},
     lambda rs: ([np.log(_dist(rs, 4, 6)), _dist(rs, 4, 6)], {}), (0, 1)),
    ("kldiv-logits-sw-3d", "KLDivLoss", dict(from_logits=False),
     lambda rs: ([_u(rs, 4, 3, 6, lo=-2, hi=2), _dist(rs, 4, 3, 6)],
                 dict(sample_weight=_u(rs, 4, lo=0))), (0,)),
    ("kldiv-axis-1", "KLDivLoss", dict(from_logits=False, axis=1),
     lambda rs: ([_u(rs, 4, 6, lo=-2, hi=2), _dist(rs, 4, 6)], {}), (0,)),
    ("ctc", "CTCLoss", {},
     lambda rs: ([_u(rs, 3, 12, 6, lo=-2, hi=2), _ctc_labels(rs, 3, 4, 6)],
                 {}), (0,)),
    ("ctc-tnc-lengths-weight", "CTCLoss",
     dict(layout="TNC", label_layout="TN", weight=0.5),
     lambda rs: ([_u(rs, 12, 3, 6, lo=-2, hi=2),
                  _ctc_labels(rs, 3, 4, 6).T.copy()],
                 dict(pred_lengths=np.array([12, 9, 10], "i4"),
                      label_lengths=np.array([3, 2, 4], "i4"))), (0,)),
    ("huber", "HuberLoss", {},
     lambda rs: ([_u(rs, 4, 5, lo=-3, hi=3), _u(rs, 4, 5)], {}), (0, 1)),
    ("huber-rho-weight-sw", "HuberLoss", dict(rho=0.5, weight=1.5),
     lambda rs: ([_u(rs, 4, 5, lo=-3, hi=3), _u(rs, 4, 5)],
                 dict(sample_weight=_u(rs, 4, 1, lo=0))), (0,)),
    ("hinge", "HingeLoss", {},
     lambda rs: ([_u(rs, 4, 5, lo=-2, hi=2), _signs(rs, 4, 5)], {}), (0,)),
    ("hinge-margin-weight-sw", "HingeLoss", dict(margin=0.5, weight=3.0),
     lambda rs: ([_u(rs, 4, 5, lo=-2, hi=2), _signs(rs, 4, 5)],
                 dict(sample_weight=_u(rs, 4, 1, lo=0))), (0,)),
    ("squared-hinge", "SquaredHingeLoss", dict(weight=3.0),
     lambda rs: ([_u(rs, 4, 5, lo=-2, hi=2), _signs(rs, 4, 5)],
                 dict(sample_weight=_u(rs, 4, 1, lo=0))), (0,)),
    ("logistic-signed", "LogisticLoss", {},
     lambda rs: ([_u(rs, 4, 5, lo=-4, hi=4), _signs(rs, 4, 5)], {}), (0,)),
    ("logistic-binary-sw", "LogisticLoss", dict(label_format="binary"),
     lambda rs: ([_u(rs, 4, 5, lo=-4, hi=4),
                  rs.randint(0, 2, (4, 5)).astype("f4")],
                 dict(sample_weight=_u(rs, 4, 1, lo=0))), (0,)),
    ("triplet", "TripletLoss", {},
     lambda rs: ([_u(rs, 4, 3, 2), _u(rs, 4, 3, 2), _u(rs, 4, 3, 2)], {}),
     (0, 1, 2)),
    ("triplet-margin", "TripletLoss", dict(margin=0.2),
     lambda rs: ([_u(rs, 6, 5), _u(rs, 6, 5), _u(rs, 6, 5)], {}), (0,)),
    ("poisson", "PoissonNLLLoss", {},
     lambda rs: ([_u(rs, 4, 5), rs.poisson(2.0, (4, 5)).astype("f4")], {}),
     (0,)),
    ("poisson-probs-full-sw", "PoissonNLLLoss",
     dict(from_logits=False, compute_full=True),
     lambda rs: ([_u(rs, 4, 5, lo=0.1, hi=4),
                  rs.poisson(2.0, (4, 5)).astype("f4")],
                 dict(sample_weight=_u(rs, 4, 1, lo=0))), (0,)),
    ("cosine", "CosineEmbeddingLoss", {},
     lambda rs: ([_u(rs, 6, 5), _u(rs, 6, 5), _signs(rs, 6)], {}), (0, 1)),
    ("cosine-margin", "CosineEmbeddingLoss", dict(margin=0.3),
     lambda rs: ([_u(rs, 6, 5), _u(rs, 6, 5), _signs(rs, 6, 1)], {}),
     (0,)),
    ("sdml", "SDMLLoss", {},
     lambda rs: ([_u(rs, 5, 4), _u(rs, 5, 4)], {}), (0, 1)),
    ("sdml-smoothing", "SDMLLoss", dict(smoothing_parameter=0.1),
     lambda rs: ([_u(rs, 5, 4), _u(rs, 5, 4)], {}), (0,)),
]


def loss_inputs(case):
    """A :data:`LOSS_CASES` entry's numpy ``(args, kwargs)``, from the
    seed ``len(id)``."""
    return case[3](np.random.RandomState(len(case[0])))


def loss_run(case, device):
    """A :data:`LOSS_CASES` entry through the port's loss on ``device``:
    its value (a ``LossValue``, whose ``backward()`` takes ones) and the
    gradients of its sum at the case's positions, as CPU tensors."""
    from .gluon import loss as gloss

    cid, name, ctor, _, grad_at = case
    args, kw = loss_inputs(case)
    ts = [torch.tensor(a, device=device) for a in args]
    for i in grad_at:
        ts[i].requires_grad_()
    out = getattr(gloss, name)(**ctor)(
        *ts, **{k: torch.tensor(v, device=device) for k, v in kw.items()})
    if not isinstance(out, gloss.LossValue):
        raise TypeError(f"{name} returned {type(out).__name__}, not a "
                        "LossValue")
    out.backward()                        # a head of ones, as NDArray's
    return [out.detach().cpu()] + [ts[i].grad.cpu() for i in grad_at]


# ------------------------------------------------------------ box ops
#: two valid ground truths of image 0 share their best anchor (0), and
#: three of image 1 share anchor 1: ``multibox_target``'s forced match
#: collides, and the JAX package's ordered scatter gives each anchor the
#: last gt index
COLLIDING_TARGETS = (
    np.array([[0.0, 0.0, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9],
              [0.0, 0.6, 0.3, 0.9], [0.55, 0.0, 0.95, 0.35]], "f4"),
    np.array([[[4.0, 0.05, 0.05, 0.3, 0.3], [-1, 0.6, 0.6, 0.9, 0.9],
               [7.0, 0.1, 0.1, 0.45, 0.45], [-1, 0, 0, 0, 0]],
              [[1.0, 0.62, 0.62, 0.88, 0.88], [2.0, 0.6, 0.6, 0.85, 0.85],
               [3.0, 0.65, 0.65, 0.9, 0.9], [0.0, 0.0, 0.62, 0.3, 0.9]]],
             "f4"))


def _corner_boxes(rs, *lead, hi=1.0, min_wh=0.02):
    xy = rs.uniform(0.0, hi * 0.8, size=lead + (2,))
    wh = rs.uniform(min_wh, hi * 0.4, size=lead + (2,))
    return np.concatenate([xy, xy + wh], -1).astype("f4")


def box_op_runs(seed=0, scale=1):
    """``{op name: fn(device) -> tuple of CPU tensors}``: every operator
    of ``ops.boxes`` that the SSD path and the ``npx`` wrappers run, on
    seeded inputs (numpy, so the same on every device); ``scale``
    multiplies the batch and box counts (1: a test's size; 8: about an
    SSD-512 batch's anchors for NMS)."""
    from .ops import boxes as bx

    rs = np.random.RandomState(seed)
    n_img, n_box = 2 * scale, 170 * scale
    anchors = bx.multibox_prior((8, 8), sizes=(0.2, 0.272),
                                ratios=(1, 2, 0.5)).numpy()
    labels = np.full((n_img, 6, 5), -1.0, "f4")
    for i in range(n_img):
        k = rs.randint(1, 7)
        labels[i, :k, 0] = rs.randint(0, 20, k)
        labels[i, :k, 1:] = _corner_boxes(rs, k)
    logits = rs.randn(n_img, 21, anchors.shape[0]).astype("f4") * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rs.randn(n_img, anchors.shape[0] * 4) * 0.5).astype("f4")
    rows = np.full((n_img, n_box, 6), -1.0, "f4")
    live = n_box * 2 // 3
    rows[:, :live, 0] = rs.randint(0, 4, (n_img, live))
    rows[:, :live, 1] = rs.choice([0.2, 0.5, 0.9], (n_img, live))
    rows[:, :live, 2:] = _corner_boxes(rs, n_img, live)
    data = rs.randn(n_img, 16, 24, 20).astype("f4")
    rois = np.concatenate([rs.randint(0, n_img, (12, 1)),
                           _corner_boxes(rs, 12, hi=40.0, min_wh=1.0)],
                          1).astype("f4")
    score = rs.rand(n_img, 9, 7).astype("f4")

    def on(a, dev):
        return torch.as_tensor(a).to(dev)

    def cpu(*ts):
        return tuple(t.cpu() for t in ts)

    return {
        "multibox_prior": lambda dev: cpu(bx.multibox_prior(
            (16, 16), sizes=(0.1, 0.141), ratios=(1, 2, 0.5), device=dev)),
        "multibox_target": lambda dev: cpu(*bx.multibox_target(
            on(anchors, dev), on(labels, dev))),
        "multibox_target_colliding": lambda dev: cpu(*bx.multibox_target(
            on(COLLIDING_TARGETS[0], dev), on(COLLIDING_TARGETS[1], dev))),
        "box_iou": lambda dev: cpu(bx.box_iou(on(anchors, dev),
                                              on(labels[..., 1:], dev))),
        "box_nms": lambda dev: cpu(bx.box_nms(on(rows, dev), id_index=0,
                                              topk=100 * scale)),
        "multibox_detection": lambda dev: cpu(bx.multibox_detection(
            on(prob, dev), on(loc, dev), on(anchors, dev))),
        "roi_align": lambda dev: cpu(bx.roi_align(
            on(data, dev), on(rois, dev), (4, 4), spatial_scale=0.5)),
        "bipartite_matching": lambda dev: cpu(*bx.bipartite_matching(
            on(score, dev))),
    }


def box_exact_parts(name, outs):
    """The parts of :func:`box_op_runs`'s ``name`` outputs that must
    agree exactly across devices: masks, classes and matched indices,
    and the class ids and -1 fill of NMS rows."""
    if name.startswith("multibox_target"):
        return [outs[1], outs[2]]
    if name == "bipartite_matching":
        return list(outs)
    if name in ("box_nms", "multibox_detection"):
        return [outs[0][..., 0], outs[0][..., 1] < 0]
    return []
