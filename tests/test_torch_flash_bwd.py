"""The port's flash-attention backward against the JAX package, on the CPU.

Both packages get the same inputs, made with numpy from a seed.  The
port's ``flash_attention_bwd`` on CPU tensors runs its plain version
``flash_attention_bwd_reference`` (the two CUDA kernels are held
against it on the card by ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py``).  The JAX side runs its Pallas
kernels ``flash_attention_bwd_pallas`` in interpret mode on the forward
kernel's ``(out, lse)`` (interpret mode too), as
``tests/test_flash_kernel.py`` does; where T is not a multiple of 8 the
JAX kernels do not apply and the reference is ``jax.grad`` of
``attention_reference``.  The autograd path (``torch.autograd.grad``
through the port's ``flash_attention``) is held against ``jax.grad``
through the JAX ``flash_attention`` under ``kreg.override("interpret")``.
Tolerance ``rtol = atol = 2e-5``, the bar of ``tests/test_flash_kernel.py``
(f32, different summation order).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.kernels import registry as jkreg
from mxnet_tpu.kernels.flash_bwd import flash_attention_bwd_pallas
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu_torch.kernels import flash_bwd as tfb
from mxnet_tpu_torch.ops import attention as tatt

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(b, h, t, d, seed):
    rs = np.random.RandomState(seed)
    return tuple((rs.rand(b, h, t, d) - 0.5).astype("float32")
                 for _ in range(4))


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


CASES = {
    "dense": dict(t=32, d=8, causal=False, lens=None),
    "causal": dict(t=32, d=16, causal=True, lens=None),
    "kv_len_empty_row": dict(t=32, d=8, causal=False, lens=[0, 13, 32]),
    "causal_kv_len": dict(t=16, d=8, causal=True, lens=[10, 0, 16]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bwd_reference_matches_pallas_kernels(name):
    c = CASES[name]
    b = 3 if c["lens"] is not None else 2
    q, k, v, g = _inputs(b, 2, c["t"], c["d"], seed=len(name))
    lens = None if c["lens"] is None else np.asarray(c["lens"], np.int32)
    jl = None if lens is None else jnp.asarray(lens)
    scale = 1.0 / np.sqrt(c["d"])
    out, lse = jatt._flash_forward_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), c["causal"], scale,
        kv_len=jl, interpret=True, return_lse=True)
    bq = jatt._pick_block(c["t"])
    want = flash_attention_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(g),
        out, lse, jl, c["causal"], scale, bq=bq, bk=bq, interpret=True)
    got = tfb.flash_attention_bwd(
        _t(q), _t(k), _t(v), _t(g), _t(out), _t(lse), _t(lens),
        causal=c["causal"], scale=scale)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
    if lens is not None:
        for r, n in enumerate(lens):           # exact zeros past lengths
            assert not got[1][r, :, n:].any() and not got[2][r, :, n:].any()
            if n == 0:
                assert not got[0][r].any()


@pytest.mark.parametrize("causal", [False, True], ids=["dense", "causal"])
def test_bwd_reference_ragged_t_matches_jax_grad(causal):
    """T = 13, not a multiple of 8: the JAX kernels do not take it; the
    reference is ``jax.grad`` of ``attention_reference``."""
    t, d = 13, 8
    q, k, v, g = _inputs(2, 3, t, d, seed=40 + causal)
    lens = np.asarray([5, 13], np.int32)
    scale = 1.0 / np.sqrt(d)
    m = jatt._merge_mask(None, jnp.asarray(lens), t, t, causal)

    def f(q_, k_, v_):
        return (jatt.attention_reference(q_, k_, v_, mask=m, scale=scale)
                * jnp.asarray(g)).sum()

    want = jax.grad(f, (0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out, lse = tatt.flash_attention(tq, tk, tv, causal=causal, scale=scale,
                                    kv_valid_length=_t(lens),
                                    return_lse=True)
    got = tfb.flash_attention_bwd(tq, tk, tv, _t(g), out, lse, _t(lens),
                                  causal, scale)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["dense", "causal"])
@pytest.mark.parametrize("d", [4, 36, 100, 320, 512])
def test_bwd_reference_any_head_width_matches_jax_grad(d, causal):
    """d not a multiple of 8, which the JAX kernels do not take: the
    reference is ``jax.grad`` of ``attention_reference`` (its jnp path),
    with an empty row and a short one."""
    t = 21
    q, k, v, g = _inputs(3, 2, t, d, seed=d + causal)
    lens = np.asarray([t, 0, 6], np.int32)
    scale = 1.0 / np.sqrt(d)
    m = jatt._merge_mask(None, jnp.asarray(lens), t, t, causal)

    def f(q_, k_, v_):
        return (jatt.attention_reference(q_, k_, v_, mask=m, scale=scale)
                * jnp.asarray(g)).sum()

    want = jax.grad(f, (0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v))
    tq, tk, tv = _t(q), _t(k), _t(v)
    out, lse = tatt.flash_attention(tq, tk, tv, causal=causal,
                                    kv_valid_length=_t(lens),
                                    return_lse=True)
    got = tfb.flash_attention_bwd(tq, tk, tv, _t(g), out, lse, _t(lens),
                                  causal)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)
    assert not got[0][1].any() and not got[1][1].any()   # the empty row


@pytest.mark.parametrize("causal,with_len", [(False, False), (True, False),
                                             (False, True), (True, True)])
def test_autograd_through_flash_attention_matches_jax(causal, with_len):
    b, h, t, d = 2, 2, 32, 8
    q, k, v, g = _inputs(b, h, t, d, seed=60 + 2 * causal + with_len)
    lens = np.asarray([20, 0], np.int32) if with_len else None

    with jkreg.override("interpret"):
        def f(q_, k_, v_):
            out = jatt.flash_attention(
                q_, k_, v_, causal=causal,
                kv_valid_length=None if lens is None else jnp.asarray(lens))
            return (out * jnp.asarray(g)).sum()

        want = jax.grad(f, (0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v))
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    out = tatt.flash_attention(*leaves, causal=causal,
                               kv_valid_length=_t(lens))
    got = torch.autograd.grad(out, leaves, _t(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL)


def test_autograd_function_saves_lse_and_returns_it_without_grad():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, 9, 8, seed=3))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = tatt.flash_attention(*leaves, return_lse=True)
    assert out.grad_fn is not None and not lse.requires_grad
    ref, ref_lse = tatt.flash_attention_reference(q, k, v, return_lse=True)
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=0)
    # without grad, nothing is recorded: serving keeps no graph
    with torch.no_grad():
        assert tatt.flash_attention(*leaves).grad_fn is None


def test_bwd_refuses_other_devices_and_bad_shapes():
    from mxnet_tpu_torch.base import MXNetError

    x = torch.zeros(1, 1, 4, 8, device="meta")
    lse = torch.zeros(1, 1, 4, device="meta")
    with pytest.raises(MXNetError):
        tfb.flash_attention_bwd(x, x, x, x, x, lse)
    ok = torch.zeros(1, 1, 4, 264)                   # any width runs
    tfb._check_args(ok, ok, ok, ok, ok, torch.zeros(1, 1, 4), None)
    empty = torch.zeros(1, 1, 0, 264)                # no key: refused
    with pytest.raises(MXNetError):
        tfb._check_args(ok, empty, empty, ok, ok, torch.zeros(1, 1, 4), None)
    with pytest.raises(MXNetError):                  # not f32
        tfb._check_args(ok.double(), ok, ok, ok, ok, torch.zeros(1, 1, 4),
                        None)
