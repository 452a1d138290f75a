"""The port's flash attention against the JAX package, on the CPU.

Both packages get the same inputs, made with numpy from a seed.  The
port's ``flash_attention`` on CPU tensors runs its plain version (the
CUDA kernel is held against that plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``); the JAX side
runs its dispatch (the reference on the CPU) and its Pallas kernel
``_flash_forward_pallas`` in interpret mode, as
``tests/test_flash_kernel.py`` does.  Tolerance ``rtol = atol = 2e-5``,
the bar of ``tests/test_flash_kernel.py`` (f32, different summation
order).  The row log-sum-exp is compared against the interpret kernel,
the one JAX function that returns it.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import numpy_extension as jnpx
from mxnet_tpu.ops import attention as jatt
from mxnet_tpu_torch import numpy_extension as tnpx
from mxnet_tpu_torch.ops import attention as tatt

TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(b, h, tq, tk, d, seed):
    rs = np.random.RandomState(seed)
    return ((rs.rand(b, h, tq, d) - 0.5).astype("float32"),
            (rs.rand(b, h, tk, d) - 0.5).astype("float32"),
            (rs.rand(b, h, tk, d) - 0.5).astype("float32"))


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


CASES = {
    "dense": dict(t=32, d=8, causal=False, lens=None),
    "causal": dict(t=32, d=16, causal=True, lens=None),
    "kv_len": dict(t=32, d=8, causal=False, lens=[0, 13, 32]),
    "causal_kv_len": dict(t=16, d=8, causal=True, lens=[10, 0, 16]),
    "kv_len_block_edges": dict(t=64, d=8, causal=False, lens=[1, 8, 9]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attention_matches_jax(name):
    c = CASES[name]
    b = 3 if c["lens"] is not None else 2
    q, k, v = _qkv(b, 2, c["t"], c["t"], c["d"], seed=len(name))
    lens = None if c["lens"] is None else np.asarray(c["lens"], np.int32)
    scale = 1.0 / np.sqrt(c["d"])
    got, got_lse = tatt.flash_attention(
        _t(q), _t(k), _t(v), causal=c["causal"], kv_valid_length=_t(lens),
        return_lse=True)
    want = jatt.flash_attention(_j(q), _j(k), _j(v), causal=c["causal"],
                                kv_valid_length=_j(lens))
    kern, kern_lse = jatt._flash_forward_pallas(
        _j(q), _j(k), _j(v), causal=c["causal"], scale=scale,
        kv_len=_j(lens), interpret=True, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                               err_msg="dispatch")
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL,
                               err_msg="interpret kernel")
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(kern_lse), **TOL,
                               err_msg="interpret kernel lse")
    if lens is not None and 0 in c["lens"]:
        empty = c["lens"].index(0)
        assert (got[empty] == 0).all()
        assert torch.isneginf(got_lse[empty]).all()


@pytest.mark.parametrize("tq,tk,causal", [(13, 13, False), (7, 21, True),
                                          (21, 5, False)])
def test_flash_attention_untileable_lengths_match_dispatch(tq, tk, causal):
    # T not a multiple of 8: the JAX package runs its reference here (the
    # Pallas kernel cannot tile it); the port's kernel takes any T
    q, k, v = _qkv(2, 3, tq, tk, 8, seed=tq + tk)
    lens = np.asarray([tk, max(1, tk // 2)], np.int32)
    got = tatt.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               kv_valid_length=_t(lens))
    want = jatt.flash_attention(_j(q), _j(k), _j(v), causal=causal,
                                kv_valid_length=_j(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["dense", "causal"])
@pytest.mark.parametrize("d", [4, 36, 100, 320, 512])
def test_flash_attention_any_head_width_matches_jax(d, causal):
    """d not a multiple of 8 (the JAX package runs its jnp path there, the
    port's kernel pads its shared rows): output and lse against JAX."""
    q, k, v = _qkv(3, 2, 19, 19, d, seed=d + causal)
    lens = np.asarray([19, 0, 7], np.int32)
    got, got_lse = tatt.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                        kv_valid_length=_t(lens),
                                        return_lse=True)
    want = jatt.flash_attention(_j(q), _j(k), _j(v), causal=causal,
                                kv_valid_length=_j(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    m = jatt._merge_mask(None, _j(lens), 19, 19, causal)
    logits = jnp.einsum("bhqd,bhkd->bhqk", _j(q), _j(k)) / np.sqrt(d)
    want_lse = jax.nn.logsumexp(jnp.where(m, logits, -jnp.inf), axis=-1)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), **TOL)


def test_flash_attention_general_mask_runs_the_reference():
    q, k, v = _qkv(2, 2, 16, 16, 8, seed=9)
    rs = np.random.RandomState(1)
    mask = rs.rand(2, 1, 16, 16) > 0.3
    mask[:, :, :, 0] = True                 # no empty row
    got = tatt.flash_attention(_t(q), _t(k), _t(v), mask=_t(mask),
                               causal=True)
    want = jatt.flash_attention(_j(q), _j(k), _j(v), mask=_j(mask),
                                causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_multi_head_attention_matches_npx():
    rs = np.random.RandomState(4)
    b, t, heads, d = 2, 16, 4, 8
    q, k, v = ((rs.rand(b, t, heads * d) - 0.5).astype("float32")
               for _ in range(3))
    lens = np.asarray([16, 5], np.int32)
    got = tnpx.multi_head_attention(_t(q), _t(k), _t(v), num_heads=heads,
                                    valid_length=_t(lens))
    want = jnpx.multi_head_attention(
        mx.nd.NDArray(q), mx.nd.NDArray(k), mx.nd.NDArray(v),
        num_heads=heads, valid_length=mx.nd.NDArray(lens))
    np.testing.assert_allclose(got.numpy(), want.asnumpy(), **TOL)
    with pytest.raises(Exception, match="divisible"):
        tnpx.multi_head_attention(_t(q), _t(k), _t(v), num_heads=3)
