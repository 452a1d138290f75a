"""The decode path's LM carriers: the causal transformer LM with its KV
cache, and the stacked-LSTM LM whose cache is its recurrent state.

The port of ``TransformerLM`` and ``LSTMLM`` from
``mxnet_tpu/gluon/model_zoo/decoder.py``.  ``TransformerLM``: pre-norm decoder layers (fused QKV projection, exact-GELU
FFN), learned absolute positions, and an output head tied to the word
embedding plus ``out_bias``.  Parameter names match the JAX package's
``collect_params()`` names (``word_embed.weight``, ``position_weight``,
``layers.0.attention.qkv.weight``, ..., ``out_bias``).

One call serves both prefill (T = padded prompt chunk) and a decode step
(T = 1)::

    logits, cache = lm(tokens, cache, cache_len, n_tokens)

* ``tokens``    — (B, T) token ids.
* ``cache``     — one tuple per layer: ``(k, v)``, each (B, H, C, dh) in
  the model dtype, or with ``cache_dtype="int8"`` ``(k_q, k_scale, v_q,
  v_scale)``: int8 pages plus per-position f32 scales (B, H, C, 1).
  Every leaf has the capacity C on axis 2.

16 bits, as in the JAX package.  ``dtype=torch.bfloat16`` (or f16)
makes ``word_embed``, ``position_weight`` and the cache 16-bit and
leaves the decoder cells, ``ln_f`` and ``out_bias`` f32, so f32 queries
meet a 16-bit cache and the logits are f32; ``Block.cast`` makes every
parameter 16-bit but keeps the cache the constructor's type (an f32
cache under 16-bit queries, 16-bit logits); both together give a model,
cache and logits all in 16 bits.  Mixed operands promote as jnp does.
* ``cache_len`` — (B,) valid cache length per row BEFORE the call, a
  host array or a tensor; it is moved to the model's device and never
  read back, so the call can be captured as a CUDA graph.  Query ``i``
  sees cache positions ``<= cache_len + i``,
  so padded garbage past a row's true length is never attended.
* ``n_tokens``  — (B,) how many of the T tokens are real; the transformer
  needs no gating (masking is positional), so it is accepted and unused.

The forward runs under ``torch.no_grad`` (the model only serves; its
parameters are trainable tensors like every module's of the port).
The cache is updated IN PLACE (:func:`~mxnet_tpu_torch.ops.attention.
cache_append`) and the same tuple is returned.  A row with
``cache_len == 0`` is inert: it attends at most its own fresh token.

``LSTMLM`` keeps the same signature with ``cache`` = one ``(h, c)`` pair
of (B, U) tensors a layer: capacity-independent (``begin_cache``
ignores ``capacity``), so the decode tier never grows it.  It gates
every state update on ``step < n_tokens``, so padded prompt tokens never
reach the state, and returns a new cache tuple (the JAX carrier's
functional update); ``cache_len`` is unused.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...context import resolve_device
from ...ops import attention as _att
from ...ops import nn as _ops
from ..block import HybridBlock
from ..nn import Dense, Embedding, HybridSequential, LayerNorm
from ..parameter import with_init
from ..rnn import LSTMCell
from .bert import PositionwiseFFN

__all__ = ["CausalSelfAttentionCell", "TransformerDecoderCell",
           "TransformerLM", "LSTMLM", "transformer_lm", "lstm_lm"]


def _on_device(x, dtype, device):
    """A host array or a tensor as a tensor on ``device`` (of ``dtype``
    when given); a tensor already there is not copied."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(np.asarray(x))
    return x.to(device=device, dtype=dtype if dtype is not None else x.dtype)


class CausalSelfAttentionCell(HybridBlock):
    """Self-attention against the KV cache: fused QKV projection, append
    of the new keys/values at ``cache_len``, then decode attention through
    the hand-written kernel (``ops.attention.flash_attention_decode``)."""

    def __init__(self, units: int, num_heads: int, device=None,
                 dtype=torch.float32):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by heads {num_heads}")
        self._units = units
        self._num_heads = num_heads
        self._head_dim = units // num_heads
        self.qkv = Dense(3 * units, flatten=False, in_units=units,
                         device=device, dtype=dtype)
        self.proj = Dense(units, flatten=False, in_units=units, device=device,
                          dtype=dtype)

    def forward(self, x, layer_cache, lens):
        b, t = x.shape[0], x.shape[1]
        h, dh = self._num_heads, self._head_dim

        def heads(y):                       # (B, T, U) -> (B, H, T, dh)
            return y.reshape(b, t, h, dh).transpose(1, 2).contiguous()

        q, k, v = (heads(y) for y in self.qkv(x).split(self._units, dim=-1))
        if len(layer_cache) == 4:
            # int8 cache: quantize BEFORE the append — a raw float->int8
            # cast truncates instead of rounding to scale
            k_q, k_s, v_q, v_s = layer_cache
            kq, ks = _att.quantize_kv(k)
            vq, vs = _att.quantize_kv(v)
            for dst, src in ((k_q, kq), (k_s, ks), (v_q, vq), (v_s, vs)):
                _att.cache_append(dst, src, lens)
            out = _att.flash_attention_decode(q, k_q, v_q, lens,
                                              k_scale=k_s, v_scale=v_s)
        else:
            k_c, v_c = layer_cache
            _att.cache_append(k_c, k, lens)
            _att.cache_append(v_c, v, lens)
            out = _att.flash_attention_decode(q, k_c, v_c, lens)
        return self.proj(out.transpose(1, 2).reshape(b, t, self._units))


class TransformerDecoderCell(HybridBlock):
    """Pre-norm decoder layer: x + attn(ln(x)); x + ffn(ln(x))."""

    def __init__(self, units: int, hidden_size: int, num_heads: int,
                 layer_norm_eps: float = 1e-5, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.attention = CausalSelfAttentionCell(units, num_heads,
                                                 device=device, dtype=dtype)
        self.ffn = PositionwiseFFN(units, hidden_size, device=device,
                                   dtype=dtype)
        self.ln_att = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                device=device, dtype=dtype)
        self.ln_ffn = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                                device=device, dtype=dtype)

    def forward(self, x, layer_cache, lens):
        x = x + self.attention(self.ln_att(x), layer_cache, lens)
        return x + self.ffn(self.ln_ffn(x))


class TransformerLM(HybridBlock):
    """Causal transformer LM with an in-place KV cache (module docstring).

    Built on ``device`` (default ``cuda:0``; ``"cpu"`` only on request).
    Parameters start uninitialized: call :meth:`initialize` or load
    weights (``convert.load_into``)."""

    def __init__(self, vocab_size: int = 256, units: int = 128,
                 hidden_size: Optional[int] = None, num_layers: int = 2,
                 num_heads: int = 4, max_length: int = 2048,
                 layer_norm_eps: float = 1e-5, cache_dtype: Optional[str] = None,
                 device=None, dtype=torch.float32):
        super().__init__()
        if cache_dtype not in (None, "int8"):
            raise ValueError(
                f"cache_dtype={cache_dtype!r} unsupported; None (cache in "
                "the model dtype) or 'int8' (quantized KV pages with "
                "per-position scales)")
        dev = resolve_device(device)
        self._cache_dtype = cache_dtype
        self._vocab_size = vocab_size
        self._units = units
        self._num_layers = num_layers
        self._num_heads = num_heads
        self._head_dim = units // num_heads
        self._max_length = max_length
        self._dtype = dtype
        self.word_embed = Embedding(vocab_size, units, device=dev, dtype=dtype)
        self.position_weight = nn.Parameter(
            torch.empty(max_length, units, device=dev, dtype=dtype))
        # the cells, ln_f and out_bias stay f32 whatever ``dtype`` is, as
        # the JAX package builds them (module docstring)
        self.layers = nn.ModuleList(
            TransformerDecoderCell(units, hidden_size or 4 * units, num_heads,
                                   layer_norm_eps, device=dev)
            for _ in range(num_layers))
        self.ln_f = LayerNorm(epsilon=layer_norm_eps, in_channels=units,
                              device=dev)
        self.out_bias = with_init(nn.Parameter(
            torch.empty(vocab_size, device=dev)), "zeros")

    @property
    def device(self) -> torch.device:
        return self.out_bias.device

    def begin_cache(self, batch_size: int, capacity: int):
        """The zeroed cache for ``batch_size`` rows of ``capacity``."""
        shape = (batch_size, self._num_heads, capacity, self._head_dim)
        kw = dict(device=self.device)
        if self._cache_dtype == "int8":
            sshape = shape[:3] + (1,)
            return tuple((torch.zeros(shape, dtype=torch.int8, **kw),
                          torch.zeros(sshape, dtype=torch.float32, **kw),
                          torch.zeros(shape, dtype=torch.int8, **kw),
                          torch.zeros(sshape, dtype=torch.float32, **kw))
                         for _ in range(self._num_layers))
        return tuple((torch.zeros(shape, dtype=self._dtype, **kw),
                      torch.zeros(shape, dtype=self._dtype, **kw))
                     for _ in range(self._num_layers))

    @torch.no_grad()
    def forward(self, tokens, cache, cache_len, n_tokens=None):
        dev = self.device
        tokens = _on_device(tokens, torch.long, dev)
        # the lengths stay on the card: nothing here reads them back, so
        # a step and a prefill each capture as one CUDA graph
        lens = _on_device(cache_len, torch.int32, dev).reshape(-1)
        t = tokens.shape[1]
        # absolute position = cache_len + local offset; the clip keeps
        # padded garbage rows inside the table (their outputs are unread)
        pos = (lens[:, None].long() + torch.arange(t, device=dev)
               ).clamp_(0, self._max_length - 1)
        x = self.word_embed(tokens) + self.position_weight[pos]
        for cell, layer_cache in zip(self.layers, cache):
            x = cell(x, layer_cache, lens)
        logits = _ops.fully_connected(self.ln_f(x), self.word_embed.weight,
                                      self.out_bias, flatten=False)
        return logits, cache


class LSTMLM(HybridBlock):
    """Stacked-LSTM LM, the second decode carrier (module docstring):
    ``word_embed`` (V, U), ``cells.L`` (``rnn.LSTMCell(units,
    input_size=units)``), the output tied to ``word_embed.weight`` plus
    ``out_bias``; the JAX package's parameter names.  Built on ``device``
    (default ``cuda:0``; ``"cpu"`` only on request)."""

    def __init__(self, vocab_size: int = 256, units: int = 128,
                 num_layers: int = 2, dtype=torch.float32, device=None):
        super().__init__()
        dev = resolve_device(device)
        self._vocab_size = vocab_size
        self._units = units
        self._num_layers = num_layers
        self._dtype = dtype
        self.word_embed = Embedding(vocab_size, units, dtype=dtype,
                                    device=dev)
        self.cells = HybridSequential()          # container only; iterated
        for _ in range(num_layers):
            self.cells.add(LSTMCell(units, input_size=units, device=dev))
        self.out_bias = with_init(nn.Parameter(
            torch.empty(vocab_size, device=dev)), "zeros")

    @property
    def device(self) -> torch.device:
        return self.out_bias.device

    def begin_cache(self, batch_size: int, capacity: int = 0):
        """The zeroed ``(h, c)`` of every layer for ``batch_size`` rows;
        ``capacity`` is ignored (the state is the whole history)."""
        return tuple(tuple(torch.zeros(batch_size, self._units,
                                       dtype=self._dtype, device=self.device)
                           for _ in range(2))
                     for _ in range(self._num_layers))

    def forward(self, tokens, cache, cache_len, n_tokens):
        dev = self.device
        tokens = _on_device(tokens, torch.long, dev)
        t = tokens.shape[1]
        n_tokens = _on_device(n_tokens, None, dev).reshape(-1, 1)
        emb = self.word_embed(tokens)                       # (B, T, U)
        states = [list(pair) for pair in cache]
        outs = []
        for step in range(t):
            x = emb[:, step]                                # (B, U)
            upd = n_tokens > step                           # (B, 1)
            for li, cell in enumerate(self.cells):
                h_old, c_old = states[li]
                _, (h_new, c_new) = cell(x, [h_old, c_old])
                states[li] = [torch.where(upd, h_new, h_old),
                              torch.where(upd, c_new, c_old)]
                x = states[li][0]
            outs.append(x)
        hid = torch.stack(outs, dim=1)                      # (B, T, U)
        logits = _ops.fully_connected(hid, self.word_embed.weight,
                                      self.out_bias, flatten=False)
        return logits, tuple((h, c) for h, c in states)


def transformer_lm(**kwargs) -> TransformerLM:
    """Causal transformer LM (decode-path carrier); ``device`` defaults to
    ``cuda:0``."""
    return TransformerLM(**kwargs)


def lstm_lm(**kwargs) -> LSTMLM:
    """Stacked-LSTM LM (decode-path carrier); ``device`` defaults to
    ``cuda:0``."""
    return LSTMLM(**kwargs)
