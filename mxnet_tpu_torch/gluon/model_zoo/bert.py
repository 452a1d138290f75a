"""The BERT model family (transformer encoder), its pretraining heads,
and the FFN block the decoder layers share with it.

The port of ``mxnet_tpu/gluon/model_zoo/bert.py``:

  * attention runs through ``npx.multi_head_attention`` -> the
    hand-written flash kernel (``ops.attention.flash_attention``), with
    the fused QKV projection and each row's ``valid_length`` as the key
    length, so a padded batch never attends its padding; in training the
    kernel's backward is the hand-written dq and dk/dv pair;
  * post-norm encoder layers (LayerNorm eps 1e-12), exact-GELU FFN,
    learned absolute positions and a tanh pooler over the first token;
  * :class:`BERTForPretrain`: masked-LM head (erf-GELU transform,
    LayerNorm, decoder tied to ``word_embed.weight`` plus ``mlm_bias``)
    over the gathered masked positions, and the next-sentence head.

Parameter names equal the JAX package's ``collect_params()`` names
(``word_embed.weight``, ``token_type_embed.weight``, ``position_weight``,
``embed_layer_norm.gamma``, ``encoder.layers.0.attention.qkv.weight``,
..., ``pooler.bias``; under ``BERTForPretrain`` the same with a ``bert.``
prefix, plus ``mlm_transform.*``, ``mlm_layer_norm.*``, ``mlm_bias`` and
``nsp.*``), so ``convert.load_into`` maps them one to one.  Models are
built on ``cuda:0`` unless ``device="cpu"`` is passed.  Dropout runs
only inside ``autograd.record()``: serving runs none, and a trainer's
step enters the scope.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ... import numpy_extension as npx
from ...context import resolve_device
from ...ops import nn as _ops
from ..block import HybridBlock
from ..loss import SoftmaxCrossEntropyLoss
from ..nn import Dense, Dropout, Embedding, LayerNorm

__all__ = ["BERTEncoder", "BERTModel", "BERTForPretrain",
           "MultiHeadAttentionCell", "PositionwiseFFN",
           "TransformerEncoderCell", "get_bert", "bert_12_768_12",
           "bert_24_1024_16", "pretrain_loss"]


class MultiHeadAttentionCell(HybridBlock):
    """Self-attention with a fused QKV projection and flash attention."""

    def __init__(self, units: int, num_heads: int, dropout: float = 0.0,
                 device=None, dtype=torch.float32):
        super().__init__()
        if units % num_heads:
            raise ValueError(f"units {units} not divisible by heads {num_heads}")
        self._units = units
        self._num_heads = num_heads
        self.qkv = Dense(3 * units, flatten=False, in_units=units,
                         device=device, dtype=dtype)
        self.proj = Dense(units, flatten=False, in_units=units, device=device,
                          dtype=dtype)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x, mask=None, valid_length=None):
        q, k, v = self.qkv(x).split(self._units, dim=-1)
        out = npx.multi_head_attention(q, k, v, num_heads=self._num_heads,
                                       mask=mask, valid_length=valid_length)
        out = self.proj(out)
        if self.dropout is not None:
            out = self.dropout(out)
        return out


class PositionwiseFFN(HybridBlock):
    """Transformer FFN block: Dense -> exact GELU -> Dense (``ffn1`` /
    ``ffn2``)."""

    def __init__(self, units: int, hidden_size: int, dropout: float = 0.0,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.ffn1 = Dense(hidden_size, flatten=False, in_units=units,
                          device=device, dtype=dtype)
        self.ffn2 = Dense(units, flatten=False, in_units=hidden_size,
                          device=device, dtype=dtype)
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        h = self.ffn2(_ops.erf_gelu(self.ffn1(x)))
        if self.dropout is not None:
            h = self.dropout(h)
        return h


class TransformerEncoderCell(HybridBlock):
    """Post-norm transformer encoder layer (BERT style)."""

    def __init__(self, units: int, hidden_size: int, num_heads: int,
                 dropout: float = 0.0, layer_norm_eps: float = 1e-12,
                 device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attention = MultiHeadAttentionCell(units, num_heads,
                                                dropout=dropout, **kw)
        self.ffn = PositionwiseFFN(units, hidden_size, dropout=dropout, **kw)
        self.layer_norm_att = LayerNorm(epsilon=layer_norm_eps,
                                        in_channels=units, **kw)
        self.layer_norm_ffn = LayerNorm(epsilon=layer_norm_eps,
                                        in_channels=units, **kw)

    def forward(self, x, mask=None, valid_length=None):
        x = self.layer_norm_att(x + self.attention(x, mask, valid_length))
        return self.layer_norm_ffn(x + self.ffn(x))


class BERTEncoder(HybridBlock):
    """Stack of transformer encoder cells."""

    def __init__(self, num_layers: int = 12, units: int = 768,
                 hidden_size: int = 3072, num_heads: int = 12,
                 dropout: float = 0.1, layer_norm_eps: float = 1e-12,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderCell(units, hidden_size, num_heads,
                                   dropout=dropout,
                                   layer_norm_eps=layer_norm_eps,
                                   device=device, dtype=dtype)
            for _ in range(num_layers))

    def forward(self, x, mask=None, valid_length=None):
        for cell in self.layers:
            x = cell(x, mask, valid_length)
        return x


def _on(x, device, dtype):
    """Host array or tensor -> tensor of ``dtype`` on ``device``."""
    if not torch.is_tensor(x):
        x = np.asarray(x)
    return torch.as_tensor(x, device=device).to(dtype)


class BERTModel(HybridBlock):
    """BERT backbone: embeddings + encoder + pooler.

    ``forward(inputs, token_types=None, valid_length=None)`` ->
    ``(sequence_output (B, T, U), pooled_output (B, U))``.  ``inputs`` and
    ``token_types`` are (B, T) ids and ``valid_length`` (B,) lengths, as
    host arrays or tensors; a row attends only its first
    ``valid_length`` positions, so its outputs do not depend on padding.

    Built on ``device`` (default ``cuda:0``); parameters
    start uninitialized: call :meth:`initialize` or load weights
    (``convert.load_into``).  ``dtype`` is that of the word, token-type
    and position embeddings, as in the JAX package; every other layer is
    f32, so bf16 embeddings meet the f32 embedding LayerNorm and the
    encoder runs in f32.  Training in 16 bits is the trainer's
    ``compute_dtype``, which casts every parameter for the step."""

    def __init__(self, vocab_size: int = 30522, token_type_vocab_size: int = 2,
                 units: int = 768, hidden_size: int = 3072,
                 num_layers: int = 12, num_heads: int = 12,
                 max_length: int = 512, dropout: float = 0.1,
                 layer_norm_eps: float = 1e-12, device=None,
                 dtype=torch.float32):
        super().__init__()
        dev = resolve_device(device)
        emb = dict(device=dev, dtype=dtype)
        kw = dict(device=dev, dtype=torch.float32)
        self._units = units
        self._max_length = max_length
        self.word_embed = Embedding(vocab_size, units, **emb)
        self.token_type_embed = Embedding(token_type_vocab_size, units, **emb)
        self.position_weight = nn.Parameter(
            torch.empty(max_length, units, **emb))
        self.embed_layer_norm = LayerNorm(epsilon=layer_norm_eps,
                                          in_channels=units, **kw)
        self.embed_dropout = Dropout(dropout) if dropout else None
        self.encoder = BERTEncoder(num_layers=num_layers, units=units,
                                   hidden_size=hidden_size,
                                   num_heads=num_heads, dropout=dropout,
                                   layer_norm_eps=layer_norm_eps, **kw)
        self.pooler = Dense(units, activation="tanh", flatten=False,
                            in_units=units, **kw)

    @property
    def device(self) -> torch.device:
        return self.position_weight.device

    def forward(self, inputs, token_types=None, valid_length=None):
        dev = self.device
        inputs = _on(inputs, dev, torch.long)
        seq_len = inputs.shape[1]
        if seq_len > self._max_length:
            raise ValueError(
                f"sequence length {seq_len} exceeds max_length "
                f"{self._max_length} this BERTModel was built with")
        emb = self.word_embed(inputs)
        if token_types is not None:
            emb = emb + self.token_type_embed(_on(token_types, dev,
                                                  torch.long))
        emb = emb + self.position_weight[:seq_len][None]
        emb = self.embed_layer_norm(emb)
        if self.embed_dropout is not None:
            emb = self.embed_dropout(emb)
        if valid_length is not None:
            # one device copy of the lengths for all layers' kernels
            valid_length = _on(valid_length, dev, torch.int32).reshape(-1)
        out = self.encoder(emb, None, valid_length)
        pooled = self.pooler(out[:, 0])
        return out, pooled


class BERTForPretrain(HybridBlock):
    """Masked-LM + next-sentence-prediction heads over a :class:`BERTModel`.

    ``forward(inputs, token_types=None, valid_length=None,
    masked_positions=None)`` -> ``(mlm_scores (B, P, V), nsp_scores
    (B, 2))``; without ``masked_positions`` the MLM head scores every
    position (P = T).  The MLM decoder is tied to the word-embedding
    matrix: it has no weight of its own, only ``mlm_bias``, so
    ``bert.word_embed.weight`` gets gradient from the embedding gather
    and from the decoder.  Built on the backbone's device."""

    def __init__(self, bert: BERTModel, vocab_size=None):
        super().__init__()
        self.bert = bert
        self._vocab_size = vocab_size or bert.word_embed.weight.shape[0]
        units = bert._units
        kw = dict(device=bert.device, dtype=torch.float32)
        # exact erf GELU, as in the JAX package (BERT semantics)
        self.mlm_transform = Dense(units, activation="erf_gelu",
                                   flatten=False, in_units=units, **kw)
        self.mlm_layer_norm = LayerNorm(epsilon=1e-12, in_channels=units,
                                        **kw)
        self.mlm_bias = nn.Parameter(torch.zeros(self._vocab_size, **kw))
        self.nsp = Dense(2, flatten=False, in_units=units, **kw)

    @property
    def device(self) -> torch.device:
        return self.bert.device

    def forward(self, inputs, token_types=None, valid_length=None,
                masked_positions=None):
        seq_out, pooled = self.bert(inputs, token_types, valid_length)
        nsp_scores = self.nsp(pooled)
        if masked_positions is None:
            hidden = seq_out
        else:
            idx = _on(masked_positions, self.device, torch.long)
            idx = idx.reshape(idx.shape[0], -1, 1).expand(
                -1, -1, seq_out.shape[-1])
            hidden = torch.gather(seq_out, 1, idx)          # (B, P, U)
        h = self.mlm_layer_norm(self.mlm_transform(hidden))
        scores = _ops.fully_connected(h, self.bert.word_embed.weight,
                                      self.mlm_bias, flatten=False)
        return scores, nsp_scores


def pretrain_loss(pred, label):
    """BERT's pretraining loss per row, as ``bench.py``'s
    ``bench_bert_base`` defines it: the masked-LM cross entropy averaged
    over a row's masked positions plus the next-sentence cross entropy.
    ``pred`` is ``(mlm_scores (B, P, V), nsp_scores (B, 2))`` and
    ``label`` ``(mlm_labels (B, P), nsp_labels (B,))``; returns (B,) f32:
    like the bench's loss, it casts the scores to f32 before the
    ``log_softmax``, so 16-bit scores give an f32 loss."""
    ce = SoftmaxCrossEntropyLoss()
    (mlm_scores, nsp_scores), (mlm_y, nsp_y) = pred, label
    return ce(mlm_scores.float(), mlm_y) + ce(nsp_scores.float(), nsp_y)


_BERT_SPECS = {
    "bert_12_768_12": dict(num_layers=12, units=768, hidden_size=3072,
                           num_heads=12),
    "bert_24_1024_16": dict(num_layers=24, units=1024, hidden_size=4096,
                            num_heads=16),
}


def get_bert(name: str = "bert_12_768_12", vocab_size: int = 30522,
             max_length: int = 512, dropout: float = 0.1,
             **kwargs) -> BERTModel:
    """A :class:`BERTModel` of the named published size; keyword
    arguments override the spec (``num_layers``, ``units``, ...) and pass
    ``device`` / ``dtype`` through."""
    spec = dict(_BERT_SPECS[name])
    spec.update(kwargs)
    return BERTModel(vocab_size=vocab_size, max_length=max_length,
                     dropout=dropout, **spec)


def bert_12_768_12(**kwargs) -> BERTModel:
    """BERT-base: 12 layers, 768 units, FFN 3072, 12 heads."""
    return get_bert("bert_12_768_12", **kwargs)


def bert_24_1024_16(**kwargs) -> BERTModel:
    """BERT-large: 24 layers, 1024 units, FFN 4096, 16 heads."""
    return get_bert("bert_24_1024_16", **kwargs)
