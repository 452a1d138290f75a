"""Seeded initialization of the port's model zoo.

The JAX package initializes with ``mx.init.Xavier()`` from its global
key; a torch generator gives other numbers from the same seed, so the
port has one rule of its own, shared by every zoo family
(``TransformerLM``, the BERT family, the vision zoo) and the same for a
seed on every device.  Parity tests carry weights over with
``convert.load_into`` instead.
"""
from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["seeded_init"]


def _fans(module: nn.Module, p: torch.Tensor):
    """``(fan_in, fan_out)`` of a weight: (out, in) for 2-D; for a 4-D
    convolution weight, ``fan_in = kh * kw * in`` and ``fan_out = out *
    kh * kw`` in either of the JAX package's layouts (OHWI for
    channel-last, OIHW otherwise)."""
    if p.ndim == 2:
        return p.shape[1], p.shape[0]
    if getattr(module, "_channel_last", False):
        o, kh, kw, i = p.shape
    else:
        o, i, kh, kw = p.shape
    return kh * kw * i, o * kh * kw


@torch.no_grad()
def seeded_init(module: nn.Module, seed: int):
    """Seeded random weights: Xavier-uniform (magnitude 3, fan average)
    for every 2-D and 4-D weight, zero biases and betas, unit gammas
    (a ``LayerNorm``'s ``fills`` where its initializers differ);
    BatchNorm's running mean 0 and variance 1.  Drawn on the CPU from a
    ``torch.Generator`` in parameter order, then copied to the model's
    device."""
    gen = torch.Generator().manual_seed(int(seed))
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if p.ndim in (2, 4):
                fan_in, fan_out = _fans(mod, p)
                bound = math.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
                w = torch.rand(p.shape, generator=gen, dtype=torch.float32)
                p.copy_((w * 2.0 - 1.0) * bound)
            else:     # gamma 1, beta and biases 0, or the layer's fills
                p.fill_(getattr(mod, "fills", {}).get(
                    name, 1.0 if name == "gamma" else 0.0))
        for name, b in mod.named_buffers(recurse=False):
            b.fill_(1.0 if name == "running_var" else 0.0)
    return module
