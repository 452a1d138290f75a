"""``save`` / ``load``: the port's copy of the JAX package's array file
format (``mxnet_tpu/ndarray/utils.py:19-130``), for dense tensors.

A file is a numpy ``.npz``: the magic key ``__mxnet_tpu_nd_format__``
holds ``"list"`` or ``"dict"``, and each array is stored under
``arr:<i>`` (a list) or ``key:<name>`` (a dict).  bfloat16, which numpy
lacks, is stored as its bits in uint16 under the key with the suffix
``::bfloat16``.  So a file written by either package loads into the
other.  The JAX package's sparse entries (``::rsp::`` / ``::csr::``) are
not read here.
"""
from __future__ import annotations

from typing import Dict, List, Union

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["save", "load"]

_MAGIC_KEY = "__mxnet_tpu_nd_format__"
_BF16_SUFFIX = "::bfloat16"


def _put(payload, key, a):
    if "::" in key:
        raise MXNetError(f"'::' is reserved in save keys: {key!r}")
    if not torch.is_tensor(a):
        raise MXNetError(f"save expects tensors, got {type(a)}")
    a = a.detach().cpu()
    if a.dtype == torch.bfloat16:
        payload[key + _BF16_SUFFIX] = a.view(torch.int16).numpy().view(
            np.uint16)
    else:
        payload[key] = a.numpy()


def save(fname: str, data: Union[torch.Tensor, List[torch.Tensor],
                                 Dict[str, torch.Tensor]]):
    """Save one tensor, a list, or a ``{str: tensor}`` dict."""
    payload = {}
    if torch.is_tensor(data):
        data = [data]
    if isinstance(data, (list, tuple)):
        payload[_MAGIC_KEY] = np.array("list")
        for i, a in enumerate(data):
            _put(payload, f"arr:{i}", a)
    elif isinstance(data, dict):
        payload[_MAGIC_KEY] = np.array("dict")
        for k, a in data.items():
            _put(payload, f"key:{k}", a)
    else:
        raise MXNetError(f"save expects a tensor, list or dict, got "
                         f"{type(data)}")
    with open(fname, "wb") as f:
        np.savez(f, **payload)


def _entry(z, key) -> torch.Tensor:
    a = z[key]
    if key.endswith(_BF16_SUFFIX):
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def load(fname: str):
    """What :func:`save` (of either package) wrote: a list or a dict of
    CPU tensors."""
    with np.load(fname, allow_pickle=False) as z:
        if _MAGIC_KEY not in z.files:
            raise MXNetError(f"{fname} is not an mxnet_tpu array file")
        kind = str(z[_MAGIC_KEY])
        entries = {}
        for key in z.files:
            if key == _MAGIC_KEY:
                continue
            base = key.split("::")[0]
            if key != base and not key.endswith(_BF16_SUFFIX):
                raise MXNetError(f"{fname}: entry {key!r} (a sparse array) "
                                 "is not read by the port")
            entries[base] = _entry(z, key)
    if kind == "list":
        return [entries[k] for k in sorted(entries,
                                           key=lambda b: int(b[4:]))]
    return {base.split(":", 1)[1]: a for base, a in entries.items()}
