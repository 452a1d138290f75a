"""Serving tier of the port: batch serving with continuous coalescing
(``Server`` over a ``Registry``) and generative decode with token-level
continuous batching (``serve.decode``).

Batch quick start::

    import numpy as np
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch.gluon.model_zoo import bert_12_768_12

    mx.random.seed(0)
    bert = bert_12_768_12(dropout=0.0).initialize(mx.init.Xavier())  # cuda:0
    serve.register("bert", bert,
                   bucketer={0: [1, 2, 4, 8, 16], 1: ("pow2", 32, 512)},
                   sample=(np.zeros(32, "int32"), np.zeros(32, "int32"),
                           np.asarray(32, "int32")))
    seq, pooled = serve.predict("bert", tokens, token_types,
                                np.asarray(len(tokens), "int32"),
                                timeout=5.0)

Module-level calls ride one lazily created default :class:`Server` over
the process-global registry; construct :class:`Server` directly for
other bounds or an isolated registry.  Env knobs:
``MXNET_SERVE_MAX_WAIT_MS`` (5), ``MXNET_SERVE_MAX_BATCH`` (32),
``MXNET_SERVE_QUEUE_MAX`` (1024), ``MXNET_SERVE_MAX_INFLIGHT`` (2).
"""
from __future__ import annotations

import threading
from typing import Optional

from .coalescer import (ClosedError, DeadlineError, RejectedError, Request,
                        RequestQueue, ServeFuture)
from .decode import (DecodeEntry, DecodeFuture, DecodeServer, TokenRangeError,
                     decode_server, decode_submit, generate, register_decode,
                     shutdown_decode)
from .registry import ModelEntry, Registry, default_registry
from .server import Server

__all__ = ["Server", "Registry", "ModelEntry", "ServeFuture", "Request",
           "RequestQueue", "ClosedError", "DeadlineError", "RejectedError",
           "register", "unregister", "models", "submit", "predict",
           "shutdown", "default_registry", "default_server", "DecodeEntry",
           "DecodeFuture", "DecodeServer", "TokenRangeError", "decode_server",
           "decode_submit", "generate", "register_decode", "shutdown_decode"]

_SERVER: Optional[Server] = None
_LOCK = threading.Lock()


def default_server() -> Server:
    """The lazily created process-default :class:`Server` (recreated
    after :func:`shutdown`)."""
    global _SERVER
    with _LOCK:
        if _SERVER is None or _SERVER._closed:
            _SERVER = Server()
        return _SERVER


def register(name: str, block, bucketer=None, sample=None,
             warmup: bool = True, background: bool = False,
             precision=None) -> ModelEntry:
    """Register ``block`` under ``name`` in the default registry and
    capture its bucket grid, on a thread of its own with
    ``background=True`` (see :meth:`Registry.register`)."""
    return default_registry().register(name, block, bucketer=bucketer,
                                       sample=sample, warmup=warmup,
                                       background=background,
                                       precision=precision)


def unregister(name: str):
    default_registry().unregister(name)


def models():
    return default_registry().models()


def submit(model: str, *args) -> ServeFuture:
    """Enqueue one request on the default server (see
    :meth:`Server.submit`)."""
    return default_server().submit(model, *args)


def predict(model: str, *args, timeout: Optional[float] = None):
    """Blocking convenience on the default server."""
    return default_server().predict(model, *args, timeout=timeout)


def shutdown(timeout: float = 60.0):
    """Close the default server (drains accepted requests); the next
    :func:`submit` starts a fresh one."""
    global _SERVER
    with _LOCK:
        srv, _SERVER = _SERVER, None
    if srv is not None:
        srv.close(timeout)
