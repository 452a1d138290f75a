"""``write_payload``: the port's copy of the JAX package's durable
checkpoint write (``mxnet_tpu/resilience/checkpoint.py:203``).

The payload goes to a temporary file beside ``path``, is flushed and
fsynced, and replaces ``path`` with ``os.replace``; the directory is
fsynced after.  A crash at any point leaves the previous content of
``path`` whole, never a torn file.  Only this function is ported: the
fault seams, counters and the checkpoint manager of the JAX package are
not.
"""
from __future__ import annotations

import itertools
import os
from typing import Callable, Union

__all__ = ["write_payload"]

_SEQ = itertools.count()


def _fsync_dir(d: str):
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_payload(path: str, data: Union[bytes, Callable]):
    """Write ``data`` (bytes, or a callable taking the open binary file)
    to ``path`` atomically (module docstring)."""
    path = os.path.abspath(path)
    d = os.path.dirname(path)
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}.{next(_SEQ)}"
    try:
        with open(tmp, "wb") as f:
            if callable(data):
                data(f)
            else:
                f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
