"""Array files: ``save`` / ``load`` in the JAX package's format
(``ndarray.utils``)."""
from .utils import load, save

__all__ = ["load", "save"]
