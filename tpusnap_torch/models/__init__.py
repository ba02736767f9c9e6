"""Flagship model of the port (counterpart of tpusnap/models). The
embedding-table collection is a later slice (ROADMAP.md item A7)."""

from .transformer import Transformer, TransformerConfig  # noqa: F401

__all__ = ["Transformer", "TransformerConfig"]
