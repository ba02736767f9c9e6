"""``tpusnap.tricks.orbax``'s import path in the port: code written against
the JAX package's orbax-style checkpointer moves by changing the package
name. The class lives in ``tricks/dcp.py`` beside the DCP-shaped
functions."""

from .dcp import PyTreeCheckpointer

__all__ = ["PyTreeCheckpointer"]
