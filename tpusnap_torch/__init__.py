"""tpusnap_torch — the PyTorch/CUDA port of tpusnap.

A second package beside ``tpusnap/`` (the JAX reference, left as it is):
the same snapshot format (docs/format.md), the same knob names, the same
logical paths, for ``torch.Tensor`` state on an NVIDIA GPU. A snapshot
taken by either package restores through the other.

This slice carries the single-process ``Snapshot.take`` → ``restore``
path to a local filesystem, ``read_object`` and ``load_snapshot``, and
the flagship transformer (``tpusnap_torch.models``) whose attention
forward runs a hand-written Hopper kernel (``tpusnap_torch.ops``). The
package imports torch, numpy and the standard library only — never JAX
and never ``tpusnap``. ROADMAP.md lists what is still to port.
"""

from .version import __version__  # noqa: F401
from .state_dict import StateDict  # noqa: F401
from .stateful import AppState, Stateful  # noqa: F401
from .snapshot import Snapshot, load_snapshot  # noqa: F401

__all__ = [
    "__version__",
    "AppState",
    "Snapshot",
    "StateDict",
    "Stateful",
    "load_snapshot",
]
