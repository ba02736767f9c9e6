"""Ready-made save-time tensor transforms for ``_custom_array_prepare_func``.

Counterpart of tpusnap/transforms.py. The hook is a callable of
``(logical_path, tensor, tracing)``; this module builds the common case
so users do not hand-roll glob matching::

    from tpusnap_torch.transforms import cast_on_save

    Snapshot.take(
        path, app_state,
        _custom_array_prepare_func=cast_on_save({"train/params/**": torch.bfloat16}),
    )

At prepare time a transform runs on a ``meta`` tensor of the source's
shape and dtype (no memory, no arithmetic) to learn the stored dtype; at
stage time it runs for real, on the source's own device.
"""

from __future__ import annotations

import fnmatch
from typing import Callable, Dict

import torch

__all__ = ["cast_on_save"]


def cast_on_save(
    dtype_by_glob: Dict[str, torch.dtype],
) -> Callable[[str, torch.Tensor, bool], torch.Tensor]:
    """Save-time dtype cast by logical-path glob: checkpoint at reduced
    precision (e.g. bf16 weights) while training at full precision.

    ``dtype_by_glob`` maps glob patterns (matched against the flattened
    logical path, e.g. ``"train/params/blocks/wq"``) to torch dtypes; the
    first match wins and unmatched tensors pass through unchanged. The
    cast is ``t.to(dtype)`` on the tensor's own device (round to nearest
    even, as ``astype`` rounds in tpusnap). Restoring into a
    full-precision target upcasts into the target's dtype, on the card
    for a CUDA target."""
    patterns = list(dtype_by_glob.items())

    def transform(logical_path: str, t: torch.Tensor, tracing: bool) -> torch.Tensor:
        for pattern, dtype in patterns:
            if fnmatch.fnmatch(logical_path, pattern):
                return t.to(dtype)
        return t

    return transform
