"""The numbers that decide ``correct`` for the model step: the program's
first training steps against the plain reference's, from the same
weights and batches.

- ``loss_gap``: the largest |loss - reference loss| / |reference loss|
  over the steps.
- ``grad_gap``: over the leaves, the largest gap between the norm of the
  first step's gradient and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf.
- ``update_gap``: the same for each parameter's change after the steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (a leaf whose gradient is nought to rounding moves
  under Adam by rounding alone).
"""

from __future__ import annotations

import statistics

MOVED_SHARE = 1e-3


def _norm_gap(got: dict, want: dict, leaves) -> float:
    floor = statistics.median(want.values())
    return max(abs(got[k] - want[k]) / max(want[k], floor) for k in leaves)


def gaps(got: dict, want: dict) -> dict:
    """``got`` and ``want``: ``losses``, ``grad_norms`` and
    ``change_norms`` of the program (or a control) and the reference."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    grads = want["grad_norms"]
    floor = statistics.median(grads.values())
    moved = [k for k, v in grads.items() if v >= MOVED_SHARE * floor]
    return {
        "loss_gap": loss,
        "grad_gap": _norm_gap(got["grad_norms"], grads, grads),
        "update_gap": _norm_gap(got["change_norms"], want["change_norms"], moved),
    }
