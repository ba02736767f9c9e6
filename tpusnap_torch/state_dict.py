"""StateDict — a dict that satisfies the Stateful protocol, for tracking
plain values (progress counters, hyperparameters) and nested dicts of
tensors in app state.

Counterpart of tpusnap/state_dict.py.
"""

from typing import Any, Dict


class StateDict(Dict[str, Any]):
    def state_dict(self) -> Dict[str, Any]:
        return self

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        self.clear()
        self.update(state_dict)
