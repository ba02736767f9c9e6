"""The Stateful protocol: anything with state_dict()/load_state_dict().

Counterpart of tpusnap/stateful.py. In PyTorch an ``nn.Module`` or an
optimizer already has this shape; ``StateDict`` covers plain values.
"""

from typing import Any, Dict, Protocol, runtime_checkable


@runtime_checkable
class Stateful(Protocol):
    def state_dict(self) -> Dict[str, Any]: ...

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None: ...


AppState = Dict[str, Stateful]
