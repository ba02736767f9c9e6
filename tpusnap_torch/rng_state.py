"""RNG state capture with take/restore invariance.

Counterpart of tpusnap/rng_state.py. tpusnap captures Python's ``random``
and numpy's legacy global generator under the same two keys, pickled, so
either package restores the other's. A PyTorch program also draws from
torch's CPU generator and the default generator of each CUDA device;
those are captured as their raw state bytes under two more keys, which
tpusnap ignores on restore. A snapshot without them (one tpusnap wrote)
restores the first two and leaves torch's generators as they are.

``Snapshot`` keeps tpusnap's invariant: taking a snapshot leaves every
one of these generators exactly as it was, and a restore loads RNG state
last so that loading other statefuls cannot disturb it.
"""

import pickle
import random
from typing import Any, Dict

import numpy as np
import torch


class RNGState:
    def state_dict(self) -> Dict[str, Any]:
        state = {
            "python_random": pickle.dumps(random.getstate()),
            "numpy_random": pickle.dumps(np.random.get_state()),
            "torch_cpu": bytes(torch.get_rng_state().numpy()),
        }
        # Only a program that already uses the card has CUDA generators
        # worth saving; asking for them would initialise CUDA.
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            state["torch_cuda"] = pickle.dumps(
                [bytes(s.numpy()) for s in torch.cuda.get_rng_state_all()]
            )
        return state

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        random.setstate(pickle.loads(state_dict["python_random"]))
        np.random.set_state(pickle.loads(state_dict["numpy_random"]))
        if "torch_cpu" in state_dict:
            torch.set_rng_state(_byte_tensor(state_dict["torch_cpu"]))
        if "torch_cuda" in state_dict and torch.cuda.is_available():
            states = pickle.loads(state_dict["torch_cuda"])[: torch.cuda.device_count()]
            torch.cuda.set_rng_state_all([_byte_tensor(s) for s in states])


def _byte_tensor(raw: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8)
