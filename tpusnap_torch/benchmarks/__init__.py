"""The port's benchmark harnesses (counterparts of the JAX package's
``benchmarks/``), each runnable as
``python -m tpusnap_torch.benchmarks.<name>`` and callable in process as
``main(argv) -> int``. Each prints what it measured and, as its last line,
one JSON object: the numbers, the device they were taken on and the
correctness fields (``ok`` is their conjunction; ``main`` returns 1 when
it is false). Each runs on the card unless given ``--device cpu``.

load_tensor, pinned_host, async_latency, incremental, replicated, sharded,
embedding, gcs_pipeline, dcp_compare (the counterpart of orbax_compare:
``torch.save`` and ``torch.distributed.checkpoint`` against tpusnap) and
fleetsim (benchmarks/fleet/fleetsim.py).
"""

import json
from typing import Any


def result(bench: str, device: str, ok: bool, **fields: Any) -> int:
    """Print the harness's last line; return its exit code."""
    import torch

    out = {"bench": bench, "device": device}
    if device == "cuda":
        out["device_name"] = torch.cuda.get_device_name(0)
    out.update(fields)
    out["ok"] = bool(ok)
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


def synchronize(device: str) -> None:
    """Wait for the card's queued work before a host clock is read."""
    if device == "cuda":
        import torch

        torch.cuda.synchronize()
