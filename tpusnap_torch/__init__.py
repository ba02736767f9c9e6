"""tpusnap_torch — the PyTorch/CUDA port of tpusnap.

A second package beside ``tpusnap/`` (the JAX reference, left as it is):
the same snapshot format (docs/format.md), the same knob names, the same
logical paths, for ``torch.Tensor`` state on an NVIDIA GPU. A snapshot
taken by either package restores through the other.

It carries the ``Snapshot.take`` → ``restore`` path to a local
filesystem, from one process or from every rank of a ``torch.distributed``
job (replicated values written once, the writes spread across ranks,
``TakeAbortedError`` when a peer's take fails), ``DTensor`` state with
``Shard``/``Replicate`` placements resharded on restore (``is_sharded``,
``get_available_entries``), chunked tensors, ``async_take`` (``PendingSnapshot``)
and ``async_restore`` (``PendingRestore``), ``read_object``,
``load_snapshot`` and ``RNGState``; incremental takes
(``incremental_from``), fused tile compression (``TPUSNAP_COMPRESS``),
save-time transforms (``cast_on_save``), ``Snapshot.verify``/``materialize``
(``verify_snapshot``, ``ScrubReport``) and ``apply_retention``;
host-offloaded state in pinned CPU memory (``to_host_offload``,
``to_device``, ``is_host_resident``, ``supports_host_offload``), staged
with no device-to-host copy; ``PytreeState`` for any pytree of tensors;
storage beyond the local filesystem (``s3://``, ``gs://``,
``fsspec+<protocol>://``), the write-back tier (``tier+local=...+remote=...``)
and the content-addressed store (``cas+fs://``, ``TPUSNAP_CAS_DIR``);
delta streams of micro-commits (``Snapshot.stream``, ``DeltaStream``,
``resolve_chain``); and the two model families (``tpusnap_torch.models``): the flagship
transformer, dense or MoE, at its dp/fsdp/tp/ep layouts, whose attention
forward runs a hand-written Hopper kernel (``tpusnap_torch.ops``), and
the embedding-table collection with pinned tables and row-wise Adagrad.
The package imports torch, numpy and the standard library only — never JAX
and never ``tpusnap``. ROADMAP.md lists what is still to port.
"""

from .version import __version__  # noqa: F401
from .state_dict import StateDict  # noqa: F401
from .stateful import AppState, Stateful  # noqa: F401
from .rng_state import RNGState  # noqa: F401
from .snapshot import (  # noqa: F401
    PendingRestore,
    PendingSnapshot,
    Snapshot,
    load_snapshot,
)
from .dist_store import TakeAbortedError  # noqa: F401
from .faults import FaultPlan, InjectedFaultError  # noqa: F401
from .lifecycle import FsckReport, GCReport, fsck_snapshot, gc_snapshot  # noqa: F401
from .liveness import RankFailedError  # noqa: F401
from .retry import RetryPolicy  # noqa: F401
from .telemetry import MetricsSink, metrics_sink  # noqa: F401
from .host_offload import (  # noqa: F401
    is_host_resident,
    supports_host_offload,
    to_device,
    to_host_offload,
)
from .inspect import ScrubReport, verify_snapshot  # noqa: F401
from .io_preparers.sharded import is_sharded  # noqa: F401
from .manifest_ops import get_available_entries  # noqa: F401
from .pytree_state import PytreeState  # noqa: F401
from .retention import apply_retention  # noqa: F401
from .delta import (  # noqa: F401
    DeltaChainReport,
    DeltaStream,
    resolve_chain,
)
from .transforms import cast_on_save  # noqa: F401

__all__ = [
    "__version__",
    "AppState",
    "DeltaChainReport",
    "DeltaStream",
    "FaultPlan",
    "FsckReport",
    "GCReport",
    "InjectedFaultError",
    "MetricsSink",
    "PendingRestore",
    "PendingSnapshot",
    "PytreeState",
    "RNGState",
    "RankFailedError",
    "RetryPolicy",
    "ScrubReport",
    "Snapshot",
    "StateDict",
    "Stateful",
    "TakeAbortedError",
    "apply_retention",
    "cast_on_save",
    "fsck_snapshot",
    "gc_snapshot",
    "get_available_entries",
    "is_host_resident",
    "is_sharded",
    "load_snapshot",
    "metrics_sink",
    "resolve_chain",
    "supports_host_offload",
    "to_device",
    "to_host_offload",
    "verify_snapshot",
]
