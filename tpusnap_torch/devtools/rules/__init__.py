"""The shipped lint rules, one module per rule (stable ``TPSnnn`` ids).

Adding a rule: create ``tpsNNN_<slug>.py`` with a :class:`Rule`
subclass, import it here, append to ``ALL_RULES``, and add a row to the
rule table in ``docs/design.md`` (the per-rule test matrix in
``tests/test_torch_lint.py`` expects positive/negative/waived coverage)."""

from .tps001_knob_env import KnobEnvAccessRule
from .tps002_monotonic import MonotonicClockRule
from .tps003_sidecar_literals import SidecarLiteralRule
from .tps004_silent_swallow import SilentSwallowRule
from .tps005_async_blocking import AsyncBlockingCallRule
from .tps006_finalizer_join import FinalizerJoinRule
from .tps007_knob_docs import KnobDocDriftRule

ALL_RULES = [
    KnobEnvAccessRule,
    MonotonicClockRule,
    SidecarLiteralRule,
    SilentSwallowRule,
    AsyncBlockingCallRule,
    FinalizerJoinRule,
    KnobDocDriftRule,
]
