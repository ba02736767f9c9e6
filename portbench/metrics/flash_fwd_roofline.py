"""The flash attention forward kernel's share of its roofline inside the
step: its calls times the least time a call can take (``attention_bound``
at the model's attention shape, causal) over its device time by name in
the trace, in %. None where the model's attention has no such shape
(``_common.attention_shape``)."""

from portbench.frozen import attention_bound
from portbench.metrics._common import attention_shape
from portbench.trace import kernel_time


def read(run: dict):
    calls, seconds = kernel_time(run["trace"], "flash_fwd")
    if not calls or not seconds:
        return None
    c = run["config"]
    shape = attention_shape(c)
    if shape is None:
        return None
    return 100.0 * calls * attention_bound(shape, c["dtype"], True)[0] / 1e3 / seconds
