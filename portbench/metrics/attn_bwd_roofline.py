"""Attention's backward (the delta pass and the backward block kernel)
share of its roofline inside the step: the backward kernel's calls times
the least time a call can take (``flash_backward_bound`` at the model's
attention shape, causal) over the device time of both kernels by name in
the trace, in %. None where the model's attention has no such shape
(``_common.attention_shape``)."""

from portbench.frozen import flash_backward_bound
from portbench.metrics._common import attention_shape
from portbench.trace import kernel_time


def read(run: dict):
    calls, _ = kernel_time(run["trace"], "ring_grads_")
    _, seconds = kernel_time(run["trace"], "ring_grads_", "attention_delta")
    if not calls or not seconds:
        return None
    c = run["config"]
    shape = attention_shape(c)
    if shape is None:
        return None
    return 100.0 * calls * flash_backward_bound(shape, c["dtype"], True)[0] / 1e3 / seconds
