"""The flash attention forward kernel's share of its roofline inside the
step: its calls times the least time a call can take (``attention_bound``
at the configuration's attention shape, causal) over its device time by
name in the trace, in %."""

from portbench.frozen import attention_bound
from portbench.trace import kernel_time


def read(run: dict):
    calls, seconds = kernel_time(run["trace"], "flash_fwd")
    if not calls or not seconds:
        return None
    c = run["config"]
    shape = (c["batch"], c["max_seq_len"], c["n_heads"], c["d_model"] // c["n_heads"])
    return 100.0 * calls * attention_bound(shape, c["dtype"], True)[0] / 1e3 / seconds
