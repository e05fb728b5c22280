"""Kernel A's share of its roofline: the least time one paired constant-R
Kalman log-likelihood over all lanes at the cell's (D, O) and T needs, once
per Adam iteration of the profiled jobs, over the device time of the
kernels of ``csrc/fused_nll.cu`` in the profile."""

from roofline import paired_nll_bound_ms
from devtrace import device_seconds

#: the kernels of csrc/fused_nll.cu (not those of fused_nll_tv.cu)
PATTERNS = [r"(?<![A-Za-z0-9_])nll_(reduce|totals|downsweep|sum)_kernel"]


def read(rec):
    seg, cell = rec.get("trace"), rec["cell"]
    if not seg:
        return None
    iters = sum((j.get("timings") or {}).get("adam_iters", 0) for j in seg["jobs"])
    dev_s = device_seconds(seg["events"], PATTERNS)
    if not iters or dev_s <= 0:
        return None
    bound_ms, _ = paired_nll_bound_ms(cell["lanes"], cell["frames"], cell["state_dim"], cell["obs_dim"])
    return 100.0 * bound_ms * 1e-3 * iters / dev_s
