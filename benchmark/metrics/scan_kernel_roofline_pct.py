"""The prefix-scan kernels' share of their roofline: the least time one
filter scan and one smoother scan over all lanes at the cell's D and T
need, once per profiled job (the final pass), over the device time of the
kernels of ``csrc/prefix_scan.cu`` in the profile."""

from roofline import filter_scan_bound_ms, smoother_scan_bound_ms
from devtrace import device_seconds

#: the kernels of csrc/prefix_scan.cu
PATTERNS = [r"(?<![A-Za-z0-9_])scan_(reduce|totals|downsweep)_kernel"]


def read(rec):
    seg, cell = rec.get("trace"), rec["cell"]
    if not seg or not seg["jobs"]:
        return None
    dev_s = device_seconds(seg["events"], PATTERNS)
    if dev_s <= 0:
        return None
    N, T, D = cell["lanes"], cell["frames"], cell["state_dim"]
    bound_ms = filter_scan_bound_ms(N, T, D)[0] + smoother_scan_bound_ms(N, T, D)[0]
    return 100.0 * bound_ms * 1e-3 * len(seg["jobs"]) / dev_s
