"""Share of the profiled segment's wall in which no operation ran on the
card: 1 - (union of the device operations' intervals / wall), both from
the one device-only profile."""

from devtrace import busy_s


def read(rec):
    seg = rec.get("trace")
    if not seg or not seg["events"] or seg["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - busy_s(seg["events"]) / seg["window_s"])
