"""Device operations a s-optimizer iteration runs: the profiled segment's
device events that start inside a traced job's "optimizer" span, over
those jobs' Adam iterations. The optimizer stage ends with a wait for the
device, so its operations start and end inside its span."""

from program_spans import spans


def read(rec):
    seg = rec.get("trace")
    if not seg:
        return None
    windows, iters = [], 0
    for job in seg["jobs"]:
        found = [(t0, t1) for n, t0, t1, _ in spans(job) if n == "optimizer"]
        n = (job.get("timings") or {}).get("adam_iters", 0)
        if found and n:
            windows += found
            iters += n
    if not iters:
        return None
    ops = sum(1 for _, start, _ in seg["events"] if any(t0 <= start <= t1 for t0, t1 in windows))
    return ops / iters
