"""Milliseconds of one Adam iteration of the s-optimizer: the optimizer's
seconds over its iterations, summed over the measured window's jobs."""


def read(rec):
    jobs = [j["timings"] for j in rec["jobs"] if (j.get("timings") or {}).get("adam_iters")]
    iters = sum(t["adam_iters"] for t in jobs)
    return 1e3 * sum(t["optimizer"] for t in jobs) / iters if iters else None
