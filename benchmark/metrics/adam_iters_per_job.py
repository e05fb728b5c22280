"""Adam iterations of the s-optimizer per job over the measured window: a
count, which shows a change that alters convergence."""


def read(rec):
    iters = [j["timings"]["adam_iters"] for j in rec["jobs"] if (j.get("timings") or {}).get("adam_iters")]
    return sum(iters) / len(iters) if iters else None
