"""In-process jobs: one call of the family's entry point a job, from the
session's array to its tables, on one process that waits for each result
(a lab's script over a queue of sessions).

Set-up imports the program, makes the pool of sessions from the seed and
runs one warm-up job at the cell's shapes, which builds (in a fresh
checkout) or loads the kernels it launches. The
window's jobs cycle through the pool from its second session on, so no job
repeats the data of the one before. A traced run passes ``timings`` to
every job (the entry point then synchronises between its stages) and, after
the window, profiles a few more jobs on the device.
"""

from __future__ import annotations

import sys
import time

from families import load as load_family
from generators.sessions import session_pool
from harness import closed_loop
from kinds import Context, Result


def run(ctx: Context) -> Result:
    torch, cell = ctx.torch, ctx.cell
    cfg, traffic = cell.cfg, cell.traffic
    t0 = time.perf_counter()
    import eks_tpu_torch as eks

    print(f"setup: program imported in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    fam = load_family(cfg["family"])
    pool = session_pool(ctx.seed, cfg, traffic["pool"])
    last: dict[int, dict] = {}

    def job(i: int, timings: dict | None = None) -> dict:
        k = i % len(pool)
        last[k] = fam.call(eks, pool[k], cfg, traffic["smooth_param"], ctx.device, timings)
        return {"session": k, "timings": timings, "kp_frames": cell.kp_frames}

    job(0, {} if ctx.trace else None)
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.started
    window = closed_loop(lambda i: job(i, {} if ctx.trace else None), ctx.seconds, first=1)

    segment, peak = None, 0
    if ctx.device == "cuda":
        if ctx.trace:
            from devtrace import entry_stages, profile

            def traced_jobs() -> list:
                recs, nxt = [], window.jobs[-1]["index"] + 1
                for i in range(nxt, nxt + traffic["trace_jobs"]):
                    t0, timings = time.perf_counter(), {}
                    rec = job(i, timings)
                    recs.append(dict(rec, t0=t0, t1=time.perf_counter(), stages=entry_stages(timings)))
                return recs

            segment = profile(torch, traced_jobs)
        peak = torch.cuda.max_memory_allocated()
    judged = sorted(last)
    return Result(setup_s, window, [pool[k] for k in judged], [fam.outputs(last[k], cfg) for k in judged],
                  peak, segment)
