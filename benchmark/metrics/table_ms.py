"""Milliseconds of the entry point's pandas table build, mean per job over
the measured window: the "table" spans of each job."""

from program_spans import seconds


def read(rec):
    vals = [sum(found) for found in (seconds(j, "table") for j in rec["jobs"]) if found]
    return 1e3 * sum(vals) / len(vals) if vals else None
