"""Seconds of the process's first entry-point call, which in the benchmark
is the warm-up job inside set-up: the process record's "first_call" (its
first Adam loss, where the lazy imports of the first forward-mode call
land, is a child there)."""

from program_spans import process_seconds


def read(rec):
    return process_seconds("first_call")
