"""Milliseconds of the entry point's ``prep`` stage, mean per job over the
measured window (``timings["prep"]``)."""

from metrics import stage_mean_ms


def read(rec):
    return stage_mean_ms(rec, "prep")
