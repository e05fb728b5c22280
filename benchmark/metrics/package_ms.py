"""Milliseconds of the entry point's ``package`` stage, mean per job over the
measured window (``timings["package"]``)."""

from metrics import stage_mean_ms


def read(rec):
    return stage_mean_ms(rec, "package")
