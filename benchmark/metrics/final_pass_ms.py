"""Milliseconds of the entry point's ``final_pass`` stage, mean per job over the
measured window (``timings["final_pass"]``)."""

from metrics import stage_mean_ms


def read(rec):
    return stage_mean_ms(rec, "final_pass")
