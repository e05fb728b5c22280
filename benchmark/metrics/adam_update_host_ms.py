"""Milliseconds of Adam's update and the masked carries in one iteration of
the s-optimizer, on the host: the "adam.update" spans over the Adam
iterations, summed over the measured window's jobs."""

from program_spans import per_iteration_ms


def read(rec):
    return per_iteration_ms(rec, "adam.update")
