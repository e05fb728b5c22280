"""Milliseconds of the stop test in one Adam iteration of the s-optimizer:
the "adam.stop_test" spans (the loop-top read of which lanes are still
active, the iteration's one wait for the device; one more than the
iterations) over the Adam iterations, summed over the measured window's
jobs."""

from program_spans import per_iteration_ms


def read(rec):
    return per_iteration_ms(rec, "adam.stop_test")
