"""Milliseconds of the loss in one Adam iteration of the s-optimizer, on
the host: the "adam.loss" spans (the loss's forward-mode operations, kernel
A's launch, the block sums) over the Adam iterations, summed over the
measured window's jobs."""

from program_spans import per_iteration_ms


def read(rec):
    return per_iteration_ms(rec, "adam.loss")
