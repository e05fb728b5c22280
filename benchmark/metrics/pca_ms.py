"""Milliseconds of the linear multi-camera prep's PCA, mean per job over
the measured window: the "prep.pca" spans of each job (the centring, the
good rows' covariance and its eigendecomposition, the latent's S0 and Q)."""

from program_spans import seconds


def read(rec):
    vals = [sum(found) for found in (seconds(j, "prep.pca") for j in rec["jobs"]) if found]
    return 1e3 * sum(vals) / len(vals) if vals else None
