"""Operations, bytes and peaks for the kernels' rooflines: a frozen copy of
``chip_smoke.py``'s arithmetic (``_ops``, ``kf_step_ops``, ``combine_ops``,
``smoother_combine_ops``, ``nll_ops``, ``scan_ops``, ``bound_ms``, and the
peaks). It counts the work a function needs, whichever kernel does it: one
Kalman step per time step for a log-likelihood, T - 1 combines a lane for a
scan, each plane read and written once. A Dual (value, tangent) multiply is
4 float operations, an add 2, a divide 4, a sqrt 3 and a log 2.
"""

from __future__ import annotations

#: published H100 SXM peaks (NVIDIA data sheet), at the full 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def _ops(mul, add, div, sqrt=0, log=0, dual=False):
    if dual:
        return 4 * mul + 2 * add + 4 * div + 3 * sqrt + 2 * log
    return mul + add + div + sqrt + log


def kf_step_ops(D, O, dual):
    """One step of a Kalman filter's log-likelihood with diagonal R: predict,
    the innovation and its O x O Cholesky and log-density, the update."""
    tri = O * (O - 1) // 2
    chol = sum(i * (i + 1) // 2 for i in range(O))  # multiply-adds of the factor
    mul = (D * D + 2 * D ** 3              # A m, A P Aᵀ
           + O * D * D + O * O * D + O * D  # C P, (C P) Cᵀ, C m
           + chol + tri + O + 1             # Cholesky, z, z·z, -0.5 quad
           + D * 2 * tri                    # gain K = (C P)ᵀ S⁻¹, D solves
           + D * O + D * D * O)             # m + K d, P - K (C P)
    add = (D * (D - 1) + 2 * D * D * (D - 1) + D * D
           + O * D * (D - 1) + O * O * (D - 1) + O + O * D
           + chol + tri + (O - 1) + (O - 1) + 3
           + D * 2 * tri
           + D * O + D * D * (O - 1) + D * D)
    div = tri + O + D * 2 * O
    return _ops(mul, add, div, sqrt=O, log=O, dual=dual)


def combine_ops(D, dual=False):
    """One filtering-element combine: eight D x D products, four matvecs,
    the closed-form D x D inverse (D <= 3) and the sums."""
    inv_mul, inv_add = {1: (0, 0), 2: (6, 1), 3: (30, 11)}[D]
    return _ops(
        mul=8 * D ** 3 + 4 * D * D + inv_mul,
        add=8 * D * D * (D - 1) + 4 * D * (D - 1) + D + inv_add + 4 * D + 2 * D * D,
        div=1, dual=dual,
    )


def smoother_combine_ops(D, dual=False):
    """One smoothing-element combine: E_e E_l, E_e g_l + g_e,
    (E_e L_l) E_eᵀ + L_e."""
    return _ops(mul=3 * D ** 3 + D * D, add=3 * D * D * (D - 1) + D * (D - 1) + D + D * D,
                div=0, dual=dual)


def nll_ops(N, T, D, O, dual):
    return N * T * kf_step_ops(D, O, dual)


def scan_ops(N, T, D):
    return N * (T - 1) * combine_ops(D)


def bound_ms(n_bytes, n_ops):
    """(least milliseconds, and whether bytes or operations bound them)."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- the two path counts the kernel rooflines use ---------------------------
def table_width(D, O):
    """Scalars a lane's constant-R table holds (the port's layout, as
    ``chip_smoke.py`` counts it): A, C, J and first-step blocks and the raw
    model, 7 D² + 3 D O + O + 2 D."""
    return 7 * D * D + 3 * D * O + O + 2 * D


def paired_nll_bound_ms(N, T, D, O):
    """One paired (value and d/d log s) constant-R Kalman log-likelihood over
    N lanes of T steps: the observations, the table and its tangent read,
    two numbers a lane written."""
    n_bytes = (N * O * T + 2 * N * table_width(D, O) + 2 * N) * 4
    return bound_ms(n_bytes, nll_ops(N, T, D, O, True))


def filter_planes(D):
    """Planes of a filtering element: A, b, C, eta, J."""
    return 3 * D * D + 2 * D


def smoother_planes(D):
    """Planes of a smoothing element: E, g, L."""
    return 2 * D * D + D


def filter_scan_bound_ms(N, T, D):
    return bound_ms(2 * N * filter_planes(D) * T * 4, scan_ops(N, T, D))


def smoother_scan_bound_ms(N, T, D):
    return bound_ms(2 * N * smoother_planes(D) * T * 4,
                    N * (T - 1) * smoother_combine_ops(D))
