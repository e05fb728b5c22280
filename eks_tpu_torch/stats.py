"""Statistics: PCA, Factor Analysis, and Mahalanobis variance screening.

The port's own copy of ``eks_tpu/stats.py``. The host half (the
sklearn-exact PCA fit, ``PCA``, ``compute_pca``, ``FactorAnalysis`` and
``compute_mahalanobis``) is numpy and scipy pinned bit for bit to sklearn and
is carried over unchanged:

  * PCA: the host fit replicates sklearn's solver dispatch, the
    ``covariance_eigh`` and ``full`` branches, and ``svd_flip`` (v-based).
  * FactorAnalysis: the SVD-based EM sklearn implements (Barber BRML alg.
    21.1): scale X by sqrt(psi)*sqrt(n), SVD, W = sqrt(max(s^2-1,0)) Vt *
    sqrt(psi), psi = max(var - sum(W^2), 1e-12), stop when the loglike gain
    drops below tol. Host-side in float64: a cold-path fit on a few thousand
    rows.
  * Mahalanobis: vectorized over rows; per-view 2x2 posterior-predictive
    covariances and distances.

The device half is ``_pca_fit_batched``: one batched covariance-eigh fit over
all keypoints on the tensor's device (``torch.linalg.eigh``, as the JAX
package calls ``jnp.linalg.eigh`` outside any kernel).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from eks_tpu_torch.marker_array import MarkerArray

__all__ = ["PCA", "compute_pca", "FactorAnalysis", "compute_mahalanobis"]


# --------------------------------------------------------------------------- #
# PCA
# --------------------------------------------------------------------------- #
def _svd_flip_rows(vt: torch.Tensor) -> torch.Tensor:
    """sklearn ``svd_flip`` (v-based): the max-|v| loading of each component
    (row) is made positive; a zero anchor leaves its row zero."""
    max_idx = torch.argmax(vt.abs(), dim=-1, keepdim=True)
    return vt * torch.sign(torch.take_along_dim(vt, max_idx, dim=-1))


def _pca_fit_batched(X: torch.Tensor, n_components: int):
    """Batched device PCA fit via the covariance-eigendecomposition route
    (the formulation sklearn's ``covariance_eigh`` solver uses for
    tall-skinny data): X (K, N, F) -> means (K, F), components (K, L, F).
    It differs from the bit-exact host fit below at float32 rounding level."""
    N = X.shape[1]
    means = X.mean(dim=1)  # (K, F)
    C = torch.einsum("knf,kng->kfg", X, X) - N * (means[:, :, None] * means[:, None, :])
    _, V = torch.linalg.eigh(C)  # ascending
    Vt = _svd_flip_rows(V.flip(-1).transpose(-1, -2))  # (K, F, F), descending rows
    return means, Vt[:, :n_components, :]


def _pca_fit_sklearn_exact(X: np.ndarray, n_components: int):
    """Host PCA fit, bit-identical to sklearn 1.9's ``PCA.fit`` on the same
    input (the reference fits real sklearn PCAs, eks/stats.py:52): replicate
    the auto solver dispatch (``_pca.PCA._fit``) and the ``covariance_eigh``/
    ``full`` branches of ``_fit_full``, in the input dtype."""
    import scipy.linalg

    X = np.asarray(X)
    n, f = X.shape
    mean = np.mean(X, axis=0)
    if f <= 1_000 and n >= 10 * f:  # covariance_eigh
        C = X.T @ X
        C -= n * mean[:, None] * mean[None, :]
        C /= n - 1
        w, V = np.linalg.eigh(C)
        V = np.flip(V, axis=1)
        Vt = V.T
    else:  # 'full' (the remaining branches never trigger at this library's shapes)
        Xc = X - mean
        _, _, Vt = scipy.linalg.svd(Xc, full_matrices=False)
    # svd_flip(u_based_decision=False), in place so Vt keeps its memory
    # layout — sklearn's components_ ends up F-ordered (a transposed eigh
    # view copied with order='K'), and BLAS routes the transform GEMMs
    # differently per layout, which shows up in the last float32 bit
    anchor = np.argmax(np.abs(Vt), axis=1)
    signs = np.sign(Vt[np.arange(Vt.shape[0]), anchor])
    signs[signs == 0] = 1.0
    Vt *= signs[:, None]
    return mean, np.array(Vt[:n_components], copy=True, order="K")


class PCA:
    """Minimal PCA with the sklearn attribute surface used by this library:
    ``fit``, ``transform``, ``components_`` (L, F), ``mean_`` (F,).

    ``fit`` is bit-identical to sklearn's on the same input — the reference
    pipeline fits sklearn PCAs and the parity goldens (true reference
    outputs) are sensitive to the basis at f32 level."""

    def __init__(self, n_components: int):
        self.n_components = n_components
        self.components_: np.ndarray | None = None
        self.mean_: np.ndarray | None = None

    def fit(self, X: np.ndarray) -> "PCA":
        self.mean_, self.components_ = _pca_fit_sklearn_exact(
            X, self.n_components
        )
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        assert self.components_ is not None, "PCA must be fit before transform."
        # sklearn multiplies first, then subtracts the projected mean —
        # different rounding from (X - mean) @ compᵀ, and the parity goldens
        # see the difference
        return np.asarray(X) @ self.components_.T - (
            self.mean_[None, :] @ self.components_.T
        )


def compute_pca(
    valid_frames_mask: np.ndarray,
    emA_centered_preds: MarkerArray,
    emA_good_centered_preds: MarkerArray,
    n_components: int = 3,
    pca_object: PCA | None = None,
) -> tuple[list, list]:
    """Per-keypoint PCA on variance-filtered centered frames.

    Fit uses the (truncated, equal-length) good frames; the transform is then
    applied to ALL frames and indexed by each keypoint's own good-frame set
    (reference: eks/stats.py:9-64).

    Returns:
        (ensemble_pca, good_pcs_list) — one fitted PCA and one
        (n_good_frames_k, n_components) array per keypoint.
    """
    n_models, n_cameras, n_frames, n_keypoints, _ = emA_centered_preds.shape
    assert n_models == 1, "Expected a post-ensemble MarkerArray (models axis already collapsed to 1)."

    def _stacked_all_kp(ma: MarkerArray) -> np.ndarray:
        # (1, C, T, K, 2) -> (K, T, 2C) with per-frame [cam0_xy, cam1_xy, ...]
        arr = np.asarray(ma.array[0])
        K, T = arr.shape[2], arr.shape[1]
        return arr.transpose(2, 1, 0, 3).reshape(K, T, -1)

    X_all = _stacked_all_kp(emA_centered_preds)  # (K, T, 2C)

    if pca_object is None:
        # per-keypoint host fits, bit-identical to the reference's sklearn
        # fits (a K-loop of tiny (N, 2C) eigh problems — microseconds)
        X_good = _stacked_all_kp(emA_good_centered_preds)
        fits = [
            _pca_fit_sklearn_exact(X_good[k], n_components)
            for k in range(n_keypoints)
        ]
        means = np.stack([m for m, _ in fits])
        comps = np.stack([c for _, c in fits])
    else:
        means = np.broadcast_to(pca_object.mean_, (n_keypoints, X_all.shape[-1]))
        comps = np.broadcast_to(
            pca_object.components_,
            (n_keypoints, *pca_object.components_.shape),
        )

    # per-keypoint GEMM transform with sklearn's exact algebra (multiply
    # first, subtract the projected mean) so transformed values are
    # bit-identical to the reference's ``pca.transform`` calls
    pcs_all = np.stack(
        [
            X_all[k] @ comps[k].T - means[k][None, :] @ comps[k].T
            for k in range(n_keypoints)
        ]
    )

    ensemble_pca, good_pcs_list = [], []
    for k in range(n_keypoints):
        if pca_object is None:
            pca_k = PCA(n_components)
            pca_k.mean_ = means[k]
            pca_k.components_ = comps[k]
        else:
            pca_k = pca_object
        ensemble_pca.append(pca_k)
        good_pcs_list.append(pcs_all[k][valid_frames_mask[:, k]])
    return ensemble_pca, good_pcs_list


# --------------------------------------------------------------------------- #
# Factor Analysis
# --------------------------------------------------------------------------- #
try:  # LAPACK getrf — the exact call sklearn's range finder makes
    from scipy.linalg import lu as _scipy_lu
except Exception:  # pragma: no cover
    _scipy_lu = None


def _plu_factor(A: np.ndarray) -> np.ndarray:
    """P @ L of the partially-pivoted LU factorization A = P L U.

    sklearn's randomized range finder re-orthogonalizes power iterations
    with ``scipy.linalg.lu(permute_l=True)``; call the same LAPACK routine
    when scipy is importable (identical bits, ~10x the pure-numpy loop),
    else fall back to Doolittle elimination with the same pivoting rule.
    (A direct ``dgetrf`` + numpy P·L rebuild was measured SLOWER than the
    wrapper at these shapes — the dispatcher builds P·L in C.)
    """
    if _scipy_lu is not None:
        # check_finite=False skips an O(N·K) validation pass per call (the EM
        # loop calls this 6x per iteration); identical bits either way
        return _scipy_lu(
            np.asarray(A, dtype=np.float64), permute_l=True, check_finite=False
        )[0]
    A = np.array(A, dtype=np.float64)
    m, n = A.shape
    k = min(m, n)
    perm = np.arange(m)
    for j in range(k):
        p = j + int(np.argmax(np.abs(A[j:, j])))
        if p != j:
            A[[j, p]] = A[[p, j]]
            perm[[j, p]] = perm[[p, j]]
        piv = A[j, j]
        if piv != 0.0:
            A[j + 1:, j] /= piv
            A[j + 1:, j + 1:] -= np.outer(A[j + 1:, j], A[j, j + 1:])
    L = np.tril(A[:, :k], -1)
    L[np.arange(k), np.arange(k)] = 1.0
    PL = np.empty_like(L)
    PL[perm] = L  # undo the row swaps: rows return to their original slots
    return PL


try:  # LAPACK Householder QR — the factorization under np.linalg.qr
    from scipy.linalg.lapack import dgeqrf as _lapack_geqrf
    from scipy.linalg.lapack import dorgqr as _lapack_orgqr
except Exception:  # pragma: no cover
    _lapack_geqrf = _lapack_orgqr = None


def _qr_q(A: np.ndarray) -> np.ndarray:
    """Reduced-QR Q factor. ``dgeqrf``+``dorgqr`` are the exact LAPACK
    routines ``np.linalg.qr`` wraps (bit-identical Q, ~1.9x without the
    gufunc wrapper's dispatch/validation)."""
    if _lapack_geqrf is not None and A.shape[0] >= A.shape[1]:
        qr_raw, tau, _work, _info = _lapack_geqrf(
            np.asarray(A, dtype=np.float64)
        )
        q, _work, _info = _lapack_orgqr(qr_raw, tau)
        return q
    return np.linalg.qr(A)[0]


def _svd_flip_sign(U: np.ndarray, Vt: np.ndarray, u_based: bool = True):
    """Deterministic sign convention: the largest-|.| entry of each singular
    vector (column of U, or row of Vt) is made positive."""
    if u_based:
        anchor = np.argmax(np.abs(U), axis=0)
        signs = np.sign(U[anchor, np.arange(U.shape[1])])
    else:
        anchor = np.argmax(np.abs(Vt), axis=1)
        signs = np.sign(Vt[np.arange(Vt.shape[0]), anchor])
    signs[signs == 0] = 1.0
    return U * signs, Vt * signs[:, None]


def _randomized_svd(
    M: np.ndarray,
    n_components: int,
    n_iter: int,
    rng: np.random.RandomState,
    n_oversamples: int = 10,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Halko-style randomized truncated SVD reproducing sklearn's
    ``randomized_svd`` stream: Gaussian sketch from ``rng``, power
    iterations under sklearn's 'auto' normalizer rule (un-normalized for
    n_iter <= 2, LU beyond — sklearn's ``_randomized_range_finder``), one
    final QR, and a u-based sign flip. Matching the stream bit-for-bit is
    what pins the variance-inflation fixed point to the reference's
    (reference FA entry point: eks/stats.py:114-117)."""
    n_random = n_components + n_oversamples
    n_samples, n_features = M.shape
    transpose = n_samples < n_features
    if transpose:
        M = M.T
    Q = rng.normal(size=(M.shape[1], n_random))
    normalize = _plu_factor if n_iter > 2 else (lambda x: x)
    for _ in range(n_iter):
        Q = normalize(M @ Q)
        Q = normalize(M.T @ Q)
    Q = _qr_q(M @ Q)
    B = Q.T @ M
    Uhat, s, Vt = np.linalg.svd(B, full_matrices=False)
    U = Q @ Uhat
    U, Vt = _svd_flip_sign(U, Vt, u_based=not transpose)
    if transpose:
        return Vt[:n_components].T, s[:n_components], U[:, :n_components].T
    return U[:, :n_components], s[:n_components], Vt[:n_components]


class FactorAnalysis:
    """SVD-based EM Factor Analysis with sklearn-compatible semantics.

    ``svd_method`` selects the per-iteration SVD flavor: ``"randomized"``
    (sklearn's default — Halko sketch seeded by ``random_state``, shared
    across EM iterations) or ``"lapack"`` (exact thin SVD). The default
    matches the reference's ``FactorAnalysis(n_latent)`` call
    (eks/stats.py:114-117), whose inflation fixed point depends on the
    randomized stream.

    Attributes after fit: ``components_`` (L, F), ``mean_`` (F,),
    ``noise_variance_`` (F,), ``loglike_`` (list), ``n_iter_``.
    """

    def __init__(
        self,
        n_components: int,
        tol: float = 1e-2,
        max_iter: int = 1000,
        noise_variance_init: np.ndarray | None = None,
        svd_method: str = "randomized",
        iterated_power: int = 3,
        random_state: int | np.random.RandomState | None = 0,
    ):
        assert svd_method in ("randomized", "lapack"), svd_method
        self.n_components = n_components
        self.tol = tol
        self.max_iter = max_iter
        self.noise_variance_init = noise_variance_init
        self.svd_method = svd_method
        self.iterated_power = iterated_power
        self.random_state = random_state

    def _svd_fn(self):
        k = self.n_components
        if self.svd_method == "lapack":
            def exact(Xn):
                _, s, Vt = np.linalg.svd(Xn, full_matrices=False)
                return s[:k], Vt[:k], float(np.sum(s[k:] ** 2))

            return exact

        rs = self.random_state
        rng = rs if isinstance(rs, np.random.RandomState) else np.random.RandomState(rs)

        def sketched(Xn):
            if Xn.shape[0] <= k:
                # degenerate fits (e.g. every row filtered out) skip the
                # sketch; the thin SVD handles the empty case gracefully
                _, s, Vt = np.linalg.svd(Xn, full_matrices=False)
                return s[:k], Vt[:k], float(np.sum(s[k:] ** 2))
            _, s, Vt = _randomized_svd(Xn, k, n_iter=self.iterated_power, rng=rng)
            return s, Vt, float(np.sum(Xn**2) - np.sum(s**2))

        return sketched

    def fit(self, X: np.ndarray) -> "FactorAnalysis":
        X = np.asarray(X, dtype=np.float64)
        n_samples, n_features = X.shape
        n_components = self.n_components
        my_svd = self._svd_fn()

        self.mean_ = X.mean(axis=0)
        Xc = X - self.mean_

        nsqrt = math.sqrt(n_samples)
        llconst = n_features * math.log(2.0 * math.pi) + n_components
        var = Xc.var(axis=0)
        psi = (
            np.ones(n_features)
            if self.noise_variance_init is None
            else np.asarray(self.noise_variance_init, dtype=np.float64)
        )

        SMALL = 1e-12
        loglike: list[float] = []
        old_ll = -np.inf
        W = np.zeros((n_components, n_features))
        for i in range(self.max_iter):
            sqrt_psi = np.sqrt(psi) + SMALL
            s, Vt, unexp_var = my_svd(Xc / (sqrt_psi * nsqrt))
            s2 = s**2
            W = np.sqrt(np.maximum(s2 - 1.0, 0.0))[:, None] * Vt
            W *= sqrt_psi

            ll = llconst + np.sum(np.log(s2)) + unexp_var + np.sum(np.log(psi))
            ll *= -n_samples / 2.0
            loglike.append(float(ll))
            if (ll - old_ll) < self.tol:
                break
            old_ll = ll
            psi = np.maximum(var - np.sum(W**2, axis=0), SMALL)

        self.components_ = W
        self.noise_variance_ = psi
        self.loglike_ = loglike
        self.n_iter_ = i + 1
        return self


# --------------------------------------------------------------------------- #
# Mahalanobis
# --------------------------------------------------------------------------- #
def compute_mahalanobis(
    x: np.ndarray,
    v: np.ndarray,
    n_latent: int = 3,
    v_quantile_threshold: float | None = 50.0,
    likelihoods: np.ndarray | None = None,
    likelihood_threshold: float | None = 0.9,
    epsilon: float | None = 1e-6,
    loading_matrix: np.ndarray | None = None,
    mean: np.ndarray | None = None,
) -> dict:
    """Mahalanobis distances and posterior predictive variances under a
    linear latent model fitted by Factor Analysis.

    Observations with high ensemble variance or low likelihood are excluded
    from the FA fit; reconstructions/distances are computed for all rows
    (reference: eks/stats.py:67-157).

    Args:
        x: observations (N, 2C); v: per-dim ensemble variances (N, 2C).
        likelihoods: (N, C) per-view likelihoods (optional row filter).
        loading_matrix / mean: supply to skip the FA fit.

    Returns:
        dict with 'mahalanobis' {view: (N, 1)}, 'posterior_variance'
        {view: (N, 2, 2)}, 'reconstructed' (N, 2C).
    """
    x = np.asarray(x, dtype=np.float64)
    v = np.asarray(v, dtype=np.float64)

    if loading_matrix is None or mean is None:
        if likelihoods is not None and likelihood_threshold is not None:
            valid = np.min(likelihoods, axis=1) >= likelihood_threshold
        else:
            valid = np.ones(x.shape[0], dtype=bool)
        if v_quantile_threshold is not None:
            ev_max = v.max(axis=1)
            valid = valid & (ev_max < np.percentile(ev_max, v_quantile_threshold))
        fa = FactorAnalysis(n_components=n_latent)
        fa.fit(x[valid])
        W = fa.components_.T  # (2C, L)
        mu_x = fa.mean_
    else:
        W = np.asarray(loading_matrix, dtype=np.float64)
        mu_x = np.asarray(mean, dtype=np.float64)

    inv_v = 1.0 / (v + epsilon)  # (N, 2C)
    N, F = x.shape
    L = W.shape[1]

    # The screening runs every round of the variance-inflation fixed point
    # (models/multicam.py::mA_compute_maha); f64 c_einsum over (N, L, L) and
    # batched np.linalg.inv on tiny matrices dominated the whole inflation
    # pass, so the row-wise algebra is restructured as flat GEMMs plus
    # closed-form 2x2/3x3 inverses (same math, BLAS-speed).

    # posterior latent covariance per row: B = (Wᵀ D⁻¹ W)⁻¹, all rows at once.
    # WtDW[n] = Σ_f inv_v[n, f] · outer(W[f], W[f]) -> one (N, F)x(F, L²) GEMM
    G = (W[:, :, None] * W[:, None, :]).reshape(F, L * L)
    WtDW = (inv_v @ G).reshape(N, L, L)
    B = _inv_batched_small(WtDW)

    # posterior latent mean: ẑ = B Wᵀ D⁻¹ (x − μ)
    rhs = (inv_v * (x - mu_x)) @ W  # (N, L)
    z_hat = np.matmul(B, rhs[:, :, None])[:, :, 0]

    xhat = z_hat @ W.T + mu_x
    diff = x - xhat

    num_views = x.shape[1] // 2
    B_flat = B.reshape(N, L * L)
    Q: dict[int, np.ndarray] = {}
    M: dict[int, np.ndarray] = {}
    for view in range(num_views):
        sl = slice(2 * view, 2 * (view + 1))
        Wv = W[sl]  # (2, L)
        # Q_view = diag(v_view) + Wv B Wvᵀ per row: WBW[n, ij] =
        # Σ_lm B[n, lm] · Wv[i, l] Wv[j, m] -> one (N, L²)x(L², 4) GEMM
        Gv = (Wv[:, None, :, None] * Wv[None, :, None, :]).reshape(4, L * L)
        Qv = (B_flat @ Gv.T).reshape(N, 2, 2)
        Qv[:, 0, 0] += v[:, sl][:, 0]
        Qv[:, 1, 1] += v[:, sl][:, 1]
        d = diff[:, sl]  # (N, 2)
        # d Qv⁻¹ d via the closed-form 2x2 inverse
        det = Qv[:, 0, 0] * Qv[:, 1, 1] - Qv[:, 0, 1] * Qv[:, 1, 0]
        Mv = (
            d[:, 0] ** 2 * Qv[:, 1, 1]
            - d[:, 0] * d[:, 1] * (Qv[:, 0, 1] + Qv[:, 1, 0])
            + d[:, 1] ** 2 * Qv[:, 0, 0]
        ) / det
        Q[view] = Qv
        M[view] = Mv[:, None]

    return {"mahalanobis": M, "posterior_variance": Q, "reconstructed": xhat}


def _inv_batched_small(A: np.ndarray) -> np.ndarray:
    """Batched inverse of (N, L, L) matrices: closed-form adjugate for
    L <= 3 (batched LAPACK getri via np.linalg.inv loops per matrix and is
    ~40x slower at these sizes), np.linalg.inv beyond."""
    L = A.shape[-1]
    if L == 1:
        return 1.0 / A
    if L == 2:
        det = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
        out = np.empty_like(A)
        out[:, 0, 0] = A[:, 1, 1]
        out[:, 1, 1] = A[:, 0, 0]
        out[:, 0, 1] = -A[:, 0, 1]
        out[:, 1, 0] = -A[:, 1, 0]
        return out / det[:, None, None]
    if L == 3:
        a, b, c = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
        d, e, f = A[:, 1, 0], A[:, 1, 1], A[:, 1, 2]
        g, h, i = A[:, 2, 0], A[:, 2, 1], A[:, 2, 2]
        co00 = e * i - f * h
        co01 = f * g - d * i
        co02 = d * h - e * g
        det = a * co00 + b * co01 + c * co02
        out = np.empty_like(A)
        out[:, 0, 0] = co00
        out[:, 0, 1] = c * h - b * i
        out[:, 0, 2] = b * f - c * e
        out[:, 1, 0] = co01
        out[:, 1, 1] = a * i - c * g
        out[:, 1, 2] = c * d - a * f
        out[:, 2, 0] = co02
        out[:, 2, 1] = b * g - a * h
        out[:, 2, 2] = a * e - b * d
        return out / det[:, None, None]
    return np.linalg.inv(A)
