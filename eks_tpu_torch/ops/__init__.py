"""Device-side numerics: Kalman filtering and smoothing, linalg, kernels."""
