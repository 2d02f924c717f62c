"""KID: the unbiased MMD^2 with a cubic polynomial kernel over random
subsets of the two sets' Inception activations, mean and spread over the
subsets.  Port of `rick_tpu/metrics/kid.py` (numpy, as there): k(x, y) =
(x.y / d + 1)^3, subsets of min(1000, n) drawn without replacement by
`rng.choice`, from `np.random.default_rng(seed)` or, when `seed` is None,
from the global `np.random`, as the reference draws them.  The in-loop
evaluator's KID is `evaluator.kid_subsets`, on the device.
"""

from __future__ import annotations

import numpy as np

from rick_tpu_torch.metrics.fid import get_activations
from rick_tpu_torch.metrics.inception import InceptionV3


def _sqn(arr):
    flat = np.ravel(arr)
    return flat.dot(flat)


def _polynomial_kernel(X, Y=None, degree=3, gamma=None, coef0=1.0):
    if Y is None:
        Y = X
    if gamma is None:
        gamma = 1.0 / X.shape[1]
    return (gamma * X.dot(Y.T) + coef0) ** degree


def _mmd2_and_variance(K_XX, K_XY, K_YY, var_at_m=None, ret_var=True):
    """The unbiased MMD^2 and its variance (`kid_score.py:292-373`).

    The estimator, names and term layout included, is dougalsutherland/opt-mmd's
    (BSD licensed; Sutherland et al., "Generative Models and Model Criticism via
    Optimized MMD", ICLR 2017), which the reference vendored; the published
    unbiased-MMD^2 and variance formulas fix its algebra."""
    m = K_XX.shape[0]
    if var_at_m is None:
        var_at_m = m

    diag_X = np.diagonal(K_XX)
    diag_Y = np.diagonal(K_YY)
    sum_diag2_X = _sqn(diag_X)
    sum_diag2_Y = _sqn(diag_Y)

    Kt_XX_sums = K_XX.sum(axis=1) - diag_X
    Kt_YY_sums = K_YY.sum(axis=1) - diag_Y
    K_XY_sums_0 = K_XY.sum(axis=0)
    K_XY_sums_1 = K_XY.sum(axis=1)

    Kt_XX_sum = Kt_XX_sums.sum()
    Kt_YY_sum = Kt_YY_sums.sum()
    K_XY_sum = K_XY_sums_0.sum()

    mmd2 = (Kt_XX_sum + Kt_YY_sum) / (m * (m - 1)) - 2 * K_XY_sum / (m * m)
    if not ret_var:
        return mmd2

    Kt_XX_2_sum = _sqn(K_XX) - sum_diag2_X
    Kt_YY_2_sum = _sqn(K_YY) - sum_diag2_Y
    K_XY_2_sum = _sqn(K_XY)
    dot_XX_XY = Kt_XX_sums.dot(K_XY_sums_1)
    dot_YY_YX = Kt_YY_sums.dot(K_XY_sums_0)
    m1 = m - 1
    m2 = m - 2
    zeta1_est = (
        1 / (m * m1 * m2) * (_sqn(Kt_XX_sums) - Kt_XX_2_sum + _sqn(Kt_YY_sums) - Kt_YY_2_sum)
        - 1 / (m * m1) ** 2 * (Kt_XX_sum**2 + Kt_YY_sum**2)
        + 1 / (m * m * m1) * (_sqn(K_XY_sums_1) + _sqn(K_XY_sums_0) - 2 * K_XY_2_sum)
        - 2 / m**4 * K_XY_sum**2
        - 2 / (m * m * m1) * (dot_XX_XY + dot_YY_YX)
        + 2 / (m**3 * m1) * (Kt_XX_sum + Kt_YY_sum) * K_XY_sum
    )
    zeta2_est = (
        1 / (m * m1) * (Kt_XX_2_sum + Kt_YY_2_sum)
        - 1 / (m * m1) ** 2 * (Kt_XX_sum**2 + Kt_YY_sum**2)
        + 2 / (m * m) * K_XY_2_sum
        - 2 / m**4 * K_XY_sum**2
        - 4 / (m * m * m1) * (dot_XX_XY + dot_YY_YX)
        + 4 / (m**3 * m1) * (Kt_XX_sum + Kt_YY_sum) * K_XY_sum
    )
    var_est = (
        4 * (var_at_m - 2) / (var_at_m * (var_at_m - 1)) * zeta1_est
        + 2 / (var_at_m * (var_at_m - 1)) * zeta2_est
    )
    return mmd2, var_est


def polynomial_mmd_averages(codes_g, codes_r, n_subsets=50, subset_size=1000, *, seed=None):
    """(mmd2, variance) of each of `n_subsets` subsets."""
    m = min(codes_g.shape[0], codes_r.shape[0])
    subset_size = min(subset_size, m)
    mmds = np.zeros(n_subsets)
    vars_ = np.zeros(n_subsets)
    rng = np.random.default_rng(seed) if seed is not None else np.random
    for i in range(n_subsets):
        g = codes_g[rng.choice(len(codes_g), subset_size, replace=False)]
        r = codes_r[rng.choice(len(codes_r), subset_size, replace=False)]
        K_XX = _polynomial_kernel(g)
        K_YY = _polynomial_kernel(r)
        K_XY = _polynomial_kernel(g, r)
        mmds[i], vars_[i] = _mmd2_and_variance(K_XX, K_XY, K_YY, var_at_m=m)
    return mmds, vars_


def calculate_kid_given_images(imgs0, imgs1, model: InceptionV3, batch_size: int = 16, *,
                               n_subsets: int = 100, seed=None):
    """(kid_mean, kid_std) between two image sets by `model`
    (`kid_score.py:376-394`); each set's trailing partial batch is left out,
    as `get_activations` does."""
    act0 = get_activations(imgs0, batch_size, model)
    act1 = get_activations(imgs1, batch_size, model)
    mmds, _ = polynomial_mmd_averages(act0, act1, n_subsets=n_subsets, seed=seed)
    return float(mmds.mean()), float(mmds.std())
