"""Statistical hypothesis testing: χ² goodness-of-fit and Student's t-test.

Counterpart of the reference's `ext/hypothesis` header library powering its
`chi2test`/`ttest` scene objects (src/utils/chi2test.cpp, src/utils/ttest.cpp).
Pure numpy/scipy; used by the test-suite the same way the reference uses
statistical validation instead of unit asserts (SURVEY.md §4).
"""

from __future__ import annotations

import numpy as np
from scipy import stats


def chi2_merge_and_test(
    observed: np.ndarray,
    expected: np.ndarray,
    sample_count: int,
    min_exp_frequency: float = 5.0,
    significance: float = 0.01,
    dof_adjustment: int = 0,
    num_tests: int = 1,
) -> tuple[bool, str]:
    """χ² test with low-expected-count cell pooling.

    Mirrors `hypothesis::chi2_test` semantics used by chi2test.cpp:131+:
    cells with expected count < min_exp_frequency are pooled (largest-first)
    before computing the statistic; `num_tests` applies the Šidák correction
    for a battery of tests (ext/hypothesis significance adjustment).
    """
    if num_tests > 1:
        significance = 1.0 - (1.0 - significance) ** (1.0 / num_tests)
    obs = np.asarray(observed, np.float64).ravel()
    exp = np.asarray(expected, np.float64).ravel()

    order = np.argsort(exp)[::-1]
    obs, exp = obs[order], exp[order]

    pooled_obs = 0.0
    pooled_exp = 0.0
    chi2 = 0.0
    dof = 0
    for o, e in zip(obs, exp):
        if e == 0.0:
            if o > sample_count * 1e-5:
                return False, f"Expected 0 but observed {o} samples in a cell"
            continue
        if e < min_exp_frequency or pooled_exp > 0:
            # once we start pooling, pool all the remaining (sorted) small cells
            pooled_obs += o
            pooled_exp += e
        else:
            chi2 += (o - e) ** 2 / e
            dof += 1
    if pooled_exp > min_exp_frequency:
        chi2 += (pooled_obs - pooled_exp) ** 2 / pooled_exp
        dof += 1
    dof -= 1 + dof_adjustment
    if dof <= 0:
        return False, f"Degrees of freedom {dof} <= 0"
    pval = stats.chi2.sf(chi2, dof)
    ok = bool(pval > significance)
    return ok, f"chi2={chi2:.2f} dof={dof} p={pval:.4f} (alpha={significance})"


def students_t_test(
    mean: float,
    variance: float,
    n: int,
    reference: float,
    significance: float = 0.01,
    num_tests: int = 1,
) -> tuple[bool, str]:
    """Two-sided one-sample t-test, as in hypothesis/ttest.cpp:157-189;
    `num_tests` applies the Šidák battery correction."""
    if num_tests > 1:
        significance = 1.0 - (1.0 - significance) ** (1.0 / num_tests)
    # float32 quantization floor: a constant estimator (e.g. furnace scenes,
    # where every sample is the identical value) has variance ~0 and any
    # rounding of the mean explodes the t statistic; means within f32 eps of
    # the reference are equal by construction
    if abs(mean - reference) <= 1e-5 * max(1.0, abs(reference)):
        return True, f"exact (within f32 eps) mean={mean:.6f} ref={reference:.6f}"
    if variance <= 0:
        return False, f"zero-variance mean={mean} ref={reference}"
    t = (mean - reference) / np.sqrt(variance / n)
    pval = 2.0 * stats.t.sf(abs(t), n - 1)
    ok = bool(pval > significance)
    return ok, f"t={t:.3f} p={pval:.4f} mean={mean:.6f} ref={reference:.6f}"


def chi2_sphere_test(
    sample_fn,
    pdf_fn,
    n_samples: int = 200_000,
    theta_res: int = 10,
    phi_res: int = 20,
    seed: int = 0,
    significance: float = 0.01,
    integration_res: int = 16,
) -> tuple[bool, str]:
    """χ² test that a spherical sampler matches its pdf, as chi2test.cpp does.

    `sample_fn(u2 [n,2]) -> dirs [n,3]`; `pdf_fn(dirs [m,3]) -> [m]` (solid-angle
    density). Expected cell counts are numerically integrated on a
    theta×phi grid subdivided `integration_res`× per cell.
    """
    rng = np.random.default_rng(seed)
    u = rng.random((n_samples, 2), dtype=np.float64).astype(np.float32)
    dirs = np.asarray(sample_fn(u))

    theta = np.arccos(np.clip(dirs[:, 2], -1.0, 1.0))
    phi = np.arctan2(dirs[:, 1], dirs[:, 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    ti = np.minimum((theta / np.pi * theta_res).astype(int), theta_res - 1)
    pi_ = np.minimum((phi / (2 * np.pi) * phi_res).astype(int), phi_res - 1)
    observed = np.zeros((theta_res, phi_res))
    np.add.at(observed, (ti, pi_), 1.0)

    # numerically integrate pdf over each cell (midpoint rule on a sub-grid)
    k = integration_res
    t_edges = np.linspace(0, np.pi, theta_res * k + 1)
    p_edges = np.linspace(0, 2 * np.pi, phi_res * k + 1)
    t_mid = 0.5 * (t_edges[:-1] + t_edges[1:])
    p_mid = 0.5 * (p_edges[:-1] + p_edges[1:])
    tt, pp = np.meshgrid(t_mid, p_mid, indexing="ij")
    d = np.stack(
        [np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp), np.cos(tt)], axis=-1
    ).astype(np.float32)
    pdf = np.asarray(pdf_fn(d.reshape(-1, 3))).reshape(tt.shape).astype(np.float64)
    cell_area = (np.pi / (theta_res * k)) * (2 * np.pi / (phi_res * k))
    integrand = pdf * np.sin(tt) * cell_area
    expected = integrand.reshape(theta_res, k, phi_res, k).sum(axis=(1, 3)) * n_samples

    return chi2_merge_and_test(observed, expected, n_samples, significance=significance)
