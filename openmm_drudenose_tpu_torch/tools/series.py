"""Statistics of the long-run tools' sample series (host, numpy).

`fit` gives a series' mean, its ordinary least-squares drift per ns and
the lag-1 autocorrelation of the fit's residuals, as the JAX package's
scripts/measure_drift.py::fit_report computes them, and beside each
plain standard error the one the bands read: the standard error of
block averages, times sqrt((1 + rho) / (1 - rho)) for the AR(1)
correlation left between blocks (rho taken at 0 where it is negative,
so the factor only widens; at most 0.9).
"""

from __future__ import annotations

import numpy as np


def ar1_rho(x: np.ndarray) -> float:
    """Lag-1 autocorrelation of x (nan with fewer than 3 values)."""
    x = np.asarray(x, np.float64)
    if len(x) < 3 or np.std(x) == 0.0:
        return float("nan")
    return float(np.corrcoef(x[:-1], x[1:])[0, 1])


def inflation(rho: float) -> float:
    """sqrt((1 + rho) / (1 - rho)), rho clipped to [0, 0.9]."""
    r = 0.0 if not np.isfinite(rho) else min(max(rho, 0.0), 0.9)
    return float(np.sqrt((1.0 + r) / (1.0 - r)))


def block_means(x: np.ndarray, block: int) -> np.ndarray:
    """Means of consecutive blocks of `block` samples (a short last block
    dropped)."""
    x = np.asarray(x, np.float64)
    n = len(x) // block
    return x[:n * block].reshape(n, block).mean(axis=1)


def block_se(x: np.ndarray, block: int = 1) -> tuple:
    """(SE, rho, plain SE) of the mean of x from block averages: the
    plain SE is sd(block means) / sqrt(blocks); rho is the blocks' lag-1
    autocorrelation and SE the plain one inflated for it."""
    b = block_means(x, block)
    if len(b) < 2:
        return float("nan"), float("nan"), float("nan")
    plain = float(np.std(b, ddof=1) / np.sqrt(len(b)))
    rho = ar1_rho(b - b.mean())
    return plain * inflation(rho), rho, plain


def fit(t_ns: np.ndarray, y: np.ndarray) -> dict:
    """A series y sampled at times t_ns (ns): its mean with the plain
    and inflated SE (blocks of one sample), its per-sample sd (ddof 0,
    as numpy.std in the JAX script), the OLS
    drift (K/ns for temperatures) with the plain SE of the slope (the
    JAX fit_report's) and the slope's SE inflated by the residuals'
    AR(1) rho."""
    t = np.asarray(t_ns, np.float64)
    y = np.asarray(y, np.float64)
    m = len(y)
    out = {"n": m, "mean": float(np.mean(y)),
           "sd": float(np.std(y)) if m > 1 else float("nan")}
    if m < 3:
        out.update(drift=float("nan"), drift_se=float("nan"),
                   drift_se_ar1=float("nan"), rho=float("nan"),
                   mean_se=float("nan"), mean_se_ar1=float("nan"))
        return out
    a = np.vstack([t, np.ones_like(t)]).T
    coef, *_ = np.linalg.lstsq(a, y, rcond=None)
    resid = y - a @ coef
    se = float(np.sqrt(np.sum(resid ** 2) / (m - 2)
                       / np.sum((t - t.mean()) ** 2)))
    rho = ar1_rho(resid)
    plain_mean_se = float(np.std(y, ddof=1)) / np.sqrt(m)
    out.update(drift=float(coef[0]), drift_se=se,
               drift_se_ar1=se * inflation(rho), rho=rho,
               mean_se=float(plain_mean_se),
               mean_se_ar1=float(plain_mean_se * inflation(ar1_rho(
                   y - y.mean()))))
    return out


def within(value: float, ref: float, se: float, ref_se: float = 0.0
           ) -> tuple:
    """(held, the band's half width): |value - ref| <= 3 sqrt(se^2 +
    ref_se^2)."""
    half = 3.0 * float(np.sqrt(se * se + ref_se * ref_se))
    return bool(abs(value - ref) <= half), half
