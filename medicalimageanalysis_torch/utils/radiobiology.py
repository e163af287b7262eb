"""Radiobiological dose conversion + outcome models.

Copied from medicalimageanalysis_tpu/utils/radiobiology.py (pure numpy,
host float64): the port keeps its own copy of what it needs from the JAX
package. Formulas follow the standard LQ / Niemierko / LKB literature:

- BED   = D * (1 + d / (alpha/beta))          (d = dose per fraction)
- EQD2  = D * (d + ab) / (2 + ab)             (equieffective in 2 Gy/fx)
- gEUD  = (mean(D_i^a))^(1/a)                 (Niemierko generalized EUD)
- NTCP (LKB probit):      Phi((gEUD - TD50) / (m * TD50)), a = 1/n
- NTCP/TCP (logistic):    1 / (1 + (D50 / gEUD)^(4 * gamma50))

All take plain arrays (e.g. ``Dose.compute_roi_dose_array`` output or a
whole grid); ``Dose`` exposes the grid-level conveniences
(``compute_eqd2`` / ``compute_bed`` register first-class Dose objects so
every DVH analytic works on the converted grid).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["bed", "eqd2", "geud", "ntcp_lkb", "ntcp_logistic",
           "tcp_logistic"]


def _per_fraction(dose, n_fractions):
    n = float(n_fractions)
    if n <= 0:
        raise ValueError("n_fractions must be positive")
    return np.asarray(dose, np.float64) / n


def bed(dose, n_fractions, alpha_beta):
    """Biologically effective dose, voxel-wise LQ:
    BED = D (1 + d/ab) with d the per-fraction dose of each voxel."""
    ab = float(alpha_beta)
    if ab <= 0:
        raise ValueError("alpha_beta must be positive")
    D = np.asarray(dose, np.float64)
    return (D * (1.0 + _per_fraction(D, n_fractions) / ab)).astype(
        np.float32)


def eqd2(dose, n_fractions, alpha_beta):
    """Equieffective dose in 2 Gy fractions:
    EQD2 = D (d + ab) / (2 + ab)."""
    ab = float(alpha_beta)
    if ab <= 0:
        raise ValueError("alpha_beta must be positive")
    D = np.asarray(dose, np.float64)
    d = _per_fraction(D, n_fractions)
    return (D * (d + ab) / (2.0 + ab)).astype(np.float32)


def geud(dose_in_roi, a):
    """Niemierko generalized EUD of the ROI dose distribution.

    a > 1 emphasises hot spots (serial organs), a = 1 is the mean,
    a < 0 emphasises cold spots (targets). a == 0 is the geometric
    mean (the a -> 0 limit).
    """
    D = np.asarray(dose_in_roi, np.float64).ravel()
    if D.size == 0:
        return 0.0
    a = float(a)
    if a == 0.0:
        return float(np.exp(np.mean(np.log(np.maximum(D, 1e-12)))))
    # power mean in log space for numerical range safety
    Dpos = np.maximum(D, 1e-12)
    m = np.max(Dpos) if a > 0 else np.min(Dpos)
    return float(m * np.mean((Dpos / m) ** a) ** (1.0 / a))


def ntcp_lkb(dose_in_roi, td50, m, n):
    """Lyman-Kutcher-Burman NTCP with gEUD volume reduction
    (a = 1/n): NTCP = Phi(t), t = (gEUD - TD50) / (m TD50)."""
    if n <= 0 or m <= 0 or td50 <= 0:
        raise ValueError("td50, m, n must be positive")
    eud = geud(dose_in_roi, 1.0 / float(n))
    t = (eud - float(td50)) / (float(m) * float(td50))
    return {"ntcp": 0.5 * (1.0 + math.erf(t / math.sqrt(2.0))),
            "gEUD": eud, "t": t}


def _logistic(eud, d50, gamma50):
    if eud <= 0:
        return 0.0
    return 1.0 / (1.0 + (float(d50) / eud) ** (4.0 * float(gamma50)))


def ntcp_logistic(dose_in_roi, td50, gamma50, a):
    """Niemierko logistic NTCP: 1 / (1 + (TD50/gEUD)^(4 gamma50))."""
    eud = geud(dose_in_roi, a)
    return {"ntcp": _logistic(eud, td50, gamma50), "gEUD": eud}


def tcp_logistic(dose_in_roi, tcd50, gamma50, a=-10.0):
    """Niemierko logistic TCP (a < 0 weights cold spots):
    1 / (1 + (TCD50/gEUD)^(4 gamma50))."""
    eud = geud(dose_in_roi, a)
    return {"tcp": _logistic(eud, tcd50, gamma50), "gEUD": eud}
