"""Scalar root solvers and small math tools: the port's own copy of
``mpp_tpu/ops/mathtools.py`` (pure Python).

Reimplements ``src/mpp/ge/MathTools.F90``:

* ``hybrid``  (MathTools.F90:38-132)  — secant iteration with Brent backup
* ``zbrent``  (MathTools.F90:135-235) — Brent's method
* ``tridiag`` (MathTools.F90:238-283) — Thomas algorithm (host-side; the
  batched variant lives in ``ops/tridiag.py``)
* ``beta_function`` / ``log_gamma_function`` (MathTools.F90:286-340)

These are host-side float64 scalar routines used where the reference uses
them: once-per-solve setup scalars (e.g. the Obukhov-length fixed point in
the canopy turbulence presolve), where trajectory-exact transcription
matters for regression parity and the work is O(10) evaluations per
column.  Hot per-cell math stays in batched tensor ops.
"""
from __future__ import annotations

import math


def hybrid(func, xa: float, xb: float, tol: float, itmax: int = 40) -> float:
    """Root of ``func`` from estimates xa/xb (MathTools.F90:38-132).

    Secant iterations; switches to :func:`zbrent` once a sign change
    brackets the root; falls back to the minimum-f iterate after ``itmax``.
    ``func`` may carry side effects (the reference's Obukhov function
    mutates turbulence state on every evaluation) — the call sequence is
    transcribed exactly so the final side-effect state matches.
    """
    x0 = xa
    f0 = func(x0)
    if f0 == 0.0:
        return x0
    x1 = xb
    f1 = func(x1)
    if f1 == 0.0:
        return x1

    # NOTE: reference compares raw f, not |f| (MathTools.F90:85-91)
    if f1 < f0:
        minx, minf = x1, f1
    else:
        minx, minf = x0, f0

    it = 0
    while True:
        it += 1
        dx = -f1 * (x1 - x0) / (f1 - f0)
        x = x1 + dx
        if abs(dx) < tol:
            x0 = x
            break
        x0, f0 = x1, f1
        x1 = x
        f1 = func(x1)
        if f1 < minf:
            minx, minf = x1, f1
        if f1 * f0 < 0.0:
            x = zbrent(func, x0, x1, tol)
            x0 = x
            break
        if it > itmax:
            f1 = func(minx)
            x0 = minx
            break
    return x0


def zbrent(func, xa: float, xb: float, tol: float,
           itmax: int = 50, eps: float = 1.0e-8) -> float:
    """Brent's method on a bracketing interval (MathTools.F90:135-235)."""
    a, b = xa, xb
    fa = func(a)
    fb = func(b)
    if (fa > 0.0 and fb > 0.0) or (fa < 0.0 and fb < 0.0):
        raise ValueError("zbrent: root must be bracketed")
    c, fc = b, fb
    d = e = 0.0
    it = 0
    while True:
        if it == itmax:
            raise RuntimeError("zbrent: maximum number of iterations exceeded")
        it += 1
        if (fb > 0.0 and fc > 0.0) or (fb < 0.0 and fc < 0.0):
            c, fc = a, fa
            d = b - a
            e = d
        if abs(fc) < abs(fb):
            a, b, c = b, c, a
            fa, fb, fc = fb, fc, fa
        tol1 = 2.0 * eps * abs(b) + 0.5 * tol
        xm = 0.5 * (c - b)
        if abs(xm) <= tol1 or fb == 0.0:
            break
        if abs(e) >= tol1 and abs(fa) > abs(fb):
            s = fb / fa
            if a == c:
                p = 2.0 * xm * s
                q = 1.0 - s
            else:
                q = fa / fc
                r = fb / fc
                p = s * (2.0 * xm * q * (q - r) - (b - a) * (r - 1.0))
                q = (q - 1.0) * (r - 1.0) * (s - 1.0)
            if p > 0.0:
                q = -q
            p = abs(p)
            if 2.0 * p < min(3.0 * xm * q - abs(tol1 * q), abs(e * q)):
                e = d
                d = p / q
            else:
                d = xm
                e = d
        else:
            d = xm
            e = d
        a, fa = b, fb
        if abs(d) > tol1:
            b = b + d
        else:
            b = b + math.copysign(tol1, xm)
        fb = func(b)
        if fb == 0.0:
            break
    return b


def tridiag(a, b, c, r):
    """Thomas solve of a tridiagonal system (MathTools.F90:238-283)."""
    n = len(b)
    u = [0.0] * n
    gam = [0.0] * n
    bet = b[0]
    u[0] = r[0] / bet
    for j in range(1, n):
        gam[j] = c[j - 1] / bet
        bet = b[j] - a[j] * gam[j]
        u[j] = (r[j] - a[j] * u[j - 1]) / bet
    for j in range(n - 2, -1, -1):
        u[j] -= gam[j + 1] * u[j + 1]
    return u


def log_gamma_function(x: float) -> float:
    """ln(Gamma(x)) (MathTools.F90:316-340; Fortran ``log_gamma``)."""
    return math.lgamma(x)


def beta_function(p: float, q: float) -> float:
    """B(p,q) = exp(lnG(p)+lnG(q)-lnG(p+q)) (MathTools.F90:286-313)."""
    return math.exp(math.lgamma(p) + math.lgamma(q) - math.lgamma(p + q))
