"""Parameter inference — the ``fitting`` subtype specifier (paper §3.4.3).

Given measured costs at *sampled* PP values, infer the cost over the whole
``varied`` range and return the predicted-optimal PP value:

  * ``least-squares <order>`` — polynomial least squares.
  * ``dspline``               — discrete (natural cubic) spline through the
                                samples, evaluated on the integer grid; the
                                paper credits the d-spline method to the
                                Tanaka Laboratory, Kogakuin University.
  * ``user-defined <expr>``   — least squares over user basis terms; the
                                expression is linear in free coefficients
                                ``c0..cK`` and may reference ``x`` and BPs.
  * ``auto``                  — model selection by leave-one-out CV among
                                polynomial orders 1..5 and the d-spline.

If ``fitting`` is omitted the search is exhaustive over the full range
(handled by search.py; this module is only consulted when sampling is used).
"""
from __future__ import annotations

import math
import re
from typing import Callable, Sequence

import numpy as np

from .errors import OATSpecError
from .region import Fitting


# --------------------------------------------------------------------------
# basic fitters: fit(xs, ys) -> predict(grid) -> np.ndarray
# --------------------------------------------------------------------------

def fit_polynomial(xs: Sequence[float], ys: Sequence[float], order: int
                   ) -> Callable[[np.ndarray], np.ndarray]:
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    order = min(order, len(xs) - 1) if len(xs) > 1 else 0
    # scale x for conditioning
    mu, sd = xs.mean(), xs.std() or 1.0
    coeffs = np.polyfit((xs - mu) / sd, ys, order)

    def predict(grid: np.ndarray) -> np.ndarray:
        return np.polyval(coeffs, (np.asarray(grid, np.float64) - mu) / sd)

    return predict


def fit_dspline(xs: Sequence[float], ys: Sequence[float]
                ) -> Callable[[np.ndarray], np.ndarray]:
    """Natural cubic spline through (xs, ys), evaluated on a discrete grid.

    Classic tridiagonal construction; linear extrapolation outside the hull.
    """
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)
    order = np.argsort(xs)
    xs, ys = xs[order], ys[order]
    n = len(xs)
    if n < 3:
        return fit_polynomial(xs, ys, 1)
    h = np.diff(xs)
    if np.any(h == 0):
        raise OATSpecError("dspline requires distinct sample points")
    # second derivatives M solve: tridiagonal natural-spline system
    a = np.zeros((n, n))
    rhs = np.zeros(n)
    a[0, 0] = a[-1, -1] = 1.0
    for i in range(1, n - 1):
        a[i, i - 1] = h[i - 1]
        a[i, i] = 2.0 * (h[i - 1] + h[i])
        a[i, i + 1] = h[i]
        rhs[i] = 6.0 * ((ys[i + 1] - ys[i]) / h[i] - (ys[i] - ys[i - 1]) / h[i - 1])
    m = np.linalg.solve(a, rhs)

    def predict(grid: np.ndarray) -> np.ndarray:
        g = np.asarray(grid, dtype=np.float64)
        out = np.empty_like(g)
        for j, x in enumerate(g):
            if x <= xs[0]:
                slope = (ys[1] - ys[0]) / h[0] - h[0] * m[1] / 6.0
                out[j] = ys[0] + slope * (x - xs[0])
                continue
            if x >= xs[-1]:
                slope = (ys[-1] - ys[-2]) / h[-1] + h[-1] * m[-2] / 6.0
                out[j] = ys[-1] + slope * (x - xs[-1])
                continue
            i = int(np.searchsorted(xs, x) - 1)
            i = min(max(i, 0), n - 2)
            t0, t1 = x - xs[i], xs[i + 1] - x
            out[j] = (m[i] * t1 ** 3 + m[i + 1] * t0 ** 3) / (6 * h[i]) \
                + (ys[i] / h[i] - m[i] * h[i] / 6) * t1 \
                + (ys[i + 1] / h[i] - m[i + 1] * h[i] / 6) * t0
        return out

    return predict


_COEF_RE = re.compile(r"\bc(\d+)\b")
_SAFE_FUNCS = {"log": np.log, "dlog": np.log, "log2": np.log2, "exp": np.exp,
               "sqrt": np.sqrt, "abs": np.abs, "min": np.minimum,
               "max": np.maximum, "pi": math.pi}


def fit_user_defined(xs: Sequence[float], ys: Sequence[float], expr: str,
                     env: dict | None = None
                     ) -> Callable[[np.ndarray], np.ndarray]:
    """Least squares with a user expression linear in coefficients c0..cK.

    e.g. ``"c0 + c1*x + c2*x*log(x)"`` (paper: 'infer using the least squares
    method, using the mathematical expression specified by the user').
    Implemented by evaluating the expression's gradient w.r.t. each
    coefficient (finite basis extraction: set ck=1, others=0 — valid because
    the model is linear in c).
    """
    ks = sorted({int(m) for m in _COEF_RE.findall(expr)})
    if not ks:
        raise OATSpecError(f"user-defined fitting expr has no coefficients: {expr!r}")
    xs = np.asarray(xs, dtype=np.float64)
    ys = np.asarray(ys, dtype=np.float64)

    def eval_expr(x: np.ndarray, coef: dict[int, float]) -> np.ndarray:
        ns = dict(_SAFE_FUNCS)
        ns.update(env or {})
        ns["x"] = x
        for k in ks:
            ns[f"c{k}"] = coef.get(k, 0.0)
        return np.asarray(eval(expr, {"__builtins__": {}}, ns), dtype=np.float64)  # noqa: S307

    zero = eval_expr(xs, {})
    basis = np.stack([eval_expr(xs, {k: 1.0}) - zero for k in ks], axis=1)
    coef, *_ = np.linalg.lstsq(basis, ys - zero, rcond=None)
    cmap = {k: float(c) for k, c in zip(ks, coef)}

    def predict(grid: np.ndarray) -> np.ndarray:
        return eval_expr(np.asarray(grid, np.float64), cmap)

    return predict


def _loo_cv_error(xs, ys, fitter: Callable) -> float:
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    if len(xs) < 4:
        return float("inf")
    errs = []
    for i in range(len(xs)):
        m = np.ones(len(xs), bool)
        m[i] = False
        try:
            pred = fitter(xs[m], ys[m])(np.array([xs[i]]))[0]
        except Exception:
            return float("inf")
        errs.append((pred - ys[i]) ** 2)
    return float(np.mean(errs))


def fit_auto(xs: Sequence[float], ys: Sequence[float]
             ) -> Callable[[np.ndarray], np.ndarray]:
    """'auto': model selection by leave-one-out CV (poly 1..5 vs dspline)."""
    candidates: list[tuple[float, Callable]] = []
    for order in range(1, 6):
        if order >= len(xs):
            break
        err = _loo_cv_error(xs, ys, lambda a, b, o=order: fit_polynomial(a, b, o))
        candidates.append((err, fit_polynomial(xs, ys, order)))
    err = _loo_cv_error(xs, ys, fit_dspline)
    candidates.append((err, fit_dspline(xs, ys)))
    candidates.sort(key=lambda t: t[0])
    return candidates[0][1]


# --------------------------------------------------------------------------
# entry point used by search.py
# --------------------------------------------------------------------------

def fitted_minimum(fitting: Fitting, xs: Sequence[int], ys: Sequence[float],
                   grid: Sequence[int], env: dict | None = None) -> int:
    """Fit the sampled costs and return the grid point of minimum predicted
    cost (the paper's 'optimum parameter determined by inference')."""
    if len(xs) == 0:
        raise OATSpecError("no sample points measured")
    if len(xs) == 1:
        return int(xs[0])
    if fitting.method == "least-squares":
        predict = fit_polynomial(xs, ys, fitting.order)
    elif fitting.method == "dspline":
        predict = fit_dspline(xs, ys)
    elif fitting.method == "user-defined":
        if not fitting.expr:
            raise OATSpecError("user-defined fitting requires an expression")
        predict = fit_user_defined(xs, ys, fitting.expr, env)
    elif fitting.method == "auto":
        predict = fit_auto(xs, ys)
    else:
        raise OATSpecError(f"unknown fitting method {fitting.method!r}")
    g = np.asarray(list(grid), dtype=np.float64)
    pred = predict(g)
    return int(g[int(np.argmin(pred))])


def auto_sample_points(lo: int, hi: int, budget: int = 8) -> list[int]:
    """``sampled auto`` — geometric-ish spread over [lo, hi]."""
    if hi - lo + 1 <= budget:
        return list(range(lo, hi + 1))
    pts = np.unique(np.round(np.geomspace(max(lo, 1), hi, budget)).astype(int))
    pts = pts[(pts >= lo) & (pts <= hi)]
    out = sorted(set([lo, hi]) | set(int(p) for p in pts))
    return out
