"""
The f64 host engine of the linear classifiers.

Counterpart of ``skdist_tpu/models/host_linear.py``, copied: numpy and
scipy only, no torch. It minimises the objectives of
``LogisticRegression`` and ``LinearSVC`` (``models/linear.py``: the same
loss, intercept unpenalised, the same class weighting) in float64 with
scipy's L-BFGS-B, the solver scikit-learn's ``LogisticRegression``
wraps, on BLAS-rate host matmuls. The batched torch engine and this one
minimise the same convex objective, so they agree at the optimum to
solver tolerance; they stop differently at the same ``tol`` (here
scipy's ``gtol`` on the weight-mean-scaled objective, as scikit-learn
scales it; there ``max|g| <= tol`` on the weight-sum-scaled one).

``engine='auto'`` runs this engine where the estimator's device is the
CPU, and never on the card; ``engine='host'`` pins it anywhere
(``models/linear.py _resolve_host_engine``).
"""

import numpy as np

__all__ = ["logreg_host_fit", "svc_host_fit", "host_engine_available"]


def host_engine_available():
    try:
        from scipy.optimize import minimize  # noqa: F401

        return True
    except Exception:  # pragma: no cover - scipy is a dependency
        return False


def _class_weighted_sw(sw, y_idx, k, class_weight, cw_arr):
    """Numpy mirror of ``linear._apply_class_weight`` (the same
    'balanced' rule on the current weights)."""
    if class_weight is None:
        return sw
    counts = np.bincount(y_idx, weights=sw, minlength=k)
    if class_weight == "balanced":
        per_class = sw.sum() / (k * np.maximum(counts, 1e-12))
        per_class = np.where(counts > 0, per_class, 0.0)
    else:
        per_class = np.asarray(cw_arr, dtype=np.float64)
    return sw * per_class[y_idx]


def logreg_host_fit(X, y_idx, sw, *, C, tol, max_iter, fit_intercept,
                    n_classes, history, class_weight, cw_arr, w0=None):
    """Fit one logistic regression on host; returns the same params
    dict the torch fit kernel yields (``{"W", "n_iter"}``, f32) plus
    the f64 optimum for warm-starting the next fit along a C path —
    or None in its place when the solver stopped on ``max_iter``
    rather than ``tol``: an unconverged endpoint depends on where the
    solve started, and seeding a warm C path with it would make CV
    scores depend on which other C values share the grid.

    Objective identical to ``LogisticRegression._build_fit_problem``:
    binary uses the single-column softplus form, multinomial the
    softmax CE, both with the intercept column excluded from the
    ridge term.
    """
    from scipy.optimize import minimize
    from scipy.special import expit

    X = np.asarray(X, dtype=np.float64)
    n, d = X.shape
    k = int(n_classes)
    sw = _class_weighted_sw(
        np.asarray(sw, dtype=np.float64), y_idx, k, class_weight, cw_arr
    )
    Xa = np.concatenate([X, np.ones((n, 1))], axis=1) if fit_intercept else X
    p = Xa.shape[1]
    inv_C = 1.0 / float(C)
    binary = k <= 2
    # The minimised function is the weight-MEAN-scaled objective (both
    # terms divided by Σsw — sklearn's own internal scaling), so
    # scipy's gtol=tol stops at the same effective precision sklearn's
    # LogisticRegression(tol=...) does: iteration counts match sklearn
    # instead of growing with n. Scaling does not move the optimum, so
    # engine parity with the (sum-scaled) torch kernel holds at the
    # solution; only the stopping rule's absolute scale differs.
    scale = 1.0 / max(float(sw.sum()), 1e-12)

    if binary:
        ypm = (y_idx == (k - 1)).astype(np.float64)

        def fun(w):
            z = Xa @ w
            ce = float(np.dot(sw, np.logaddexp(0.0, z) - ypm * z))
            reg = 0.5 * inv_C * float(np.dot(w[:d], w[:d]))
            resid = sw * (expit(z) - ypm)
            g = Xa.T @ resid
            g[:d] += inv_C * w[:d]
            return scale * (ce + reg), scale * g

        x0 = np.zeros(p) if w0 is None else np.asarray(w0, np.float64)
        res = minimize(
            fun, x0, jac=True, method="L-BFGS-B",
            options={"maxiter": int(max_iter), "maxcor": int(history),
                     "gtol": float(tol), "ftol": 1e-12},
        )
        params = {"W": res.x.astype(np.float32),
                  "n_iter": np.int32(res.nit)}
        return params, (res.x if res.status == 0 else None)

    onehot_rows = np.arange(n)

    def fun(wflat):
        W = wflat.reshape(p, k)
        z = Xa @ W
        zmax = z.max(axis=1)
        ez = np.exp(z - zmax[:, None])
        sez = ez.sum(axis=1)
        lse = zmax + np.log(sez)
        ce = float(np.dot(sw, lse - z[onehot_rows, y_idx]))
        P = ez / sez[:, None]
        P[onehot_rows, y_idx] -= 1.0
        G = Xa.T @ (sw[:, None] * P)
        G[:d] += inv_C * W[:d]
        reg = 0.5 * inv_C * float(np.sum(W[:d] * W[:d]))
        return scale * (ce + reg), scale * G.ravel()

    x0 = np.zeros(p * k) if w0 is None else np.asarray(w0, np.float64)
    res = minimize(
        fun, x0, jac=True, method="L-BFGS-B",
        options={"maxiter": int(max_iter), "maxcor": int(history),
                 "gtol": float(tol), "ftol": 1e-12},
    )
    params = {"W": res.x.reshape(p, k).astype(np.float32),
              "n_iter": np.int32(res.nit)}
    return params, (res.x if res.status == 0 else None)


def svc_host_fit(X, y_idx, sw, *, C, tol, max_iter, fit_intercept,
                 n_classes, history, class_weight, cw_arr, w0=None):
    """Squared-hinge linear SVM on host (objective identical to
    ``LinearSVC._build_fit_problem``: ``0.5·‖W[:d]‖² + C·Σ sw·max(0,
    1−y·z)²``, intercept unpenalised, one-vs-rest columns solved
    jointly). Same mean-scaling/stopping treatment as
    :func:`logreg_host_fit`."""
    from scipy.optimize import minimize

    X = np.asarray(X, dtype=np.float64)
    n, d = X.shape
    k = int(n_classes)
    sw = _class_weighted_sw(
        np.asarray(sw, dtype=np.float64), y_idx, k, class_weight, cw_arr
    )
    Xa = np.concatenate([X, np.ones((n, 1))], axis=1) if fit_intercept else X
    p = Xa.shape[1]
    Cf = float(C)
    scale = 1.0 / max(float(sw.sum()), 1e-12)
    binary = k <= 2

    if binary:
        ypm = np.where(y_idx == (k - 1), 1.0, -1.0)

        def fun(w):
            z = Xa @ w
            margin = np.maximum(0.0, 1.0 - ypm * z)
            val = 0.5 * float(np.dot(w[:d], w[:d])) \
                + Cf * float(np.dot(sw, margin * margin))
            g = -2.0 * Cf * (Xa.T @ (sw * margin * ypm))
            g[:d] += w[:d]
            return scale * val, scale * g

        x0 = np.zeros(p) if w0 is None else np.asarray(w0, np.float64)
        res = minimize(
            fun, x0, jac=True, method="L-BFGS-B",
            options={"maxiter": int(max_iter), "maxcor": int(history),
                     "gtol": float(tol), "ftol": 1e-12},
        )
        return ({"W": res.x.astype(np.float32),
                 "n_iter": np.int32(res.nit)},
                res.x if res.status == 0 else None)

    Ypm = np.full((n, k), -1.0)
    Ypm[np.arange(n), y_idx] = 1.0

    def fun(wflat):
        W = wflat.reshape(p, k)
        margin = np.maximum(0.0, 1.0 - Ypm * (Xa @ W))
        val = 0.5 * float(np.sum(W[:d] * W[:d])) \
            + Cf * float(np.dot(sw, (margin * margin).sum(axis=1)))
        G = -2.0 * Cf * (Xa.T @ (sw[:, None] * margin * Ypm))
        G[:d] += W[:d]
        return scale * val, scale * G.ravel()

    x0 = np.zeros(p * k) if w0 is None else np.asarray(w0, np.float64)
    res = minimize(
        fun, x0, jac=True, method="L-BFGS-B",
        options={"maxiter": int(max_iter), "maxcor": int(history),
                 "gtol": float(tol), "ftol": 1e-12},
    )
    return ({"W": res.x.reshape(p, k).astype(np.float32),
             "n_iter": np.int32(res.nit)},
            res.x if res.status == 0 else None)
