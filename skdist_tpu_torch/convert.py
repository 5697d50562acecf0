"""Carry a fitted model from the JAX package into the port.

``logistic_regression_from_reference`` takes the fitted state of a JAX
``skdist_tpu`` ``LogisticRegression`` as plain numpy (its ``_params``
and ``_meta``) and returns a fitted port ``LogisticRegression`` that
computes the same ``decision_function`` and ``predict_proba``: the
counterpart of ``_set_fitted`` in ``skdist_tpu/models/linear.py``. The
two packages share the weight layout (``W`` is ``(p,)`` binary or
``(p, k)``, rows ``[:d]`` the coefficients and row ``d`` the intercept
when fitted), so nothing is reshaped. Carrying weights the other way
waits for a later slice.
"""

import numpy as np

from .models.linear import LogisticRegression

__all__ = ["logistic_regression_from_reference"]


def logistic_regression_from_reference(params, meta, device=None):
    """A fitted port ``LogisticRegression`` from the JAX package's
    ``params`` (``{"W": ..., "n_iter": ...}``) and ``meta``
    (``classes``, ``n_features``, ``n_classes``; ``cw_arr`` optional)."""
    W = np.asarray(params["W"], dtype=np.float32)
    d = int(meta["n_features"])
    n_classes = int(meta["n_classes"])
    classes = np.asarray(meta["classes"])
    if len(classes) != n_classes:
        raise ValueError(
            f"meta has {len(classes)} classes but n_classes={n_classes}"
        )
    want_ndim = 1 if n_classes <= 2 else 2
    if W.ndim != want_ndim or (want_ndim == 2 and W.shape[1] != n_classes):
        raise ValueError(
            f"W of shape {W.shape} does not fit {n_classes} classes"
        )
    if W.shape[0] not in (d, d + 1):
        raise ValueError(
            f"W has {W.shape[0]} rows; expected {d} or {d + 1} for "
            f"{d} features"
        )
    est = LogisticRegression(fit_intercept=W.shape[0] == d + 1,
                             device=device)
    fitted = {"W": W}
    if "n_iter" in params:
        fitted["n_iter"] = np.asarray(params["n_iter"])
    est._set_fitted(fitted, {
        "n_features": d,
        "classes": classes,
        "n_classes": n_classes,
        "cw_arr": meta.get("cw_arr"),
        "x_format": meta.get("x_format", "dense"),
    })
    return est
