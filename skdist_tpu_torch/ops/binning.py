"""Quantile binning for the histogram trees.

Counterpart of ``skdist_tpu/ops/binning.py``. :func:`quantile_bin_edges`
and :func:`apply_bins_np` are numpy and are copied as they are;
:func:`apply_bins` is the torch form over ``(n, d)`` on any device. All
three share one rule: feature ``j`` maps ``x`` to the count of edges
``e`` with ``x >= e``, NaN goes to bin 0 (``NaN >= e`` is false), and the
``+inf`` edges that absorb duplicate quantiles are never reached by a
finite value. :func:`apply_bins` and :func:`apply_bins_np` give
bit-identical bin ids.

Not ported yet (ROADMAP): ``StreamingQuantileSketch`` (the streamed
fits, P12).
"""

import numpy as np
import torch

__all__ = ["MAX_BINS", "apply_bins", "apply_bins_np", "quantile_bin_edges"]

MAX_BINS = 256


def quantile_bin_edges(X, n_bins=32):
    """Per-feature quantile bin edges, host-side, once per fit.

    Returns ``edges`` of shape (n_features, n_bins - 1); feature j maps
    value v to bin ``searchsorted(edges[j], v, side='right')`` in
    [0, n_bins). Degenerate (constant) features get +inf edges, so all
    values land in bin 0.
    """
    X = np.asarray(X, dtype=np.float32)
    n, d = X.shape
    if not 2 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins must be in [2, {MAX_BINS}], got {n_bins}")
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    edges = np.quantile(X, qs, axis=0).T.astype(np.float32)  # (d, n_bins-1)
    # collapse duplicate edges (low-cardinality features) so empty bins
    # sit at the top; +inf keeps searchsorted stable
    for j in range(d):
        e = edges[j]
        dup = np.concatenate([[False], e[1:] <= e[:-1]])
        e[dup] = np.inf
        edges[j] = np.sort(e)
    return edges


def apply_bins_np(X, edges):
    """Numpy twin of :func:`apply_bins` (bit-identical bin ids:
    ``searchsorted(e, x, 'right')`` counts the edges <= x, and NaN is
    pinned to bin 0)."""
    X = np.asarray(X, np.float32)
    edges = np.asarray(edges, np.float32)
    out = np.empty(X.shape, np.int32)
    for j in range(X.shape[1]):
        col = X[:, j]
        idx = np.searchsorted(edges[j], col, side="right")
        nan = np.isnan(col)
        if nan.any():
            idx[nan] = 0
        out[:, j] = idx
    return out


def apply_bins(X, edges):
    """Discretise ``X (n, d)`` with ``edges (d, B-1)`` into int32 bins
    ``(n, d)`` on X's device: the count of ``x >= e`` per feature. One
    feature at a time, so the comparison temporary is ``(n, B-1)``, not
    ``(n, d, B-1)``."""
    X = torch.as_tensor(X, dtype=torch.float32)
    edges = torch.as_tensor(edges, dtype=torch.float32, device=X.device)
    if X.ndim != 2 or edges.ndim != 2 or edges.shape[0] != X.shape[1]:
        raise ValueError(
            f"X {tuple(X.shape)} and edges {tuple(edges.shape)} do not fit"
        )
    out = torch.empty(X.shape, dtype=torch.int32, device=X.device)
    for j in range(X.shape[1]):
        out[:, j] = torch.sum(X[:, j, None] >= edges[j][None, :], dim=1)
    return out
