"""
Adaptive (ASHA-style) search configuration: a copy of the JAX package's
``skdist_tpu/distribute/adaptive.py``.

:class:`HalvingSpec` is the user-facing knob of quality-based lane
retirement on the convergence-compacted backend (asynchronous
successive halving, Li et al., *A System for Massively Parallel
Hyperparameter Tuning*, MLSys 2020; Hyperband, Li et al., JMLR 2018):

    DistGridSearchCV(est, grid, backend=backend,
                     adaptive=HalvingSpec(eta=3, min_slices=1))

Every ``min_slices`` iteration slices the scheduler scores all live
carries on the held-out validation fold on the device (the decision
kernels and the ``DEVICE_SCORERS`` rung kernel; only an ``(n_lanes,)``
score vector reaches the host), then kills the bottom ``1 - 1/eta`` of
live candidates through the ordinary retirement path. A candidate's
CV-fold lanes are grouped: they live and die together on their mean
rung score, which keeps ``cv_results_`` rows whole.

Killed candidates map to sklearn-compatible rows through the
``error_score`` semantics (a numeric ``error_score`` substitutes, the
default ``np.nan`` ranks them last) with one :class:`RungKilledWarning`,
and ``cv_results_["rung_"]`` records the rung at which each candidate
died (``-1`` = ran to completion).

``eta=float('inf')`` scores every rung but kills nothing: its
``cv_results_`` are bitwise those of ``adaptive=None``.

In the port, rungs fire only when every round is resident on the card
(``CUDABackend.batched_map_iterative``); when the lanes do not fit at
once the search runs exhaustively and warns (:func:`warn_not_engaged`).
The streamed (out-of-core) search is not ported yet.
"""

import math
import warnings

__all__ = ["HalvingSpec", "RungKilledWarning", "check_adaptive",
           "warn_not_engaged"]


class RungKilledWarning(RuntimeWarning):
    """A batch of candidates was retired early by an adaptive rung and
    recorded at ``error_score`` (the adaptive analogue of
    ``FitFailedWarning`` — same row semantics, different cause: the
    fits were healthy, the scheduler judged them not worth finishing).
    """


class HalvingSpec:
    """Configuration of adaptive successive-halving search.

    Parameters
    ----------
    eta : float, default 3
        Reduction factor: each rung keeps the top ``ceil(live / eta)``
        candidates and kills the rest. Must be > 1; ``float('inf')``
        scores rungs but never kills (observe-only, bitwise-identical
        results to ``adaptive=None``).
    min_slices : int, default 1
        Rung cadence in iteration slices: a rung fires after every
        ``min_slices`` slices of the compacted loop (the slice size
        itself is ``SKDIST_SLICE_ITERS`` / ~1/8 of ``max_iter`` — see
        ``parallel.resolve_slice_iters``), so the first rung decision
        happens after ``min_slices * slice_iters`` iterations.
    metric : str, default 'auto'
        Device scorer used for rung decisions. ``'auto'`` follows the
        search's refit metric. Must resolve to a ``DEVICE_SCORERS``
        kernel compatible with the label set; when it cannot (host-only scorers, incompatible binary metrics),
        adaptive search WARNS and falls back to exhaustive execution —
        it never gathers per-rung predictions host-side.
    """

    def __init__(self, eta=3, min_slices=1, metric="auto"):
        eta = float(eta)
        if not eta > 1.0 or math.isnan(eta):
            raise ValueError(
                f"HalvingSpec eta must be > 1 (got {eta!r}); use "
                "float('inf') for the observe-only mode"
            )
        min_slices = int(min_slices)
        if min_slices < 1:
            raise ValueError(
                f"HalvingSpec min_slices must be >= 1 (got {min_slices!r})"
            )
        if not isinstance(metric, str):
            raise ValueError(
                "HalvingSpec metric must be a scorer name or 'auto' "
                f"(got {metric!r})"
            )
        self.eta = eta
        self.min_slices = min_slices
        self.metric = metric

    def get_params(self, deep=False):
        """sklearn-style param introspection."""
        return {
            "eta": self.eta, "min_slices": self.min_slices,
            "metric": self.metric,
        }

    def __repr__(self):
        return (
            f"HalvingSpec(eta={self.eta!r}, min_slices={self.min_slices!r},"
            f" metric={self.metric!r})"
        )


def check_adaptive(adaptive):
    """Shared fit()-entry validation of the ``adaptive`` constructor
    param (search, multimodel, eliminator)."""
    if adaptive is not None and not isinstance(adaptive, HalvingSpec):
        raise ValueError(
            "adaptive must be None or a HalvingSpec(...); got "
            f"{adaptive!r}"
        )


def warn_not_engaged(context):
    """The shared could-not-engage warning: adaptive search fell back
    to EXHAUSTIVE execution (it never gathers per-rung predictions for
    a host scorer) — loudly, so a user counting on the speedup learns
    why it did not happen. ``context`` names the caller's task axis,
    e.g. "the search" or "the eliminator"."""
    warnings.warn(
        f"adaptive=HalvingSpec(...) could not engage: {context} did "
        "not run the compacted iterative device path end to end "
        "(host-only scorer, host-engine estimator, a non-sliceable "
        "family, a grid below the compaction threshold, or a backend "
        "downgrade to the exhaustive fallback). Ran exhaustive "
        "scoring instead.",
        UserWarning,
    )


def rung_per_candidate(n_candidates, n_splits, killed_gids):
    """Fold the per-lane kill record into the per-candidate ``rung_``
    column: the rung at which the candidate's lanes were killed (max
    over folds, for the degenerate case of folds dying at different
    rungs), ``-1`` for candidates that ran to completion."""
    import numpy as np

    rungs = np.full(n_candidates, -1, dtype=np.int32)
    for gid, rung in killed_gids.items():
        c = int(gid) // n_splits
        if 0 <= c < n_candidates:
            rungs[c] = max(rungs[c], int(rung))
    return rungs
