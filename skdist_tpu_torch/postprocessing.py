"""
Postprocessing of the port: ``SimpleVoter``, the counterpart of
``skdist_tpu/postprocessing.py``: a voting classifier over estimators
that were fitted elsewhere (the best models of distributed searches, say).
``fit`` only assembles them; the vote is on the host.

Hard voting is one flattened ``bincount`` over ``row * n_classes +
class`` indices, weighted by the members' weights, and ties go to the
lowest class index. Soft voting averages the members' ``predict_proba``.
Members given as ``None`` or ``"drop"`` leave both the vote and the
weights. Labels go through a label encoding seeded with ``classes``,
which raises on a label outside them, as scikit-learn's
``LabelEncoder`` does.
"""

import numpy as np

from .base import BaseEstimator, ClassifierMixin
from .utils.validation import check_is_fitted

__all__ = ["SimpleVoter", "Bunch"]


class Bunch(dict):
    """A dict whose keys are also attributes (scikit-learn's ``Bunch``)."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key, value):
        self[key] = value

    def __dir__(self):
        return list(self.keys())


class _ClassEncoder:
    """Labels to indices into ``classes_`` and back: scikit-learn's
    ``LabelEncoder`` with its ``classes_`` set, written out (a lookup
    table over object and string labels, a binary search over the
    others)."""

    def __init__(self, classes):
        self.classes_ = np.asarray(classes)

    def transform(self, y):
        y = np.asarray(y)
        if y.size == 0:
            return np.array([], dtype=np.int64)
        if y.dtype.kind in "OUS":
            table = {c: i for i, c in enumerate(self.classes_.tolist())}
            try:
                return np.array([table[v] for v in y.tolist()],
                                dtype=np.int64)
            except KeyError as exc:
                raise ValueError(
                    f"y contains previously unseen labels: {[exc.args[0]]}"
                ) from None
        unseen = np.setdiff1d(y, self.classes_)
        if unseen.size:
            raise ValueError(
                f"y contains previously unseen labels: {unseen.tolist()}")
        return np.searchsorted(self.classes_, y)

    def inverse_transform(self, idx):
        return self.classes_[np.asarray(idx)]


def _weighted_vote_matrix(encoded_preds, n_classes, weights):
    """The ``(n_samples, n_classes)`` tally of the members' weights over
    their predicted classes (``encoded_preds (n_samples, n_members)``
    class indices): one flat ``bincount``, no ``(n, members, classes)``
    one-hot."""
    n, m = encoded_preds.shape
    if weights is None:
        w = np.ones(m, dtype=np.float64)
    else:
        w = np.asarray(weights, dtype=np.float64)
    flat = encoded_preds + n_classes * np.arange(n)[:, None]
    tally = np.bincount(
        flat.ravel(),
        weights=np.broadcast_to(w, (n, m)).ravel(),
        minlength=n * n_classes,
    )
    return tally.reshape(n, n_classes)


class SimpleVoter(BaseEstimator, ClassifierMixin):
    """Voting over pre-fitted ``(name, estimator)`` pairs: ``voting``
    ``"hard"`` (the weighted majority of the members' predictions) or
    ``"soft"`` (the weighted mean of their probabilities), over
    ``classes``. ``fit`` re-assembles the members and fits nothing."""

    def __init__(self, estimators, classes, voting="hard", weights=None):
        self.estimators = estimators
        self.classes = classes
        self.voting = voting
        self.weights = weights
        self._assemble_attributes()

    @property
    def named_estimators(self):
        return Bunch(**dict(self.estimators))

    def fit(self, X, y=None):
        self._assemble_attributes()
        return self

    def predict(self, X):
        check_is_fitted(self, "estimators_")
        if self.voting == "soft":
            maj = np.argmax(self.predict_proba(X), axis=1)
        else:
            encoded = np.column_stack([self.le_.transform(clf.predict(X))
                                       for clf in self.estimators_])
            tally = _weighted_vote_matrix(
                encoded, len(self.classes_), self._active_weights()
            )
            maj = np.argmax(tally, axis=1)
        return self.le_.inverse_transform(maj)

    def predict_proba(self, X):
        if self.voting == "hard":
            raise AttributeError(
                f"predict_proba is not available when voting={self.voting!r}"
            )
        check_is_fitted(self, "estimators_")
        stacked = np.stack([clf.predict_proba(X) for clf in self.estimators_])
        return np.average(stacked, axis=0, weights=self._active_weights())

    def _active_weights(self):
        """The weights of the members that are not dropped, or None for
        equal weights."""
        if self.weights is None:
            return None
        return [
            w for (_name, est), w in zip(self.estimators, self.weights)
            if not _dropped(est)
        ]

    def _assemble_attributes(self):
        self.estimators_ = tuple(
            est for _, est in self.estimators if not _dropped(est)
        )
        self.classes_ = np.asarray(self.classes)
        self.le_ = _ClassEncoder(self.classes_)


def _dropped(est):
    """Whether a member is left out: None or the string ``"drop"``."""
    return est is None or (isinstance(est, str) and est == "drop")
