"""
Forests of the port: RandomForest / ExtraTrees (classifier and
regressor) and RandomTreesEmbedding.

Counterpart of ``skdist_tpu/models/forest.py``. The tree axis is the
task axis of ``CUDABackend.batched_map``: a round of T trees is one call
of the batched tree kernel (``models/tree.py``), whose per-level
histogram is one K4 launch for the whole round. Per-tree seeds ride the
task axis and are drawn from ``np.random.RandomState(random_state)``
exactly as in the JAX package (so warm start advances the same stream);
each tree's bootstrap counts, ``max_features`` subsets and ExtraTrees
thresholds come from the counter-based hash of ``utils/draws.py`` keyed
by its seed, not from ``jax.random``. Parity with the JAX package is
therefore tree for tree where no draw is involved (``bootstrap=False,
max_features=None``, best splits) and statistical otherwise. The seed
is stored with each tree, so OOB scoring regenerates its bootstrap.

The fitted forest is a dict of stacked numpy tree arrays (``_trees``)
and the bin edges (``_edges``): nothing on the device, nothing live.

On the CPU a forest that fits on a ``LocalBackend`` (the plain forests'
default backend) grows its trees with the host C engine under
``hist_mode="auto"`` (``models/native_forest.py``, ``n_jobs`` threads),
and predicts with its walker, as the JAX package's CPU default does;
the bootstrap weights still come from ``utils/draws.py``, so OOB scoring
is engine-agnostic. Under ``reuse_broadcast=True`` on the backend, the
quantile edges and the binned X of a host X are memoised across fits
(:func:`_memo_edges`, :func:`_memo_apply_bins`).

Not ported yet (ROADMAP Queue 1 item 5.6): the ``hist_calib`` table.
"""

import warnings
import weakref

import numpy as np
import torch

from ..base import (
    BaseEstimator,
    ClassifierMixin,
    RegressorMixin,
    TransformerMixin,
)
from ..ops.binning import apply_bins, quantile_bin_edges
from ..parallel import LocalBackend
from ..utils import draws
from ..utils.device import resolve_device
from .linear import (
    as_dense_f32,
    class_weight_vector,
    encode_labels,
    prepare_sample_weight,
)
from .tree import (
    DecisionTreeClassifier,
    DecisionTreeRegressor,
    build_tree_kernel,
    classification_channels,
    feature_importances_from_tree,
    n_tree_nodes,
    regression_channels,
    resolve_hist_config,
    resolve_max_features,
    tree_predict_kernel,
    tree_task_bytes,
    walk_trees,
)

__all__ = [
    "RandomForestClassifier",
    "RandomForestRegressor",
    "ExtraTreesClassifier",
    "ExtraTreesRegressor",
    "RandomTreesEmbedding",
    "make_forest_tree_kernel",
]

MAX_RAND_SEED = np.iinfo(np.int32).max

#: trees walked at once by the OOB aggregation
_OOB_TREES = 32


# Two separate memos, keyed by a host X's identity and ``n_bins``, each
# entry holding a weakref to its X (a recycled ``id`` never serves it;
# collecting X evicts it), as the backend's broadcast cache does:
#   _EDGE_MEMO: -> (weakref, edges), written only by _memo_edges, so it
#       only ever holds quantile_bin_edges(X) of that very X;
#   _XB_MEMO: -> (weakref, edges, Xb on the device), written by
#       _memo_apply_bins with whatever edges the caller passed (a warm
#       start applies the edges it inherited).
# Kept apart, a warm-start apply on a new X cannot leave its inherited
# edges where _memo_edges would serve them as that X's own, which would
# change the trees of a later fresh fit. Enabled by the backend's
# reuse_broadcast, whose contract they share: mutating X after a fit is
# the caller's error.
_EDGE_MEMO = {}
_XB_MEMO = {}
_BIN_MEMO_MAX = 4


def _memo_lookup(memo, X, n_bins, enabled):
    if not enabled or not isinstance(X, np.ndarray):
        return None, None
    key = (id(X), int(n_bins))
    ent = memo.get(key)
    if ent is not None:
        if ent[0]() is X:
            return key, ent
        memo.pop(key, None)
    return key, None


def _memo_store(memo, key, X, *values):
    memo[key] = (weakref.ref(X, lambda _r: memo.pop(key, None)), *values)
    while len(memo) > _BIN_MEMO_MAX:
        memo.pop(next(iter(memo)), None)


def _memo_edges(X, n_bins, enabled):
    """``quantile_bin_edges(X, n_bins)``, memoised when ``enabled``."""
    key, ent = _memo_lookup(_EDGE_MEMO, X, n_bins, enabled)
    if ent is not None:
        return ent[1]
    edges = quantile_bin_edges(X, n_bins)
    if key is not None:
        _memo_store(_EDGE_MEMO, key, X, np.asarray(edges))
    return edges


def _memo_apply_bins(X, edges, n_bins, device, enabled):
    """``X`` binned under ``edges`` on ``device`` (int32), memoised when
    ``enabled``: a hit needs the same X, the same edges and the same
    device."""
    key, ent = _memo_lookup(_XB_MEMO, X, n_bins, enabled)
    want = torch.device(device)
    if ent is not None and np.array_equal(ent[1], edges) \
            and ent[2].device.type == want.type \
            and want.index in (None, ent[2].device.index):
        return ent[2]
    with torch.no_grad():
        Xb = apply_bins(torch.as_tensor(X).to(device), edges)
    if key is not None:
        _memo_store(_XB_MEMO, key, X, np.asarray(edges), Xb)
    return Xb


def make_forest_tree_kernel(d, n_bins, channels, max_depth, max_features,
                            min_samples_split, min_samples_leaf,
                            min_impurity_decrease, extra, classification,
                            bootstrap, hist_mode="auto"):
    """Round kernel for ``CUDABackend.batched_map``: the task is a tree
    seed, ``task["seed"] (T,)``; ``shared`` holds ``Xb (n, d)``, ``y``
    and ``sw`` on the device. Returns the round's stacked trees, each
    with its seed, so OOB masks regenerate from it."""
    grow = build_tree_kernel(
        n_features=d, n_bins=n_bins, channels=channels, max_depth=max_depth,
        max_features=max_features, min_samples_split=min_samples_split,
        min_samples_leaf=min_samples_leaf,
        min_impurity_decrease=min_impurity_decrease, extra=extra,
        classification=classification, hist_mode=hist_mode,
    )
    K = channels - 1 if classification else 1

    def kernel(shared, task):
        Xb, y, sw = shared["Xb"], shared["y"], shared["sw"]
        seeds = task["seed"]
        T, n = seeds.shape[0], Xb.shape[0]
        if bootstrap:
            w = sw[None, :] * draws.bootstrap_counts(seeds, n, sw.dtype)
        else:
            w = sw[None, :].expand(T, n)
        if classification:
            Ych = classification_channels(y, w, K)
        else:
            Ych = regression_channels(y, w)
        tree = grow(Xb, Ych, seeds)
        tree["seed"] = seeds.to(torch.int32)
        return tree

    return kernel


class _BaseForest(BaseEstimator):
    """Shared forest machinery; subclasses set ``_extra`` (random
    thresholds) and classification/regression via mixins.

    ``warm_start=True`` keeps the trees already grown, and their bin
    edges, and appends ``n_estimators - len(grown)`` new ones.
    """

    _extra = False

    def __init__(self, n_estimators=100, max_depth=8, n_bins=32,
                 max_features="sqrt", min_samples_split=2, min_samples_leaf=1,
                 min_impurity_decrease=0.0, bootstrap=True, oob_score=False,
                 class_weight=None, warm_start=False, random_state=None,
                 n_jobs=None, hist_mode="auto", device=None):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.n_bins = n_bins
        self.max_features = max_features
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.min_impurity_decrease = min_impurity_decrease
        self.bootstrap = bootstrap
        self.oob_score = oob_score
        self.class_weight = class_weight
        self.warm_start = warm_start
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.hist_mode = hist_mode
        self.device = device

    @property
    def _classification(self):
        return isinstance(self, ClassifierMixin)

    # the distributed wrappers override this to route through their
    # backend and partitions
    def _resolve_fit_backend(self):
        return LocalBackend(n_jobs=self.n_jobs, device=self.device), None

    def fit(self, X, y, sample_weight=None):
        X = as_dense_f32(X)
        n, d = X.shape
        sw = prepare_sample_weight(sample_weight, n)
        backend, round_size = self._resolve_fit_backend()
        device = backend.device
        # binning is a function of (X, n_bins) alone: under the backend's
        # reuse_broadcast contract a repeat fit on the same host X skips
        # the quantile pass, the upload and the apply
        reuse = getattr(backend, "reuse_broadcast", False)
        warm = self.warm_start and getattr(self, "_trees", None) is not None
        if not warm:  # a cold fit replaces any trees converted into it
            self.__dict__.pop("_foreign_seeds", None)
        # existing trees' thresholds are bin ids under the original edges:
        # a warm refit keeps them
        edges = self._edges if warm else _memo_edges(X, self.n_bins, reuse)

        if self._classification:
            y_enc, classes = encode_labels(y)
            self.classes_ = classes
            K = len(classes)
            channels = K + 1
            cw = getattr(self, "class_weight", None)
            if cw is not None:
                if cw == "balanced":
                    counts = np.bincount(y_enc, minlength=K).astype(np.float64)
                    per_class = len(y_enc) / (K * np.maximum(counts, 1))
                elif isinstance(cw, dict):
                    per_class = class_weight_vector(cw, classes)
                else:
                    raise ValueError(
                        f"Unsupported class_weight {cw!r}: use 'balanced' "
                        "or a {label: weight} dict"
                    )
                sw = sw * per_class[y_enc].astype(np.float32)
        else:
            y_enc = np.asarray(y, dtype=np.float32)
            channels = 4
        if self.oob_score and not self.bootstrap:
            raise ValueError("oob_score requires bootstrap=True")

        prev = getattr(self, "_trees", None) if warm else None
        n_prev = 0 if prev is None else int(prev["feat"].shape[0])
        n_more = self.n_estimators - n_prev
        if n_more < 0:
            raise ValueError(
                f"warm_start: n_estimators={self.n_estimators} is smaller "
                f"than the {n_prev} trees already grown"
            )
        if self.oob_score:
            self._check_own_draws()

        if n_more > 0:
            rng = np.random.RandomState(self.random_state)
            if n_prev:  # advance the stream past already-drawn seeds
                rng.randint(MAX_RAND_SEED, size=n_prev)
            seeds = rng.randint(MAX_RAND_SEED, size=n_more).astype(np.int32)
            # the host engine only on a LocalBackend, as in the JAX
            # package; a CUDABackend round is a batched kernel
            mode = resolve_hist_config(
                self.hist_mode, device,
                allow_native=isinstance(backend, LocalBackend),
                n_bins=self.n_bins)
            if mode == "native":
                from ..ops.binning import apply_bins_np

                new_trees = self._fit_native(apply_bins_np(X, edges), y_enc,
                                             sw, seeds, d)
            else:
                kernel = make_forest_tree_kernel(
                    d=d, n_bins=self.n_bins, channels=channels,
                    max_depth=self.max_depth,
                    max_features=resolve_max_features(self.max_features, d),
                    min_samples_split=self.min_samples_split,
                    min_samples_leaf=self.min_samples_leaf,
                    min_impurity_decrease=self.min_impurity_decrease,
                    extra=self._extra, classification=self._classification,
                    bootstrap=self.bootstrap, hist_mode=mode,
                )
                Xb = _memo_apply_bins(X, edges, self.n_bins, device, reuse)
                shared = backend.place({"Xb": Xb, "y": y_enc, "sw": sw})
                new_trees = backend.batched_map(
                    kernel, {"seed": seeds}, shared,
                    bytes_per_task=tree_task_bytes(
                        n, d, self.n_bins, channels, self.max_depth, mode),
                    round_size=round_size,
                )
                del shared, Xb
            if prev is not None:
                new_trees = {k: np.concatenate([prev[k], new_trees[k]])
                             for k in prev}
            self._trees = new_trees
        self._edges = edges
        self.n_features_in_ = d
        if self.oob_score:
            self._compute_oob(X, y_enc, device)
        return self

    def _fit_native(self, Xb, y_enc, sw, seeds, d):
        """Grow the trees with the host C engine
        (``models/native_forest.py``) on ``n_jobs`` threads. Each tree's
        bootstrap weights are ``utils/draws.py bootstrap_counts`` of its
        seed, the draw of the torch engine, which OOB scoring
        regenerates; they are made a chunk of trees at a time, so no
        ``(T, n)`` weight matrix is held."""
        from ..native import default_threads
        from .native_forest import grow_forest_native

        n = Xb.shape[0]
        sw = np.asarray(sw, np.float32)
        bootstrap = self.bootstrap

        def weights(t0, t1):
            if bootstrap:
                counts = draws.bootstrap_counts(
                    torch.as_tensor(seeds[t0:t1]), n).numpy()
                return sw[None, :] * counts
            return np.broadcast_to(sw, (t1 - t0, n)).copy()

        return grow_forest_native(
            Xb, y_enc, weights, seeds,
            n_bins=self.n_bins, max_depth=self.max_depth,
            max_features=resolve_max_features(self.max_features, d),
            min_samples_split=self.min_samples_split,
            min_samples_leaf=self.min_samples_leaf,
            min_impurity_decrease=self.min_impurity_decrease,
            extra=self._extra, classification=self._classification,
            n_classes=len(getattr(self, "classes_", ())) or 1,
            n_threads=default_threads(self.n_jobs),
        )

    def _check_own_draws(self):
        """OOB masks are regenerated from the stored seeds with the
        port's generator; trees carried over from the JAX package drew
        their bootstrap with ``jax.random``, which the port does not
        reproduce, so their masks cannot be regenerated."""
        if getattr(self, "_foreign_seeds", 0):
            raise ValueError(
                f"this forest holds {self._foreign_seeds} trees converted "
                "from the JAX package, whose bootstrap draws came from "
                "jax.random; the port cannot regenerate them, so it "
                "cannot compute out-of-bag scores over them (oob_score "
                "recomputation and warm-start refits with oob_score=True "
                "are refused)"
            )

    def _compute_oob(self, X, y_enc, device):
        """Out-of-bag scoring: each sample is scored by the trees whose
        bootstrap missed it. Masks are regenerated from the stored seeds,
        a chunk of trees at a time, and never stored."""
        self._check_own_draws()
        trees = self._trees
        seeds = np.asarray(trees["seed"])
        T = seeds.shape[0]
        walk = tree_predict_kernel(self.max_depth)
        with torch.no_grad():
            Xb = apply_bins(torch.as_tensor(X).to(device), self._edges)
            n = Xb.shape[0]
            K = np.asarray(trees["leaf"]).shape[-1]
            num = torch.zeros((n, K), dtype=torch.float32, device=device)
            cnt = torch.zeros(n, dtype=torch.float32, device=device)
            for t0 in range(0, T, _OOB_TREES):
                part = {k: torch.as_tensor(
                    np.asarray(trees[k][t0:t0 + _OOB_TREES])).to(device)
                    for k in ("feat", "thr", "is_split", "leaf")}
                per_tree = walk(part, Xb)  # (Tc, n, K)
                s = torch.as_tensor(seeds[t0:t0 + _OOB_TREES]).to(device)
                m = (draws.bootstrap_counts(s, n) == 0).to(torch.float32)
                num += torch.sum(per_tree * m[:, :, None], dim=0)
                cnt += torch.sum(m, dim=0)
            agg = (num / torch.clamp(cnt, min=1.0)[:, None]).cpu().numpy()
            cnt = cnt.cpu().numpy()
        covered = cnt > 0
        if not covered.all():
            warnings.warn(
                "Some samples were in-bag for every tree; OOB estimates "
                "for them are undefined and excluded from oob_score_."
            )
        if self._classification:
            self.oob_decision_function_ = agg
            pred = np.argmax(agg, axis=1)
            self.oob_score_ = float(
                np.mean(pred[covered] == np.asarray(y_enc)[covered])
            ) if covered.any() else float("nan")
        else:
            self.oob_prediction_ = agg[:, 0]
            yv = np.asarray(y_enc)[covered]
            pv = agg[covered, 0]
            ss_res = float(np.sum((yv - pv) ** 2))
            ss_tot = float(np.sum((yv - yv.mean()) ** 2))
            self.oob_score_ = (
                1.0 - ss_res / ss_tot if ss_tot > 0 else float("nan")
            )

    # ------------------------------------------------------------------
    def _check_fitted(self):
        if not hasattr(self, "_trees"):
            raise AttributeError(
                f"This {type(self).__name__} instance is not fitted yet."
            )

    def _forest_values(self, X):
        """Mean over trees of the per-tree leaf outputs -> (n, K_out)."""
        self._check_fitted()
        return walk_trees(self._trees, self._edges, X, self.max_depth,
                          resolve_device(self.device), "predict",
                          n_threads=self._walk_threads())

    def apply(self, X):
        """(n, n_estimators) leaf ids: sklearn's ``forest.apply``."""
        self._check_fitted()
        return walk_trees(self._trees, self._edges, X, self.max_depth,
                          resolve_device(self.device), "apply",
                          n_threads=self._walk_threads())

    def _walk_threads(self):
        """The host C walker's threads on the CPU: ``n_jobs``, read as
        the host engine reads it."""
        from ..native import default_threads

        return default_threads(getattr(self, "n_jobs", None))

    @property
    def feature_importances_(self):
        self._check_fitted()
        T = self._trees["feat"].shape[0]
        imps = np.stack([
            feature_importances_from_tree(
                self._trees["feat"][t], self._trees["gain"][t],
                self.n_features_in_,
            )
            for t in range(T)
        ])
        return imps.mean(axis=0)

    @property
    def estimators_(self):
        """Per-tree estimator views (fitted single trees)."""
        self._check_fitted()
        cls = (
            DecisionTreeClassifier if self._classification
            else DecisionTreeRegressor
        )
        out = []
        T = self._trees["feat"].shape[0]
        for t in range(T):
            est = cls(
                max_depth=self.max_depth, n_bins=self.n_bins,
                max_features=self.max_features,
                min_samples_split=self.min_samples_split,
                min_samples_leaf=self.min_samples_leaf,
                min_impurity_decrease=self.min_impurity_decrease,
                splitter="random" if self._extra else "best",
                device=self.device,
            )
            est._params = {k: np.asarray(v[t]) for k, v in self._trees.items()}
            est._params["edges"] = np.asarray(self._edges)
            est._meta = {"n_features": self.n_features_in_}
            est.n_features_in_ = self.n_features_in_
            if self._classification:
                est.classes_ = self.classes_
                est._meta.update(
                    classes=self.classes_, n_classes=len(self.classes_)
                )
            out.append(est)
        return out


class _ForestClassifierMixin(ClassifierMixin):
    def predict_proba(self, X):
        return self._forest_values(X)

    def predict_log_proba(self, X):
        return np.log(np.clip(self.predict_proba(X), 1e-15, None))

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]


class _ForestRegressorMixin(RegressorMixin):
    def predict(self, X):
        out = self._forest_values(X)
        return out[:, 0] if out.ndim == 2 and out.shape[1] == 1 else out


class RandomForestClassifier(_BaseForest, _ForestClassifierMixin):
    """Histogram random forest (bagged best-split trees)."""


class RandomForestRegressor(_BaseForest, _ForestRegressorMixin):
    def __init__(self, n_estimators=100, max_depth=8, n_bins=32,
                 max_features=1.0, min_samples_split=2, min_samples_leaf=1,
                 min_impurity_decrease=0.0, bootstrap=True, oob_score=False,
                 warm_start=False, random_state=None, n_jobs=None,
                 hist_mode="auto", device=None):
        super().__init__(
            n_estimators=n_estimators, max_depth=max_depth, n_bins=n_bins,
            max_features=max_features, min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease, bootstrap=bootstrap,
            oob_score=oob_score, warm_start=warm_start,
            random_state=random_state, n_jobs=n_jobs, hist_mode=hist_mode,
            device=device,
        )


class ExtraTreesClassifier(_BaseForest, _ForestClassifierMixin):
    """Extremely randomised trees: random per-(node, feature) thresholds,
    no bootstrap by default (sklearn semantics)."""

    _extra = True

    def __init__(self, n_estimators=100, max_depth=8, n_bins=32,
                 max_features="sqrt", min_samples_split=2, min_samples_leaf=1,
                 min_impurity_decrease=0.0, bootstrap=False, oob_score=False,
                 class_weight=None, warm_start=False, random_state=None,
                 n_jobs=None, hist_mode="auto", device=None):
        super().__init__(
            n_estimators=n_estimators, max_depth=max_depth, n_bins=n_bins,
            max_features=max_features, min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease, bootstrap=bootstrap,
            oob_score=oob_score, class_weight=class_weight,
            warm_start=warm_start, random_state=random_state, n_jobs=n_jobs,
            hist_mode=hist_mode, device=device,
        )


class ExtraTreesRegressor(_BaseForest, _ForestRegressorMixin):
    _extra = True

    def __init__(self, n_estimators=100, max_depth=8, n_bins=32,
                 max_features=1.0, min_samples_split=2, min_samples_leaf=1,
                 min_impurity_decrease=0.0, bootstrap=False, oob_score=False,
                 warm_start=False, random_state=None, n_jobs=None,
                 hist_mode="auto", device=None):
        super().__init__(
            n_estimators=n_estimators, max_depth=max_depth, n_bins=n_bins,
            max_features=max_features, min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease, bootstrap=bootstrap,
            oob_score=oob_score, warm_start=warm_start,
            random_state=random_state, n_jobs=n_jobs, hist_mode=hist_mode,
            device=device,
        )


class RandomTreesEmbedding(_BaseForest, TransformerMixin):
    """Unsupervised leaf-index embedding: extra-random regression trees
    fit on uniform random targets; ``transform`` one-hot-encodes each
    sample's leaf per tree (a ``scipy.sparse`` CSR matrix)."""

    _extra = True
    _estimator_type = None

    def __init__(self, n_estimators=100, max_depth=5, n_bins=32,
                 min_samples_split=2, min_samples_leaf=1,
                 min_impurity_decrease=0.0, sparse_output=True,
                 warm_start=False, random_state=None, n_jobs=None,
                 hist_mode="auto", device=None):
        super().__init__(
            n_estimators=n_estimators, max_depth=max_depth, n_bins=n_bins,
            max_features=1.0, min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease, bootstrap=False,
            warm_start=warm_start, random_state=random_state, n_jobs=n_jobs,
            hist_mode=hist_mode, device=device,
        )
        self.sparse_output = sparse_output

    @property
    def _classification(self):
        return False

    def fit(self, X, y=None, sample_weight=None):
        # uniform random targets
        rng = np.random.RandomState(self.random_state)
        y_rand = rng.uniform(size=np.asarray(X).shape[0]).astype(np.float32)
        super().fit(X, y_rand, sample_weight=sample_weight)
        # fit-time one-hot layout: one block of 2^(D+1)-1 slots per tree
        self._n_nodes = n_tree_nodes(self.max_depth)
        return self

    def fit_transform(self, X, y=None, sample_weight=None):
        return self.fit(X, y, sample_weight).transform(X)

    def transform(self, X):
        self._check_fitted()
        leaves = self.apply(X)  # (n, T)
        n, T = leaves.shape
        N = self._n_nodes
        cols = (leaves + np.arange(T)[None, :] * N).ravel()
        rows = np.repeat(np.arange(n), T)
        from scipy import sparse

        out = sparse.csr_matrix(
            (np.ones(n * T, dtype=np.float32), (rows, cols)),
            shape=(n, T * N),
        )
        return out if self.sparse_output else np.asarray(out.todense())
