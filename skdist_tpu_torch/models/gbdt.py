"""
Histogram gradient-boosted trees of the port:
``DistHistGradientBoostingClassifier`` and
``DistHistGradientBoostingRegressor``.

Counterpart of ``skdist_tpu/models/gbdt.py``, built from the tree
family's parts. One boosting round grows one Newton tree a lane (K trees
for K classes) with :func:`~skdist_tpu_torch.models.tree.build_tree_kernel`
(``newton=True``: channels ``[s*g, s*h, count(s>0)]``, gain
``G**2/(H+lambda)``, Newton-step leaves), over X quantile-binned once.
The ensemble is a carry chain: the raw predictions ``F``, the stacked
tree bank and the early-stopping state.

Where the JAX package ``vmap``s a fit over its lanes, every tensor here
has an explicit leading lane axis ``L``: ``F (L, n, Kt)``, the bank
``(L, max_iter, Kt, N)``, ``it``/``done``/``best``/``bad`` and the
hypers ``learning_rate``/``l2_regularization``/``tol`` ``(L,)``. A round
grows all ``L * Kt`` trees in one ``build_tree_kernel`` call, each with
its lane's lambda, so K4 launches once a level however many lanes and
classes ride the round. A round updates a lane under ``where(done, old,
new)``: a finished lane's carry never changes, so the plain fit kernel
(rounds until every lane is done), the iteration-sliced kernels of the
compacted scheduler (one boosting round an iteration) and the live
carries that ASHA scores (``score_params``) agree bit for bit.

The semantics and the deliberate divergences from scikit-learn are the
JAX package's: depth-bounded trees, quantile-bin thresholds,
``max_bins=64`` by default, and an early-stopping validation split that
is a deterministic row mask. The port draws that mask from its counter
hash (:func:`validation_uniforms`), not from ``jax.random``: with early
stopping on, a fit stops at the JAX package's round only where a test
hands it the JAX mask (ROADMAP Queue 3). The trees draw nothing (every
feature is a candidate, thresholds are not random), so their seeds,
the estimator's ``random_state``, change no tree.

Not ported yet (ROADMAP): the streamed fit over a ``ChunkedDataset``
(Queue 1 item 9c) and the quantized serving tiers (item 12).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..base import BaseEstimator, ClassifierMixin, RegressorMixin
from ..ops.binning import MAX_BINS, apply_bins, quantile_bin_edges
from ..utils import draws
from ..utils.device import lane_sum, resolve_device
from .linear import (
    _freeze,
    as_dense_f32,
    encode_labels,
    hyper_float,
    prepare_sample_weight,
)
from .tree import (
    _WALK_ELEMS,
    build_tree_kernel,
    n_tree_nodes,
    newton_channels,
    tree_predict_kernel,
    tree_task_bytes,
)

__all__ = [
    "DistHistGradientBoostingClassifier",
    "DistHistGradientBoostingRegressor",
    "validation_uniforms",
]

#: scikit-learn's early_stopping='auto' rule: on iff the fit sees more rows
EARLY_STOP_AUTO_N = 10000

#: probability floor of the baseline log-odds / log-priors
_P_EPS = 1e-7

#: the salt of the validation split's seed (the JAX package's)
_VALIDATION_SALT = 0x5DEECE66

#: the fitted arrays of one ensemble
_BANK_KEYS = ("feat", "thr", "is_split", "leaf", "baseline")


def _check_early_stopping(early_stopping):
    if early_stopping not in ("auto", True, False):
        raise ValueError(
            "early_stopping must be 'auto', True or False; got "
            f"{early_stopping!r}"
        )


def _resolve_early_stopping(early_stopping, n_samples):
    # validated again here: set_params bypasses __init__, and a typo must
    # not coerce through bool()
    _check_early_stopping(early_stopping)
    if early_stopping == "auto":
        return bool(n_samples > EARLY_STOP_AUTO_N)
    return bool(early_stopping)


def _refuse_chunked(X, what):
    if type(X).__name__ == "ChunkedDataset":
        raise NotImplementedError(
            f"{what} over a ChunkedDataset (the streamed boosting fit) is "
            "not ported to skdist_tpu_torch yet (see ROADMAP.md, queue 1 "
            "item 9c)"
        )


def validation_uniforms(seed, n, device):
    """``(n,)`` float32 uniforms in [0, 1) that pick a fit's
    early-stopping validation rows (``u < validation_fraction``): a
    function of ``seed`` and ``n`` alone, so every kernel of a fit, and
    every lane, draws the same split. The JAX package draws
    ``jax.random.uniform(PRNGKey(seed ^ 0x5DEECE66), (n,))``, a stream
    the port cannot reproduce; this is the port's counter hash
    (``utils/draws.py``) under the same salted seed. A test that holds
    an early-stopped fit to the JAX package's replaces this function
    with that draw."""
    key = torch.tensor([(int(seed) ^ _VALIDATION_SALT) & 0xFFFFFFFF],
                       device=device)
    return draws.uniform(key, 0, draws.VALIDATION, (int(n),))[0]


def _by_lane(fn, x):
    """``fn(x)`` with each lane's row alone on the CPU: there PyTorch's
    ``sigmoid`` and ``logaddexp`` take a vectorized path for the body of
    a tensor and a scalar one, with other bits, for its tail, so a row's
    bits would depend on its place in the batch. On the card every
    element takes one path."""
    if x.is_cuda or x.shape[0] == 1:
        return fn(x)
    return torch.stack([fn(row[None])[0] for row in x])


def _walk_leaves(walk, Xb, feat, thr, split, leaf):
    """Leaf values ``(T, n)`` of trees ``feat/thr/split/leaf (T, N)``
    over the bins ``Xb``, through the tree family's one traversal
    (``walk``, a :func:`~skdist_tpu_torch.models.tree.tree_predict_kernel`),
    so split semantics cannot drift between the families."""
    tree = {"feat": feat, "thr": thr, "is_split": split,
            "leaf": leaf[..., None]}
    return walk(tree, Xb)[..., 0]


def _bank_decision(walk, Xb, params, Kt):
    """Raw predictions of fitted banks over the bins ``Xb (n, d)``: one
    ensemble (``feat`` ``(R, Kt, N)``) gives ``(n,)`` or ``(n, Kt)``, a
    stack of lanes (``(L, R, Kt, N)``) ``(L, n)`` or ``(L, n, Kt)``.
    Every round is added in order to the baseline, as the fit added it
    (rounds past ``n_iter`` hold all-zero trees and add exact zeros); the
    rounds are walked in groups of at most ``_WALK_ELEMS`` node ids."""
    single = params["feat"].ndim == 3
    bank = {k: params[k][None] if single else params[k] for k in _BANK_KEYS}
    L, R, _, N = bank["feat"].shape
    n = Xb.shape[0]
    out = bank["baseline"].to(torch.float32)[:, None, :].expand(L, n, Kt)
    step = max(1, _WALK_ELEMS // max(L * Kt * n, 1))
    for r0 in range(0, R, step):
        r1 = min(R, r0 + step)

        def rounds(a):  # (r1 - r0) * L * Kt trees, round-major
            return a[:, r0:r1].transpose(0, 1).reshape(-1, N)

        vals = _walk_leaves(walk, Xb, rounds(bank["feat"]),
                            rounds(bank["thr"]), rounds(bank["is_split"]),
                            rounds(bank["leaf"])).reshape(r1 - r0, L, Kt, n)
        for j in range(r1 - r0):
            out = out + vals[j].transpose(1, 2)
    if Kt == 1:
        out = out[..., 0]
    return out[0] if single else out


def _n_trees_a_round(static):
    """Trees a lane grows a round: K for K > 2 classes, else one."""
    K = dict(static).get("_n_classes", 0)
    return K if K > 2 else 1


def _build_boost_parts(meta, static):
    """The one construction point of a boosting fit's pieces, over a
    batch of ``L`` lanes that share the bins ``Xb (n, d)``:
    ``init_carry``, ``restart``, ``resume``, ``finalize`` and
    ``converged``, with the round count ``T``. The plain
    fit kernel and the iteration-sliced kernels are both made of them,
    so a sliced fit is bitwise the fused one: the same guarded round
    runs in the same order, only the loop is cut differently."""
    st = dict(static)
    K = st.get("_n_classes", 0)
    classification = K > 0
    Kt = _n_trees_a_round(static)
    D = int(st["max_depth"])
    T = int(st["max_iter"])
    N = n_tree_nodes(D)
    es = bool(st["_early_stopping"])
    vf = st["validation_fraction"]
    patience = int(st["n_iter_no_change"])
    seed = int(st["random_state"] or 0)
    loss_name = st["loss"]
    if T < 1:
        raise ValueError(f"max_iter must be >= 1; got {T}")
    if patience < 1:
        raise ValueError(
            f"n_iter_no_change must be >= 1; got {patience}"
        )
    if classification and loss_name != "log_loss":
        raise ValueError(
            "DistHistGradientBoostingClassifier supports loss='log_loss'"
        )
    if not classification and loss_name != "squared_error":
        raise ValueError(
            "DistHistGradientBoostingRegressor supports "
            "loss='squared_error'"
        )
    if vf is not None and not 0.0 < float(vf) < 1.0:
        raise ValueError(
            f"validation_fraction must be in (0, 1) or None; got {vf!r}"
        )

    grow = build_tree_kernel(
        n_features=st["_n_features"], n_bins=st["max_bins"], channels=3,
        max_depth=D, max_features=st["_n_features"], min_samples_split=2,
        min_samples_leaf=st["min_samples_leaf"],
        min_impurity_decrease=0.0, extra=False, classification=False,
        hist_mode=st.get("hist_mode", "auto"), newton=True,
    )
    walk = tree_predict_kernel(D)

    def positive(y):
        return (y == (K - 1)).to(torch.float32)

    def grads(Fr, y):
        """Per-sample ``(gradient, hessian)``, each ``(L, n, Kt)``, of the
        boosting loss at raw predictions ``Fr (L, n, Kt)``; ``y`` is
        ``(n,)`` or one vector a lane ``(L, n)``."""
        if not classification:
            return (Fr[..., 0] - y)[..., None], torch.ones_like(Fr)
        if K <= 2:
            p = _by_lane(torch.sigmoid, Fr[..., 0])
            return (p - positive(y))[..., None], (p * (1.0 - p))[..., None]
        P = torch.softmax(Fr, dim=-1)
        Y1 = F.one_hot(y.long(), K).to(torch.float32)
        return P - Y1, P * (1.0 - P)

    def loss_vals(Fr, y):
        """Per-sample loss ``(L, n)`` at raw predictions: what the
        early-stopping monitor averages (scikit-learn's scoring='loss')."""
        if not classification:
            return 0.5 * (y - Fr[..., 0]) ** 2
        if K <= 2:
            z = Fr[..., 0]
            softplus = _by_lane(
                lambda v: torch.logaddexp(v, torch.zeros_like(v)), z)
            return softplus - positive(y) * z
        lse = torch.logsumexp(Fr, dim=-1)
        idx = y.long()[..., None].expand(*Fr.shape[:-1], 1)
        return lse - torch.gather(Fr, -1, idx)[..., 0]

    def baseline_of(y, w):
        """``(L, Kt)`` constant raw prediction minimising each lane's loss
        on its weighted train rows: weighted mean, log-odds or log-priors
        (per-lane sums that do not depend on the lane's slot)."""
        wsum = torch.clamp(lane_sum(w), min=1e-12)
        if not classification:
            return (lane_sum(w * y) / wsum)[:, None]
        if K <= 2:
            p = torch.clamp(lane_sum(w * positive(y)) / wsum, _P_EPS,
                            1.0 - _P_EPS)
            return torch.log(p / (1.0 - p))[:, None]
        L, n = w.shape
        wy = F.one_hot(y.long(), K).to(torch.float32) * w[..., None]
        pri = lane_sum(wy.transpose(-1, -2).reshape(L * K, n)).reshape(
            L, K) / wsum[:, None]
        return torch.log(torch.clamp(pri, min=_P_EPS))

    def fit_weights(sw):
        """``(train_w, monitor_w)`` of weights ``sw (L, n)``: the
        early-stopping validation rows (:func:`validation_uniforms`) leave
        the train side; rows outside a lane's CV fold weigh 0 on both."""
        if es and vf is not None:
            u = validation_uniforms(seed, sw.shape[1], sw.device)
            vmask = (u < float(vf)).to(torch.float32)
            return sw * (1.0 - vmask), sw * vmask
        return sw, sw

    def init_carry(Xb, y, sw, hyper):
        L, n = sw.shape
        dev = sw.device
        train_w, _ = fit_weights(sw)
        b0 = baseline_of(y, train_w).to(torch.float32)
        shape = (L, T, Kt, N)
        return {
            "F": b0[:, None, :].expand(L, n, Kt).contiguous(),
            "feat": torch.full(shape, -1, dtype=torch.int32, device=dev),
            "thr": torch.zeros(shape, dtype=torch.int32, device=dev),
            "split": torch.zeros(shape, dtype=torch.bool, device=dev),
            "leaf": torch.zeros(shape, dtype=torch.float32, device=dev),
            "baseline": b0,
            "it": torch.zeros(L, dtype=torch.int64, device=dev),
            "done": torch.zeros(L, dtype=torch.bool, device=dev),
            "best": torch.full((L,), float("inf"), dtype=torch.float32,
                               device=dev),
            "bad": torch.zeros(L, dtype=torch.int32, device=dev),
        }

    def restart(Xb, y, sw, hyper, carry, slots):
        """Start the lanes at ``slots`` afresh, in place."""
        fresh = init_carry(Xb, y, sw, hyper)
        for key, leaf in carry.items():
            leaf.index_copy_(0, slots, fresh[key].index_select(0, slots))
        return carry

    def resume(Xb, y, sw, hyper, carry, n_rounds):
        """Up to ``n_rounds`` guarded boosting rounds of every lane; stops
        early once every lane is done (one host read a round)."""
        L, n = sw.shape
        dev = sw.device
        lr = hyper["learning_rate"].to(torch.float32)
        tol = hyper["tol"].to(torch.float32)
        # each class tree of a lane takes the lane's lambda and rate
        lam_t = hyper["l2_regularization"].to(torch.float32) \
            .repeat_interleave(Kt)
        lr_t = lr.repeat_interleave(Kt)[:, None]
        train_w, monitor_w = fit_weights(sw)
        mon_den = torch.clamp(lane_sum(monitor_w), min=1e-12)
        seeds = torch.full((L * Kt,), seed, dtype=torch.int64, device=dev)
        lanes = torch.arange(L, device=dev)

        def round_body(c):
            keep = c["done"]
            g, h = grads(c["F"], y)
            Ych = newton_channels(g.transpose(1, 2), h.transpose(1, 2),
                                  train_w[:, None, :]).reshape(L * Kt, n, 3)
            trees = grow(Xb, Ych, seeds, lam_t)
            leaf_r = trees["leaf"][..., 0] * lr_t
            upd = _walk_leaves(walk, Xb, trees["feat"], trees["thr"],
                               trees["is_split"], leaf_r)
            F_new = c["F"] + upd.reshape(L, Kt, n).transpose(1, 2)
            mon = lane_sum(monitor_w * loss_vals(F_new, y)) / mon_den
            improved = mon < c["best"] - tol
            it1 = c["it"] + 1
            done = it1 >= T
            bad = torch.where(improved, 0, c["bad"] + 1).to(torch.int32)
            if es:
                done = done | (bad >= patience)
            slot = torch.clamp(c["it"], max=T - 1)

            def put(bank, new):
                new = new.reshape(L, Kt, N)
                old = bank[lanes, slot]
                return bank.index_put(
                    (lanes, slot), torch.where(keep[:, None, None], old, new))

            return {
                "F": torch.where(keep[:, None, None], c["F"], F_new),
                "feat": put(c["feat"], trees["feat"]),
                "thr": put(c["thr"], trees["thr"]),
                "split": put(c["split"], trees["is_split"]),
                "leaf": put(c["leaf"], leaf_r),
                "baseline": c["baseline"],
                "it": torch.where(keep, c["it"], it1),
                "done": keep | done,
                "best": torch.where(keep, c["best"],
                                    torch.minimum(c["best"], mon)),
                "bad": torch.where(keep, c["bad"], bad),
            }

        for _ in range(int(n_rounds)):
            if bool(carry["done"].all()):
                break
            carry = round_body(carry)
        return carry

    def finalize(carry):
        return {
            "feat": carry["feat"],
            "thr": carry["thr"],
            "is_split": carry["split"],
            "leaf": carry["leaf"],
            "baseline": carry["baseline"],
            "n_iter": carry["it"],
        }

    def converged(carry):
        """Lanes stopped by the no-improvement rule (the others ran out of
        rounds)."""
        if not es:
            return torch.zeros_like(carry["done"])
        return carry["done"] & (carry["bad"] >= patience)

    return {
        "init_carry": init_carry, "restart": restart, "resume": resume,
        "finalize": finalize, "converged": converged, "T": T,
    }


class _BaseGBDT(BaseEstimator):
    """Shared surface of the two boosting estimators, on the card unless
    ``device="cpu"``: the searches' batched-fit contract
    (``_hyper_names``/``_static_names``/``_prep_fit_data``/
    ``_fit_operand``/``_build_fit_kernel``/``_build_decision_kernel``),
    the iteration-sliced contract of the compacted scheduler and ASHA
    (``_build_fit_slice_kernels``: one boosting round an iteration, the
    live carry scoreable at every slice boundary), and the fitted
    surface that ``device_predict_plan`` serves.

    ``learning_rate``, ``l2_regularization`` and ``tol`` ride the task
    axis; the others shape the kernel. The histogram engine resolves in
    the kernel, on the device of the bins: K4 on the card, the scatter on
    the CPU; ``hist_mode="native"`` raises, as for every batched tree
    kernel.
    """

    _hyper_names = ("learning_rate", "l2_regularization", "tol")
    _static_names = (
        "loss", "max_iter", "max_depth", "max_bins", "min_samples_leaf",
        "early_stopping", "validation_fraction", "n_iter_no_change",
        "random_state", "hist_mode",
    )
    #: the params :meth:`_prep_fit_data` reads: a search preps the whole
    #: X's edges once for every bucket of one ``max_bins``
    _prep_params = ("max_bins",)
    #: packed-CSR input has no histogram form; prepare_fit_X densifies
    _supports_packed_X = False
    #: the compacted scheduler's gate: boosting rounds are the iteration
    #: axis, early stopping is the done flag
    _supports_sliced_fit = True

    def __init__(self, loss, learning_rate=0.1, max_iter=100, max_depth=5,
                 max_bins=64, l2_regularization=0.0, min_samples_leaf=20,
                 early_stopping="auto", validation_fraction=0.1,
                 n_iter_no_change=10, tol=1e-7, random_state=0,
                 hist_mode="auto", device=None):
        self.loss = loss
        self.learning_rate = learning_rate
        self.max_iter = max_iter
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.l2_regularization = l2_regularization
        self.min_samples_leaf = min_samples_leaf
        self.early_stopping = early_stopping
        self.validation_fraction = validation_fraction
        self.n_iter_no_change = n_iter_no_change
        self.tol = tol
        self.random_state = random_state
        self.hist_mode = hist_mode
        self.device = device
        if not 2 <= int(max_bins) <= MAX_BINS:
            raise ValueError(
                f"max_bins must be in [2, {MAX_BINS}]; got {max_bins}"
            )
        _check_early_stopping(early_stopping)
        self._check_hypers()

    def _check_hypers(self):
        """scikit-learn's domains of the task-axis hypers, checked in
        ``__init__`` and again at every data prep (a ``set_params`` fit,
        the generic search path). A search's per-candidate values ride
        the task axis unchecked, as in the JAX package."""
        lr = getattr(self, "learning_rate", 0.1)
        if not (lr is None or float(lr) > 0):
            raise ValueError(
                f"learning_rate must be > 0; got {lr!r}"
            )
        l2 = getattr(self, "l2_regularization", 0.0)
        if not (l2 is None or float(l2) >= 0):
            raise ValueError(
                f"l2_regularization must be >= 0; got {l2!r}"
            )

    _check_supported = _check_hypers

    @property
    def _classification(self):
        return isinstance(self, ClassifierMixin)

    @classmethod
    def _batched_task_cost(cls, hyper):
        """Round-packing heuristic: a smaller learning rate needs more
        rounds before the no-improvement rule fires, and a tighter tol
        delays it further (``tol=None`` is -inf: never stops early, sorts
        last)."""
        lr = np.asarray(hyper.get("learning_rate", 0.1), dtype=np.float64)
        tol = np.asarray(hyper.get("tol", 1e-7), dtype=np.float64)
        cost = -np.log(np.maximum(lr, 1e-30)) - np.where(
            tol > 0, np.log(np.where(tol > 0, tol, 1.0)), -np.inf
        )
        return np.broadcast_to(
            cost, np.broadcast_shapes(lr.shape, tol.shape)
        )

    # ---- fit-data prep --------------------------------------------------
    def _prep_fit_data(self, X, y, sample_weight=None):
        """``(host data, meta)`` of a fit: dense float32 ``X``, encoded
        labels (or float32 targets) and weights; ``meta`` holds the
        quantile ``edges`` of the whole ``X`` (the JAX kernel's
        ``aux["edges"]``), which every lane bins with."""
        self._check_hypers()
        X = as_dense_f32(X)
        sw = prepare_sample_weight(sample_weight, X.shape[0])
        meta = {"n_features": X.shape[1], "n_samples": X.shape[0],
                "x_format": "dense",
                "edges": quantile_bin_edges(X, self.max_bins)}
        if self._classification:
            y_idx, classes = encode_labels(y)
            meta.update(classes=classes, n_classes=len(classes))
            return {"X": X, "y": y_idx, "sw": sw}, meta
        return {"X": X, "y": np.asarray(y, np.float32).reshape(-1),
                "sw": sw}, meta

    def _static_config(self, meta):
        cfg = {k: getattr(self, k) for k in self._static_names}
        cfg["_n_classes"] = meta.get("n_classes", 0)
        cfg["_n_features"] = meta["n_features"]
        # 'auto' resolves against the fit's row count
        cfg["_early_stopping"] = _resolve_early_stopping(
            self.early_stopping, meta.get("n_samples", 0)
        )
        return cfg

    @classmethod
    def _fit_operand(cls, X, meta, static):
        """The fit kernels' shared operand: device ``X`` binned under the
        whole X's edges, once for every round."""
        return apply_bins(X, meta["edges"])

    # ---- kernels --------------------------------------------------------
    @classmethod
    def _build_fit_kernel(cls, meta, static):
        """``kernel(Xb, y, sw, hyper) -> params``: boost every lane of
        ``sw (L, n)`` (with labels ``y``, ``(n,)`` or one vector a lane)
        to the end. Returns ``{feat, thr, is_split, leaf: (L, max_iter,
        Kt, N), baseline: (L, Kt), n_iter: (L,)}``."""
        parts = _build_boost_parts(meta, static)

        def kernel(Xb, y, sw, hyper):
            carry = parts["init_carry"](Xb, y, sw, hyper)
            carry = parts["resume"](Xb, y, sw, hyper, carry, parts["T"])
            return parts["finalize"](carry)

        return kernel

    @classmethod
    def _build_fit_slice_kernels(cls, meta, static, n_slice):
        """The iteration-sliced fit (one boosting round an iteration), in
        the parts of :class:`~skdist_tpu_torch.parallel.IterativeKernelSpec`
        over a batch of lanes ``(Xb, y, sw, hyper, ...)``: ``init`` starts
        every lane (no round), ``restart`` starts the lanes at ``slots``
        afresh in place, ``step`` boosts ``n_slice`` more rounds,
        ``finalize`` shapes the params from the ``finalize_keys`` leaves
        (``F`` and the early-stopping state never leave the device),
        ``score_params`` is the same on a live carry (the trees grown so
        far and the baseline: a valid model), and ``converged`` tells
        early-stopped lanes from those that ran out of rounds."""
        parts = _build_boost_parts(meta, static)
        n_slice = int(n_slice)

        def step(Xb, y, sw, hyper, carry):
            return parts["resume"](Xb, y, sw, hyper, carry, n_slice)

        def finalize(Xb, y, sw, hyper, carry):
            return parts["finalize"](carry)

        def converged(Xb, y, sw, hyper, carry):
            return parts["converged"](carry)

        return {
            "init": parts["init_carry"], "restart": parts["restart"],
            "step": step, "finalize": finalize,
            "finalize_keys": ("feat", "thr", "split", "leaf", "baseline",
                              "it"),
            "score_params": finalize, "converged": converged,
            "max_iter": parts["T"],
        }

    @classmethod
    def _decision_params(cls, params):
        """What the decision kernel reads of a batched fit's outputs: the
        stacked banks themselves."""
        return params

    @classmethod
    def _build_decision_kernel(cls, meta, static):
        """``decision(params, X)``: raw predictions of fitted banks over a
        dense device block ``X``, binned with ``params["edges"]`` (else
        ``meta["edges"]``: a batched fit's lanes). Every ``max_iter``
        round is walked; rounds past ``n_iter`` hold zero trees."""
        st = dict(static)
        walk = tree_predict_kernel(int(st["max_depth"]))
        Kt = _n_trees_a_round(static)

        def decision(params, X):
            edges = params["edges"] if "edges" in params else meta["edges"]
            return _bank_decision(walk, apply_bins(X, edges), params, Kt)

        return decision

    @classmethod
    def _batched_task_bytes(cls, meta, static, n):
        """A lane's device bytes: its ``Kt`` trees of a round, ``F`` with
        the loss temporaries, its bank (carried and in the finalize
        batch), and the scores' walk of a round over X (int64 node ids
        and gathers)."""
        st = dict(static)
        Kt = _n_trees_a_round(static)
        N = n_tree_nodes(int(st["max_depth"]))
        trees = Kt * tree_task_bytes(n, st["_n_features"], st["max_bins"],
                                     3, int(st["max_depth"]),
                                     st["hist_mode"])
        carry = n * Kt * 4 * 8 + n * 4 * 4
        bank = 2 * int(st["max_iter"]) * Kt * N * 13
        walk = Kt * n * 8 * 6
        return int(trees + carry + bank + walk)

    @classmethod
    def _batched_round_bytes(cls, meta, static, n):
        """The shared int32 bins, K4's padded uint8 copy of them and the
        scores' binning of X, held once a round."""
        d = dict(static)["_n_features"]
        return n * (4 * d + 16 * -(-d // 16) + 4 * d)

    @classmethod
    def _plan_row_bytes(cls, meta, static):
        """Device bytes a row of a prediction block holds beside its
        input and output: its bins, the rounds' int64 node ids with the
        walk's gathers (``max_iter * Kt`` trees) and ``F``."""
        st = dict(static)
        Kt = _n_trees_a_round(static)
        return 4 * st["_n_features"] + 6 * 8 * int(st["max_iter"]) * Kt \
            + 8 * Kt

    # ---- fitted state ---------------------------------------------------
    def _set_fitted(self, params, meta):
        """Fitted state from one lane of a batched fit: its bank,
        ``n_iter`` and the edges it was grown under."""
        self._params = {k: np.asarray(params[k]) for k in _BANK_KEYS}
        self._params["n_iter"] = np.asarray(params["n_iter"])
        self._params["edges"] = np.asarray(meta["edges"], np.float32)
        self._meta = {k: v for k, v in meta.items() if k != "edges"}
        self.n_features_in_ = meta["n_features"]
        if "classes" in meta:
            self.classes_ = meta["classes"]
        self.n_iter_ = int(np.asarray(params["n_iter"]).reshape(()))
        return self

    def fit(self, X, y=None, sample_weight=None):
        """Boost on ``device`` (the card unless ``device="cpu"``): a batch
        of one lane of the fit kernel."""
        _refuse_chunked(X, f"{type(self).__name__}.fit")
        if y is None:
            raise TypeError(f"{type(self).__name__}.fit requires y")
        device = resolve_device(self.device)
        data, meta = self._prep_fit_data(X, y, sample_weight)
        static = _freeze(self._static_config(meta))
        kernel = type(self)._build_fit_kernel(meta, static)
        hyper = {k: torch.tensor([hyper_float(getattr(self, k))],
                                 device=device)
                 for k in self._hyper_names}
        with torch.no_grad():
            Xb = self._fit_operand(torch.as_tensor(data["X"]).to(device),
                                   meta, static)
            params = kernel(Xb, torch.as_tensor(data["y"]).to(device),
                            torch.as_tensor(data["sw"]).to(device)[None],
                            hyper)
        return self._set_fitted(
            {k: v[0].cpu().numpy() for k, v in params.items()}, meta)

    def _check_fitted(self):
        if not hasattr(self, "_params"):
            raise AttributeError(
                f"This {type(self).__name__} instance is not fitted yet."
            )

    def _kernel_params(self):
        """The fitted arrays the decision and proba kernels read."""
        return {k: self._params[k] for k in _BANK_KEYS + ("edges",)}

    def _device_outputs(self, X, which):
        self._check_fitted()
        _refuse_chunked(X, which)
        device = resolve_device(self.device)
        X = as_dense_f32(X)
        static = _freeze(self._static_config(self._meta))
        kernel = getattr(type(self), f"_build_{which}_kernel")(
            self._meta, static)
        params = {k: torch.as_tensor(v).to(device)
                  for k, v in self._kernel_params().items()}
        with torch.no_grad():
            out = kernel(params, torch.as_tensor(X).to(device))
        return out.cpu().numpy()

    def decision_function(self, X):
        return self._device_outputs(X, "decision")


class DistHistGradientBoostingClassifier(_BaseGBDT, ClassifierMixin):
    """Histogram gradient-boosting classifier (log loss).

    A binary fit grows one tree a round on the sigmoid gradient/hessian;
    a K-class fit grows K trees a round (one launch of the round's
    kernels for all of them) on the softmax gradient/hessian.
    ``decision_function`` returns raw logits, ``(n,)`` binary or ``(n,
    K)``, which the device scorers, the searches and batch prediction
    consume as they do a linear classifier's. One-vs-rest puts its binary
    sub-problems on the lane axis (``_lane_labels``).
    """

    #: one-vs-rest batches its binary sub-problems, one label vector a lane
    _lane_labels = True

    def __init__(self, loss="log_loss", learning_rate=0.1, max_iter=100,
                 max_depth=5, max_bins=64, l2_regularization=0.0,
                 min_samples_leaf=20, early_stopping="auto",
                 validation_fraction=0.1, n_iter_no_change=10, tol=1e-7,
                 random_state=0, hist_mode="auto", device=None):
        super().__init__(
            loss=loss, learning_rate=learning_rate, max_iter=max_iter,
            max_depth=max_depth, max_bins=max_bins,
            l2_regularization=l2_regularization,
            min_samples_leaf=min_samples_leaf,
            early_stopping=early_stopping,
            validation_fraction=validation_fraction,
            n_iter_no_change=n_iter_no_change, tol=tol,
            random_state=random_state, hist_mode=hist_mode, device=device,
        )
        if loss != "log_loss":
            raise ValueError(
                "DistHistGradientBoostingClassifier supports "
                "loss='log_loss'"
            )

    @classmethod
    def _build_proba_kernel(cls, meta, static):
        decision = cls._build_decision_kernel(meta, static)
        binary = meta.get("n_classes", 2) <= 2

        def proba(params, X):
            z = decision(params, X)
            if binary:
                p1 = torch.sigmoid(z)
                return torch.stack([1.0 - p1, p1], dim=-1)
            return torch.softmax(z, dim=-1)

        return proba

    def predict_proba(self, X):
        return self._device_outputs(X, "proba")

    def predict_log_proba(self, X):
        return np.log(np.clip(self.predict_proba(X), 1e-15, None))

    def predict(self, X):
        scores = self.decision_function(X)
        if scores.ndim == 1:
            idx = (scores > 0).astype(np.int64)
        else:
            idx = np.argmax(scores, axis=1)
        return self.classes_[idx]


class DistHistGradientBoostingRegressor(_BaseGBDT, RegressorMixin):
    """Histogram gradient-boosting regressor (squared error): one tree a
    round on the residuals (unit hessian), Newton leaves with
    ``l2_regularization``. ``decision_function``/``predict`` return raw
    predictions ``(n,)``, which the regression device scorers read as
    ``kind='predict'``, rung metrics among them."""

    def __init__(self, loss="squared_error", learning_rate=0.1,
                 max_iter=100, max_depth=5, max_bins=64,
                 l2_regularization=0.0, min_samples_leaf=20,
                 early_stopping="auto", validation_fraction=0.1,
                 n_iter_no_change=10, tol=1e-7, random_state=0,
                 hist_mode="auto", device=None):
        super().__init__(
            loss=loss, learning_rate=learning_rate, max_iter=max_iter,
            max_depth=max_depth, max_bins=max_bins,
            l2_regularization=l2_regularization,
            min_samples_leaf=min_samples_leaf,
            early_stopping=early_stopping,
            validation_fraction=validation_fraction,
            n_iter_no_change=n_iter_no_change, tol=tol,
            random_state=random_state, hist_mode=hist_mode, device=device,
        )
        if loss != "squared_error":
            raise ValueError(
                "DistHistGradientBoostingRegressor supports "
                "loss='squared_error'"
            )

    def predict(self, X):
        return self.decision_function(X)
