"""
Histogram-based decision trees of the port.

Counterpart of ``skdist_tpu/models/tree.py``, in the same steps:

1. features are quantile-binned once (``ops/binning.py``);
2. the tree grows breadth-first to a static ``max_depth``; the node of
   every sample is a vector updated level by level;
3. per-level split search is a histogram reduction of per-sample
   channel vectors into (feature, node, bin, channel), then cumulative
   sums over bins, and a Gini (or variance, or Newton) gain for every
   (feature, bin) at once;
4. row subsets (bootstrap, CV folds) are sample weights; a count channel
   tracks unweighted occupancy for the ``min_samples`` rules.

Where the JAX package ``vmap``s one tree per lane, :func:`build_tree_kernel`
here grows a round of T trees at once: ``Xb (n, d)`` is shared by all
trees, channels are ``(T, n, C)`` and every tree draws from its own seed
(``utils/draws.py``). The forests, the searches and one-vs-rest/one-vs-one
put their trees, folds, classes or class pairs on that axis
(:class:`_BaseTree` has the searches' batched-fit contract). The
histogram engine (``hist_mode``):

- ``"pallas"``: K4, the hand-written CUDA kernel ``level_histogram``
  (``ops/hist.py``), on the card; its plain version on the CPU;
- ``"scatter"``: the plain ``index_add_`` histogram;
- ``"matmul"``: one-hot ``(n, d*B)`` times ``(n, nl*C)`` through
  ``torch.matmul`` (what the JAX package computes with XLA's dot);
- ``"matmul_sib"``: the same with sibling subtraction below the root;
- ``"native"``: the host C engine (``models/native_forest.py``), on the
  CPU only, and never inside a batched kernel;
- ``"auto"``: ``"pallas"`` on the card; on the CPU ``"native"`` for a
  single tree and for a forest on a ``LocalBackend`` (the JAX package's
  CPU calibration), else ``"scatter"`` (a batched kernel: the
  calibration's ``xla_mode``). See :func:`resolve_hist_config`.

The random draws (``max_features`` subsets, ExtraTrees thresholds) come
from a counter-based hash keyed by each tree's seed, not from
``jax.random``: randomised trees agree with the JAX package
statistically, not tree for tree.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..base import BaseEstimator, ClassifierMixin, RegressorMixin
from ..ops.binning import apply_bins, apply_bins_np, quantile_bin_edges
from ..ops.hist import (integer_channels, kernel_bins, level_histogram,
                        level_histogram_ref)
from ..sparse import MaskedColumns
from ..utils import draws
from ..utils.device import exact_matmuls, lane_sum, resolve_device
from .linear import as_dense_f32, encode_labels, prepare_sample_weight

__all__ = [
    "DecisionTreeClassifier",
    "DecisionTreeRegressor",
    "ExtraTreeClassifier",
    "ExtraTreeRegressor",
    "build_tree_kernel",
    "feature_importances_from_tree",
    "histogram_node_scores",
    "n_tree_nodes",
    "newton_channels",
    "pick_level_splits",
    "resolve_hist_config",
    "resolve_max_features",
    "tree_predict_kernel",
    "tree_task_bytes",
]

_NEG = -1e30

#: the arrays of one fitted tree
_TREE_KEYS = ("feat", "thr", "is_split", "leaf", "gain")

#: rows walked at once by the predict side, times the tree count
_WALK_ELEMS = 2 ** 24


def n_tree_nodes(max_depth):
    return 2 ** (max_depth + 1) - 1


#: bins a block of the CPU's bin scan (:func:`bin_cumsum`)
_SCAN_BLOCK = 16


def bin_cumsum(hist, dim):
    """Cumulative sums of a histogram over its bins (axis ``dim``).

    On the CPU in the JAX package's float32 order there (XLA's CPU
    cumsum): a sequential float32 scan within blocks of 16 bins, each
    block then offset by the running total of the blocks before it. So
    fractional channels' split gains round as the JAX package's do, and
    its exact ties (a classifier's first boosting round has many) break
    the same way; ``torch.cumsum`` accumulates in float64 on the CPU. On
    the card it is ``torch.cumsum``."""
    if hist.is_cuda:
        return torch.cumsum(hist, dim=dim)
    x = hist.movedim(dim, -1)
    out = torch.empty_like(x)
    total = None
    for lo in range(0, x.shape[-1], _SCAN_BLOCK):
        acc = x[..., lo]
        for i in range(lo, min(lo + _SCAN_BLOCK, x.shape[-1])):
            if i > lo:
                acc = acc + x[..., i]
            out[..., i] = acc if total is None else acc + total
        total = acc if total is None else total + acc
    return out.movedim(-1, dim)


def histogram_node_scores(hist_cum, lam=None, *, newton=False,
                          classification=False, K=1):
    """``hist_cum (..., d, nl, B, C)`` cumulative over bins -> per
    (feature, node, threshold) gains and counts. Returns ``(gain, cnt_l,
    cnt_r, node_totals)`` with ``node_totals (..., d, nl, C)``. ``lam``
    is the Newton lambda (a float, or a tensor broadcastable to the gain),
    read only by the newton objective: a per-tree lambda is ``(T, 1, 1,
    1)`` against a ``(T, d, nl, B)`` gain, and its last axis is dropped
    for the node totals."""
    tot = hist_cum[..., -1, :]
    L = hist_cum  # left stats for threshold t = bins <= t
    R = tot[..., None, :] - L
    cnt_l = L[..., -1]
    cnt_r = R[..., -1]
    if newton:
        g_l, h_l = L[..., 0], L[..., 1]
        g_r, h_r = R[..., 0], R[..., 1]
        g_t, h_t = tot[..., 0], tot[..., 1]
        lam_t = lam[..., 0] if torch.is_tensor(lam) and lam.ndim else lam
        gain = (
            g_l ** 2 / torch.clamp(h_l + lam, min=1e-12)
            + g_r ** 2 / torch.clamp(h_r + lam, min=1e-12)
            - (g_t ** 2 / torch.clamp(h_t + lam_t, min=1e-12))[..., None]
        )
    elif classification:
        wl = torch.sum(L[..., :K], dim=-1)
        wr = torch.sum(R[..., :K], dim=-1)
        sl = torch.sum(L[..., :K] ** 2, dim=-1) / torch.clamp(wl, min=1e-12)
        sr = torch.sum(R[..., :K] ** 2, dim=-1) / torch.clamp(wr, min=1e-12)
        st = torch.sum(tot[..., :K] ** 2, dim=-1) / torch.clamp(
            torch.sum(tot[..., :K], dim=-1), min=1e-12
        )
        # (sum wt * gini improvements): decrease * W_root = sl + sr - st
        gain = sl + sr - st[..., None]
    else:
        w_l, wy_l, wy2_l = L[..., 0], L[..., 1], L[..., 2]
        w_r, wy_r, wy2_r = R[..., 0], R[..., 1], R[..., 2]
        sse_l = wy2_l - wy_l ** 2 / torch.clamp(w_l, min=1e-12)
        sse_r = wy2_r - wy_r ** 2 / torch.clamp(w_r, min=1e-12)
        wt, wy_t, wy2_t = tot[..., 0], tot[..., 1], tot[..., 2]
        sse_t = wy2_t - wy_t ** 2 / torch.clamp(wt, min=1e-12)
        gain = sse_t[..., None] - (sse_l + sse_r)
    return gain, cnt_l, cnt_r, tot


def pick_level_splits(gain, node_cnt, *, min_samples_split, w_root,
                      min_impurity_decrease):
    """Best (feature, threshold) per node from masked gains.

    ``gain (..., d, nl, B)`` with invalid cells already at ``_NEG``;
    ``node_cnt (..., nl)`` unweighted occupancy; ``w_root`` broadcasts to
    ``(..., nl)``. The gains are flattened to ``(nl, d*B)`` as in the JAX
    package, so a tie goes to the lowest feature, then the lowest bin
    (``torch.argmax`` returns the first maximum). Returns ``(best_f,
    best_t, best_gain, do_split)``."""
    d, nl, B = gain.shape[-3:]
    gain_fb = gain.transpose(-3, -2).reshape(*gain.shape[:-3], nl, d * B)
    best_flat = torch.argmax(gain_fb, dim=-1)
    best_gain = torch.gather(gain_fb, -1, best_flat[..., None])[..., 0]
    best_f = (best_flat // B).to(torch.int32)
    best_t = (best_flat % B).to(torch.int32)
    decrease = best_gain / torch.clamp(w_root, min=1e-12)
    do_split = (
        (best_gain > 1e-12)
        & (decrease >= min_impurity_decrease)
        & (node_cnt >= min_samples_split)
    )
    return best_f, best_t, best_gain, do_split


def resolve_hist_config(hist_mode, device, allow_native=False, n_bins=32):
    """The concrete histogram engine for ``hist_mode`` on ``device``.

    ``allow_native`` is set by the callers that may run the host C
    engine (``models/native_forest.py``): a single tree's ``fit``, and a
    forest's that fits on a ``LocalBackend``; a batched kernel (a forest
    round on ``CUDABackend``, the searches' and the multiclass lanes) may
    not, as in the JAX package (``resolve_hist_config(allow_native=
    False)``). ``"auto"`` is K4 (``"pallas"``) on the card; on the CPU it
    is ``"native"`` where allowed and the C kernels build for ``n_bins``
    (at most 256), else ``"scatter"``. An explicit ``"native"`` raises on
    the card, where not allowed, and where the C engine cannot serve the
    fit: nothing gives way silently. There is no calibration table yet
    (``hist_calib.py`` waits, ROADMAP Queue 1 item 5.6), and none of the
    JAX package's TPU guards applies: K4 takes any ``n_bins`` and builds
    nothing of size ``(n, d*B)``."""
    on_card = torch.device(device).type == "cuda"
    if hist_mode == "native":
        if on_card:
            raise ValueError(
                "hist_mode='native' is the host C tree engine and cannot "
                "run on the card; use 'auto' or 'pallas' there, or "
                "device='cpu'"
            )
        if not allow_native:
            raise ValueError(
                "hist_mode='native' is the host (LocalBackend) tree engine "
                "and cannot run inside a batched kernel (a CUDABackend "
                "forest round, the searches' and the multiclass lanes); "
                "use 'auto' or 'scatter'/'matmul'/'pallas'"
            )
        from .native_forest import native_supported_or_raise

        native_supported_or_raise(n_bins, True)
        return "native"
    if hist_mode == "auto":
        if on_card:
            return "pallas"
        if allow_native:
            from .native_forest import native_supported_or_raise

            if native_supported_or_raise(n_bins, False):
                return "native"
        return "scatter"
    if hist_mode not in ("scatter", "matmul", "matmul_sib", "pallas"):
        raise ValueError(
            f"hist_mode must be 'auto', 'native', 'scatter', 'matmul', "
            f"'matmul_sib' or 'pallas'; got {hist_mode!r}"
        )
    return hist_mode


def tree_task_bytes(n, d, n_bins, channels, max_depth, hist_mode):
    """Device bytes one tree of a round may hold at once, for the round
    sizer: the deepest level's ``(d, nl, B, C)`` histogram with its
    cumsum and the gain temporaries, the ``(n, C)`` channels and weights,
    the per-sample node and routing vectors and the draws' integer
    temporaries, and for the matmul engines the ``(n, nl*C)`` factor."""
    nl = 2 ** max(max_depth - 1, 0)
    B, C = n_bins, channels
    hist = d * nl * B * C * 4
    gain = d * nl * B * 4
    per = 8 * hist + 12 * gain  # hist, cum, R, squares; gain, masks, draws
    per += n * C * 4 * 3  # channels and the class/bootstrap products
    per += n * 8 * 14  # int64 node ids, routing, hash temporaries
    if hist_mode in ("matmul", "matmul_sib"):
        per += n * nl * (C + 1) * 4 * 2
    elif hist_mode == "scatter":
        per += n * 8 * 4
    N = n_tree_nodes(max_depth)
    per += N * (C * 4 * 2 + 16)
    return int(per)


def build_tree_kernel(n_features, n_bins, channels, max_depth, max_features,
                      min_samples_split, min_samples_leaf,
                      min_impurity_decrease, extra, classification,
                      hist_mode="auto", newton=False):
    """Returns ``kernel(Xb, Ych, seeds, l2=None, feature_mask=None) ->
    trees`` growing a round of T trees at once.

    - ``Xb (n, d) int32`` binned features, shared by the trees;
    - ``Ych (T, n, C) float32`` per-tree channels:
      classification C = K + 1: ``[w*onehot(y) ..., count(w>0)]``;
      regression C = 4: ``[w, w*y, w*y**2, count(w>0)]``;
      newton C = 3: ``[s*g, s*h, count(s>0)]``;
    - ``seeds (T,)`` integer seeds of the trees' draws
      (``max_features`` subsets, ExtraTrees thresholds);
    - ``l2``: the Newton lambda (``newton=True`` only): a float for
      every tree of the round, or a ``(T,)`` tensor, one lambda a tree
      (a GBDT search's lanes, each class of a lane with its lane's).
      A scalar gives the bits it gave before per-tree lambdas existed.
    - ``feature_mask``: None, or ``(T, d)`` bool, the features each tree
      may split (the feature eliminator's column masks). A masked
      feature's gains are invalid before the split is chosen, so a tree
      grows as over its X with the masked columns zeroed and binned
      under the whole X's edges (a constant column never yields a valid
      split, and an all-invalid node picks the same cell either way).
      The histogram still covers all ``d`` features (K4 runs one launch
      a level over the shared ``Xb``), and the ``max_features`` draws
      and ExtraTrees thresholds are drawn as without a mask. None gives
      the bits it gave before masks existed.

    ``trees`` = ``{feat, thr, is_split, gain: (T, N), leaf: (T, N,
    K_out)}`` with N = 2**(D+1) - 1 heap-indexed nodes (children of i:
    2i+1, 2i+2). ``hist_mode`` picks the histogram engine (module
    docstring); ``"auto"`` resolves on the device of ``Xb``.
    """
    d, B, C, D = n_features, n_bins, channels, max_depth
    if newton and classification:
        raise ValueError(
            "newton=True grows a regression tree on gradient/hessian "
            "channels; pass classification=False"
        )
    K = C - 1 if classification else 1  # leaf output width
    resolve_hist_config(hist_mode, "cpu")  # validate the name early

    def node_scores(hist_cum, lam=None):
        return histogram_node_scores(
            hist_cum, lam, newton=newton,
            classification=classification, K=K,
        )

    def kernel(Xb, Ych, seeds, l2=None, feature_mask=None):
        mode = resolve_hist_config(hist_mode, Xb.device)
        T, n = Ych.shape[0], Ych.shape[1]
        dev = Xb.device
        seeds = torch.as_tensor(seeds, device=dev)
        if feature_mask is not None:
            if tuple(feature_mask.shape) != (T, d):
                raise ValueError(
                    f"feature_mask must be ({T}, {d}) bool, one row a "
                    f"tree; got {tuple(feature_mask.shape)}")
            # against the (T, d, nl, B) gain
            feature_mask = feature_mask.to(dev, torch.bool)[:, :, None, None]
        N = n_tree_nodes(D)
        lam = None
        if newton:
            lam = torch.as_tensor(0.0 if l2 is None else l2,
                                  dtype=torch.float32, device=dev)
            if lam.ndim:
                if tuple(lam.shape) != (T,):
                    raise ValueError(
                        f"l2 must be a float or one lambda a tree, shape "
                        f"({T},); got {tuple(lam.shape)}")
                # against the (T, d, nl, B) gain; the leaves take lam[:, None]
                lam = lam[:, None, None, None]
        feat = torch.full((T, N), -1, dtype=torch.int32, device=dev)
        thr = torch.zeros((T, N), dtype=torch.int32, device=dev)
        is_split = torch.zeros((T, N), dtype=torch.bool, device=dev)
        gain_rec = torch.zeros((T, N), dtype=torch.float32, device=dev)
        node_id = torch.zeros((T, n), dtype=torch.int64, device=dev)
        # lane_sum: a tree's totals do not depend on its slot in the round
        if newton:
            w_root = lane_sum(Ych[..., 1])  # total hessian mass
        elif classification:
            w_root = lane_sum(Ych[..., :K])
        else:
            w_root = lane_sum(Ych[..., 0])
        w_root = w_root[:, None]

        Xb = Xb.contiguous()
        if mode in ("matmul", "matmul_sib"):
            # (n, d*B) one-hot of the binned features: the left factor of
            # every level's contraction
            XohT = F.one_hot(Xb.long(), B).to(Ych.dtype).reshape(n, d * B).T
        elif mode == "pallas":
            # once a round: K4's bin layout, the proof of which channels
            # are integral (K4 sums those exactly in int32), and which
            # samples weigh anything (K4 skips the others by their key)
            Xb_k4 = kernel_bins(Xb, B)
            int_ch = integer_channels(Ych)
            live = torch.any(Ych != 0, dim=-1)
        row_off = torch.arange(n, device=dev) * d
        Xb_flat = Xb.reshape(-1)

        prev_hist = prev_split = None  # matmul_sib level-to-level carry
        for level in range(D):
            start = 2 ** level - 1
            nl = 2 ** level
            rel = node_id - start
            at_level = (node_id >= start) & (node_id < start + nl)

            if mode == "matmul_sib" and level > 0:
                # only LEFT children by matmul; each right child is its
                # parent's histogram minus the left sibling, zeroed for
                # children of unsplit parents
                nh = nl // 2
                left = at_level & (rel % 2 == 0)
                parent_oh = F.one_hot(
                    torch.clamp(rel // 2, 0, nh - 1), nh
                ).to(Ych.dtype) * left[..., None].to(Ych.dtype)
                NW = (parent_oh[..., None] * Ych[:, :, None, :]).reshape(
                    T, n, nh * C)
                hist_left = torch.matmul(XohT, NW).reshape(
                    T, d, B, nh, C).permute(0, 1, 3, 2, 4)
                split_mask = prev_split.to(torch.float32)[
                    :, None, :, None, None]
                hist_right = (prev_hist - hist_left) * split_mask
                hist = torch.stack([hist_left, hist_right], dim=3).reshape(
                    T, d, nl, B, C)
            elif mode in ("matmul", "matmul_sib"):
                level_oh = F.one_hot(
                    torch.clamp(rel, 0, nl - 1), nl
                ).to(Ych.dtype) * at_level[..., None].to(Ych.dtype)
                NW = (level_oh[..., None] * Ych[:, :, None, :]).reshape(
                    T, n, nl * C)
                hist = torch.matmul(XohT, NW).reshape(
                    T, d, B, nl, C).permute(0, 1, 3, 2, 4)
            elif mode == "pallas":
                node_key = torch.where(at_level & live, rel, nl).to(torch.int32)
                hist = level_histogram(Xb_k4, node_key, Ych, nl, B,
                                       integer=int_ch)
            else:
                node_key = torch.where(at_level, rel, nl).to(torch.int32)
                hist = level_histogram_ref(Xb, node_key, Ych, nl, B)
            cum = bin_cumsum(hist, 3)
            gain, cnt_l, cnt_r, tot = node_scores(cum, lam)

            # ---- validity
            node_cnt = tot[:, 0, :, -1]  # (T, nl) unweighted occupancy
            ok = (cnt_l >= min_samples_leaf) & (cnt_r >= min_samples_leaf)
            if feature_mask is not None:
                ok = ok & feature_mask
            gain = torch.where(ok, gain, _NEG)

            if max_features < d:
                r = draws.uniform(seeds, level, draws.FEATURE_SUBSET, (nl, d))
                kth = torch.sort(r, dim=2).values[:, :, max_features - 1]
                fmask = (r <= kth[..., None]).transpose(1, 2)  # (T, d, nl)
                gain = torch.where(fmask[..., None], gain, _NEG)
            if extra:
                # a random threshold per (feature, node) within the
                # occupied bin range: ExtraTrees semantics on bins
                occ = (hist[..., -1] > 0).to(torch.uint8)  # (T, d, nl, B)
                lo = torch.argmax(occ, dim=3)  # first occupied
                hi = B - 1 - torch.argmax(torch.flip(occ, (3,)), dim=3)
                u = draws.uniform(seeds, level, draws.EXTRA_THRESHOLD, (d, nl))
                t_rand = lo + torch.floor(
                    u * torch.clamp(hi - lo, min=1)).to(torch.int64)
                t_rand = torch.clamp(t_rand, 0, B - 2)
                sel = torch.arange(B, device=dev) == t_rand[..., None]
                gain = torch.where(sel, gain, _NEG)

            best_f, best_t, best_gain, do_split = pick_level_splits(
                gain, node_cnt,
                min_samples_split=min_samples_split,
                w_root=w_root,
                min_impurity_decrease=min_impurity_decrease,
            )

            sl = slice(start, start + nl)
            feat[:, sl] = torch.where(do_split, best_f, -1)
            thr[:, sl] = best_t
            is_split[:, sl] = do_split
            gain_rec[:, sl] = torch.where(do_split, best_gain, 0.0)
            if mode == "matmul_sib":
                prev_hist, prev_split = hist, do_split

            # ---- route samples
            relc = torch.clamp(rel, 0, nl - 1)
            f_s = torch.gather(best_f, 1, relc).to(torch.int64)
            t_s = torch.gather(best_t, 1, relc)
            split_s = torch.gather(do_split, 1, relc) & at_level
            bin_s = Xb_flat[row_off + f_s]
            child = 2 * node_id + 1 + (bin_s > t_s).to(torch.int64)
            node_id = torch.where(split_s, child, node_id)

        # ---- leaf statistics over the final assignments
        flat = (node_id + torch.arange(T, device=dev)[:, None] * N).reshape(-1)
        stats = torch.zeros((T * N, C), dtype=Ych.dtype, device=dev)
        stats.index_add_(0, flat, Ych.reshape(T * n, C))
        stats = stats.reshape(T, N, C)
        if newton:
            # empty nodes hold exact 0 (their stats are all zero)
            lam_n = lam[:, :, 0, 0] if lam.ndim else lam
            leaf = (-stats[..., 0]
                    / torch.clamp(stats[..., 1] + lam_n, min=1e-12))[..., None]
        elif classification:
            wsum = torch.sum(stats[..., :K], dim=-1, keepdim=True)
            leaf = stats[..., :K] / torch.clamp(wsum, min=1e-12)
            leaf = torch.where(wsum > 0, leaf, 1.0 / K)
        else:
            leaf = (stats[..., 1] / torch.clamp(stats[..., 0], min=1e-12))[
                ..., None]
        return {
            "feat": feat, "thr": thr, "is_split": is_split, "leaf": leaf,
            "gain": gain_rec,
        }

    return kernel


def tree_predict_kernel(max_depth, return_nodes=False):
    """Returns ``predict(tree, Xb)``: the leaf values ``(n, K_out)`` of
    one tree (arrays ``(N,)``), or ``(T, n, K_out)`` of a stack of trees
    (arrays ``(T, N)``); with ``return_nodes`` the final node ids
    (``(n,)`` or ``(T, n)``), the ``apply()`` of RandomTreesEmbedding."""

    def predict(tree, Xb):
        single = tree["feat"].ndim == 1
        feat, thr, split = tree["feat"], tree["thr"], tree["is_split"]
        if single:
            feat, thr, split = feat[None], thr[None], split[None]
        T = feat.shape[0]
        n, d = Xb.shape
        Xb_flat = Xb.contiguous().reshape(-1)
        row_off = torch.arange(n, device=Xb.device) * d
        node = torch.zeros((T, n), dtype=torch.int64, device=Xb.device)
        for _ in range(max_depth):
            f = torch.gather(feat, 1, node).to(torch.int64)
            t = torch.gather(thr, 1, node)
            s = torch.gather(split, 1, node)
            b = Xb_flat[row_off + torch.clamp(f, 0, d - 1)]
            child = 2 * node + 1 + (b > t).to(torch.int64)
            node = torch.where(s, child, node)
        if return_nodes:
            return node[0] if single else node
        leaf = tree["leaf"]
        if single:
            leaf = leaf[None]
        K = leaf.shape[-1]
        out = torch.gather(leaf, 1, node[..., None].expand(T, n, K))
        return out[0] if single else out

    return predict


def feature_importances_from_tree(feat, gain, n_features):
    """Impurity-decrease importances (sklearn semantics), host-side."""
    imp = np.zeros(n_features, dtype=np.float64)
    mask = np.asarray(feat) >= 0
    np.add.at(imp, np.asarray(feat)[mask], np.asarray(gain)[mask])
    total = imp.sum()
    return imp / total if total > 0 else imp


# ---------------------------------------------------------------------------
# channel construction; ``sw`` may carry a leading tree axis (T, n)
# ---------------------------------------------------------------------------

def classification_channels(y_idx, sw, n_classes):
    oh = F.one_hot(y_idx.long(), n_classes).to(torch.float32)
    cnt = (sw > 0).to(torch.float32)
    return torch.cat([oh * sw[..., None], cnt[..., None]], dim=-1)


def regression_channels(y, sw):
    cnt = (sw > 0).to(torch.float32)
    return torch.stack(torch.broadcast_tensors(
        sw, sw * y, sw * y * y, cnt), dim=-1)


def newton_channels(g, h, sw):
    """Gradient/hessian channels of a boosting loss, weighted by the
    sample weights, plus the unweighted-occupancy channel; consumed with
    ``build_tree_kernel(newton=True, channels=3)``."""
    cnt = (sw > 0).to(torch.float32)
    return torch.stack(torch.broadcast_tensors(sw * g, sw * h, cnt), dim=-1)


def resolve_max_features(max_features, d):
    if max_features in (None, "none", "all"):
        return d
    if max_features == "sqrt":
        return max(1, int(np.sqrt(d)))
    if max_features == "log2":
        return max(1, int(np.log2(d)))
    if isinstance(max_features, float):
        return max(1, int(max_features * d))
    return min(d, int(max_features))


def walk_block(walk, trees, edges, X, mode):
    """One row block of :func:`walk_trees` on the trees' device: bin
    ``X (n, d)`` and walk the stack ``trees`` (``(T, N)`` tensors) with
    ``walk`` (a :func:`tree_predict_kernel`); the final node ids ``(n,
    T)`` for ``mode="apply"``, else the mean leaf value ``(n, K)``."""
    res = walk(trees, apply_bins(X, edges))
    return res.T if mode == "apply" else torch.mean(res, dim=0)


def walk_trees(trees, edges, X, max_depth, device, mode, n_threads=None):
    """Walk a stack of fitted trees (numpy ``(T, N)`` arrays) over ``X``
    on ``device``. ``mode="apply"`` returns the final node ids ``(n,
    T)``; ``"predict"`` the mean leaf value ``(n, K)``. On the CPU the
    host C walker (``native/hist_tree.c``, ``n_threads`` threads) walks
    when it built, as the JAX package's CPU walk does; else, and on the
    card, the torch walker walks in row blocks."""
    X = as_dense_f32(X)
    if X.shape[1] != len(edges):
        raise ValueError(
            f"X has {X.shape[1]} features; the model was fitted on "
            f"{len(edges)}"
        )
    if torch.device(device).type == "cpu":
        from ..native import forest_walk_native, hist_tree_available

        if hist_tree_available():
            out = forest_walk_native(apply_bins_np(X, edges), trees,
                                     max_depth, mode=mode,
                                     n_threads=n_threads)
            if out is not None:
                return out.astype(np.int64) if mode == "apply" else out
    walk = tree_predict_kernel(max_depth, return_nodes=(mode == "apply"))
    keys = ("feat", "thr", "is_split") + (("leaf",) if mode != "apply"
                                         else ())
    dev_trees = {k: torch.tensor(np.asarray(trees[k])).to(device)
                 for k in keys}
    T = dev_trees["feat"].shape[0]
    edges_t = torch.as_tensor(np.asarray(edges, np.float32)).to(device)
    step = max(1, _WALK_ELEMS // max(T, 1))
    outs = []
    with torch.no_grad():
        for lo in range(0, X.shape[0], step):
            res = walk_block(walk, dev_trees, edges_t,
                             torch.as_tensor(X[lo:lo + step]).to(device),
                             mode)
            outs.append(res.cpu().numpy())
    if not outs:
        K = 0 if mode == "apply" else np.asarray(trees["leaf"]).shape[-1]
        return np.zeros((0, T if mode == "apply" else K),
                        np.int64 if mode == "apply" else np.float32)
    return np.concatenate(outs)


# ---------------------------------------------------------------------------
# estimator classes
# ---------------------------------------------------------------------------

class _BaseTree(BaseEstimator):
    """Single-tree estimator over the histogram kernel, on the card
    unless ``device="cpu"``.

    ``splitter='random'`` gives ExtraTree behaviour (random thresholds).
    On the CPU, ``hist_mode="auto"`` fits with the host C engine
    (``models/native_forest.py``) and predicts with its walker, as the
    JAX package does there; on the card it runs K4.

    The batched-fit contract of :mod:`skdist_tpu_torch.distribute.search`
    and the multiclass meta-estimators marks every parameter static (a
    candidate that changes one is a bucket of its own) and nothing rides
    the task axis: a round of T lanes (folds, classes, class pairs) is
    one :func:`build_tree_kernel` call over X binned once under the
    quantile edges of the whole X (as the JAX kernel's ``aux["edges"]``
    does), each lane with its own weights and, for a classifier, its own
    labels (``_lane_labels``), and every lane with the seed
    ``random_state or 0``.
    """

    _hyper_names = ()
    _static_names = (
        "max_depth", "n_bins", "max_features", "min_samples_split",
        "min_samples_leaf", "min_impurity_decrease", "splitter",
        "random_state", "hist_mode",
    )
    #: the params :meth:`_prep_fit_data` reads: a search preps the whole
    #: X's edges once for every bucket of one ``n_bins``
    _prep_params = ("n_bins",)

    def __init__(self, max_depth=8, n_bins=32, max_features=None,
                 min_samples_split=2, min_samples_leaf=1,
                 min_impurity_decrease=0.0, splitter="best", random_state=0,
                 hist_mode="auto", device=None):
        self.max_depth = max_depth
        self.n_bins = n_bins
        self.max_features = max_features
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.min_impurity_decrease = min_impurity_decrease
        self.splitter = splitter
        self.random_state = random_state
        self.hist_mode = hist_mode
        self.device = device

    @property
    def _classification(self):
        return isinstance(self, ClassifierMixin)

    # ---- the batched-fit contract --------------------------------------
    def _check_supported(self):
        """Raise for invalid settings (also those set through
        ``set_params``)."""

    def _prep_fit_data(self, X, y, sample_weight=None):
        """``(host data, meta)`` of a fit: ``X`` dense float32, ``y``
        (encoded class indices, or float32 targets), ``sw``; ``meta``
        holds the quantile ``edges`` of the whole ``X``, which every lane
        of a batched round bins with."""
        X = as_dense_f32(X)
        sw = prepare_sample_weight(sample_weight, X.shape[0])
        meta = {"n_features": X.shape[1], "x_format": "dense",
                "edges": quantile_bin_edges(X, self.n_bins)}
        if self._classification:
            y_idx, classes = encode_labels(y)
            meta.update(classes=classes, n_classes=len(classes))
            return {"X": X, "y": y_idx, "sw": sw}, meta
        return {"X": X, "y": np.asarray(y, np.float32), "sw": sw}, meta

    def _static_config(self, meta):
        """Every parameter that shapes the fit, plus the class count and
        the width (``_n_classes``, ``_n_features``)."""
        cfg = {k: getattr(self, k) for k in self._static_names}
        cfg["_n_classes"] = meta.get("n_classes", 0)
        cfg["_n_features"] = meta["n_features"]
        return cfg

    @classmethod
    def _fit_operand(cls, X, meta, static):
        """The fit kernels' shared operand: device ``X`` binned under the
        whole X's edges, once for every round."""
        return apply_bins(X, meta["edges"])

    @classmethod
    def _build_fit_kernel(cls, meta, static):
        """``kernel(Xb, y, sw, hyper) -> trees``: one round of T trees
        over the shared bins ``Xb (n, d)`` (:meth:`_fit_operand`), with
        weights ``sw (T, n)`` and labels ``y``, ``(n,)`` or one vector a
        lane ``(T, n)``; ``hyper`` is empty. Returns ``{feat, thr,
        is_split, gain: (T, N), leaf: (T, N, K)}``. The histogram engine
        resolves on the device of ``Xb`` with no host engine (a batched
        kernel): K4 on the card, the scatter on the CPU."""
        st = dict(static)
        d, K = st["_n_features"], st["_n_classes"]
        classification = K > 0
        grow = build_tree_kernel(
            n_features=d, n_bins=st["n_bins"],
            channels=(K + 1) if classification else 4,
            max_depth=st["max_depth"],
            max_features=resolve_max_features(st["max_features"], d),
            min_samples_split=st["min_samples_split"],
            min_samples_leaf=st["min_samples_leaf"],
            min_impurity_decrease=st["min_impurity_decrease"],
            extra=(st["splitter"] == "random"),
            classification=classification, hist_mode=st["hist_mode"],
        )
        seed = st["random_state"] or 0

        def kernel(Xb, y, sw, hyper):
            fmask = None
            if isinstance(Xb, MaskedColumns):
                Xb, fmask = Xb.base, Xb.mask
            if classification:
                Ych = classification_channels(y, sw, K)
            else:
                Ych = regression_channels(y, sw)
            seeds = torch.full((sw.shape[0],), seed, dtype=torch.int64,
                               device=Xb.device)
            return grow(Xb, Ych, seeds, feature_mask=fmask)

        return kernel

    @classmethod
    def _mask_operand(cls, Xb, fmask):
        """The fit operand of lanes that each see only the features of
        their row of ``fmask (T, d)`` (the feature eliminator's task
        axis): the shared bins beside the masks, which the kernel hands
        to :func:`build_tree_kernel` as ``feature_mask``."""
        return MaskedColumns(Xb, fmask)

    @classmethod
    def _mask_decision_params(cls, params, fmask):
        """A masked lane's tree never splits a masked feature, so its
        walk never reads one: the trees pass unchanged."""
        return params

    @classmethod
    def _mask_task_bytes(cls, meta, static):
        """The masked-gain temporary of a lane's deepest level, and its
        mask."""
        st = dict(static)
        nl = 2 ** max(st["max_depth"] - 1, 0)
        return st["_n_features"] * (nl * st["n_bins"] * 4 + 4)

    @classmethod
    def _decision_params(cls, params):
        """What the decision kernel reads of a batched fit's outputs: the
        stacked trees themselves."""
        return params

    @classmethod
    def _batched_task_bytes(cls, meta, static, n):
        st = dict(static)
        K = st["_n_classes"]
        C = (K + 1) if K else 4
        # the lane's tree, its walk over X for the scores (int64 nodes,
        # the gathers and the leaf values)
        return tree_task_bytes(n, st["_n_features"], st["n_bins"], C,
                               st["max_depth"], st["hist_mode"]) \
            + n * (8 * 4 + 4 * K)

    @classmethod
    def _batched_round_bytes(cls, meta, static, n):
        """The shared int32 bins, K4's padded uint8 copy of them and the
        scores' binning of X, held once a round."""
        d = dict(static)["_n_features"]
        return n * (4 * d + 16 * -(-d // 16) + 4 * d)

    def _set_fitted(self, params, meta):
        """Fitted state from one lane of a batched fit: the tree's arrays
        and the edges it was grown under."""
        self._params = {k: np.asarray(params[k]) for k in _TREE_KEYS}
        self._params["edges"] = np.asarray(meta["edges"], np.float32)
        self._meta = {k: v for k, v in meta.items() if k != "edges"}
        self.n_features_in_ = meta["n_features"]
        if "classes" in meta:
            self.classes_ = meta["classes"]

    # ---- fit and predict -----------------------------------------------
    def fit(self, X, y, sample_weight=None):
        device = resolve_device(self.device)
        mode = resolve_hist_config(self.hist_mode, device, allow_native=True,
                                   n_bins=self.n_bins)
        data, meta = self._prep_fit_data(X, y, sample_weight)
        d = meta["n_features"]
        if mode == "native":
            from .native_forest import grow_single_tree_native

            params = grow_single_tree_native(
                apply_bins_np(data["X"], meta["edges"]), data["y"],
                data["sw"], self.random_state or 0,
                n_bins=self.n_bins, max_depth=self.max_depth,
                max_features=resolve_max_features(self.max_features, d),
                min_samples_split=self.min_samples_split,
                min_samples_leaf=self.min_samples_leaf,
                min_impurity_decrease=self.min_impurity_decrease,
                extra=(self.splitter == "random"),
                classification=self._classification,
                n_classes=meta.get("n_classes", 0) or 1,
            )
            self._set_fitted(params, meta)
            return self
        static = self._static_config(meta)
        static["hist_mode"] = mode
        kernel = self._build_fit_kernel(meta, tuple(static.items()))
        with torch.no_grad(), exact_matmuls():
            Xb = self._fit_operand(
                torch.as_tensor(data["X"]).to(device), meta, None)
            tree = kernel(Xb, torch.as_tensor(data["y"]).to(device),
                          torch.as_tensor(data["sw"]).to(device)[None], {})
        self._set_fitted({k: v[0].cpu().numpy() for k, v in tree.items()},
                         meta)
        return self

    def _check_fitted(self):
        if not hasattr(self, "_params"):
            raise AttributeError(
                f"This {type(self).__name__} instance is not fitted yet."
            )

    def _kernel_params(self):
        """The fitted arrays the decision kernel reads: the tree's nodes
        and its bin edges."""
        return {k: self._params[k]
                for k in ("feat", "thr", "is_split", "leaf", "edges")}

    @classmethod
    def _build_decision_kernel(cls, meta, static):
        """``decision(params, X)``: the leaf values of fitted trees over a
        dense device block ``X``, binned with ``params["edges"]`` (else
        ``meta["edges"]``: a batched fit's lanes). One tree (arrays
        ``(N,)``) gives ``(n, K)``, a stack of lanes (``(T, N)``) gives
        ``(T, n, K)``; a one-output regressor's last axis is dropped.
        There is no proba kernel, as in the JAX package: a classifier's
        leaf values are its probabilities, and ``predict_proba`` of a
        plan-driven caller takes the host path."""
        walk = tree_predict_kernel(dict(static)["max_depth"])

        def decision(params, X):
            edges = params["edges"] if "edges" in params else meta["edges"]
            trees = {k: params[k] for k in ("feat", "thr", "is_split", "leaf")}
            out = walk(trees, apply_bins(X, edges))
            return out[..., 0] if out.shape[-1] == 1 else out

        return decision

    def _walk(self, X, mode):
        self._check_fitted()
        trees = {k: np.asarray(v)[None] for k, v in self._params.items()
                 if k in ("feat", "thr", "is_split", "leaf")}
        return walk_trees(trees, self._params["edges"], X, self.max_depth,
                          resolve_device(self.device), mode)

    def _leaf_values(self, X):
        out = self._walk(X, "predict")
        return out[:, 0] if out.shape[1] == 1 else out

    @property
    def feature_importances_(self):
        self._check_fitted()
        return feature_importances_from_tree(
            self._params["feat"], self._params["gain"], self.n_features_in_
        )

    def apply(self, X):
        """Leaf (node) index per sample: sklearn's ``tree.apply``."""
        return self._walk(X, "apply")[:, 0]


class DecisionTreeClassifier(_BaseTree, ClassifierMixin):
    #: one-vs-rest and one-vs-one batch its binary sub-problems, one label
    #: vector a lane
    _lane_labels = True

    def predict_proba(self, X):
        return self._leaf_values(X)

    def predict(self, X):
        return self.classes_[np.argmax(self.predict_proba(X), axis=1)]


class DecisionTreeRegressor(_BaseTree, RegressorMixin):
    def predict(self, X):
        return self._leaf_values(X)


class ExtraTreeClassifier(DecisionTreeClassifier):
    def __init__(self, max_depth=8, n_bins=32, max_features=None,
                 min_samples_split=2, min_samples_leaf=1,
                 min_impurity_decrease=0.0, splitter="random", random_state=0,
                 device=None):
        super().__init__(
            max_depth=max_depth, n_bins=n_bins, max_features=max_features,
            min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease, splitter=splitter,
            random_state=random_state, device=device,
        )


class ExtraTreeRegressor(DecisionTreeRegressor):
    def __init__(self, max_depth=8, n_bins=32, max_features=None,
                 min_samples_split=2, min_samples_leaf=1,
                 min_impurity_decrease=0.0, splitter="random", random_state=0,
                 device=None):
        super().__init__(
            max_depth=max_depth, n_bins=n_bins, max_features=max_features,
            min_samples_split=min_samples_split,
            min_samples_leaf=min_samples_leaf,
            min_impurity_decrease=min_impurity_decrease, splitter=splitter,
            random_state=random_state, device=device,
        )
