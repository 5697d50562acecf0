"""
The host (CPU) tree engine of the port, ``hist_mode="native"``.

Counterpart of ``skdist_tpu/models/native_forest.py``, copied with its
algorithm unchanged: the breadth-first histogram tree of
``models/tree.py`` (the same gain formulas, validity rules, routing and
leaf statistics), with each level's histogram and split search run by
the multithreaded C kernels of ``native/hist_tree.c`` over a chunk of
trees at once, and only the glue (routing, records, the per-level draws)
in numpy. Features that no node of a tree drew this level
(``max_features``) are skipped in both kernels.

It is the CPU's engine, never the card's: ``resolve_hist_config`` picks
it under ``"auto"`` only for a single tree on the CPU and for a forest on
the CPU that fits on a ``LocalBackend``, as the JAX package's CPU
calibration does, and an explicit ``"native"`` for the card, or inside
a batched kernel, raises.

Draws. The per-level ``max_features`` masks and ExtraTrees thresholds
keep the JAX copy's numpy ``RandomState`` streams (:func:`_level_rng`),
so a native forest equals the JAX package's native forest tree for tree
whenever its bootstrap does (``bootstrap=False``, or the same weights).
The bootstrap itself is not drawn here: the caller passes each tree's
weights, and the port's forests draw them with ``utils/draws.py
bootstrap_counts``, the function the torch engine and OOB scoring use,
so OOB masks regenerate from the stored seeds whatever the engine. A
native forest and a torch-engine forest therefore agree tree for tree
with ``bootstrap=False, max_features=None`` and best splits (the C split
search sums in float64 where torch sums in float32, which can only move
an exact tie), and statistically otherwise.
"""

import numpy as np

_NEG = -1e30


def native_forest_supported(n_bins):
    """The C kernel keys bins as uint8, and it must have built."""
    from ..native import hist_tree_available

    return n_bins <= 256 and hist_tree_available()


def native_supported_or_raise(n_bins, explicit):
    """True when the C engine can serve this fit, False when ``"auto"``
    should grow the trees with the torch engine instead, and an error
    for an explicit ``hist_mode='native'`` that cannot be honoured here
    (shared by the tree and forest dispatch, so the diagnosis is one)."""
    if native_forest_supported(n_bins):
        return True
    if explicit:
        from ..native import build_error

        why = (f"n_bins ({n_bins}) > 256" if n_bins > 256
               else f"the C kernel did not build ({build_error()})")
        raise ValueError(
            f"hist_mode='native' requested but the host C tree engine "
            f"cannot serve this fit: {why}"
        )
    return False


def grow_single_tree_native(Xb, y, sw, seed, **config):
    """One tree via the host engine (a T=1 forest): the single-tree
    estimators' dispatch (``tree.py _BaseTree.fit``). Returns the
    unstacked param dict (without the forest-only ``seed`` entry)."""
    trees = grow_forest_native(
        Xb, y, np.asarray(sw, np.float32)[None, :],
        np.asarray([seed], np.int32), **config,
    )
    return {k: np.asarray(v[0]) for k, v in trees.items() if k != "seed"}


def _level_rng(seed, level):
    # deterministic per (tree, level): the JAX copy's map, kept so the
    # two packages' native forests draw the same masks and thresholds
    return np.random.RandomState(
        (int(seed) * 2654435761 + level * 40503 + 7) % (2**31 - 1)
    )


def _best_splits_numpy(hist, fmask, urand, K, classification, msl):
    """Numpy scoring form, math-matched to the torch kernel's
    ``histogram_node_scores`` (f32, same masking/tie-break order). Returns
    ``(gain, f, t, cnt_l, cnt_r)`` each (Tb, nl), like the C kernel."""
    Tb, d, nl, B, C = hist.shape
    cum = np.cumsum(hist, axis=3)
    tot = cum[:, :, :, -1, :]  # (Tb, d, nl, C)
    cnt_l = cum[..., -1]
    cnt_r = tot[..., None, -1] - cnt_l
    if classification:
        Lk = cum[..., :K]
        wl = Lk.sum(-1)
        sl = np.einsum("...c,...c->...", Lk, Lk) / np.maximum(wl, 1e-12)
        totk = tot[..., :K]
        Rk = totk[:, :, :, None, :] - Lk
        wr = Rk.sum(-1)
        sr = np.einsum("...c,...c->...", Rk, Rk) / np.maximum(wr, 1e-12)
        wt = totk.sum(-1)
        st = np.einsum("...c,...c->...", totk, totk) / np.maximum(wt, 1e-12)
        gain = sl + sr - st[..., None]
    else:
        w_l, wy_l, wy2_l = cum[..., 0], cum[..., 1], cum[..., 2]
        w_t = tot[..., 0, None]
        wy_t = tot[..., 1, None]
        wy2_t = tot[..., 2, None]
        sse_l = wy2_l - wy_l**2 / np.maximum(w_l, 1e-12)
        w_r = w_t - w_l
        wy_r = wy_t - wy_l
        sse_r = (wy2_t - wy2_l) - wy_r**2 / np.maximum(w_r, 1e-12)
        sse_t = wy2_t - wy_t**2 / np.maximum(w_t, 1e-12)
        gain = sse_t - (sse_l + sse_r)

    ok = (cnt_l >= msl) & (cnt_r >= msl)
    gain = np.where(ok, gain, _NEG)
    if fmask is not None:
        gain = np.where(fmask[..., None].astype(bool), gain, _NEG)
    if urand is not None:
        occ = hist[..., -1] > 0  # (Tb, d, nl, B)
        lo = np.argmax(occ, axis=3)
        hi = B - 1 - np.argmax(occ[:, :, :, ::-1], axis=3)
        t_rand = lo + np.floor(urand * np.maximum(hi - lo, 1)).astype(
            np.int32
        )
        t_rand = np.clip(t_rand, 0, B - 2)
        sel = np.arange(B)[None, None, None, :] == t_rand[..., None]
        gain = np.where(sel, gain, _NEG)

    gain_fb = gain.transpose(0, 2, 1, 3).reshape(Tb, nl, d * B)
    best_flat = np.argmax(gain_fb, axis=2)[..., None]
    best_gain = np.take_along_axis(gain_fb, best_flat, axis=2)[..., 0]
    bf = (best_flat[..., 0] // B).astype(np.int32)
    bt = (best_flat[..., 0] % B).astype(np.int32)

    def pick(a):
        afb = a.transpose(0, 2, 1, 3).reshape(Tb, nl, d * B)
        return np.take_along_axis(afb, best_flat, axis=2)[..., 0]

    return best_gain, bf, bt, pick(cnt_l), pick(cnt_r)


def _leaf_stats(node_id, W, cls, yv, n_nodes, C, n_threads):
    """Final (Tb, N, C) channel sums via the histogram kernel, seen as
    a single-feature, single-bin level over all N nodes."""
    from ..native import hist_level

    Tb, n = node_id.shape
    dummy = np.zeros((1, n), np.uint8)
    stats = np.empty((Tb, 1, n_nodes, 1, C), np.float32)
    hist_level(stats, dummy, node_id, W, cls=cls, yv=yv,
               n_threads=n_threads)
    return stats.reshape(Tb, n_nodes, C)


def grow_forest_native(Xb, y, W, seeds, *, n_bins, max_depth, max_features,
                       min_samples_split, min_samples_leaf,
                       min_impurity_decrease, extra, classification,
                       n_classes, n_threads=None, budget_bytes=512 << 20):
    """Grow ``len(seeds)`` trees; returns the same stacked arrays the
    torch engine yields: ``{feat (T,N) i32, thr (T,N) i32, is_split
    (T,N) bool, leaf (T,N,K), gain (T,N) f32, seed (T,) i32}``.

    ``Xb`` (n, d) binned features (any int dtype, values < n_bins),
    ``y`` int32 class indices or f32 targets, ``W`` the (T, n) f32
    combined weights (sample_weight x bootstrap counts) — either the
    array itself or a ``(t0, t1) -> (t1-t0, n)`` callable built per
    tree-chunk, so a 500-tree x 1M-row fit never co-materialises all
    rows' weights — ``seeds`` (T,) int, used ONLY for
    feature-subsampling / random-threshold draws (the bootstrap is
    already inside ``W``).
    """
    from ..native import best_splits_native, hist_level

    n, d = Xb.shape
    T = len(seeds)
    D, B = int(max_depth), int(n_bins)
    K = int(n_classes) if classification else 1
    C = K + 1 if classification else 4
    N = 2 ** (D + 1) - 1
    msl, mss = int(min_samples_leaf), int(min_samples_split)
    mid = float(min_impurity_decrease)
    cls = np.ascontiguousarray(y, np.int32) if classification else None
    if cls is not None and cls.size:
        # the C kernel indexes histograms by class with no bounds
        # check (native/hist_tree.c hist_level) — raw labels or an
        # understated n_classes would corrupt heap memory, so the
        # range is validated host-side before the buffer is handed off
        lo, hi = int(cls.min()), int(cls.max())
        if lo < 0 or hi >= K:
            raise ValueError(
                f"grow_forest_native expects encoded class indices in "
                f"[0, {K - 1}] (n_classes={K}); got range [{lo}, {hi}]"
            )
    yv = None if classification else np.ascontiguousarray(y, np.float32)
    if n:
        # same defense for bin values: the C kernel's histogram index
        # (node*B + bin)*C has no bounds check either, and the uint8
        # casts below would silently truncate wider values
        bmin, bmax = int(np.min(Xb)), int(np.max(Xb))
        if bmin < 0 or bmax >= B:
            raise ValueError(
                f"grow_forest_native expects binned features in "
                f"[0, {B - 1}] (n_bins={B}); got range [{bmin}, {bmax}]"
            )
    XbT = np.ascontiguousarray(np.asarray(Xb).T, np.uint8)
    Xb = np.ascontiguousarray(Xb, np.uint8)
    if not callable(W):
        W = np.ascontiguousarray(W, np.float32)
    if n_threads is None:
        from ..native import default_threads

        n_threads = default_threads()

    # chunk trees so one level's histogram stays inside the budget
    # (the C path holds just the histogram; ~4x headroom covers the
    # numpy fallback's cumsum and gain temporaries)
    per_tree = d * (2 ** (D - 1)) * B * C * 4 * 4
    Tb_max = max(1, int(budget_bytes // max(per_tree, 1)))

    feat = np.full((T, N), -1, np.int32)
    thr = np.zeros((T, N), np.int32)
    is_split = np.zeros((T, N), bool)
    gain_rec = np.zeros((T, N), np.float32)
    leaf = np.zeros((T, N, K), np.float32)
    need_fmask = max_features < d

    rows = np.arange(n)
    for t0 in range(0, T, Tb_max):
        t1 = min(t0 + Tb_max, T)
        Tb = t1 - t0
        Wc = W(t0, t1) if callable(W) else W[t0:t1]
        Wc = np.ascontiguousarray(Wc, np.float32)
        w_root = Wc.sum(axis=1)  # (Tb,)
        node_id = np.zeros((Tb, n), np.int32)

        for level in range(D):
            start = 2**level - 1
            nl = 2**level
            rel = node_id - start
            at_level = (rel >= 0) & (rel < nl)
            node_rel = np.where(at_level, rel, -1).astype(np.int32)

            # per-(tree, level) draws: feature-subsample mask first,
            # random thresholds second (the JAX copy's order), one
            # stream per tree
            fmask = urand = None
            if need_fmask or extra:
                if need_fmask:
                    fmask = np.empty((Tb, d, nl), np.uint8)
                if extra:
                    urand = np.empty((Tb, d, nl), np.float32)
                for i in range(Tb):
                    rng = _level_rng(seeds[t0 + i], level)
                    if need_fmask:
                        r = rng.uniform(size=(nl, d))
                        kth = np.sort(r, axis=1)[:, max_features - 1]
                        fmask[i] = (r <= kth[:, None]).T
                    if extra:
                        urand[i] = rng.uniform(size=(d, nl))
            act = (
                None if fmask is None
                else np.ascontiguousarray(fmask.any(axis=2).astype(np.uint8))
            )

            hist = np.empty((Tb, d, nl, B, C), np.float32)
            hist_level(hist, XbT, node_rel, Wc, cls=cls, yv=yv, act=act,
                       n_threads=n_threads)

            # unweighted node occupancy for the min_samples_split rule
            # (kept out of the histogram so ``act``-skipped feature
            # slabs are never read)
            node_cnt = np.zeros((Tb, nl), np.float32)
            for i in range(Tb):
                m = at_level[i] & (Wc[i] > 0)
                node_cnt[i] = np.bincount(
                    node_rel[i][m], minlength=nl
                ).astype(np.float32)

            res = best_splits_native(
                hist, fmask, urand, K, classification, msl, n_threads
            )
            if res is None:
                res = _best_splits_numpy(
                    hist, fmask, urand, K, classification, msl
                )
            best_gain, best_f, best_t = res[0], res[1], res[2]

            decrease = best_gain / np.maximum(w_root[:, None], 1e-12)
            do_split = (
                (best_gain > 1e-12)
                & (decrease >= mid)
                & (node_cnt >= mss)
            )

            sl_idx = slice(start, start + nl)
            feat[t0:t1, sl_idx] = np.where(do_split, best_f, -1)
            thr[t0:t1, sl_idx] = best_t
            is_split[t0:t1, sl_idx] = do_split
            gain_rec[t0:t1, sl_idx] = np.where(do_split, best_gain, 0.0)

            relc = np.clip(rel, 0, nl - 1)
            f_s = np.take_along_axis(best_f, relc, axis=1)
            t_s = np.take_along_axis(best_t, relc, axis=1)
            split_s = np.take_along_axis(do_split, relc, axis=1) & at_level
            bin_s = Xb[rows[None, :], f_s]
            child = 2 * node_id + 1 + (bin_s > t_s)
            node_id = np.where(split_s, child, node_id).astype(np.int32)

        stats = _leaf_stats(node_id, Wc, cls, yv, N, C, n_threads)
        if classification:
            wsum = stats[:, :, :K].sum(axis=2, keepdims=True)
            lv = stats[:, :, :K] / np.maximum(wsum, 1e-12)
            leaf[t0:t1] = np.where(wsum > 0, lv, 1.0 / K)
        else:
            leaf[t0:t1] = (
                stats[:, :, 1] / np.maximum(stats[:, :, 0], 1e-12)
            )[..., None]

    return {
        "feat": feat, "thr": thr, "is_split": is_split,
        "leaf": leaf, "gain": gain_rec,
        "seed": np.asarray(seeds, np.int32),
    }
