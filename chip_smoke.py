#!/usr/bin/env python3
"""Drive the PyTorch / H100 port (``skdist_tpu_torch``) on the card.

    python3 chip_smoke.py [--candidates N]

Phases, in order; any failure ends the run with a nonzero exit and no
result line:

1. Device and build: the card's name and power limit (``nvidia-smi``),
   then the port's CUDA kernels built with ``nvcc`` from the sources in
   this checkout.
2. Kernels against their plain PyTorch versions on the card: K1
   ``packed_matvec`` and K2 ``packed_rmatvec`` on ragged small shapes
   and at the main path's shape, each held to a tolerance derived from
   its summation order; K2 bitwise repeatable; the ``PackedMatvec``
   gradient against plain autograd; times of the kernel, its plain
   version and ``torch.sparse.mm`` (a yardstick the port never calls).
3. The sparse main path at full size: ``DistGridSearchCV(
   LogisticRegression(max_iter=100), {"C": logspace(-3, 2, 96)}, cv=5,
   scoring="f1_weighted")`` on a 20news-shaped hashed-text CSR (n=11314,
   d=2**18, 20 classes), 480 fits on the card. The kernels' launch
   counters are zeroed just before it and read just after; both must be
   > 0. The pickled ``best_estimator_`` must predict as the live one,
   and one refit on the card is held to the same refit on the CPU (to
   10x the gap one ulp of input noise opens on the card).
4. The dense headline on the card: the same grid on the dense
   11314 x 4096 problem (``torch.matmul``, no hand kernel).
5. K4 ``level_histogram`` against its plain version on the card: ragged
   small shapes (n not a multiple of any chunk, nl in {1, 3, 128}, B in
   {4, 32, 256}, C in {3, 4}, sentinel keys) and every level of the
   forest (T=256, n=200000, d=28, nl=1..128, B=32, C=3). Integer channels
   must equal the plain version bitwise and repeat bitwise; fractional
   channels are held to a summation-order tolerance. Times of the kernel
   at every level of the forest, of its plain version and of the JAX
   package's "matmul" engine (one-hot times node-weighted channels
   through ``torch.matmul``, per tree), with the bound.
6. The forest path at full size: ``DistRandomForestClassifier(
   n_estimators=256, max_depth=8, n_bins=32, max_features="sqrt")`` on
   a HIGGS-shaped 200000 x 28 binary problem, fitted twice on the card
   (cold, then warm). ``level_histogram.launches`` is zeroed before each
   fit and must equal levels x rounds after it; the two fits must grow
   bitwise identical forests (integer channels), and a third fit through
   the plain histogram (``hist_mode="scatter"``) must grow the same
   forest bitwise (splits, thresholds, gains, leaves): the labels are
   99.5% one class, so train accuracy alone shows nothing. The pickled
   forest must predict as the live one, ``oob_score_`` must be finite,
   and one more fit under ``torch.profiler`` splits the device time
   between K4 and the plain-torch glue.
7. Card against CPU: a small forest (5000 x 28, 16 trees, bootstrap and
   sqrt) with the same seeds on the card and with ``device="cpu"``; at
   most 1% of split nodes may differ, and ``predict_proba`` over the
   trees that agree may differ by at most 1e-5.
8. ``DistExtraTreesRegressor`` on the card: fractional channels through
   K4 on the real path.
9. One JSON line ``{"kernels": [...]}`` (K1, K2, K4), then, last, the
   result line ``{"ok": true, "device": {...}}``.

``--candidates N`` cuts the C grid to its first N points (never the
data width); the cut is printed.

Imports torch, numpy, scipy and ``skdist_tpu_torch`` only; exits
nonzero when there is no CUDA device or no ``skdist_tpu_torch`` beside
this script.
"""

import argparse
import json
import math
import os
import pickle
import subprocess
import sys
import time

import numpy as np

#: the card's published peaks (H100 SXM data sheet): HBM bandwidth and
#: fp32 outside the tensor cores, what the packed contractions run on
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12

U32 = 2.0 ** -24  # unit roundoff of float32


def make_20news_shaped(seed=0, n=11314, d=4096, k=20):
    """Synthetic hashed-text-like dense problem (a copy of
    ``bench.py``'s): sparse positive features, power-law token
    frequencies, linearly separable-ish classes."""
    rng = np.random.RandomState(seed)
    density = 0.01
    col_pop = rng.zipf(1.5, size=d).astype(np.float64)
    col_pop /= col_pop.sum()
    cum = np.cumsum(col_pop)
    nnz_per_row = max(8, int(density * d))
    cols = np.searchsorted(cum, rng.rand(n, nnz_per_row))
    X = np.zeros((n, d), dtype=np.float32)
    rows = np.repeat(np.arange(n), nnz_per_row)
    X[rows, cols.ravel()] = rng.rand(n * nnz_per_row).astype(np.float32) + 0.5
    W = rng.normal(size=(d, k)).astype(np.float32)
    logits = X @ W
    y = np.argmax(logits + 2.0 * rng.normal(size=(n, k)), axis=1)
    return X, y


def make_20news_sparse(seed=0, n=1500, d=4096, nnz_row=40, k=20):
    """Synthetic hashed-text problem kept sparse (a copy of
    ``bench.py``'s): Zipf column popularity, ~``nnz_row`` nonzeros per
    row, k classes. Returns ``(X_csr, y)``."""
    import scipy.sparse as sp

    rng = np.random.RandomState(seed)
    col_pop = 1.0 / (np.arange(1, d + 1, dtype=np.float64))
    rng.shuffle(col_pop)
    cum = np.cumsum(col_pop / col_pop.sum())
    cols = np.searchsorted(cum, rng.rand(n, nnz_row))
    rows = np.repeat(np.arange(n), nnz_row)
    data = (rng.rand(n * nnz_row) + 0.5).astype(np.float32)
    X = sp.csr_matrix(
        (data, (rows, cols.ravel())), shape=(n, d), dtype=np.float32
    )
    W = rng.normal(size=(d, k)).astype(np.float32)
    logits = np.asarray(X @ W)
    logits = (logits - logits.mean(axis=0)) / (logits.std(axis=0) + 1e-9)
    y = np.argmax(logits + 1.0 * rng.normal(size=(n, k)), axis=1)
    return X, y


def make_tabular(n, d, k, seed=0, noise=0.7):
    """Covtype/HIGGS-style synthetic tabular problem (a copy of
    ``bench.py``'s)."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32)
    W = rng.normal(size=(d, k)).astype(np.float32)
    y = np.argmax(X @ W + noise * rng.normal(size=(n, k)), axis=1)
    return X, y


def say(*parts):
    print(*parts, flush=True)


def cuda_ms(torch, fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` launches, after a
    warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved, flops):
    """(least milliseconds, what bounds it) on the published peaks."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# phase 2: the kernels against their plain versions
# ---------------------------------------------------------------------------

def random_packed(torch, rng, n, d, m, pad_frac=0.3):
    idx = rng.randint(0, d, size=(n, m)).astype(np.int32)
    val = rng.randn(n, m).astype(np.float32)
    pad = rng.rand(n, m) < pad_frac
    idx[pad] = 0
    val[pad] = 0.0
    return (torch.as_tensor(idx).cuda(), torch.as_tensor(val).cuda())


def check_pair(torch, ps, idx, val, p, T, k, seed, label):
    """Hold K1, K2 and the PackedMatvec gradient to their plain versions
    at one shape; returns the largest error seen. Tolerance: each output
    is a sum of c products (c = m for K1, the column's entry count for
    K2), and two f32 sums of the same c terms in different orders differ
    by at most 2 * c * u * sum|terms|."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, m = idx.shape
    W = torch.randn((T, p, k), generator=g, device="cuda")
    r = torch.randn((T, n, k), generator=g, device="cuda")
    cols = ps.build_columns(idx, val, p)
    counts = (cols.col_ptr[1:] - cols.col_ptr[:-1]).to(torch.float32)

    out = ps.packed_matvec(idx, val, W)
    ref = ps.packed_matvec_ref(idx, val, W)
    tol1 = 2 * m * U32 * ps.packed_matvec_ref(idx, val.abs(), W.abs())
    err1 = (out - ref).abs()
    if not bool((err1 <= tol1).all()):
        raise AssertionError(f"K1 disagrees at {label}: max err "
                             f"{float(err1.max()):.3e}")

    out2 = ps.packed_rmatvec(idx, val, r, p, columns=cols)
    again = ps.packed_rmatvec(idx, val, r, p, columns=cols)
    if not torch.equal(out2, again):
        raise AssertionError(f"K2 is not bitwise repeatable at {label}")
    ref2 = ps.packed_rmatvec_ref(idx, val, r, p)
    tol2 = 2 * counts[None, :, None] * U32 * ps.packed_rmatvec_ref(
        idx, val.abs(), r.abs(), p)
    err2 = (out2 - ref2).abs()
    if not bool((err2 <= tol2).all()):
        raise AssertionError(f"K2 disagrees at {label}: max err "
                             f"{float(err2.max()):.3e}")

    Wk = W.clone().requires_grad_(True)
    (ps.PackedMatvec.apply(Wk, idx, val, cols) * r).sum().backward()
    Wr = W.clone().requires_grad_(True)
    (ps.packed_matvec_ref(idx, val, Wr) * r).sum().backward()
    err3 = (Wk.grad - Wr.grad).abs()
    if not bool((err3 <= tol2).all()):
        raise AssertionError(f"PackedMatvec gradient disagrees at {label}: "
                             f"max err {float(err3.max()):.3e}")
    e1, e2 = float(err1.max()), max(float(err2.max()), float(err3.max()))
    say(f"  {label}: n={n} m={m} p={p} T={T} k={k}  K1 err {e1:.3e} "
        f"(max|out| {float(ref.abs().max()):.3e})  K2 err {e2:.3e} "
        f"(max|out| {float(ref2.abs().max()):.3e}), K2 bitwise repeatable")
    return e1, e2


def time_kernels(torch, ps, idx, val, p, T, k, X_csr):
    """Times at the main path's shape: kernel, plain version and one
    torch.sparse.mm call computing the same function."""
    n, m = idx.shape
    K = T * k
    g = torch.Generator(device="cuda").manual_seed(1)
    W = torch.randn((T, p, k), generator=g, device="cuda")
    r = torch.randn((T, n, k), generator=g, device="cuda")
    cols = ps.build_columns(idx, val, p)
    # the library operands in the 2-D layouts torch.sparse.mm takes
    W2 = W.permute(1, 0, 2).reshape(p, K).contiguous()
    r2 = r.permute(1, 0, 2).reshape(n, K).contiguous()
    Xs, XsT = X_csr
    t = {
        "K1": cuda_ms(torch, lambda: ps.packed_matvec(idx, val, W), 10),
        "K1_plain": cuda_ms(torch,
                            lambda: ps.packed_matvec_ref(idx, val, W), 3),
        "K1_library": cuda_ms(torch, lambda: torch.sparse.mm(Xs, W2), 5),
        "K2": cuda_ms(torch, lambda: ps.packed_rmatvec(
            idx, val, r, p, columns=cols), 10),
        "K2_plain": cuda_ms(torch,
                            lambda: ps.packed_rmatvec_ref(idx, val, r, p), 3),
        "K2_library": cuda_ms(torch, lambda: torch.sparse.mm(XsT, r2), 5),
    }
    nnz = cols.nnz
    distinct = int((cols.col_ptr[1:] > cols.col_ptr[:-1]).sum())
    packed_bytes = n * m * 8
    k1_bytes = packed_bytes + distinct * K * 4 + n * K * 4
    k2_bytes = packed_bytes + n * K * 4 + p * K * 4
    flops = 2 * nnz * K
    return t, bound(k1_bytes, flops), bound(k2_bytes, flops)


# ---------------------------------------------------------------------------
# phases 5-8: K4 and the forest path
# ---------------------------------------------------------------------------

#: BASELINE config 4 (benchmarks/run_all.py config_4_forest)
FOREST = dict(n_estimators=256, max_depth=8, n_bins=32, max_features="sqrt",
              random_state=0)
FOREST_N, FOREST_D = 200_000, 28


def check_k4(torch, kh, Xb, key, Y, nl, B, label):
    """Hold K4 to its plain version at one shape; returns the largest
    error. Integer-valued channels sum exactly in float32: the kernel
    must equal the plain version bitwise and repeat bitwise. Fractional
    channels: an entry sums c terms (c = its sample count), and two
    float32 sums of them in different orders differ by at most
    2 * c * u * sum|terms|."""
    integer = bool(torch.equal(Y, torch.round(Y)))
    XbF = Xb.t().contiguous().t()  # the feature-major layout trees pass
    out = kh.level_histogram(XbF, key, Y, nl, B)
    again = kh.level_histogram(XbF, key, Y, nl, B)
    ref = kh.level_histogram_ref(Xb, key, Y, nl, B)
    err = float((out - ref).abs().max())
    if integer:
        if not (torch.equal(out, ref) and torch.equal(again, out)):
            raise AssertionError(f"K4 is not bitwise equal and repeatable "
                                 f"on integer channels at {label}: max err "
                                 f"{err:.3e}")
    else:
        cnt = kh.level_histogram_ref(Xb, key, torch.ones_like(Y[..., :1]),
                                     nl, B)
        tol = 2 * cnt * U32 * kh.level_histogram_ref(Xb, key, Y.abs(), nl, B)
        for res in (out, again):
            if not bool(((res - ref).abs() <= tol).all()):
                raise AssertionError(f"K4 disagrees at {label}: max err "
                                     f"{float((res - ref).abs().max()):.3e}")
    say(f"  {label}: T={key.shape[0]} n={Xb.shape[0]} d={Xb.shape[1]} "
        f"nl={nl} B={B} C={Y.shape[-1]} {'integer' if integer else 'fractional'}"
        f" channels: max err {err:.3e} (max|out| {float(ref.abs().max()):.3e})"
        + (", bitwise equal and repeatable" if integer else ""))
    return err


def k4_bound(T, n, d, nl, B, C):
    """(least ms, what bounds it) of one K4 launch: key, channels, bins
    and the output moved once; T * n * d * C adds at the fp32 peak."""
    moved = T * n * 4 + T * n * C * 4 + n * d * 4 + T * d * nl * B * C * 4
    return bound(moved, T * n * d * C)


def phase_k4(torch, X, y):
    """Phase 5: K4 against its plain version, then its times at the
    forest's shapes. Returns (max error, times, bound)."""
    import torch.nn.functional as F

    from skdist_tpu_torch.models.tree import classification_channels
    from skdist_tpu_torch.ops import hist as kh
    from skdist_tpu_torch.ops.binning import apply_bins, quantile_bin_edges
    from skdist_tpu_torch.utils import draws

    say("phase 5: K4 level_histogram against plain PyTorch on the card")
    errs = []
    for i, (T, n, d, nl, B, C) in enumerate([
            (1, 37, 3, 3, 4, 3), (3, 1001, 5, 1, 32, 4),
            (2, 5003, 7, 128, 32, 3), (4, 3001, 3, 3, 256, 4),
            (5, 10007, 28, 128, 32, 3)]):
        g = torch.Generator(device="cuda").manual_seed(i)
        Xb = torch.randint(0, B, (n, d), generator=g, device="cuda",
                           dtype=torch.int32)
        # a third of the keys past nl: samples not at this level
        key = torch.randint(0, nl + max(1, nl // 2), (T, n), generator=g,
                            device="cuda", dtype=torch.int32)
        Yi = torch.randint(0, 3, (T, n, C), generator=g, device="cuda").float()
        Yf = torch.rand((T, n, C), generator=g, device="cuda")
        for Y in (Yi, Yf):
            errs.append(check_k4(torch, kh, Xb, key, Y, nl, B,
                                 f"ragged case {i}"))

    # the forest's deepest level on the real data: binned X, bootstrap
    # channels of 256 trees, every sample at one of 128 nodes
    T, (n, d), B, C, D = 256, X.shape, FOREST["n_bins"], 3, FOREST["max_depth"]
    edges = quantile_bin_edges(X, B)
    Xb = apply_bins(torch.as_tensor(X).cuda(), edges)
    XbF = Xb.t().contiguous().t()
    seeds = torch.arange(T, device="cuda")
    counts = draws.bootstrap_counts(seeds, n)
    y_t = torch.as_tensor(y).cuda()
    Yi = classification_channels(y_t, counts, 2)
    Yf = classification_channels(
        y_t, counts * torch.where(y_t == 1, 1.3, 0.7)[None], 2)
    g = torch.Generator(device="cuda").manual_seed(9)
    nl = 2 ** (D - 1)
    # every level's shape, each held to the plain version before it is
    # timed: the shallow levels split the sample axis into chunks and
    # flush with global atomics, the deep ones write their tile once
    times = {"per_level": {}}
    for level in range(D):
        nl_l = 2 ** level
        key = torch.randint(0, nl_l, (T, n), generator=g, device="cuda",
                            dtype=torch.int32)
        for Y in (Yi, Yf):
            errs.append(check_k4(torch, kh, Xb, key, Y, nl_l, B,
                                 f"forest level {level}"))
        times["per_level"][nl_l] = cuda_ms(
            torch, lambda: kh.level_histogram(XbF, key, Yi, nl_l, B), 5)
    times["K4"] = times["per_level"][nl]
    times["K4_plain"] = cuda_ms(
        torch, lambda: kh.level_histogram_ref(Xb, key, Yi, nl, B), 2)

    # the JAX package's accelerator default, the "matmul" engine, at the
    # largest tree count whose (n, nl*C) factor fits half of free memory
    XohT = F.one_hot(Xb.long(), B).float().reshape(n, d * B).T
    per_tree = n * nl * 4 * (2 * C + 1)
    free, _ = torch.cuda.mem_get_info()
    Tm = max(1, min(T, int(0.5 * free) // per_tree))

    def matmul_engine():
        level_oh = F.one_hot(key[:Tm].long(), nl).float()
        NW = (level_oh[..., None] * Yi[:Tm, :, None, :]).reshape(Tm, n, nl * C)
        return torch.matmul(XohT, NW)

    want = kh.level_histogram_ref(Xb, key[:2], Yi[:2], nl, B)
    got = matmul_engine()[:2].reshape(2, d, B, nl, C).permute(0, 1, 3, 2, 4)
    if not torch.equal(got, want):
        raise AssertionError("the matmul engine disagrees with K4's plain "
                             "version on integer channels")
    del want, got
    times["matmul_engine_per_tree"] = cuda_ms(torch, matmul_engine, 2) / Tm
    times["matmul_engine_trees"] = Tm
    del XohT
    torch.cuda.empty_cache()
    bnd = k4_bound(T, n, d, nl, B, C)
    say("  K4 ms per level (T=256, n=200000, d=28, B=32, C=3): " + ", ".join(
        f"nl={k} {v:.3f} (bound {k4_bound(T, n, d, k, B, C)[0]:.3f})"
        for k, v in times["per_level"].items()))
    say(f"  deepest level: K4 {times['K4']:.3f} ms, plain "
        f"{times['K4_plain']:.3f} ms, matmul engine "
        f"{times['matmul_engine_per_tree']:.3f} ms per tree (timed at "
        f"{Tm} trees; x256 = {256 * times['matmul_engine_per_tree']:.3f} ms)"
        f", bound {bnd[0]:.3f} ms ({bnd[1]})")
    return max(errs), times, bnd


def profile_device_split(torch, fit):
    """Device time of one call of ``fit`` under torch.profiler: (total
    kernel ms, K4 ms), or None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fit()
        torch.cuda.synchronize()
    total = k4 = 0.0
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        total += us / 1e3
        if "level_histogram" in ev.key:
            k4 += us / 1e3
    return (total, k4) if total > 0 else None


def phase_forest(torch, X, y, backend):
    """Phase 6: the 256-tree forest at full size, cold then warm."""
    from skdist_tpu_torch import DistRandomForestClassifier
    from skdist_tpu_torch.ops import hist as kh

    say(f"phase 6: DistRandomForestClassifier({FOREST}) on {X.shape}")
    walls = {}
    for label in ("cold", "warm"):
        kh.level_histogram.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rf = DistRandomForestClassifier(backend=backend, **FOREST).fit(X, y)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t0
        launches = kh.level_histogram.launches
        stats = backend.last_round_stats
        levels = FOREST["max_depth"]
        say(f"  {label}: wall {walls[label]:.3f} s, "
            f"{FOREST['n_estimators'] / walls[label]:.1f} trees/s, rounds "
            f"{stats['rounds']} x {stats['tasks_per_round']} trees (round "
            f"walls " + ", ".join(f"{w:.3f}" for w in stats["round_walls_s"])
            + f" s), estimate per tree {stats['bytes_per_task'] / 2**20:.1f} "
            f"MiB, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, K4 "
            f"launches {launches}")
        if launches <= 0 or launches != levels * stats["rounds"]:
            raise AssertionError(
                f"K4 launched {launches} times; the path has {levels} "
                f"levels x {stats['rounds']} rounds")
        trees = rf._trees
        if label == "cold":
            cold_trees = trees
        elif not all(np.array_equal(trees[k], cold_trees[k]) for k in trees):
            raise AssertionError("the warm fit grew other trees than the "
                                 "cold fit (integer channels: must repeat)")
    say("  cold and warm fits grew bitwise identical forests")
    # the same forest through the plain histogram (index_add_): the
    # channels are integer, so every histogram, gain, split and leaf of
    # the K4 fit must come out bitwise the same
    kh.level_histogram.launches = 0
    t0 = time.perf_counter()
    plain = DistRandomForestClassifier(backend=backend, hist_mode="scatter",
                                       **FOREST).fit(X, y)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    differ = [k for k in trees
              if not np.array_equal(trees[k], plain._trees[k])]
    if differ or kh.level_histogram.launches:
        raise AssertionError(
            f"the K4 forest and the plain-histogram forest differ in "
            f"{differ} (K4 launches in the plain fit: "
            f"{kh.level_histogram.launches})")
    say(f"  the plain-histogram fit (hist_mode='scatter', {t_plain:.3f} s) "
        f"grew the same forest bitwise: " + ", ".join(sorted(trees)))
    del plain
    t0 = time.perf_counter()
    proba = rf.predict_proba(X)
    t_pred = time.perf_counter() - t0
    pred = rf.classes_[np.argmax(proba, axis=1)]
    acc = float(np.mean(pred == y))
    majority = float(np.bincount(y).max() / len(y))
    say(f"  train accuracy {acc:.4f} against the majority class's share "
        f"{majority:.4f} (predict_proba {t_pred:.3f} s)")
    if not (proba.shape == (len(y), 2) and np.all(np.isfinite(proba))
            and np.allclose(proba.sum(axis=1), 1.0, atol=1e-5)
            and acc >= majority):
        raise AssertionError(f"predict_proba is not a distribution per row, "
                             f"or accuracy {acc:.4f} < {majority:.4f}")
    if not np.array_equal(rf.predict(X), pred):
        raise AssertionError("predict disagrees with predict_proba")
    loaded = pickle.loads(pickle.dumps(rf))
    if loaded.backend is not None or not np.array_equal(loaded.predict(X),
                                                        pred):
        raise AssertionError("the pickled forest predicts differently")
    say("  pickled forest (no backend in it) predicts as the live one")
    rf.set_params(oob_score=True, warm_start=True)
    t0 = time.perf_counter()
    rf.fit(X, y)  # no new trees: OOB over the stored seeds
    if not np.isfinite(rf.oob_score_):
        raise AssertionError(f"oob_score_ {rf.oob_score_}")
    say(f"  oob_score_ {rf.oob_score_:.4f} ({time.perf_counter() - t0:.3f} s)")

    t0 = time.perf_counter()
    split = profile_device_split(torch, lambda: DistRandomForestClassifier(
        backend=backend, **FOREST).fit(X, y))
    t_prof = time.perf_counter() - t0
    if split is None:
        say("  profiler: no device time recorded (split not measured)")
    else:
        total, k4 = split
        say(f"  profiled fit (wall {t_prof:.3f} s with the profiler on): "
            f"device kernels {total:.1f} ms, of which K4 {k4:.1f} ms "
            f"({100 * k4 / total:.1f}%), plain-torch glue {total - k4:.1f} ms;"
            f" warm wall {1e3 * walls['warm']:.1f} ms")
    return walls, launches


def phase_card_vs_cpu(torch):
    """Phase 7: the same small forest, same seeds, on the card and on
    the CPU."""
    from skdist_tpu_torch import DistRandomForestClassifier

    X, y = make_tabular(5000, FOREST_D, 2, seed=3)
    kw = dict(n_estimators=16, max_depth=8, random_state=0)
    say(f"phase 7: card against CPU, DistRandomForestClassifier({kw}) on "
        f"{X.shape}")
    card = DistRandomForestClassifier(**kw).fit(X, y)
    cpu = DistRandomForestClassifier(device="cpu", **kw).fit(X, y)
    a, b = card._trees, cpu._trees
    split = a["is_split"] | b["is_split"]
    differ = split & ((a["is_split"] != b["is_split"]) | (a["feat"] != b["feat"])
                      | (a["thr"] != b["thr"]))
    n_split, n_diff = int(split.sum()), int(differ.sum())
    same = ~differ.any(axis=1)
    say(f"  split nodes {n_split}, differing {n_diff}; trees identical "
        f"{int(same.sum())} of {len(same)}")
    if n_diff > 0.01 * n_split:
        raise AssertionError(f"{n_diff} of {n_split} split nodes differ")
    pa = np.mean([e.predict_proba(X) for e, s in zip(card.estimators_, same)
                  if s], axis=0)
    pb = np.mean([e.predict_proba(X) for e, s in zip(cpu.estimators_, same)
                  if s], axis=0)
    dp = float(np.abs(pa - pb).max())
    say(f"  predict_proba over the identical trees: max diff {dp:.3e}")
    if not dp <= 1e-5:
        raise AssertionError(f"predict_proba differs by {dp:.3e}")


def phase_extra_trees_regressor(torch):
    """Phase 8: fractional channels (w, w*y, w*y**2) through K4."""
    from skdist_tpu_torch import DistExtraTreesRegressor
    from skdist_tpu_torch.ops import hist as kh

    rng = np.random.RandomState(4)
    X = rng.rand(20000, FOREST_D).astype(np.float32)
    y = (X @ rng.randn(FOREST_D) + 0.1 * rng.randn(20000)).astype(np.float32)
    kh.level_histogram.launches = 0
    t0 = time.perf_counter()
    etr = DistExtraTreesRegressor(n_estimators=32, max_depth=8,
                                  random_state=0).fit(X, y)
    wall = time.perf_counter() - t0
    r2 = etr.score(X, y)
    say(f"phase 8: DistExtraTreesRegressor(32 trees, depth 8) on {X.shape}: "
        f"{wall:.3f} s, K4 launches {kh.level_histogram.launches}, train "
        f"R^2 {r2:.4f}")
    if kh.level_histogram.launches <= 0 or not r2 > 0.5:
        raise AssertionError("the extra-trees regressor path failed")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--candidates", type=int, default=96,
                    help="C candidates of the grid (default: all 96)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import skdist_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: skdist_tpu_torch is not importable ({exc}); run "
              "from the root of a checkout", file=sys.stderr)
        return 2
    import scipy.sparse as sp

    from skdist_tpu_torch import CUDABackend, DistGridSearchCV, LogisticRegression
    from skdist_tpu_torch.models.linear import prepare_fit_X
    from skdist_tpu_torch.ops import _build
    from skdist_tpu_torch.ops import packed_sparse as ps

    t_all = time.perf_counter()
    # ---- phase 1: device and build -------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    say(smi)
    kind = torch.cuda.get_device_name(0)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = _build.build()
    for name, (path, secs, log) in built.items():
        say(f"built {name}: {os.path.relpath(path)} nvcc {secs:.1f}s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                say("  ptxas:", line.strip())
    say(f"phase 1 build seconds: {time.perf_counter() - t0:.1f}")

    # ---- data of the main path (needed for the main kernel shape) ------
    n, d, k = 11314, 2 ** 18, 20
    t0 = time.perf_counter()
    X, y = make_20news_sparse(seed=0, n=n, d=d, nnz_row=40, k=k)
    say(f"data: 20news-shaped CSR {X.shape}, nnz {X.nnz}, "
        f"{time.perf_counter() - t0:.1f}s")
    Cs = np.logspace(-3, 2, 96)
    if args.candidates < len(Cs):
        say(f"CUT: C grid cut to its first {args.candidates} of 96 points")
        Cs = Cs[: args.candidates]
    n_fits = len(Cs) * 5

    # ---- phase 2: kernels against their plain versions -----------------
    say("phase 2: kernels against plain PyTorch on the card")
    torch.backends.cuda.matmul.allow_tf32 = False  # full-f32 references
    rng = np.random.RandomState(0)
    errs = []
    for (nn, dd, mm, T, kk) in [(37, 53, 5, 1, 3), (8, 300, 1, 1, 1),
                               (100, 700, 7, 3, 13), (200, 1000, 17, 1, 20)]:
        i_, v_ = random_packed(torch, rng, nn, dd, mm)
        errs.append(check_pair(torch, ps, i_, v_, dd, T, kk, seed=nn,
                               label=f"ragged n={nn}"))
    packed = prepare_fit_X(X, LogisticRegression)
    p = d + 1
    idx = torch.cat([torch.as_tensor(packed.idx),
                     torch.full((n, 1), d, dtype=torch.int32)], 1).cuda()
    val = torch.cat([torch.as_tensor(packed.val),
                     torch.ones((n, 1), dtype=torch.float32)], 1).cuda()
    est = LogisticRegression(max_iter=100)
    meta = {"n_features": d, "n_classes": k}
    static = tuple(sorted(est._static_config(meta).items()))
    backend = CUDABackend()
    T1 = backend.plan_round_size(
        n_fits, LogisticRegression._batched_task_bytes(meta, static, n))
    errs.append(check_pair(torch, ps, idx, val, p, T1, k, seed=7,
                           label="main path shape"))
    Xa = sp.hstack([X, sp.csr_matrix(np.ones((n, 1), np.float32))]).tocsr()
    X_csr = tuple(
        torch.sparse_csr_tensor(
            torch.as_tensor(A.indptr, dtype=torch.int64),
            torch.as_tensor(A.indices, dtype=torch.int64),
            torch.as_tensor(A.data, dtype=torch.float32), size=A.shape,
        ).cuda()
        for A in (Xa, Xa.T.tocsr())
    )
    times, (k1_bound, k1_by), (k2_bound, k2_by) = time_kernels(
        torch, ps, idx, val, p, T1, k, X_csr)
    say(f"  main shape n={n} m={idx.shape[1]} p={p} K={T1 * k}: " + ", ".join(
        f"{name} {ms:.3f} ms" for name, ms in times.items()))
    say(f"  bounds: K1 {k1_bound:.3f} ms ({k1_by}), K2 {k2_bound:.3f} ms "
        f"({k2_by})")
    del X_csr
    torch.cuda.empty_cache()

    # ---- phase 3: the sparse main path at full size --------------------
    say(f"phase 3: sparse DistGridSearchCV, {len(Cs)} C x 5 folds = "
        f"{n_fits} fits on the card")
    ps.packed_matvec.launches = 0
    ps.packed_rmatvec.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gs = DistGridSearchCV(
        LogisticRegression(max_iter=100), {"C": Cs}, cv=5,
        scoring="f1_weighted", backend=backend,
    ).fit(X, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"packed_matvec": ps.packed_matvec.launches,
                "packed_rmatvec": ps.packed_rmatvec.launches}
    stats = gs.round_stats_[0]
    say(f"  wall {wall:.1f}s, {n_fits / wall:.2f} fits/s, rounds "
        f"{stats['rounds']} x {stats['tasks_per_round']} tasks, round walls "
        + ", ".join(f"{w:.1f}" for w in stats["round_walls_s"]) + " s")
    say(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
        f" GiB; estimate per task "
        f"{LogisticRegression._batched_task_bytes(meta, static, n) / 2**20:.0f}"
        " MiB")
    say(f"  best_params_ {gs.best_params_}, best_score_ {gs.best_score_:.6f}")
    say(f"  launches {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    scores = gs.cv_results_["mean_test_score"]
    if not np.all(np.isfinite(scores)):
        raise AssertionError("non-finite mean_test_score")
    live = gs.best_estimator_.predict(X)
    loaded = pickle.loads(pickle.dumps(gs.best_estimator_))
    if not np.array_equal(loaded.predict(X), live):
        raise AssertionError("pickled best_estimator_ predicts differently")
    say(f"  refit accuracy on its training data {np.mean(live == y):.4f}; "
        "pickled artifact predicts the same")

    # one fit on the card against the same fit on the CPU. Both run the
    # same 100 float32 L-BFGS iterations from w=0 and differ only in
    # summation order; the solve amplifies such rounding differences
    # (an unconverged iterate is not a stable quantity), so the CPU fit
    # is held to what one ulp of input noise does to the card's own fit:
    # the card refit again on X * (1 + 2**-23). Tolerance: the card/CPU
    # coef_ gap is at most 10x that one-ulp gap (plus 1e-6 of max|coef_|
    # for a solve that absorbs the ulp entirely); a wrong kernel or
    # objective moves coef_ by far more than rounding does.
    best_C = float(gs.best_params_["C"])
    t0 = time.perf_counter()
    on_card = LogisticRegression(C=best_C, max_iter=100).fit(X, y)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = LogisticRegression(C=best_C, max_iter=100, device="cpu").fit(X, y)
    t_cpu = time.perf_counter() - t0
    X_ulp = X.copy()
    X_ulp.data *= np.float32(1 + 2.0 ** -23)
    on_card_ulp = LogisticRegression(C=best_C, max_iter=100).fit(X_ulp, y)
    dcoef = float(np.abs(on_card.coef_ - on_cpu.coef_).max())
    dulp = float(np.abs(on_card.coef_ - on_card_ulp.coef_).max())
    scale = float(np.abs(on_cpu.coef_).max())
    say(f"  refit C={best_C:.4g}: card {t_card:.1f}s ({on_card.n_iter_} it), "
        f"cpu {t_cpu:.1f}s ({on_cpu.n_iter_} it); max|coef| {scale:.3e}, "
        f"card vs cpu max|dcoef| {dcoef:.3e}, card vs card on X*(1+ulp) "
        f"{dulp:.3e}")
    if not dcoef <= 10 * dulp + 1e-6 * scale:
        raise AssertionError(
            "card and CPU refits differ by more than 10x what one ulp of "
            "input noise does")

    # ---- phase 4: the dense headline -----------------------------------
    Xd, yd = make_20news_shaped()
    say(f"phase 4: dense DistGridSearchCV on {Xd.shape}, {n_fits} fits")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gd = DistGridSearchCV(
        LogisticRegression(max_iter=100), {"C": Cs}, cv=5,
        scoring="f1_weighted", backend=backend,
    ).fit(Xd, yd)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    sd = gd.round_stats_[0]
    if not np.all(np.isfinite(gd.cv_results_["mean_test_score"])):
        raise AssertionError("non-finite dense mean_test_score")
    say(f"  wall {wall_d:.1f}s, {n_fits / wall_d:.2f} fits/s, rounds "
        f"{sd['rounds']} x {sd['tasks_per_round']}, best_params_ "
        f"{gd.best_params_}, best_score_ {gd.best_score_:.6f}")

    # ---- phases 5-8: K4 and the forest path ----------------------------
    del gs, gd
    torch.cuda.empty_cache()
    Xf, yf = make_tabular(FOREST_N, FOREST_D, 2, seed=2)
    k4_err, k4_times, (k4_bound_ms, k4_by) = phase_k4(torch, Xf, yf)
    torch.cuda.empty_cache()
    _walls, k4_launches = phase_forest(torch, Xf, yf, backend)
    phase_card_vs_cpu(torch)
    phase_extra_trees_regressor(torch)

    # ---- phase 9: the kernel line and the result line ------------------
    source = "skdist_tpu_torch/csrc/packed_sparse.cu"
    kernels = [
        {"name": "packed_matvec", "route": "cuda", "source": source,
         "replaces": "skdist_tpu/ops/pallas_sparse.py:130",
         "launches": launches["packed_matvec"],
         "max_abs_err": max(e[0] for e in errs),
         "ms": times["K1"], "plain_ms": times["K1_plain"],
         "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": times["K1_library"]},
        {"name": "packed_rmatvec", "route": "cuda", "source": source,
         "replaces": "skdist_tpu/ops/pallas_sparse.py:180",
         "launches": launches["packed_rmatvec"],
         "max_abs_err": max(e[1] for e in errs),
         "ms": times["K2"], "plain_ms": times["K2_plain"],
         "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": times["K2_library"]},
        {"name": "level_histogram", "route": "cuda",
         "source": "skdist_tpu_torch/csrc/level_histogram.cu",
         "replaces": "skdist_tpu/ops/pallas_hist.py:124",
         "launches": k4_launches, "max_abs_err": k4_err,
         "ms": k4_times["K4"], "plain_ms": k4_times["K4_plain"],
         "bound_ms": k4_bound_ms, "bound_by": k4_by, "library_ms": None},
    ]
    for kk in kernels:
        for key, v in kk.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{kk['name']} {key} is not finite")
    say(f"total seconds {time.perf_counter() - t_all:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
