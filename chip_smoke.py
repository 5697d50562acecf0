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
5. One JSON line ``{"kernels": [...]}``, then, last, the result line
   ``{"ok": true, "device": {...}}``.

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

    # ---- phase 5: the kernel line and the result line ------------------
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
