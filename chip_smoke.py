#!/usr/bin/env python3
"""Drive the PyTorch / H100 port (``skdist_tpu_torch``) on the card.

    python3 chip_smoke.py [--candidates N]
    python3 chip_smoke.py --ab-sgd DIR [--pairs N] [--ab-rows N]
    python3 chip_smoke.py --ab-row-kernels DIR [--pairs N]
    python3 chip_smoke.py --profile-config5
    python3 chip_smoke.py --phases-17-19
    python3 chip_smoke.py --phase-20
    python3 chip_smoke.py --phase-21
    python3 chip_smoke.py --phase-22
    python3 chip_smoke.py --phase-23
    python3 chip_smoke.py --phase-24

Phases, in order; any failure ends the run with a nonzero exit and no
result line:

1. Device and build: the card's name and power limit (``nvidia-smi``),
   then the port's CUDA kernels built with ``nvcc`` from the sources in
   this checkout, and its host C tree engine (``native/hist_tree.c``)
   with the host's C compiler.
2. Kernels against their plain PyTorch versions on the card: K1
   ``packed_matvec`` and K2 ``packed_rmatvec`` on ragged small shapes,
   on shapes that reach each branch of their design (columns longer
   than one and than many K2 segments, a stretch of empty columns wider
   than a K2 tile, ``k = 1`` with ``T = 96`` as the binary path calls
   them, operands whose layout rules out the 16-byte vector form) and at
   the main path's shape, each held to a tolerance derived from its
   summation order; K2 bitwise repeatable; the ``PackedMatvec`` gradient
   against plain autograd; times of the kernel, its plain version and
   ``torch.sparse.mm`` (a yardstick the port never calls), with the
   ratio to the yardstick, and two readings of what sets each kernel's
   pace: K1 with every entry on one column (W in L2) and the time to
   write K2's output once, with K2's two passes split by the profiler.
   Then K1 and K2 in per-lane row form (``packed_row_matvec``,
   ``packed_row_rmatvec``, the SGD step's products) against their plain
   versions: B not 64, m = 1, a row of padding only in every lane, T = 1
   and T = 300, k from 1 to 33, a lane of more kept entries than one
   block's list, every column of an odd p touched (each slice edge,
   columns 0 and p - 1) for own rows and a shared batch, an inf and a
   NaN in g, one column in every row (the Zipf head) and every entry on
   column 0, integer data bitwise and fractional data to a summation-
   order tolerance, both kernels bitwise repeatable; then at the
   one-vs-rest SGD step's shape (20 lanes, 64 of the main path's rows
   with the intercept appended, m = 41, p = 2**18 + 1, k = 1, gathered
   by the SGD operator's ``row_batch``), each lane's own rows and one
   batch shared by every lane (read in place, as the step gives it), a
   random lane permutation permuting both outputs bitwise, and times of
   both kernels, their plain versions, the bound from these inputs and
   the yardsticks: an ``embedding_bag`` (sum mode, the values as
   per-sample weights, over the lanes' flattened (lane, column) cells)
   for the row matvec; an ``index_add_`` alone and ``zero_`` +
   ``index_add_`` (the same function) for the row rmatvec; a one-element
   ``fill_`` as the launch floor. Each is read four ways: CUDA events
   over 50 back-to-back calls, the profiler's device time a call, a CUDA
   graph of 50 calls replayed under events, and the host's time a call.
3. The sparse main path at full width: ``DistGridSearchCV(
   LogisticRegression(max_iter=100), {"C": logspace(-3, 2, 96)[::4]},
   cv=5, scoring="f1_weighted")`` on a 20news-shaped hashed-text CSR
   (n=11314, d=2**18, 20 classes), 120 fits on the card (every fourth C
   of config 1's 96, the span kept: a printed cut that keeps the whole
   run inside its time limit; the 480-fit grid took 228 s of it), on
   the search's default convergence-compacted path (the refill regime:
   the lanes do not all fit on the card at once). Phase 2's main path
   shape is this grid's round. The kernels' launch counters are zeroed
   just before it and read just after; both must be > 0. Printed: the
   wall, the scheduler's regime, chunk, slices and refills, the lanes'
   ``n_iter`` (min, median, p90, max), how many stopped at ``max_iter``
   or stalled, and the lane-iterations carried against those used. The
   pickled ``best_estimator_`` must predict as the live one, and one
   refit on the card is held to the same refit on the CPU (to 10x the
   gap one ulp of input noise opens on the card). Then one round of the
   grid (as many C as fill it x 5 folds, ``max_iter`` cut to 20, one
   chunk) timed alone
   and then under ``torch.profiler``: device time in K1, K2 and the
   rest, and the device's idle share of the round's wall.
3b. Classic against compacted at full width: the sparse grid cut to 12
   C (the first 12 of phase 3's) x 5 folds, both ways at equal chunk in
   one process, on a backend whose rounds hold at most 30 lanes (as if
   the card's memory held no more: the refill regime at a cut size);
   ``cv_results_`` and the refit ``coef_`` must be bitwise equal, and
   the compacted run must have refilled a slot and retired a lane
   (stalled or converged) before ``max_iter`` (else the comparison
   would be trivial).
4. The dense headline on the card: every sixth C of the same grid (16
   of 96, the span kept; a printed cut that keeps the run inside its
   time limit) as one round (``partitions=1``: every lane runs to
   ``max_iter``) on the dense 11314 x 4096 problem (``torch.matmul``, no
   hand kernel), compacted
   (every round resident), then on the classic path
   (``SKDIST_COMPACTION=0``) at the compacted run's chunk: the two
   ``cv_results_`` must be bitwise equal.
4b. ASHA on the dense headline: ``adaptive=HalvingSpec(eta=inf)`` must
   give phase 4's ``cv_results_`` bitwise; then ``eta=3``: its wall, its
   kills at each rung, ``best_params_``/``best_score_`` beside the
   exhaustive grid's, lanes retired by rung against by convergence.
5. K4 ``level_histogram`` against its plain version on the card: ragged
   small shapes (n not a multiple of any chunk, nl in {1, 3, 128}, B in
   {4, 32, 256}, C in {3, 4}, sentinel keys, bins outside [0, B)) in every
   bin layout K4 takes (uint8 rows padded to 16 bytes, unpadded uint8
   rows, feature-major uint8, int32 rows, a sliced int32 view); each branch
   of its design (lane-private copies with all lanes on one node at nl = 1
   and 2, the sample axis cut into chunks, every feature with node blocks,
   feature groups with every node, one feature with node blocks, 11
   channels); and every level of the forest (T=256, n=200000, d=28,
   nl=1..128, B=32, C=3). Integer, fractional and mixed channels:
   channels of whole numbers must equal the plain version bitwise and
   repeat bitwise (with and without ``integer_channels``' proof);
   fractional channels are held to a summation-order tolerance. At every
   level of the forest, times of the kernel (integer channels with their
   proof, as trees call it, and fractional channels), the bound from this
   run's inputs, and the ``index_add_`` yardstick (one PyTorch call
   computing K4's function, never called by the port); at the deepest,
   the plain version and the JAX package's "matmul" engine (one-hot times
   node-weighted channels through ``torch.matmul``, per tree).
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
9. K3 ``packed_weighted_gram`` against its plain version on the card:
   ragged small shapes (n off every chunk, m in {1, 7, 70} with padding,
   p odd, T in {1, 3}, an empty row, a repeated (row, col) entry) and
   the ridge path's shape (n=11314, m=41, p=2**14+1) for one and three
   lanes and for a whole round (first, middle and last lanes; random
   weights, then 0/1 fold masks on integer values). Integer data must equal the plain version bitwise; fractional
   data is held to a summation-order tolerance; two launches must be
   bitwise equal. Whether the TF32 switch reaches cuSOLVER's float32
   Cholesky. Times of K3 (a lane and a round), its plain version, and
   two yardsticks the port never calls: ``torch.sparse.mm`` of the CSR
   X~.T against the dense S X~, and the dense GEMM X~.T @ (S X~).
10. The ridge path at full size: ``DistGridSearchCV(RidgeClassifier(),
    {"alpha": logspace(-2, 3, 96)[::2]}, cv=5, scoring="f1_weighted")``
    on the 20news-shaped CSR at d=2**14 (n=11314, 20 classes), 240 fits
    on the card (every second alpha: a printed cut, 480 before). K3's launches must equal the rounds plus the refit, K2's
    and K1's be > 0; every score finite (the count of lanes whose
    Cholesky failed is printed); the pickled ``best_estimator_`` must
    predict as the live one; the refit on the card is held to the same
    refit on the CPU (one thread, so that it repeats itself bitwise; the
    four CPU refits of the phase run at once, each on its own thread) as
    in phase 3, and both to a float64 solve on the card (the card's
    error at most 10x the CPU's), at the best alpha and at alpha = 1.
    The sizer's bytes beside the peak device memory, and a
    ``torch.profiler`` split of a round of 10 lanes (2 alphas x 5
    folds).
11. ``DistGridSearchCV(Ridge(), {"alpha": logspace(-2, 3, 16)}, cv=5)``
    (r2) on the same X and a real target made from the seed: 80 fits.
12. One JSON line ``{"kernels": [...]}`` (K1, K2, K3, K4 and K1's and
    K2's row forms, each launched on its path; the row forms' entries
    also carry their device, graph and host times, their yardsticks'
    and the launch floor's; K1's and K4's ``paths`` also count their
    launches on the prediction and generic search paths, K1, K2 and the
    row forms on phase 18's search and 19(a)'s refit), then, last, the
    result line ``{"ok": true, "device": {...}}``; both are printed after
    phase 21.
13. BASELINE config 2 at full width: ``DistRandomizedSearchCV(
    SGDClassifier(max_iter=5, random_state=0), {"alpha": logspace(-6,
    -2, 60)}, n_iter=60, cv=5, scoring="accuracy", random_state=0)`` (5
    epochs, config 2's 20 cut to keep the whole run inside its time
    target; printed) on
    covtype's width (``make_tabular(290506, 54, 7, seed=1)``: half its
    581012 rows since a printed cut), 300 fits
    and the refit on the compacted path (mini-batch SGD through
    ``torch.matmul``; no hand kernel is on this path). Printed: the
    search's wall and fits/s, the refit's wall, the scheduler's counts
    and the lanes' epochs (min, median, p90, max; stopped by ``tol``
    against ``max_iter``), steps/s, a ``torch.profiler`` split of 50
    steps of the 300-lane round (products, gathers, reductions, the
    rest, the device's busy share), peak device memory, ``best_params_``
    and ``best_score_`` and the candidates' first three alphas. Every
    score must be finite, ``best_score_`` above the majority class's
    share, and the pickled ``best_estimator_`` must predict as the live
    one.
13b. The same search on ``make_tabular(12500, 54, 7, seed=1)`` (an eighth
    of the JAX package's own benchmark size, a cut that keeps the run
    inside its time target; printed): compacted, then classic
    (``SKDIST_COMPACTION=0``) at the same chunk, ``cv_results_`` and the
    refit ``coef_`` bitwise equal; ``adaptive=HalvingSpec(eta=inf)``
    bitwise equal to the exhaustive run; then ``eta=3``: its wall, kills
    per rung, and its winner's rank in the exhaustive grid.
13c. Card against CPU on 20000 rows of that data: ``SGDClassifier(
    max_iter=3)`` with ``hinge`` and with ``log_loss`` (both draw the
    same row orders), the card/CPU gap in the weights at most 10x what
    one ulp of input noise moves the card's own fit (plus 1e-6 of
    max|W|); then slot independence: a round of 300 lanes and the same
    lanes in reverse slot order give every lane bitwise the same
    weights.
14. BASELINE config 3 as ``benchmarks/run_all.py:149-183`` defines it:
    ``DistOneVsRestClassifier(LinearSVC(C=1.0, max_iter=100))`` on the
    dense 20news-shaped 11314 x 4096 problem (20 classes, 20 binary fits
    as one classic round), fitted cold and then warm. Printed: both
    walls, binary fits/s (20 / warm), train accuracy, the classes'
    ``n_iter``. The pickled model must predict as the live one, and
    class 0's binary fit on the card is held to the same fit on the CPU
    (10x the one-ulp gap, plus 1e-6 of max|W|).
14b. The same on config 3's packed stand-in (the main path's hashed
    text, d = 2**18): K1's and K2's launch counters are zeroed before
    the cold fit and must be > 0 after it; the same gates.
14c. ``DistOneVsOneClassifier(LinearSVC(C=1.0, max_iter=100))`` on that
    packed X, 190 pairs: compacted as one round (``partitions=1``: every
    pair runs to ``max_iter``, so the default's 8 rounds would only
    multiply the host-paced iterations; its regime, slices and
    refills are printed), then classic (``SKDIST_COMPACTION=0``) at the
    compacted run's chunk; every pair's weights must be bitwise equal,
    and the pickled model must predict as the live one.
14d. ``DistOneVsRestClassifier(SGDClassifier(loss="hinge", max_iter=20,
    random_state=0))`` on that packed X: SGD over packed X through the
    row kernels. Their launch counters are zeroed before the fit and
    must equal the steps' (two row matvecs and one row rmatvec a step);
    the wall, steps/s and the lanes' epochs are printed. Then card
    against CPU on the first 2000 rows with ``max_iter=3`` (the gate of
    13c over every class's weights), and the 20 class lanes against the
    same lanes in reverse slots, bitwise. Last, the bare step: host time
    a step over one epoch, and a ``torch.profiler`` split of 50 steps
    (row kernels, a zeroing memset, the dense ``(T, p, k)`` passes, the
    rest; the device's busy share).

15. BASELINE config 5 as ``benchmarks/run_all.py:240-283`` defines it:
    ``LogisticRegression(max_iter=40)`` fitted on ``make_tabular(5000,
    64, 10, seed=3)``, then ``batch_predict(model, Xs,
    method="predict_proba", backend=CUDABackend())`` over
    ``RandomState(4).rand(1_000_000, 64)`` in float32 (the resident
    dense path: blocks of the default size, one product, bias and
    softmax a block), cold and then warm. Printed: both walls, rows/s
    (1M over the warm wall), the block size and count, and a
    ``torch.profiler`` split of one warm call (host-to-device copies,
    products, softmax, device-to-host copies, the device's busy share),
    naming what sets the pace, taken by ``--profile-config5`` in a
    process of its own (this process's profiler has been seen to record
    no device time by then; the phase fails if that one's does not
    either). Gates: shape ``(1_000_000, 10)``; rows
    sum to 1 within 1e-5; two warm calls bitwise equal; within 1e-6 of
    the model's own ``predict_proba`` over the same rows cut at another
    size; ``method="predict"`` is the argmax through ``classes_``; on
    the first 20000 rows the card within 1e-5 of ``device="cpu"`` (a
    CPU fit, its weights carried to a card model); the pickled model
    predicts the same.
15b. Sparse prediction through K1: ``LogisticRegression(max_iter=20)``
    on the main path's hashed text (11314 x 2**18, 20 classes), then
    ``batch_predict(..., "predict_proba")`` over 200000 rows of
    ``make_20news_sparse(seed=1, n=200000, d=2**18)``: packed row
    blocks, K1 on each. K1's launch counter is zeroed first and must
    equal the blocks after; the first 2000 rows' decision is held to a
    float64 product of their dense rows and the weights at K1's
    summation-order tolerance; the labels equal ``model.predict``.
    Printed: wall, rows/s, the bytes a dense block would have needed.
15c. The host-model path: ``RandomForestClassifier(n_estimators=32,
    max_depth=8)`` on phase 6's data, ``batch_predict(...,
    "predict_proba", batch_size=50000)`` through ``LocalBackend(n_jobs=1)``
    and ``LocalBackend(n_jobs=4)``, both bitwise equal to the forest's
    ``predict_proba``; then ``get_prediction_udf(forest,
    "predict_proba")`` on the columns: its rows equal that output.
16. The generic search path on the card: ``DistGridSearchCV(
    RandomForestClassifier(n_estimators=32, random_state=0), {"max_depth":
    [4, 6, 8], "min_samples_leaf": [1, 20]}, cv=3, scoring=["accuracy",
    "roc_auc"], refit="roc_auc", preds=True)`` on 50000 x 28 rows with a
    balanced binary target (a random projection split at its median),
    at ``n_jobs=1``, ``n_jobs=4`` and the default ``n_jobs=None`` (a
    host thread a CPU core; K4 in every fit). Gates: K4's launches
    exactly one a tree level of each fit over the three runs (the
    counters are exact under threads), every score finite, ``cv_results_`` scores bitwise equal among the three,
    ``preds_`` of shape (50000, 2), the pickled ``best_estimator_``
    predicts as the live one. Printed: the class shares, the walls and
    fits/s.

17. The f64 host engine and its warm C path at the flagship's width:
    ``DistGridSearchCV(LogisticRegression(engine="host", max_iter=100),
    {"C": logspace(-2, 2, 4)[:2]}, cv=3, scoring="accuracy")`` on the
    first 1500 rows of the dense 11314 x 4096 problem (20 classes; the
    cut, from 4 C x 5 folds on every row, is printed) under
    ``CUDABackend`` (an explicit pin: ``auto``
    never picks the host engine on the card). Gates: every fit ran the
    host engine, at least one was warm-seeded (the capped fits refit cold
    are counted), fold 0's seeded fits rerun cold and alone score as the
    chain's within 1e-5 wherever they converged (at least one must), the
    pickled search equals the live one. Printed: the wall, fits/s,
    iterations a fit warm against cold.
18. ``DistMultiModelSearch`` over ``LogisticRegression(max_iter=100)``
    (8 C), ``LinearSVC(max_iter=100)`` (8 C) and ``SGDClassifier(
    max_iter=20)`` (8 alpha), ``n=4, cv=5, scoring="accuracy",
    random_state=0``, on the main path's packed hashed text: K1, K2 and
    both row forms launched (the row forms exactly two matvecs and one
    rmatvec a step of whole epochs), every family's segment of
    ``cv_results_`` finite, ``best_index_`` the nan-argmax, ``predict`` =
    ``best_estimator_.predict``, the pickled search equal to the live one.
19. The estimator options. (a) The phase-18 winner's family refit on the
    packed X from its own ``coef_``/``intercept_`` after a cold fit at its
    params (``tol`` raised along 1e-4 .. 100 until the cold fit converges):
    the seeded refit stops at once with ``coef_`` within solver tolerance
    (a seeded SGD fit restarts its step sizes and does not stop early, so
    when SGD wins the best L-BFGS family is refit and SGD's seeded epochs
    are printed). (b) The dense flagship
    ``LogisticRegression(max_iter=100)`` with ``matmul_dtype="bfloat16"``
    against float32: score within 1e-3 (its largest probability gap
    printed); the JAX package's bf16 contract test on its own problem
    (``clf_data``, 180 x 8, 3 classes) on the card: score within 1e-3,
    probabilities within 0.05. (c) The main path's packed
    ``LinearOperator`` matvec under bf16: bitwise its gather expression,
    within 0.02 relative of K1's float32 matvec, both timed. (d)
    ``batch_predict(config 5's model, 300000 rows,
    "predict_log_proba")`` equals ``model.predict_log_proba`` within
    1e-6.
20. The tree family's batched paths, the bring-your-own-base forests,
    the bin memos and the host C engine. (a) ``DistGridSearchCV(
    DecisionTreeClassifier(), {"max_depth": [4, 6, 8],
    "min_samples_leaf": [1, 50]}, cv=5)`` on 200000 x 28 rows of phase
    16's balanced problem: every candidate a batched round of five fold
    lanes; K4 launches exactly the levels of the rounds plus the
    refit's; lanes 0 and 3 of the deepest round bitwise their lone fits;
    the (4, 50) candidate's scores on the CPU equal the card's (the cut
    to 1 of 6 candidates is printed); the wall and fits/s beside the
    generic path's on the same grid (a scalar ``sample_weight`` sends
    it there); the pickled search predicts as the live one. (b)
    ``DistOneVsRestClassifier(DecisionTreeClassifier(max_depth=8))`` on
    a 7-class 200000 x 28 tabular target: one batched round of 7 class
    lanes, K4 launches 8 a round, class 0's lane bitwise a lone fit of
    its binary labels, accuracy above the majority share, pickled =
    live. (c) ``DistForestClassifier(DecisionTreeClassifier(
    max_features="sqrt"), n_estimators=32)`` on 25000 rows on the card,
    ``CUDABackend``'s host threads against a serial ``LocalBackend``:
    bitwise the same trees, rows summing to 1, pickled = live. (d) Phase
    6's forest fitted twice under ``CUDABackend(reuse_broadcast=True)``:
    the second fit reads both bin memos and grows bitwise the same
    trees; its wall printed beside phase 6's warm wall. (e) The host C
    engine (built in phase 1 on this machine's host), then a 16-tree
    bootstrapped ``RandomForestClassifier(max_features=None,
    device="cpu")`` on 20000 rows, native against the torch engine: the
    same trees, leaves and seeds, the recorded gains within 1e-5 of the
    largest (float64 in C, float32 in torch).
21. Histogram gradient boosting on K4's Newton channels, and naive
    Bayes. (k) K4 against its plain version at the boosting round's
    shapes: 200000 x 28 bins of 64, channels ``[s*g, s*h, count]`` of
    1, 6, 7 and 48 lanes under cv=3 fold masks, every level of
    ``max_depth=5`` (nl = 1 to 16): the count channel bitwise under its
    ``integer_channels`` proof, the gradient and hessian within the
    float32 summation bound; each level's time beside its bound and
    ``index_add_``'s. (a) ``DistHistGradientBoostingClassifier()`` (the
    JAX package's defaults, early stopping on) on phase 20's 200000 x 28
    problem: K4 launches exactly ``n_iter_ x 5``, a second identical fit
    compared bit for bit (reported), rows summing to 1, pickled = live, a
    profiled 5-round fit (K4 against glue), and 20 rounds on 20000 rows
    on the card against the CPU, within 10x of what one ulp of weight
    noise moves the card's own fit. (b) A 7-class fit on phase 20b's
    problem: 7 trees ride each launch, K4 launches ``n_iter_ x 5``. (c)
    ``DistGridSearchCV`` over 8 log-spaced learning rates x
    ``l2_regularization`` in {0, 1}, cv=3 (48 lanes), ``neg_log_loss``,
    compacted, K4 launches exactly 5 a boosting round of each round of
    lanes plus the refit's; two lanes of a six-lane batch (lambda 0 and
    1) against lone fits within 10x their ulp-noise gap; then
    ``HalvingSpec(eta=3, min_slices=4)`` kills candidates and keeps the
    exhaustive best. (d) The regressor on a regression target of the same X. (e)
    ``batch_predict`` of (a)'s model over 1M rows equals its
    ``predict_proba`` within 1e-6; a GBDT and a GaussianNB fitted by the
    JAX package (``build_tools/torch_reference_models.npz``) converted
    with ``convert.py`` and predicted on the card against the JAX
    package's stored outputs. (f) ``DistGridSearchCV`` over 12
    ``MultinomialNB`` alphas and 12 ``GaussianNB`` var_smoothing values
    at cv=5 on the dense flagship (11314 x 4096, 20 classes), an alpha's
    split scores on the CPU within 1e-5 of the card's, GaussianNB's
    decisions card against CPU within 1e-5 of the largest at the grid's
    best var_smoothing (at the default the comparison is printed: a class
    feature's variance there is float32 residue), and a
    ``DistMultiModelSearch`` of GaussianNB beside LogisticRegression.
22. Feature elimination at BASELINE row 7's covtype shape (581012 x 54,
    7 classes, 14 junk columns; ``examples/eliminate/covtype.py``'s
    generator and settings). (a) ``DistFeatureEliminator(
    LogisticRegression(max_iter=40), min_features_to_select=10, step=4,
    cv=5, scoring="accuracy", partitions=1)``: 12 sets x 5 folds = 60
    masked lanes as one compacted round (the default's 8 rounds of 8
    only multiply the host-paced iterations when every lane runs to
    ``max_iter``): walls of the initial fit, the grid and the refit,
    scores, kept columns, peak memory; three lanes, each run as a round
    of one (a lane's bits depend on its round's shape; a round of all
    three is printed beside them) for 10 iterations: bitwise the round
    over the materialised ``X * fmask``, and against a lone fit of the
    column-dropped X (fold weights) within 10x of what one ulp of random
    input noise moves the lane, masked weights exactly 0; on 3000 rows
    at the default's 8 rounds of 8 (``partitions=8``), the classic path
    bitwise the compacted one, which must have retired a lane before
    ``max_iter`` and merged rounds, and the card against the
    CPU (scores within three flipped test rows a set, the same best set
    or a near tie, refits within 10x of what ulp noise moves the card's);
    pickled = live. (b) The same with ``HalvingSpec(eta=3)`` at the
    default rounds: a rung fires, killed sets score NaN and never win,
    ``rung_`` filled; whether the race keeps the exhaustive best set is
    printed. (c) The eliminator over ``DecisionTreeClassifier(
    max_depth=8)``: K4 under per-lane feature masks, launches exactly 8
    a round plus the initial fit's and the refit's; the round's lanes as
    the eliminator grew them, every one free of masked splits and three
    bitwise their lone fits of the column-zeroed X; K4 at this round's
    shape (T=60, C=8 whole-number channels) bitwise its plain version at
    levels 1, 16 and 128, and its time a level there beside its bound,
    its plain version and its ``index_add_`` yardstick (a sum of calls
    over groups of 12 lanes, each group's result bitwise K4's: the
    round's whole source would take ~60 GB). (d) ``SimpleVoter`` hard and
    soft over a card-fitted LogisticRegression,
    DistRandomForestClassifier and GaussianNB on 20000 rows, each vote
    equal to a numpy recount; pickled = live.
23. Featurisation (BASELINE row 9, ``examples/encoder/basic_usage.py``)
    on 20news-shaped text: 20 classes, each with its own skewed word
    distribution over ~30000 seeded made-up words, lognormal document
    lengths (median and p99 printed); the frames are dicts of columns
    (no pandas on the card's machine). (a) 1000 documents:
    ``Encoderizer`` at sizes small, medium and large, fitted
    unsupervised, then ``DistGridSearchCV(LogisticRegression(
    max_iter=100), {"C": [0.1, 1, 10]}, cv=5, scoring="f1_weighted")``
    on the card over its CSR output, routed packed (K1/K2) or densified
    (``densify.c`` from 2**22 elements) by the port's own rule: steps,
    width, nnz a row, encode wall, route, K1/K2 launches, search wall,
    best score; every score finite, the best above the majority class's
    share, a pickled encoder's ``transform`` equal to the live one's,
    width = the sum of ``transformer_lengths``. (b) 11314 rows with
    every encoder type (text, numeric with None, a 20-value categorical,
    lists, dicts) through ``Encoderizer(size="small")`` (fit and
    transform walls); ``csr_to_dense_f32`` (C) bitwise scipy's
    ``toarray``, both timed; ``TruncatedSVDTransformer(n_components=128)``
    on the card over the densified output against the same fit on the
    CPU and the sparse route (host scipy): singular values within 1e-3
    relative, ``|transform|`` within 1e-2 of its largest;
    ``FastHashingVectorizer`` (C) and the MurmurHash3 C kernel bitwise
    their Python forms on the first 200 documents.
24. Out of core at the main path's width: the 20news-shaped hashed text
    at a million rows (1048576 x 2**18, 40 nonzeros a row, 20 classes)
    as a packed ``ChunkedDataset`` of 16 blocks of 65536 rows. (a) Saved
    to a temporary directory and loaded memory-mapped: every loaded
    block bitwise the in-memory one; one value-and-gradient pass of the
    streamed LogisticRegression objective at a seeded W fed serially and
    pipelined (pinned buffers and a copy stream), bitwise equal, with
    each feed's ``feed_wait_s`` and the share of the feed hidden; K1 and
    K2 once a block a pass. (b) ``LogisticRegression(C=1.0,
    max_iter=50).fit(dataset)`` (a printed cut of 100) on the card
    against the same fit resident on the same rows and a resident fit
    with the weights one ulp off: streamed ``coef_`` within 10x what
    that ulp moves the resident fit, predictions equal on at least
    99.5% of rows (the ulp refit's share printed beside it), K1 and K2
    launches exactly blocks x passes, ``streamed_bytes`` = passes x the
    dataset's bytes, peak device memory under the solver's state plus
    four blocks plus 64 MiB (the resident fit's beside it); walls and
    passes printed. (c) Chunked ``batch_predict(model, dataset,
    "predict_proba")`` bitwise the resident sparse path at
    ``batch_size=65536``, K1 once a block; rows/s of both.

``--candidates N`` cuts the C and alpha grids (and config 2's ``n_iter``)
to their first N points (never the data width); the cut is printed. The compacted path's
out-of-memory downgrade is an error in every phase: the up-front sizing
must hold on the card.

``--ab-sgd DIR`` runs none of the phases above: it times phase 13b's
compacted search (on ``--ab-rows`` rows, 12500 by default) in turns on
the checkout at DIR (a parent commit, unpacked with ``git archive``) and
on this one, ``--pairs`` pairs (default 6) ordered parent, this, this,
parent, one process a run, and
prints each run and every tree's median, least and largest walls; the
runs must agree on epochs and ``best_score_``.

``--profile-config5`` runs none of the phases either: it prints phase
15's split of one warm call (above) and exits. ``--phases-17-19`` builds
the kernels and runs phases 17-19 alone, with no result line;
``--phase-20``, ``--phase-21``, ``--phase-22``, ``--phase-23`` and
``--phase-24`` do the same for phases 20, 21, 22, 23 and 24.

``--ab-row-kernels DIR`` runs none of the phases either: phase 2's
row-kernel readings at the SGD step's shape, a split of the host's
launch path, phase 14d's bare-step split and its fit's wall, in turns on
the checkout at DIR and on this one (``--pairs`` pairs ordered parent,
this, this, parent), one process a run with its own tree's package, and
prints each tree's median, least and largest fit wall.

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
import warnings
from concurrent.futures import ThreadPoolExecutor

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


#: the clock of :func:`lap`: when the previous group of phases ended
_LAP = {"t": None}


def lap(label=None):
    """Print ``label``'s seconds, those since the previous call; with no
    label only restart the clock (after phases that print their own)."""
    now = time.perf_counter()
    if label is not None:
        say(f"{label} seconds: {now - _LAP['t']:.1f}")
    _LAP["t"] = now


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


def host_ms(torch, fn, reps):
    """Host milliseconds a call of ``fn``: ``perf_counter`` over ``reps``
    calls, then one synchronise (``reps`` stays far below the launch
    queue's depth, so the host is never held back by the device)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return ms


def graph_ms(torch, fn, reps, replays=5):
    """Device milliseconds a call of ``fn`` with the host out of the way:
    a CUDA graph of ``reps`` calls replayed ``replays`` times under
    events (the gaps between the graph's launches included). A
    measurement only: the port launches no graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def device_ms(torch, fn, reps):
    """Device milliseconds a call of ``fn`` by ``torch.profiler``: every
    device activity of ``reps`` calls, over ``reps``; None when the
    profiler saw no device time."""
    split = profile_device_split(torch, lambda: [fn() for _ in range(reps)],
                                 {})
    return None if split is None else split["total"] / reps


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


def check_pair(torch, ps, idx, val, p, T, k, seed, label, sliced=False,
               r=None):
    """Hold K1, K2 and the PackedMatvec gradient to their plain versions
    at one shape; returns the largest error seen. ``sliced``: W and r
    are views ``[..., 1:]`` of ``(T, rows, k + 1)`` buffers, a layout
    that rules out the kernels' 16-byte vector form. ``r``: K2's operand
    (and the gradient's upstream), default random normal. Tolerance: each
    output is a sum of c products (c = m for K1, the column's entry
    count for K2), and two f32 sums of the same c terms in different
    orders differ by at most 2 * c * u * sum|terms|."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n, m = idx.shape
    extra = 1 if sliced else 0
    W = torch.randn((T, p, k + extra), generator=g, device="cuda")[..., extra:]
    if r is None:
        r = torch.randn((T, n, k + extra), generator=g,
                        device="cuda")[..., extra:]
    forms = (ps._vector_width(W), ps._vector_width(r))
    if sliced and forms != (1, 1):
        raise AssertionError(f"the sliced operands at {label} would be read "
                             f"as vectors: {forms}")
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
    say(f"  {label}: n={n} m={m} p={p} T={T} k={k} (vector width "
        f"{forms[0]}; {cols.n_segs} K2 segments)  K1 err {e1:.3e} "
        f"(max|out| {float(ref.abs().max()):.3e})  K2 err {e2:.3e} "
        f"(max|out| {float(ref2.abs().max()):.3e}), K2 bitwise repeatable")
    return e1, e2


def segmented_packed(torch, rng, n, p, m):
    """A packed pair that reaches every branch of K2's design: entries on
    columns [0, 100) only, so [100, p - 1) is a stretch of empty columns
    many tiles wide; column 7 in every third row (several segments) and
    column p - 1 in every row (an intercept of n entries, many
    segments)."""
    idx = rng.randint(0, 100, size=(n, m)).astype(np.int32)
    idx[:, 0] = p - 1
    idx[::3, 1] = 7
    val = rng.randn(n, m).astype(np.float32)
    return torch.as_tensor(idx).cuda(), torch.as_tensor(val).cuda()


def time_kernels(torch, ps, idx, val, p, T, k, X_csr):
    """Times at the main path's shape: kernel, plain version and one
    torch.sparse.mm call computing the same function; then what sets
    each kernel's pace: K1 with every entry on one column (each W row it
    reads is then in L2, so the time left is latency and instruction
    throughput), the time to write K2's (T, p, k) output once
    (``zero_``), and K2's device time split between its segment and tile
    passes."""
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
    one = torch.full_like(idx, int(idx[0, 0]))
    t["K1_one_column"] = cuda_ms(torch, lambda: ps.packed_matvec(one, val, W),
                                 10)
    out = torch.empty((T, p, k), device="cuda")
    t["K2_output_write"] = cuda_ms(torch, out.zero_, 10)
    del one, out
    split = profile_device_split(
        torch, lambda: [ps.packed_rmatvec(idx, val, r, p, columns=cols)
                        for _ in range(10)],
        {"segment": ("rmatvec_segment",), "tile": ("rmatvec_tile",)})
    if split is not None:
        t["K2_segment_pass"] = split["segment"] / 10
        t["K2_tile_pass"] = split["tile"] / 10
    nnz = cols.nnz
    distinct = int((cols.col_ptr[1:] > cols.col_ptr[:-1]).sum())
    packed_bytes = n * m * 8
    k1_bytes = packed_bytes + distinct * K * 4 + n * K * 4
    k2_bytes = packed_bytes + n * K * 4 + p * K * 4
    flops = 2 * nnz * K
    say(f"  K2 layout: {nnz} entries, {cols.n_segs} segments of at most "
        f"{ps.SEGMENT_ENTRIES} entries over "
        f"{int((cols.col_seg[1:] > cols.col_seg[:-1]).sum())} long columns")
    return t, bound(k1_bytes, flops), bound(k2_bytes, flops)


def row_case(torch, rng, T, B, p, m, k, integer=False, column=None):
    """Gathered packed rows ``(T, B, m)`` (row 0 of every lane padding
    only, ~30% padding elsewhere), ``W (T, p, k)`` and ``g (T, B, k)``:
    small whole numbers with ``integer``, else normal. ``column``: that
    column in slot 0 of every row (the Zipf head)."""
    idx = rng.randint(0, p, size=(T, B, m)).astype(np.int32)
    if integer:
        val = rng.randint(-3, 4, size=(T, B, m)).astype(np.float32)
        W = rng.randint(-4, 5, size=(T, p, k)).astype(np.float32)
        g = rng.randint(-4, 5, size=(T, B, k)).astype(np.float32)
    else:
        val = rng.randn(T, B, m).astype(np.float32)
        W = rng.randn(T, p, k).astype(np.float32)
        g = rng.randn(T, B, k).astype(np.float32)
    pad = rng.rand(T, B, m) < 0.3
    pad[:, 0] = True
    idx[pad] = 0
    val[pad] = 0.0
    if column is not None:
        idx[:, :, 0] = column
        val[:, :, 0] = np.where(val[:, :, 0] == 0, 1.0, val[:, :, 0])
    return tuple(torch.as_tensor(a).cuda() for a in (idx, val, W, g))


def check_rows(torch, ps, idx, val, W, g, p, integer, label):
    """Hold K1's and K2's row forms to their plain versions at one
    shape; returns the largest errors. Integer data: bitwise. Fractional:
    each output is a sum of c products (c = m for the row matvec, the
    column's entries in the lane's batch for the row rmatvec), held to
    2 * c * u * sum|terms|. Both must repeat bitwise."""
    out = ps.packed_row_matvec(idx, val, W)
    if not torch.equal(out, ps.packed_row_matvec(idx, val, W)):
        raise AssertionError(f"row matvec is not bitwise repeatable at {label}")
    ref = ps.packed_row_matvec_ref(idx, val, W)
    back = ps.packed_row_rmatvec(idx, val, g, p)
    if not torch.equal(back, ps.packed_row_rmatvec(idx, val, g, p)):
        raise AssertionError(f"row rmatvec is not bitwise repeatable at {label}")
    ref2 = ps.packed_row_rmatvec_ref(idx, val, g, p)
    e1 = float((out - ref).abs().max()) if out.numel() else 0.0
    e2 = float((back - ref2).abs().max())
    if integer:
        if not (torch.equal(out, ref) and torch.equal(back, ref2)):
            raise AssertionError(f"row kernels differ from the plain versions "
                                 f"on integer data at {label}: {e1}, {e2}")
    else:
        m = idx.shape[2]
        tol1 = 2 * m * U32 * ps.packed_row_matvec_ref(idx, val.abs(), W.abs())
        counts = ps.packed_row_rmatvec_ref(idx, (val != 0).float(),
                                           torch.ones_like(g), p)
        tol2 = 2 * counts * U32 * ps.packed_row_rmatvec_ref(
            idx, val.abs(), g.abs(), p)
        if not bool(((out - ref).abs() <= tol1).all()):
            raise AssertionError(f"row matvec disagrees at {label}: {e1:.3e}")
        if not bool(((back - ref2).abs() <= tol2).all()):
            raise AssertionError(f"row rmatvec disagrees at {label}: {e2:.3e}")
    T, B, m = idx.shape
    say(f"  rows {label}: T={T} B={B} m={m} p={p} k={W.shape[2]} "
        f"({'integer' if integer else 'fractional'}"
        f"{', shared batch' if T > 1 and idx.stride(0) == 0 else ''}): row "
        f"matvec err {e1:.3e}, row rmatvec err {e2:.3e}, bitwise repeatable")
    return e1, e2


def every_column_case(torch, rng, T, B, p, m, k, shared):
    """Integer rows whose entries touch every column of an odd ``p``
    (``B * (m - 2) >= p``), so every slice edge of the row rmatvec's grid
    is hit (its slice width depends on the lanes a block serves and on
    k), with column 0 and column p - 1 in every row; one batch every
    lane shares (lane stride 0) with ``shared``."""
    lanes = 1 if shared else T
    idx = np.zeros((lanes, B, m), np.int32)
    idx[:, :, 1:-1] = np.stack([rng.permutation(B * (m - 2)) % p
                                for _ in range(lanes)]).reshape(lanes, B, -1)
    idx[:, :, -1] = p - 1
    val = rng.randint(-3, 4, size=(lanes, B, m)).astype(np.float32)
    W = rng.randint(-4, 5, size=(T, p, k)).astype(np.float32)
    g = rng.randint(-4, 5, size=(T, B, k)).astype(np.float32)
    idx, val, W, g = (torch.as_tensor(a).cuda() for a in (idx, val, W, g))
    if shared:
        idx, val = idx.expand(T, -1, -1), val.expand(T, -1, -1)
    return idx, val, W, g


def main_plane(torch, X):
    """The main path's packed plane with the intercept column last, on
    the card: ``(idx, val, p)``."""
    from skdist_tpu_torch import LogisticRegression
    from skdist_tpu_torch.models.linear import prepare_fit_X

    packed = prepare_fit_X(X, LogisticRegression)
    n, d = X.shape
    idx = torch.cat([torch.as_tensor(packed.idx),
                     torch.full((n, 1), d, dtype=torch.int32)], 1).cuda()
    val = torch.cat([torch.as_tensor(packed.val),
                     torch.ones((n, 1), dtype=torch.float32)], 1).cuda()
    return idx, val, d + 1


def sgd_step_rows(torch, idx, val, p, T=20, B=64, k=1):
    """The one-vs-rest SGD step's operands: the SGD operator over the main
    path's rows (it appends the intercept itself), one batch of ``B``
    rows shared by ``T`` lanes gathered by its own ``row_batch`` (lane
    stride 0, as the step reads it), each lane's own rows, ``W (T, p,
    k)`` and ``g (T, B, k)``: ``(shared pair, own pair, W, g)``."""
    from skdist_tpu_torch.sparse import LinearOperator, PackedX

    n = idx.shape[0]
    op = LinearOperator(PackedX(idx[:, :-1], val[:, :-1], p - 1),
                        fit_intercept=True)
    if not (torch.equal(op.pidx, idx) and torch.equal(op.pval, val)):
        raise AssertionError("the SGD operator's packed plane is not phase "
                             "2's")
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = torch.randperm(n, generator=gen, device="cuda")[:B]
    shared = op.row_batch(rows.expand(T, -1))
    W = torch.randn((T, p, k), generator=gen, device="cuda")
    g = torch.randn((T, B, k), generator=gen, device="cuda")
    own = op.row_batch(torch.randint(0, n, (T, B), generator=gen,
                                     device="cuda"))
    return shared, own, W, g


#: the calls timed at the SGD step's shape, each with every clock
ROW_TIMED = ("row_matvec", "row_matvec_library", "row_rmatvec",
             "row_rmatvec_library", "row_rmatvec_library_zeroed",
             "launch_floor")


def time_row_step(torch, ps, si, sv, W, g, p):
    """Times at the SGD step's shape of both row kernels, their plain
    versions and the yardsticks: ``embedding_bag`` (sum mode, the values
    as per-sample weights, over the lanes' flattened (lane, column)
    cells) for the row matvec; one ``index_add_`` of the given products
    into a (T * p, k) plane, alone and after ``zero_`` (the row
    rmatvec's whole function) for the row rmatvec; and the launch floor,
    a one-element ``fill_``. The cells and products are built outside
    the timed calls. Every call of ``ROW_TIMED`` gets four clocks:
    CUDA events over 50 back-to-back calls (``name``), the profiler's
    device time a call (``name_device``), a CUDA graph of 50 calls
    replayed under events (``name_graph``) and the host's time a call
    (``name_host``)."""
    import torch.nn.functional as F

    T, B, m = si.shape
    k = W.shape[2]
    bag_idx = (torch.arange(T, device="cuda")[:, None, None] * p
               + si.long()).reshape(T * B, m)
    bag_w = sv.reshape(T * B, m)
    W_flat = W.reshape(T * p, k)
    bag = F.embedding_bag(bag_idx, W_flat, per_sample_weights=bag_w,
                          mode="sum").reshape(T, B, k)
    tol = 2 * m * U32 * ps.packed_row_matvec_ref(si, sv.abs(), W.abs())
    if not bool(((bag - ps.packed_row_matvec_ref(si, sv, W)).abs()
                 <= tol).all()):
        raise AssertionError("the embedding_bag yardstick disagrees with the "
                             "row matvec's plain version")
    cell = bag_idx.reshape(-1)
    contrib = (sv[..., None] * g[:, :, None, :]).reshape(-1, k)
    plane = torch.zeros((T * p, k), device="cuda")
    tiny = torch.zeros(1, device="cuda")
    calls = {
        "row_matvec": lambda: ps.packed_row_matvec(si, sv, W),
        "row_matvec_library": lambda: F.embedding_bag(
            bag_idx, W_flat, per_sample_weights=bag_w, mode="sum"),
        "row_rmatvec": lambda: ps.packed_row_rmatvec(si, sv, g, p),
        "row_rmatvec_library": lambda: plane.index_add_(0, cell, contrib),
        "row_rmatvec_library_zeroed": lambda: plane.zero_().index_add_(
            0, cell, contrib),
        "launch_floor": lambda: tiny.fill_(0.0),
    }
    t = {}
    for name in ROW_TIMED:
        fn = calls[name]
        t[name] = cuda_ms(torch, fn, 50)
        t[name + "_device"] = device_ms(torch, fn, 50)
        t[name + "_graph"] = graph_ms(torch, fn, 50)
        t[name + "_host"] = host_ms(torch, fn, 200)
    t["row_matvec_plain"] = cuda_ms(
        torch, lambda: ps.packed_row_matvec_ref(si, sv, W), 20)
    t["row_rmatvec_plain"] = cuda_ms(
        torch, lambda: ps.packed_row_rmatvec_ref(si, sv, g, p), 20)
    return t


def row_step_bounds(torch, si, p, k):
    """The row kernels' bounds at the SGD step's shape from these inputs:
    one batch read once, the W rows it references (row matvec) or the
    dense planes written once (row rmatvec), 2 flops an entry."""
    T, B, m = si.shape
    distinct = int(torch.unique(si[0]).numel())
    pair_bytes = B * m * 8
    flops = 2 * T * B * m * k
    return (bound(pair_bytes + T * distinct * k * 4 + T * B * k * 4, flops),
            bound(pair_bytes + T * B * k * 4 + T * p * k * 4, flops))


def say_row_times(t, mv_bound, rmv_bound, label="  "):
    """Print :func:`time_row_step`'s readings, one line a timed call."""
    for name in ROW_TIMED:
        dev = t[name + "_device"]
        say(f"{label}{name}: events {t[name]:.4f} ms, device "
            + ("not measured" if dev is None else f"{dev:.4f} ms")
            + f", graph {t[name + '_graph']:.4f} ms, host "
            f"{t[name + '_host']:.4f} ms")
    say(f"{label}plain versions: row matvec {t['row_matvec_plain']:.4f} ms, "
        f"row rmatvec {t['row_rmatvec_plain']:.4f} ms; bounds: row matvec "
        f"{mv_bound[0]:.5f} ms ({mv_bound[1]}), row rmatvec "
        f"{rmv_bound[0]:.4f} ms ({rmv_bound[1]})")


def phase_row_kernels(torch, ps, idx, val, p):
    """Phase 2's row forms: ragged shapes (T = 1 and T = 300, k from 1 to
    33, a lane of more entries than one block keeps at once), every
    column of an odd p touched (each slice edge of the row rmatvec,
    columns 0 and p - 1) for each lane's own rows and one shared batch,
    an inf and a NaN in g, the Zipf head and column 0; then the one-vs-rest SGD step's shape
    (the main path's rows gathered by the SGD operator's ``row_batch``)
    for each lane's own rows and the shared batch, with a random lane
    permutation that must permute both kernels' outputs bitwise; then
    the times of :func:`time_row_step` beside the bounds."""
    rng = np.random.RandomState(5)
    errs = []
    for (T, B, pp, m, k) in [(1, 37, 53, 5, 3), (3, 64, 300, 1, 1),
                             (300, 16, 900, 7, 1), (4, 64, 2000, 41, 20),
                             (2, 300, 5000, 41, 4), (2, 40, 700, 12, 33)]:
        for integer in (True, False):
            errs.append(check_rows(torch, ps, *row_case(
                torch, rng, T, B, pp, m, k, integer), pp, integer,
                f"ragged T={T}"))
    # one lane whose 12300 entries fall on 40 columns: every slice's
    # kept entries overflow a block's list, taken in chunks
    i_, v_, W_, g_ = row_case(torch, rng, 2, 300, 40, 41, 4, True)
    errs.append(check_rows(torch, ps, i_, v_, W_, g_, 40, True,
                           "12300 entries on 40 columns"))
    for (T, k) in [(1, 1), (20, 1), (20, 4), (6, 20), (3, 33), (300, 1)]:
        for shared in ((False, True) if T > 1 else (False,)):
            errs.append(check_rows(torch, ps, *every_column_case(
                torch, rng, T, 64, 6147, 100, k, shared), 6147, True,
                "every column of p=6147"))
    # an inf and a NaN in g: the padding's zero values then put NaN on
    # column 0, as in the plain version (the row rmatvec leaves zero
    # values out only when every g it stages is finite)
    i_, v_, _W, g_ = row_case(torch, rng, 6, 64, 300, 9, 2, True)
    g_[2, 5, 1], g_[4, 0, 0] = float("inf"), float("nan")
    back = ps.packed_row_rmatvec(i_, v_, g_, 300)
    ref = ps.packed_row_rmatvec_ref(i_, v_, g_, 300)
    if not (bool(ref.isnan().any())
            and torch.equal(back.isnan(), ref.isnan())
            and torch.equal(back.nan_to_num(0.0, 1.0, -1.0),
                            ref.nan_to_num(0.0, 1.0, -1.0))):
        raise AssertionError("row rmatvec differs from its plain version "
                             "with an inf and a NaN in g")
    say(f"  rows inf and NaN in g: row rmatvec equals its plain version, "
        f"{int(ref.isnan().sum())} NaN outputs in the same places")
    for column in (7, 0):
        for integer in (True, False):
            i_, v_, W_, g_ = row_case(torch, rng, 6, 64, 400, 9, 2, integer,
                                      column=column)
            if column == 0:
                i_.zero_()
            errs.append(check_rows(torch, ps, i_, v_, W_, g_, 400, integer,
                                   f"every row on column {column}"))
    k = 1
    (si, sv), own, W, g = sgd_step_rows(torch, idx, val, p, k=k)
    errs.append(check_rows(torch, ps, *own, W, g, p, False,
                           "SGD step shape, own rows"))
    errs.append(check_rows(torch, ps, si, sv, W, g, p, False,
                           "SGD step shape, shared batch"))
    perm = torch.as_tensor(rng.permutation(W.shape[0])).cuda()
    for label, (pi, pv) in (("own rows", own), ("shared batch", (si, sv))):
        same = (torch.equal(ps.packed_row_matvec(pi, pv, W)[perm],
                            ps.packed_row_matvec(pi[perm], pv[perm], W[perm]))
                and torch.equal(ps.packed_row_rmatvec(pi, pv, g, p)[perm],
                                ps.packed_row_rmatvec(pi[perm], pv[perm],
                                                      g[perm], p)))
        say(f"  rows SGD step shape, {label}: a lane permutation permutes "
            "both outputs " + ("bitwise" if same else "NOT bitwise"))
        if not same:
            raise AssertionError(f"a row kernel's lane bits depend on its "
                                 f"slot ({label})")
    t = time_row_step(torch, ps, si, sv, W, g, p)
    mv_bound, rmv_bound = row_step_bounds(torch, si, p, k)
    T, B, m = si.shape
    say(f"  SGD step shape T={T} B={B} m={m} p={p} k={k}, shared batch:")
    say_row_times(t, mv_bound, rmv_bound, "    ")
    say(f"  row matvec against embedding_bag (flat cells given): "
        f"{t['row_matvec'] / t['row_matvec_library']:.2f}x events, "
        f"{t['row_matvec_graph'] / t['row_matvec_library_graph']:.2f}x graph; "
        f"row rmatvec against zero_ + index_add_ (products given): "
        f"{t['row_rmatvec'] / t['row_rmatvec_library_zeroed']:.2f}x events, "
        f"{t['row_rmatvec_graph'] / t['row_rmatvec_library_zeroed_graph']:.2f}"
        "x graph")
    return errs, t, mv_bound, rmv_bound


# ---------------------------------------------------------------------------
# phases 5-8: K4 and the forest path
# ---------------------------------------------------------------------------

#: BASELINE config 4 (benchmarks/run_all.py config_4_forest)
FOREST = dict(n_estimators=256, max_depth=8, n_bins=32, max_features="sqrt",
              random_state=0)
FOREST_N, FOREST_D = 200_000, 28


def check_k4(torch, kh, Xs, Xb, key, Y, nl, B, label, proof=True):
    """Hold K4 to its plain version at one shape; returns the largest
    error and the channels held bitwise. ``Xs`` is the bin layout K4 is
    given, ``Xb`` the int32 bins of
    the plain version; with ``proof`` K4 gets ``integer_channels(Y)``.
    Channels of whole numbers (sums below 2**24) sum exactly in float32 and
    in int32: there K4 must equal the plain version bitwise and repeat
    bitwise, with or without the proof. Other channels: an entry sums c
    terms (c = its sample count), and two float32 sums of them in
    different orders differ by at most 2 * c * u * sum|terms|."""
    whole = kh.integer_channels(Y)
    mask = whole.mask if whole is not None else 0
    given = whole if proof else None
    out = kh.level_histogram(Xs, key, Y, nl, B, integer=given)
    again = kh.level_histogram(Xs, key, Y, nl, B, integer=given)
    ref = kh.level_histogram_ref(Xb, key, Y, nl, B)
    err = float((out - ref).abs().max())
    C = Y.shape[-1]
    exact = [c for c in range(C) if mask >> c & 1]
    rest = [c for c in range(C) if not mask >> c & 1]
    if exact and not (torch.equal(out[..., exact], ref[..., exact])
                      and torch.equal(again[..., exact], out[..., exact])):
        raise AssertionError(f"K4 is not bitwise equal and repeatable on "
                             f"integer channels {exact} at {label}: max err "
                             f"{err:.3e}")
    if rest:
        cnt = kh.level_histogram_ref(Xb, key, torch.ones_like(Y[..., :1]),
                                     nl, B)
        tol = 2 * cnt * U32 * kh.level_histogram_ref(Xb, key, Y[..., rest].abs(),
                                                     nl, B)
        for res in (out, again):
            if not bool(((res[..., rest] - ref[..., rest]).abs() <= tol).all()):
                raise AssertionError(
                    f"K4 disagrees at {label}: max err "
                    f"{float((res - ref).abs().max()):.3e}")
    return err, exact


def k4_bound(key, Xs, C, nl, B, d):
    """(least ms, what bounds it) of one K4 launch on these inputs: every
    key, the channels of the samples at the level (K4 reads no other),
    the bins as given and the output, each moved once; one add per
    channel of every (sample at the level, feature) at the fp32 peak."""
    T, n = key.shape
    live = int(((key >= 0) & (key < nl)).sum())
    moved = (T * n * 4 + live * C * 4 + n * d * Xs.element_size()
             + T * d * nl * B * C * 4)
    return bound(moved, live * d * C)


def k4_layouts(torch, kh, Xb, B):
    """The bin layouts K4 takes, each a branch of its design: uint8 rows
    padded to 16 bytes (what trees pass: 16-byte loads), unpadded uint8
    rows and feature-major uint8 (one scalar load a feature), int32 rows
    and an int32 view sliced out of a wider array (strides)."""
    out = {"int32 rows": Xb}
    if B <= 255:
        out["uint8 rows padded"] = kh.kernel_bins(Xb, B)
        u8 = torch.where((Xb >= 0) & (Xb < B), Xb, 255).to(torch.uint8)
        out["uint8 rows"] = u8
        out["uint8 feature-major"] = u8.t().contiguous().t()
    wide = torch.zeros((Xb.shape[0], Xb.shape[1] + 3), dtype=torch.int32,
                       device=Xb.device)
    wide[:, 2:2 + Xb.shape[1]] = Xb
    out["int32 sliced"] = wide[:, 2:2 + Xb.shape[1]]
    return out


def k4_yardstick(torch, Xb, key, Y, nl, B, src):
    """K4's function as one PyTorch call, ``index_add_``, into a
    ``(T*d*(nl*B+1), C)`` buffer whose last slot of every (tree, feature)
    absorbs samples off the level; the index over (tree, feature, sample)
    is built here, outside the timed call, as torch.sparse.mm's operand is
    for K1 and K2. ``src`` is the channels repeated for every feature.
    Returns (call, its result as (T, d, nl, B, C)). The port never calls
    it."""
    T, n = key.shape
    d, C, S = Xb.shape[1], Y.shape[-1], nl * B + 1
    idx = torch.empty((T, d, n), dtype=torch.int32, device=Xb.device)
    xt = Xb.t().long()
    for t0 in range(0, T, 16):
        k = key[t0:t0 + 16].long()
        valid = ((k >= 0) & (k < nl))[:, None, :]
        ok = valid & (xt >= 0)[None] & (xt < B)[None]
        slot = torch.where(ok, k[:, None, :] * B + xt[None], S - 1)
        tf = (torch.arange(t0, min(T, t0 + 16), device=Xb.device)[:, None] * d
              + torch.arange(d, device=Xb.device)[None])
        idx[t0:t0 + 16] = (slot + (tf * S)[..., None]).to(torch.int32)
    idx = idx.reshape(-1)
    buf = torch.zeros((T * d * S, C), dtype=torch.float32, device=Xb.device)

    def call():
        buf.zero_()
        buf.index_add_(0, idx, src)

    def result():
        return buf.reshape(T, d, S, C)[:, :, :S - 1].reshape(T, d, nl, B, C)

    return call, result


def phase_k4(torch, X, y):
    """Phase 5: K4 against its plain version at ragged shapes, at every
    branch of its design and at every level of the forest, then its times
    there beside the bound, the plain version and the index_add_ yardstick.
    Returns (max error, times, bound at the deepest level)."""
    import torch.nn.functional as F

    from skdist_tpu_torch.models.tree import classification_channels
    from skdist_tpu_torch.ops import hist as kh
    from skdist_tpu_torch.ops.binning import apply_bins, quantile_bin_edges
    from skdist_tpu_torch.utils import draws

    say("phase 5: K4 level_histogram against plain PyTorch on the card")
    errs = []

    def channel_sets(g, T, n, C):
        Yi = torch.randint(0, 3, (T, n, C), generator=g, device="cuda").float()
        Yf = torch.rand((T, n, C), generator=g, device="cuda")
        Ym = Yi.clone()
        Ym[..., 0] = Yf[..., 0]  # channel 0 fractional, the rest integer
        return {"integer": Yi, "fractional": Yf, "mixed": Ym}

    for i, (T, n, d, nl, B, C) in enumerate([
            (1, 37, 3, 3, 4, 3), (3, 1001, 5, 1, 32, 4),
            (2, 5003, 7, 128, 32, 3), (4, 3001, 3, 3, 256, 4),
            (5, 10007, 28, 128, 32, 3)]):
        g = torch.Generator(device="cuda").manual_seed(i)
        Xb = torch.randint(0, B, (n, d), generator=g, device="cuda",
                           dtype=torch.int32)
        if B < 255:
            Xb[::7, 0] = B + 3  # a bin outside [0, B) adds nothing
        # a third of the keys past nl: samples not at this level
        key = torch.randint(0, nl + max(1, nl // 2), (T, n), generator=g,
                            device="cuda", dtype=torch.int32)
        layouts = k4_layouts(torch, kh, Xb, B)
        case = []
        for name, Y in channel_sets(g, T, n, C).items():
            for lay, Xs in layouts.items():
                case.append(check_k4(torch, kh, Xs, Xb, key, Y, nl, B,
                                     f"ragged case {i}, {name}, {lay}"))
        errs += [e for e, _ in case]
        say(f"  ragged case {i}: T={T} n={n} d={d} nl={nl} B={B} C={C}, "
            f"{len(layouts)} bin layouts ({', '.join(layouts)}) x integer, "
            f"fractional, mixed channels: max err "
            f"{max(e for e, _ in case):.3e}; whole channels bitwise equal "
            f"and repeatable")

    # each branch of the design: lane-private copies (float cells, all
    # lanes on one node at nl = 1 and 2) with the sample axis cut into
    # chunks flushed by global atomics; every feature with node blocks;
    # feature groups with every node; one feature and node blocks; more
    # than 4 channels (read per update)
    for label, (T, n, d, nl, B, C, node) in {
            "copies, one node of nl=1, chunked flush": (2, 70001, 28, 1, 32, 3, 0),
            "copies, one node of nl=2, chunked flush": (2, 70001, 28, 2, 32, 3, 1),
            "every feature, node blocks": (2, 20011, 3, 128, 256, 4, None),
            "feature groups, every node": (2, 20011, 60, 2, 256, 4, None),
            "one feature, node blocks": (2, 20011, 60, 128, 256, 4, None),
            "11 channels": (3, 3001, 4, 5, 16, 11, None)}.items():
        g = torch.Generator(device="cuda").manual_seed(n + d)
        Xb = torch.randint(0, B, (n, d), generator=g, device="cuda",
                           dtype=torch.int32)
        if node is None:
            key = torch.randint(0, nl + 1, (T, n), generator=g, device="cuda",
                                dtype=torch.int32)
        else:
            key = torch.full((T, n), node, dtype=torch.int32, device="cuda")
        layouts = k4_layouts(torch, kh, Xb, B)
        Xs = layouts.get("uint8 rows padded", Xb)
        case = [check_k4(torch, kh, Xs, Xb, key, Y, nl, B, f"{label}, {name}")
                for name, Y in channel_sets(g, T, n, C).items()]
        case.append(check_k4(torch, kh, Xs, Xb, key,
                              channel_sets(g, T, n, C)["integer"], nl, B,
                              f"{label}, integer, no proof", proof=False))
        errs += [e for e, _ in case]
        say(f"  {label}: T={T} n={n} d={d} nl={nl} B={B} C={C}, bins "
            f"{Xs.dtype} strides {tuple(Xs.stride())}, integer (with and "
            f"without the proof), fractional, mixed channels: max err "
            f"{max(e for e, _ in case):.3e}; whole channels bitwise equal "
            f"and repeatable")

    # every level of the forest on the real data: binned X in the layout
    # trees pass (uint8 rows padded to 16 bytes), bootstrap channels of 256
    # trees, random keys with the zero-weight samples folded out as trees
    # fold them; integer channels with their proof (the forest's path) and
    # fractional ones (weights 1.3 / 0.7 by class: channel 0 and 1
    # fractional, the count channel integer)
    T, (n, d), B, C, D = 256, X.shape, FOREST["n_bins"], 3, FOREST["max_depth"]
    edges = quantile_bin_edges(X, B)
    Xb = apply_bins(torch.as_tensor(X).cuda(), edges)
    Xs = kh.kernel_bins(Xb, B)
    seeds = torch.arange(T, device="cuda")
    counts = draws.bootstrap_counts(seeds, n)
    y_t = torch.as_tensor(y).cuda()
    Yi = classification_channels(y_t, counts, 2)
    Yf = classification_channels(
        y_t, counts * torch.where(y_t == 1, 1.3, 0.7)[None], 2)
    pi, pf = kh.integer_channels(Yi), kh.integer_channels(Yf)
    live = counts > 0
    src = Yi[:, None].expand(T, d, n, C).reshape(-1, C)  # the yardstick's
    g = torch.Generator(device="cuda").manual_seed(9)
    times = {"per_level": {}}
    for level in range(D):
        nl = 2 ** level
        key = torch.randint(0, nl, (T, n), generator=g, device="cuda",
                            dtype=torch.int32)
        key = torch.where(live, key, nl).to(torch.int32)
        (ei, xi), (ef, xf) = (check_k4(torch, kh, Xs, Xb, key, Y, nl, B,
                                       f"forest level {level}")
                              for Y in (Yi, Yf))
        errs += [ei, ef]
        say(f"  forest level {level} (nl={nl}): integer channels {xi} bitwise "
            f"equal and repeatable (err {ei:.3e}); fractional: channels "
            f"{xf} bitwise, max err {ef:.3e}")
        k4_int = cuda_ms(torch, lambda: kh.level_histogram(
            Xs, key, Yi, nl, B, integer=pi), 5)
        k4_frac = cuda_ms(torch, lambda: kh.level_histogram(
            Xs, key, Yf, nl, B, integer=pf), 5)
        lib_call, lib_result = k4_yardstick(torch, Xb, key, Yi, nl, B, src)
        lib_ms = cuda_ms(torch, lib_call, 2)
        if not torch.equal(lib_result(), kh.level_histogram_ref(
                Xb, key, Yi, nl, B)):
            raise AssertionError(f"the index_add_ yardstick disagrees with "
                                 f"K4's plain version at nl={nl}")
        del lib_call, lib_result
        times["per_level"][nl] = {
            "ms": k4_int, "frac_ms": k4_frac, "library_ms": lib_ms,
            "bound_ms": k4_bound(key, Xs, C, nl, B, d)}
    del src
    torch.cuda.empty_cache()
    deepest = times["per_level"][2 ** (D - 1)]
    times["K4"], times["K4_library"] = deepest["ms"], deepest["library_ms"]
    nl = 2 ** (D - 1)
    times["K4_plain"] = cuda_ms(
        torch, lambda: kh.level_histogram_ref(Xb, key, Yi, nl, B), 2)

    # the JAX package's accelerator default, the "matmul" engine, at the
    # largest tree count whose (n, nl*C) factor fits half of free memory
    XohT = F.one_hot(Xb.long(), B).float().reshape(n, d * B).T
    per_tree = n * nl * 4 * (2 * C + 1)
    free, _ = torch.cuda.mem_get_info()
    Tm = max(1, min(T, int(0.5 * free) // per_tree))

    def matmul_engine():
        level_oh = F.one_hot(key[:Tm].long(), nl + 1)[..., :nl].float()
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
    say("  K4 ms per level (T=256, n=200000, d=28, B=32, C=3; uint8 rows, "
        "zero weights folded out of the keys):")
    for k, v in times["per_level"].items():
        b_ms, b_by = v["bound_ms"]
        say(f"    nl={k}: integer channels {v['ms']:.3f} ms, fractional "
            f"{v['frac_ms']:.3f} ms, bound {b_ms:.3f} ms ({b_by}; "
            f"{v['ms'] / b_ms:.1f}x), index_add_ {v['library_ms']:.3f} ms "
            f"({v['library_ms'] / v['ms']:.1f}x K4)")
    total = sum(v["ms"] for v in times["per_level"].values())
    total_frac = sum(v["frac_ms"] for v in times["per_level"].values())
    say(f"  the 8 levels: integer channels {total:.3f} ms, fractional "
        f"{total_frac:.3f} ms, bound "
        f"{sum(v['bound_ms'][0] for v in times['per_level'].values()):.3f} ms"
        f", index_add_ "
        f"{sum(v['library_ms'] for v in times['per_level'].values()):.3f} ms")
    say(f"  deepest level: K4 {times['K4']:.3f} ms, plain "
        f"{times['K4_plain']:.3f} ms, matmul engine "
        f"{times['matmul_engine_per_tree']:.3f} ms per tree (timed at "
        f"{Tm} trees; x256 = {256 * times['matmul_engine_per_tree']:.3f} ms)")
    return max(errs), times, deepest["bound_ms"]


def profile_device_split(torch, fn, kernels, top=0, window=False, big=None):
    """Device time of one call of ``fn`` under torch.profiler, in ms:
    ``total`` (every device activity) and, for each name of ``kernels``
    (``{name: substrings}``), the device activities whose name holds one
    of its substrings (the first name that matches takes it); with
    ``top``, also ``top_rest``: the ``top`` largest activities that no
    name took, as (name, ms); with ``window``, also ``window``: (busy,
    span), the union of the device activities' intervals and the trace's
    span from its first to its last activity, host or device, both read
    from this one trace; with ``big`` (a count of elements), also
    ``big``: the device time launched by the PyTorch operators that take
    a tensor of ``big`` elements or more (their recorded input shapes).
    None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=big is not None) as prof:
        fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(["total", *kernels], 0.0)
    rest = []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        out["total"] += us / 1e3
        for name, subs in kernels.items():
            if any(sub in ev.key for sub in subs):
                out[name] += us / 1e3
                break
        else:
            rest.append((ev.key, us / 1e3))
    if out["total"] <= 0:
        return None
    if top:
        out["top_rest"] = sorted(rest, key=lambda kv: -kv[1])[:top]
    if window:
        events = prof.events()
        on_device = sorted(
            (ev.time_range.start, ev.time_range.end) for ev in events
            if ev.device_type == torch.autograd.DeviceType.CUDA)
        busy, reached = 0.0, -math.inf
        for lo, hi in on_device:
            if hi > reached:
                busy += hi - max(lo, reached)
                reached = hi
        span = (max(ev.time_range.end for ev in events)
                - min(ev.time_range.start for ev in events))
        out["window"] = (busy / 1e3, span / 1e3)
    if big is not None:
        out["big"] = 0.0
        for ev in prof.key_averages(group_by_input_shape=True):
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                continue
            shapes = [s for s in (ev.input_shapes or [])
                      if isinstance(s, list) and s
                      and all(isinstance(d, int) for d in s)]
            if any(math.prod(s) >= big for s in shapes):
                us = getattr(ev, "self_device_time_total", None)
                if us is None:
                    us = ev.self_cuda_time_total
                out["big"] += us / 1e3
    return out


#: L-BFGS iterations of the profiled LogReg round (the grid runs 100)
ROUND_ITERS = 20

#: the warning of the compacted path's out-of-memory downgrade; it is an
#: error here, since the up-front sizing must hold on the card
OOM_DOWNGRADE = "compacted iterative dispatch exhausted device memory"


def lane_readout(st):
    """A compacted run's scheduler and lane counts, on one line."""
    n_iter = np.asarray(st["lane_n_iter"])
    med, p90 = np.percentile(n_iter, [50, 90])
    carried, used = st["lane_iters_carried"], st["lane_iters_used"]
    return (
        f"{st['mode']}, regime {st['regime']}, chunk {st['chunk']}, pool "
        f"{st['pool_rounds']} round(s), slices {st['slices']}, refills "
        f"{st['refills']} ({st['refilled_lanes']} lanes), compactions "
        f"{st['compactions']}; lane n_iter min {n_iter.min()} median "
        f"{med:.0f} p90 {p90:.0f} max {n_iter.max()}; at max_iter "
        f"{st['lanes_max_iter']}, stalled {st['lanes_stalled']}, converged "
        f"{st['lanes_converged']}, rung-killed {st['retired_rung']}; "
        f"lane-iterations carried {carried} vs used {used} "
        f"({carried / max(used, 1):.2f}x)")


def differing_columns(a, b):
    """The ``cv_results_`` columns (all but times and params) in which
    two searches differ in any bit."""
    return [c for c in a.cv_results_ if c != "params" and "_time" not in c
            and not np.array_equal(np.asarray(a.cv_results_[c]),
                                   np.asarray(b.cv_results_[c]))]


def fit_grid(torch, X, y, Cs, backend, compaction=True, **kw):
    """A timed ``DistGridSearchCV(LogisticRegression(max_iter=100))`` of
    the main path's form, with the compacted path on or off; returns the
    search and its wall."""
    from skdist_tpu_torch import DistGridSearchCV, LogisticRegression

    os.environ["SKDIST_COMPACTION"] = "1" if compaction else "0"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs = DistGridSearchCV(
            LogisticRegression(max_iter=100), {"C": Cs}, cv=5,
            scoring="f1_weighted", backend=backend, **kw,
        ).fit(X, y)
        torch.cuda.synchronize()
        return gs, time.perf_counter() - t0
    finally:
        del os.environ["SKDIST_COMPACTION"]


def capped_backend(cap):
    """A ``CUDABackend`` whose rounds hold at most ``cap`` tasks, as if
    the card's memory held no more: the compacted path's refill regime
    at a cut size."""
    from skdist_tpu_torch import CUDABackend

    class CappedBackend(CUDABackend):
        def round_cap(self, *args, **kw):
            got = super().round_cap(*args, **kw)
            return got if got is None else min(got, cap)

    return CappedBackend()


def phase_sparse_ab(torch, X, y, Cs):
    """Phase 3b: the sparse grid cut to 12 C (the first 12 of phase 3's)
    x 5 folds, 60 fits in two rounds of 30 on a backend whose rounds hold
    at most 30 tasks (so the two do not fit at once), classic against
    compacted at equal chunk, in one process: ``cv_results_`` and the
    refit ``coef_`` must be bitwise equal, the card's proof that a lane's
    bits do not depend on its slot at the main path's shapes (the refill
    regime restarts lanes in any freed slot)."""
    Cs_ab = Cs[:12]
    n_fits = 5 * len(Cs_ab)
    backend = capped_backend(n_fits // 2)
    say(f"phase 3b: sparse grid, {len(Cs_ab)} C x 5 folds = {n_fits} fits, "
        "compacted against classic at equal chunk")
    say(f"CUT: phase 3b runs {len(Cs_ab)} of its 24 C, on a backend whose "
        f"rounds hold at most {n_fits // 2} tasks")
    comp, wall_c = fit_grid(torch, X, y, Cs_ab, backend, partitions=2)
    st = comp.round_stats_[0]
    say(f"  compacted wall {wall_c:.1f}s: " + lane_readout(st))
    if st["refills"] < 1 or st["lanes_stalled"] + st["lanes_converged"] < 1:
        raise AssertionError(
            f"phase 3b: refills {st['refills']}, lanes retired before "
            f"max_iter {st['lanes_stalled'] + st['lanes_converged']}: the "
            "refill regime's slot reuse went untested")
    classic, wall_k = fit_grid(torch, X, y, Cs_ab, backend,
                               compaction=False, partitions=2)
    sk = classic.round_stats_[0]
    say(f"  classic wall {wall_k:.1f}s: {sk['rounds']} rounds x "
        f"{sk['tasks_per_round']} tasks")
    if sk["tasks_per_round"] != st["chunk"]:
        raise AssertionError(
            f"unequal chunks: classic {sk['tasks_per_round']}, compacted "
            f"{st['chunk']}")
    diff = differing_columns(comp, classic)
    if diff or not np.array_equal(comp.best_estimator_.coef_,
                                  classic.best_estimator_.coef_):
        raise AssertionError(
            f"compacted and classic differ: columns {diff}, refit coef_ "
            f"max|d| {np.abs(comp.best_estimator_.coef_ - classic.best_estimator_.coef_).max():.3e}")
    say("  cv_results_ and the refit coef_ bitwise equal")


def phase_asha(torch, Xd, yd, Cs, backend, exhaustive):
    """Phase 4b: ASHA on the dense headline. ``eta=inf`` must give
    phase 4's compacted ``cv_results_`` bitwise; then ``eta=3``: its
    wall, its kills at each rung, its winner beside the exhaustive
    grid's, and the lanes retired by rung against by convergence."""
    from skdist_tpu_torch.distribute.adaptive import (
        HalvingSpec,
        RungKilledWarning,
    )

    say("phase 4b: adaptive (ASHA) search on the dense headline")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ginf, wall_inf = fit_grid(torch, Xd, yd, Cs, backend, partitions=1,
                                  adaptive=HalvingSpec(eta=float("inf")))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RungKilledWarning)
            g3, wall3 = fit_grid(torch, Xd, yd, Cs, backend, partitions=1,
                                 adaptive=HalvingSpec(eta=3))
    for w in caught:
        if "could not engage" in str(w.message) or \
                OOM_DOWNGRADE in str(w.message):
            raise AssertionError(f"phase 4b: {w.message}")
    si = ginf.round_stats_[0]
    diff = differing_columns(exhaustive, ginf)
    say(f"  eta=inf wall {wall_inf:.1f}s, {len(si['rung_history'])} rungs "
        f"scored, regime {si['regime']}; cv_results_ against phase 4: "
        + ("bitwise equal" if not diff else f"differ in {diff}"))
    if diff:
        raise AssertionError("eta=inf differs from adaptive=None")
    s3 = g3.round_stats_[0]
    rungs = np.asarray(g3.cv_results_["rung_"])
    say(f"  eta=3 wall {wall3:.1f}s (eta=inf {wall_inf:.1f}s); kills: "
        + ", ".join(
            f"rung {h['rung']} slice {h['slice']}: {h['n_killed']} of "
            f"{h['n_live']} lanes" for h in s3["rung_history"]
            if h["n_killed"] or h["rung"] < 3))
    say(f"  candidates killed {int((rungs >= 0).sum())} of {len(rungs)}; "
        f"lanes retired by rung {s3['retired_rung']}, by convergence "
        f"{s3['retired_convergence']}; " + lane_readout(s3))
    rank = exhaustive.cv_results_["rank_test_score"][g3.best_index_]
    say(f"  best_params_ {g3.best_params_} best_score_ {g3.best_score_:.6f}"
        f" (rank {rank} of the exhaustive grid); exhaustive "
        f"{exhaustive.best_params_} {exhaustive.best_score_:.6f}")
    if s3["retired_rung"] <= 0:
        raise AssertionError("eta=3 killed no lane")
    if not np.isfinite(g3.best_score_):
        raise AssertionError("eta=3 has no finite best_score_")


def profile_logreg_round(torch, X, y, Cs, tasks_per_round, backend):
    """Phase 3's split of one round of the sparse grid: as many C values
    as fill a round over 5 folds, ``max_iter`` cut to ROUND_ITERS, fitted
    once alone (host wall) and once under torch.profiler (device time in
    K1, K2 and the rest). The busy share is the union of the device's
    activities over the profiled trace's span, both from that one run
    (the profiler's own host cost is inside the span); the device time
    over the unprofiled wall is printed beside it as an estimate drawn
    from two runs."""
    from skdist_tpu_torch import DistGridSearchCV, LogisticRegression
    from skdist_tpu_torch.ops import packed_sparse as ps

    lanes = max(1, tasks_per_round // 5)

    def one_round():
        # partitions=1: the compacted path with one chunk of every task
        gs = DistGridSearchCV(
            LogisticRegression(max_iter=ROUND_ITERS), {"C": Cs[:lanes]},
            cv=5, refit=False, scoring="f1_weighted", backend=backend,
            partitions=1,
        ).fit(X, y)
        torch.cuda.synchronize()
        return gs

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gs = one_round()
    wall = time.perf_counter() - t0
    st = gs.round_stats_[0]
    ps.packed_matvec.launches = ps.packed_rmatvec.launches = 0
    t0 = time.perf_counter()
    split = profile_device_split(torch, one_round, {
        "K1": ("packed_matvec_kernel",), "K2": ("packed_rmatvec",)}, top=8,
        window=True)
    t_prof = time.perf_counter() - t0
    if split is None:
        say("  profiler: no device time recorded (round split not measured)")
        return
    total = split["total"]
    busy, span = split["window"]
    rest = total - split["K1"] - split["K2"]
    say(f"  one round of {st['tasks_per_round']} tasks ({lanes} C x 5 folds, "
        f"max_iter={ROUND_ITERS}, {st['mode']}, {st['regime']}, "
        f"{st['slices']} slices): wall {wall:.3f} s "
        f"alone, {t_prof:.3f} s under the profiler; device {total:.1f} ms = "
        f"K1 {split['K1']:.1f} ms ({100 * split['K1'] / total:.1f}%, "
        f"{ps.packed_matvec.launches} launches), K2 {split['K2']:.1f} ms "
        f"({100 * split['K2'] / total:.1f}%, {ps.packed_rmatvec.launches} "
        f"launches), rest {rest:.1f} ms ({100 * rest / total:.1f}%)")
    say(f"  device busy {busy:.1f} ms of the profiled trace's {span:.1f} ms "
        f"({100 * busy / span:.1f}%, idle {span - busy:.1f} ms), one run; "
        f"estimate from two runs: device time over the unprofiled wall "
        f"{100 * total / (1e3 * wall):.1f}%")
    say("  largest of the rest: " + "; ".join(
        f"{name[:70]} {ms:.1f} ms" for name, ms in split["top_rest"]))


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
        backend=backend, **FOREST).fit(X, y), {"K4": ("level_histogram",)})
    t_prof = time.perf_counter() - t0
    if split is None:
        say("  profiler: no device time recorded (split not measured)")
    else:
        total, k4 = split["total"], split["K4"]
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


# ---------------------------------------------------------------------------
# phases 9-11: K3 and the ridge path
# ---------------------------------------------------------------------------

#: the ridge path's hashed-text width: one lane's (p, p) gram is 1.07 GB
RIDGE_D = 2 ** 14

#: alphas of phase 10's profiled round (x 5 folds): a round of 60 lanes
#: took 53 s under the profiler
RIDGE_PROFILE_ALPHAS = 2


def hold_k3(torch, ps, out, idx, val, sw, p, label, lanes=None):
    """Hold K3's output ``out`` to its plain version, lane by lane over
    ``lanes`` (default all); returns (largest error, largest |out|,
    whether the data is integer). Each K3 term is bitwise the plain
    version's term, so integer data must give the plain gram exactly;
    fractional data is held to 2 * c * u * sum|terms| (c = the cell's
    pair count). One lane's reference and tolerance are held at a time,
    so a whole round's output fits beside them."""
    integer = bool(torch.equal(val, torch.round(val))
                   and torch.equal(sw, torch.round(sw)))
    sw2 = sw if sw.ndim == 2 else sw[None]
    out2 = out if out.ndim == 3 else out[None]
    err = scale = 0.0
    count = None
    for t in (range(sw2.shape[0]) if lanes is None else lanes):
        ref = ps.packed_weighted_gram_ref(idx, val, sw2[t], p)
        scale = max(scale, float(ref.abs().max()))
        if integer:
            if not torch.equal(out2[t], ref):
                raise AssertionError(
                    f"K3 is not bitwise equal to its plain version on "
                    f"integer data at {label}, lane {t}: max err "
                    f"{float((out2[t] - ref).abs().max()):.3e}")
            del ref
            continue
        diff = out2[t] - ref
        del ref
        diff.abs_()
        err = max(err, float(diff.max()))
        if count is None:
            count = ps.packed_weighted_gram_ref(
                idx, (val != 0).float(), torch.ones_like(sw2[t]), p)
            count *= 2 * U32
        tol = ps.packed_weighted_gram_ref(idx, val.abs(), sw2[t].abs(), p)
        tol *= count
        bad = int((diff > tol).sum())
        del diff, tol
        if bad:
            raise AssertionError(f"K3 disagrees at {label}, lane {t}, in "
                                 f"{bad} cells: max err {err:.3e}")
    del count
    torch.cuda.empty_cache()
    return err, scale, integer


def check_k3(torch, ps, idx, val, sw, p, label, pairs=None):
    """Hold K3 to its plain version at one shape (:func:`hold_k3`), and
    two launches to each other, bitwise; returns the largest error."""
    out = ps.packed_weighted_gram(idx, val, sw, p, pairs=pairs)
    again = ps.packed_weighted_gram(idx, val, sw, p, pairs=pairs)
    if not torch.equal(out, again):
        raise AssertionError(f"K3 is not bitwise repeatable at {label}")
    del again
    err, scale, integer = hold_k3(torch, ps, out, idx, val, sw, p, label)
    del out
    torch.cuda.empty_cache()
    n, m = idx.shape
    T = 1 if sw.ndim == 1 else sw.shape[0]
    say(f"  {label}: n={n} m={m} p={p} T={T} "
        f"{'integer' if integer else 'fractional'} data: max err {err:.3e} "
        f"(max|out| {scale:.3e}), bitwise repeatable"
        + (", bitwise equal" if integer else ""))
    return err


def k3_bound(idx, val, sw, p, n_pairs):
    """(least ms, what bounds it) of one K3 launch over sw's lanes: what
    the function must move, the dense output written once and idx, val
    and sw read once (the pair table is K3's own layout of idx and val,
    not counted); three FLOPs (two products, one add) per nonzero pair
    and lane."""
    T = 1 if sw.ndim == 1 else sw.shape[0]
    moved = (T * p * p * 4 + idx.numel() * idx.element_size()
             + val.numel() * val.element_size()
             + sw.numel() * sw.element_size())
    return bound(moved, 3 * n_pairs * T)


def ridge_f64(torch, X, y, device="cuda"):
    """A float64 arbiter for RidgeClassifier's fit on the CSR ``X``: the
    same closed form (+-1 targets a class, unit weights, the intercept
    unpenalised, ``1e-8`` jitter) by dense float64 algebra on the card,
    outside the port. Returns ``(coef, G, b)``: ``coef(alpha) -> (k,
    d)`` numpy, and the float64 gram ``X~.T X~`` and right-hand side
    ``X~.T T`` it solves."""
    n, d = X.shape
    _, yi = np.unique(y, return_inverse=True)
    coo = X.tocoo()
    Xa = torch.zeros((n, d + 1), dtype=torch.float64, device=device)
    Xa.index_put_((torch.as_tensor(coo.row.astype(np.int64)).to(device),
                   torch.as_tensor(coo.col.astype(np.int64)).to(device)),
                  torch.as_tensor(coo.data.astype(np.float64)).to(device),
                  accumulate=True)
    Xa[:, d] = 1.0
    T = -torch.ones((n, int(yi.max()) + 1), dtype=torch.float64,
                    device=device)
    T[torch.arange(n), torch.as_tensor(yi).to(device)] = 1.0
    G = Xa.t() @ Xa
    b = Xa.t() @ T
    del Xa, T

    def coef(alpha):
        A = G.clone()
        A.diagonal()[:d] += alpha
        A.diagonal().add_(1e-8)
        W = torch.cholesky_solve(b, torch.linalg.cholesky(A))
        return W[:d].t().cpu().numpy()

    return coef, G, b


def refit_error_budget(torch, X, y, alpha, G64, b64, coef64, card_coef):
    """Where the card refit's distance to the float64 solve comes from.
    The refit's gram (K3) and right-hand side (K2; unit weights, +-1
    targets) are formed on the card as the port forms them and held to
    the float64 ones, beside the CPU's right-hand side (the plain
    version, as the CPU refit forms it). Then float32 solves, each as
    the port solves (regulariser in place, cuSOLVER Cholesky): the
    card's gram or the float64 gram rounded once to float32, with the
    card's right-hand side or the float64 one rounded once, and the
    card's gram with the CPU's right-hand side. Prints each solve's max
    distance to the float64 coef; the first must be the card's refit,
    bitwise."""
    from skdist_tpu_torch import RidgeClassifier
    from skdist_tpu_torch.models.linear import prepare_fit_X, to_device_X
    from skdist_tpu_torch.ops import packed_sparse as ps

    n, d = X.shape
    op = RidgeClassifier._linear_op(
        to_device_X(prepare_fit_X(X, RidgeClassifier), "cuda"),
        (("fit_intercept", True),))
    _, yi = np.unique(y, return_inverse=True)
    Y = torch.where(torch.as_tensor(yi).cuda()[:, None]
                    == torch.arange(int(yi.max()) + 1, device="cuda"),
                    1.0, -1.0)
    G, b = op.weighted_gram_rhs(torch.ones((1, n), device="cuda"), Y)
    G, b = G[0], b[0]
    b_cpu = ps.packed_rmatvec(op.pidx.cpu(), op.pval.cpu(), Y.cpu(), op.p)
    e_b = float((b.double() - b64).abs().max())
    e_b_cpu = float((b_cpu.double() - b64.cpu()).abs().max())
    e_G = float((G.double() - G64).abs().max())
    a32 = torch.tensor(np.float32(alpha), device="cuda")

    def solve(Gs, bs):
        A = Gs.clone()
        A.diagonal()[:d] += a32
        A.diagonal().add_(1e-8)
        factor, _ = torch.linalg.cholesky_ex(A)
        return torch.cholesky_solve(bs, factor)[:d].t().cpu().numpy()

    G_r, b_r = G64.float(), b64.float()
    dist = {name: float(np.abs(solve(Gs, bs) - coef64).max())
            for name, Gs, bs in (("card gram, card rhs", G, b),
                                 ("card gram, float64 rhs", G, b_r),
                                 ("float64 gram, card rhs", G_r, b),
                                 ("float64 gram, float64 rhs", G_r, b_r),
                                 ("card gram, cpu rhs", G, b_cpu.cuda()))}
    same = np.array_equal(solve(G, b), card_coef)
    del op, G, b, G_r, b_r
    torch.cuda.empty_cache()
    say(f"  refit error budget alpha={alpha:.4g}: right-hand side against "
        f"float64 (max|b| {float(b64.abs().max()):.3e}): card K2 {e_b:.3e}, "
        f"cpu plain {e_b_cpu:.3e}; card K3 gram {e_G:.3e} (max|G| "
        f"{float(G64.abs().max()):.3e}); coef against float64 after a "
        f"float32 solve of: " + ", ".join(f"{k} {v:.3e}"
                                          for k, v in dist.items())
        + f" (the first is the card's refit bitwise: {same})")
    if not same:
        raise AssertionError("the error budget's solve does not reproduce "
                             "the card's refit")


def ridge_data(seed=0):
    """The ridge path's data: 20news-shaped hashed text at d = 2**14."""
    return make_20news_sparse(seed=seed, n=11314, d=RIDGE_D, nnz_row=40,
                              k=20)


def phase_k3(torch, X, y, round_lanes):
    """Phase 9: K3 against its plain version on the card, at ragged small
    shapes and at the ridge path's shape, then its times; K1 and K2 at
    the ridge path's shapes. Returns (K3's max error, times, bound of one
    lane, K1's and K2's (max error) pairs)."""
    from skdist_tpu_torch.models.linear import RidgeClassifier, prepare_fit_X
    from skdist_tpu_torch.ops import packed_sparse as ps

    say("phase 9: K3 packed_weighted_gram against plain PyTorch on the card")
    errs = []
    rng = np.random.RandomState(3)
    for i, (n, p, m, T) in enumerate([(37, 53, 7, 1), (1001, 301, 1, 3),
                                      (299, 1001, 70, 3), (5003, 9, 7, 1)]):
        idx, val = random_packed(torch, rng, n, p, m)
        idx[1], val[1] = 0, 0.0  # an empty row
        if m > 1:
            idx[2, 1] = idx[2, 0]  # a repeated (row, col) entry
        sw_f = torch.as_tensor(rng.rand(T, n).astype(np.float32)).cuda()
        sw_i = torch.as_tensor(rng.randint(0, 4, (T, n)).astype(np.float32)
                               ).cuda()
        errs.append(check_k3(torch, ps, idx, val, sw_f, p, f"ragged case {i}"))
        errs.append(check_k3(torch, ps, idx, torch.round(3 * val), sw_i, p,
                             f"ragged case {i}"))

    # the ridge path's shape: hashed text plus the intercept column
    packed = prepare_fit_X(X, RidgeClassifier)
    n, p = X.shape[0], RIDGE_D + 1
    idx = torch.cat([torch.as_tensor(packed.idx),
                     torch.full((n, 1), RIDGE_D, dtype=torch.int32)], 1).cuda()
    val = torch.cat([torch.as_tensor(packed.val),
                     torch.ones((n, 1), dtype=torch.float32)], 1).cuda()
    t0 = time.perf_counter()
    pairs = ps.build_pairs(idx, val, p)
    torch.cuda.synchronize()
    t_pairs = time.perf_counter() - t0
    counts = pairs.cell_ptr[1:] - pairs.cell_ptr[:-1]
    say(f"  pair table: {pairs.n_pairs} pairs in {pairs.n_cells} cells "
        f"(longest {int(counts.max())}), {pairs.nbytes() / 2**20:.1f} MiB, "
        f"built in {t_pairs:.3f} s")
    g = torch.Generator(device="cuda").manual_seed(5)
    sw = torch.rand((3, n), generator=g, device="cuda")
    errs.append(check_k3(torch, ps, idx, val, sw[0], p, "ridge shape", pairs))
    errs.append(check_k3(torch, ps, idx, val, sw, p, "ridge shape", pairs))
    val_i = torch.round(2 * val)
    pairs_i = ps.build_pairs(idx, val_i, p)
    errs.append(check_k3(torch, ps, idx, val_i, torch.round(3 * sw), p,
                         "ridge shape", pairs_i))
    del pairs_i

    # K1 and K2 as the ridge path launches them, a round of lanes at
    # once: K2 on the right-hand side sw[..., None] * Y (Y the +-1
    # targets) under the grid's 0/1 fold masks and under random
    # fractional weights, K1 on a (lanes, p, k) weight batch
    _, yi = np.unique(y, return_inverse=True)
    classes = int(yi.max()) + 1
    Y = torch.where(torch.as_tensor(yi).cuda()[:, None]
                    == torch.arange(classes, device="cuda"), 1.0, -1.0)
    fold = torch.arange(n, device="cuda") * 5 // n
    masks = (fold[None] != (torch.arange(round_lanes, device="cuda")
                            % 5)[:, None]).float()
    pair_errs = [
        check_pair(torch, ps, idx, val, p, round_lanes, classes, seed=9 + i,
                   label=f"ridge round, {name}", r=w[..., None] * Y)
        for i, (name, w) in enumerate((
            ("0/1 fold masks", masks),
            ("fractional weights", torch.rand(
                (round_lanes, n), generator=g, device="cuda"))))]
    del Y
    torch.cuda.empty_cache()

    # does the TF32 switch reach cuSOLVER's float32 Cholesky? factor one
    # regularised lane with it off and on
    G = ps.packed_weighted_gram(idx, val, sw[0], p, pairs=pairs)
    G.diagonal().add_(1.0)
    torch.backends.cuda.matmul.allow_tf32 = False
    L_off, info = torch.linalg.cholesky_ex(G)
    torch.backends.cuda.matmul.allow_tf32 = True
    L_on, _ = torch.linalg.cholesky_ex(G)
    torch.backends.cuda.matmul.allow_tf32 = False
    say(f"  cuSOLVER float32 Cholesky of one lane (info {int(info)}): TF32 "
        f"switch on and off give "
        + ("bitwise equal factors" if torch.equal(L_off, L_on) else
           f"factors that differ by {float((L_off - L_on).abs().max()):.3e}"))
    del G, L_off, L_on
    torch.cuda.empty_cache()

    # times: a lane, a round, the plain version and two yardsticks the
    # port never calls (TF32 off)
    times = {
        "K3": cuda_ms(torch, lambda: ps.packed_weighted_gram(
            idx, val, sw[0], p, pairs=pairs), 10),
        "K3_plain": cuda_ms(torch, lambda: ps.packed_weighted_gram_ref(
            idx, val, sw[0], p), 3),
    }
    swr = torch.rand((round_lanes, n), generator=g, device="cuda")
    times["K3_round"] = cuda_ms(torch, lambda: ps.packed_weighted_gram(
        idx, val, swr, p, pairs=pairs), 3)
    rbnd = k3_bound(idx, val, swr, p, pairs.n_pairs)

    # the launch the path makes, a whole round of lanes (int64 lane
    # offsets past 2**31 elements), held to the plain version at its
    # first, middle and last lanes: random weights on the path's values,
    # then the path's own weights (0/1 fold masks) on integer values,
    # bitwise
    ends = sorted({0, round_lanes // 2, round_lanes - 1})
    out = ps.packed_weighted_gram(idx, val, swr, p, pairs=pairs)
    err, scale, _ = hold_k3(torch, ps, out, idx, val, swr, p,
                            "a round", lanes=ends)
    errs.append(err)
    del out, swr
    torch.cuda.empty_cache()
    say(f"  a round: n={n} m={idx.shape[1]} p={p} T={round_lanes} "
        f"fractional data, lanes {ends}: max err {err:.3e} (max|out| "
        f"{scale:.3e})")
    pairs_i = ps.build_pairs(idx, val_i, p)
    out = ps.packed_weighted_gram(idx, val_i, masks, p, pairs=pairs_i)
    hold_k3(torch, ps, out, idx, val_i, masks, p, "a round of fold masks",
            lanes=ends)
    del out, masks, pairs_i
    torch.cuda.empty_cache()
    say(f"  a round of 0/1 fold masks: T={round_lanes} integer data, "
        f"lanes {ends}: bitwise equal")
    from skdist_tpu_torch.sparse import packed_to_dense

    Xa = packed_to_dense(idx, val, p)
    SXa = Xa * sw[0][:, None]
    XaT = Xa.t().to_sparse_csr()
    times["sparse_mm"] = cuda_ms(torch, lambda: torch.sparse.mm(XaT, SXa), 3)
    times["dense_gemm"] = cuda_ms(torch, lambda: Xa.t() @ SXa, 3)
    want = ps.packed_weighted_gram(idx, val, sw[0], p, pairs=pairs)
    for name, got in (("sparse_mm", torch.sparse.mm(XaT, SXa)),
                      ("dense_gemm", Xa.t() @ SXa)):
        gap = float((got - want).abs().max())
        say(f"  yardstick {name} against K3: max diff {gap:.3e}")
    del Xa, SXa, XaT, want
    torch.cuda.empty_cache()
    bnd = k3_bound(idx, val, sw[0], p, pairs.n_pairs)
    say(f"  ridge shape n={n} m={idx.shape[1]} p={p}: K3 a lane "
        f"{times['K3']:.3f} ms (bound {bnd[0]:.3f} ms, {bnd[1]}); a round of "
        f"{round_lanes} lanes {times['K3_round']:.3f} ms (bound "
        f"{rbnd[0]:.3f} ms); plain {times['K3_plain']:.3f} ms; "
        f"torch.sparse.mm {times['sparse_mm']:.3f} ms; dense GEMM "
        f"{times['dense_gemm']:.3f} ms")
    return max(errs), times, bnd, pair_errs


def phase_ridge(torch, X, y, alphas, backend):
    """Phase 10: the RidgeClassifier grid at full size (240 fits since a
    printed cut, 480 before). Returns
    the kernels' launches over the search."""
    from skdist_tpu_torch import DistGridSearchCV, RidgeClassifier
    from skdist_tpu_torch.models.linear import prepare_fit_X, to_device_X
    from skdist_tpu_torch.ops import packed_sparse as ps

    n_fits = 5 * len(alphas)
    say(f"phase 10: DistGridSearchCV(RidgeClassifier(), {len(alphas)} alpha "
        f"x 5 folds = {n_fits} fits, f1_weighted) on {X.shape} on the card")
    ps.packed_weighted_gram.launches = 0
    ps.packed_rmatvec.launches = 0
    ps.packed_matvec.launches = 0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gs = DistGridSearchCV(RidgeClassifier(), {"alpha": alphas}, cv=5,
                          scoring="f1_weighted", backend=backend).fit(X, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"packed_weighted_gram": ps.packed_weighted_gram.launches,
                "packed_rmatvec": ps.packed_rmatvec.launches,
                "packed_matvec": ps.packed_matvec.launches}
    stats = gs.round_stats_[0]
    say(f"  wall {wall:.1f} s, {n_fits / wall:.2f} fits/s, rounds "
        f"{stats['rounds']} x {stats['tasks_per_round']} tasks, round walls "
        + ", ".join(f"{w:.2f}" for w in stats["round_walls_s"])
        + f" s, refit {gs.refit_time_:.2f} s")
    billed = (stats["tasks_per_round"] * stats["bytes_per_task"]
              + stats["bytes_per_round"])
    say(f"  sizer: {stats['bytes_per_task'] / 2**30:.3f} GiB a task + "
        f"{stats['bytes_per_round'] / 2**30:.3f} GiB a round = "
        f"{billed / 2**30:.1f} GiB; measured peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    splits = np.stack([gs.cv_results_[f"split{i}_test_score"]
                       for i in range(5)])
    failed = int((~np.isfinite(splits)).sum())
    say(f"  best_params_ {gs.best_params_}, best_score_ {gs.best_score_:.6f}; "
        f"lanes whose Cholesky failed: {failed}; launches {launches}")
    if launches["packed_weighted_gram"] != stats["rounds"] + 1 or \
            min(launches.values()) <= 0:
        raise AssertionError(f"K3 launched {launches['packed_weighted_gram']}"
                             f" times over {stats['rounds']} rounds and the "
                             f"refit, or a kernel never launched: {launches}")
    if failed or not np.all(np.isfinite(gs.cv_results_["mean_test_score"])):
        raise AssertionError("non-finite mean_test_score")
    live = gs.best_estimator_.predict(X)
    loaded = pickle.loads(pickle.dumps(gs.best_estimator_))
    if not np.array_equal(loaded.predict(X), live):
        raise AssertionError("pickled best_estimator_ predicts differently")
    say(f"  refit accuracy on its training data {np.mean(live == y):.4f}; "
        "pickled artifact predicts the same")

    # the refit on the card against the same fit on the CPU, held to what
    # one ulp of input noise does to the card's own fit (phase 3's
    # method): the card and the CPU sum the gram and factor it in other
    # orders, and the solve amplifies rounding by the gram's condition.
    # Both are also held to a float64 solve on the card, which sees
    # neither float32 rounding path: the card's float32 error may be at
    # most 10x the CPU's. Read at the best alpha (gated) and at alpha = 1
    # (a worse-conditioned gram; the one-ulp ratio is printed, the
    # float64 arbiter gated), each with its error budget; then at the
    # best alpha on a second draw of the data (seed 1), read the same way
    best = float(gs.best_params_["alpha"])
    del gs
    torch.cuda.empty_cache()

    def cpu_refit(Xs, ys, alpha):
        # set in the worker thread itself: OpenMP's and MKL's thread
        # counts are the calling thread's
        torch.set_num_threads(1)
        t0 = time.perf_counter()
        fit = RidgeClassifier(alpha=alpha, device="cpu").fit(Xs, ys)
        return fit, time.perf_counter() - t0

    X1, y1 = ridge_data(seed=1)
    # the CPU refits first, all at once, each on one thread: the
    # multithreaded LAPACK Cholesky does not repeat itself bitwise, which
    # would make the check below a coin toss; a single-threaded one does,
    # beside other threads as well (the refit at the best alpha runs twice
    # to show it)
    jobs = {"best": (X, y, best), "again": (X, y, best), "one": (X, y, 1.0),
            "seed1": (X1, y1, best)}
    threads = torch.get_num_threads()
    try:
        with ThreadPoolExecutor(len(jobs)) as pool:
            cpu_fits = dict(zip(jobs, pool.map(lambda a: cpu_refit(*a),
                                               jobs.values())))
    finally:
        torch.set_num_threads(threads)

    def hold_refit(Xs, ys, alpha, label, gate_ulp, key):
        X_ulp = Xs.copy()
        X_ulp.data *= np.float32(1 + 2.0 ** -23)
        exact, G64, b64 = ridge_f64(torch, Xs, ys)
        t0 = time.perf_counter()
        on_card = RidgeClassifier(alpha=alpha).fit(Xs, ys)
        t_card = time.perf_counter() - t0
        on_cpu, t_cpu = cpu_fits[key]
        on_card_ulp = RidgeClassifier(alpha=alpha).fit(X_ulp, ys)
        coef64 = exact(alpha)
        dcoef = float(np.abs(on_card.coef_ - on_cpu.coef_).max())
        dulp = float(np.abs(on_card.coef_ - on_card_ulp.coef_).max())
        scale = float(np.abs(on_cpu.coef_).max())
        e_card = float(np.abs(on_card.coef_ - coef64).max())
        e_cpu = float(np.abs(on_cpu.coef_ - coef64).max())
        rerun = ""
        if key == "best":
            gap = np.abs(on_cpu.coef_ - cpu_fits["again"][0].coef_)
            rerun = f", cpu vs cpu again {float(gap.max()):.3e}"
        say(f"  refit {label}alpha={alpha:.4g}: card {t_card:.2f} s, cpu "
            f"(one thread) {t_cpu:.2f} s; max|coef| {scale:.3e}, card vs "
            f"cpu max|dcoef| {dcoef:.3e}, card vs card on X*(1+ulp) "
            f"{dulp:.3e} (ratio {dcoef / max(dulp, 1e-30):.2f}; 10 allowed "
            f"at the best alpha of seed 0){rerun}; against float64: card "
            f"{e_card:.3e}, cpu {e_cpu:.3e} (ratio "
            f"{e_card / max(e_cpu, 1e-30):.2f}; 10 allowed)")
        if gate_ulp and not dcoef <= 10 * dulp + 1e-6 * scale:
            raise AssertionError("card and CPU refits differ by more than "
                                 "10x what one ulp of input noise does")
        if not e_card <= 10 * e_cpu:
            raise AssertionError(f"the card's refit {label}at alpha={alpha} "
                                 f"is more than 10x further from the "
                                 f"float64 solve than the CPU's")
        refit_error_budget(torch, Xs, ys, alpha, G64, b64, coef64,
                           on_card.coef_)
        del exact, G64, b64
        torch.cuda.empty_cache()

    hold_refit(X, y, best, "", gate_ulp=True, key="best")
    hold_refit(X, y, 1.0, "", gate_ulp=False, key="one")
    hold_refit(X1, y1, best, "on seed 1, ", gate_ulp=False, key="seed1")
    del X1, y1, cpu_fits

    # one round's device time, split by torch.profiler over kernel names
    # (the factorisation and the solve share cuBLAS kernels, so they are
    # one bucket there, split below by timing one lane of each)
    # two alphas x 5 folds: a round's split is per lane (each lane's gram
    # and Cholesky), and the profiler slows cuSOLVER's calls ~15x
    lanes = min(RIDGE_PROFILE_ALPHAS, max(1, stats["tasks_per_round"] // 5))
    t0 = time.perf_counter()
    split = profile_device_split(
        torch, lambda: DistGridSearchCV(
            RidgeClassifier(), {"alpha": alphas[:lanes]}, cv=5, refit=False,
            scoring="f1_weighted", backend=backend).fit(X, y),
        {"K3": ("packed_gram_kernel",),
         "memsets (K3 zero fill, cuSOLVER)": ("Memset",),
         "K2": ("packed_rmatvec",), "K1": ("packed_matvec_kernel",),
         "Cholesky factor + solve (cuSOLVER, cuBLAS)": (
             "getrf", "syrk", "syherk", "sgemm", "xmma_gemm", "trsm",
             "splitKreduce", "gemv", "dot_kernel", "xxtrf", "triu_tril",
             "Memcpy DtoD")})
    t_prof = time.perf_counter() - t0
    if split is None:
        say("  profiler: no device time recorded (split not measured)")
    else:
        rest = split["total"] - sum(v for k, v in split.items()
                                    if k != "total")
        say(f"  profiled round of {5 * lanes} tasks (wall {t_prof:.2f} s "
            f"with the profiler on): device {split['total']:.1f} ms = "
            + ", ".join(f"{k} {v:.1f} ms ({100 * v / split['total']:.1f}%)"
                        for k, v in split.items() if k != "total")
            + f", rest {rest:.1f} ms ({100 * rest / split['total']:.1f}%)")
    # one lane's factorisation and solve by CUDA events, at the best alpha
    op = RidgeClassifier._linear_op(
        to_device_X(prepare_fit_X(X, RidgeClassifier), "cuda"),
        (("fit_intercept", True),))
    sw = torch.ones(X.shape[0], device="cuda")
    T = torch.ones((X.shape[0], 20), device="cuda")
    G, b = op.weighted_gram_rhs(sw, T)
    G.diagonal()[:-1] += best
    G.diagonal().add_(1e-8)
    factor, _ = torch.linalg.cholesky_ex(G)
    t_factor = cuda_ms(torch, lambda: torch.linalg.cholesky_ex(G), 3)
    t_solve = cuda_ms(torch, lambda: torch.cholesky_solve(b, factor), 3)
    del op, G, b, factor
    torch.cuda.empty_cache()
    say(f"  one lane by CUDA events: Cholesky factor {t_factor:.2f} ms "
        f"({1.0e3 * (X.shape[1] + 1) ** 3 / 3 / t_factor / 1e12:.1f} "
        f"TFLOP/s of p**3/3), solve {t_solve:.2f} ms; x{5 * lanes} lanes = "
        f"{5 * lanes * t_factor:.1f} + {5 * lanes * t_solve:.1f} ms")
    return launches


def phase_ridge_regressor(torch, X, alphas, backend):
    """Phase 11: Ridge on a real target made from the seed, default r2."""
    from skdist_tpu_torch import DistGridSearchCV, Ridge
    from skdist_tpu_torch.ops import packed_sparse as ps

    rng = np.random.RandomState(6)
    yr = (np.asarray(X @ rng.randn(X.shape[1]).astype(np.float32)).ravel()
          + 0.5 * rng.randn(X.shape[0])).astype(np.float32)
    ps.packed_weighted_gram.launches = 0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gs = DistGridSearchCV(Ridge(), {"alpha": alphas}, cv=5,
                          backend=backend).fit(X, yr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = gs.round_stats_[0]
    launches = ps.packed_weighted_gram.launches
    say(f"phase 11: DistGridSearchCV(Ridge(), {len(alphas)} alpha x 5 folds, "
        f"r2) on {X.shape}: {wall:.1f} s, rounds {stats['rounds']} x "
        f"{stats['tasks_per_round']}, K3 launches {launches}, best_params_ "
        f"{gs.best_params_}, best r2 {gs.best_score_:.6f}")
    if launches <= 0 or not np.isfinite(gs.best_score_):
        raise AssertionError("the ridge regressor path failed")


# ---------------------------------------------------------------------------
# phases 13-13c: BASELINE config 2, the SGD search
# ---------------------------------------------------------------------------

#: BASELINE config 2 (benchmarks/run_all.py:113-131): covtype's published
#: shape, made by bench.py's make_tabular; the A/B phase runs at half the
#: JAX package's own benchmark size (100000 rows), a cut that keeps the
#: whole run inside its time target
SGD_N, SGD_D, SGD_K = 581012, 54, 7
#: phase 13's rows: half of covtype's, so that the whole run stays inside
#: its time limit
SGD_ROWS = SGD_N // 2
SGD_AB_N = 12_500
#: phase 13's epochs: config 2's 20 cut to 5, so that the whole run
#: keeps its time target beside phase 21 (at 10 its lanes stopped on tol
#: after 7-10 epochs, and a run on an H100 took up to 1134 s); fewer than
#: 5 would take the search off the compacted path (a slice is 4 epochs)
SGD_EPOCHS = 5

SGD_ALPHAS = list(np.logspace(-6, -2, 60))


def sgd_search(torch, X, y, alphas, backend, compaction=True, max_iter=20,
               **kw):
    """A timed config-2 search (``n_iter`` = every alpha) with the
    compacted path on or off; returns the search and its wall."""
    from skdist_tpu_torch import DistRandomizedSearchCV, SGDClassifier

    os.environ["SKDIST_COMPACTION"] = "1" if compaction else "0"
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gs = DistRandomizedSearchCV(
            SGDClassifier(max_iter=max_iter, random_state=0),
            {"alpha": alphas},
            n_iter=len(alphas), cv=5, scoring="accuracy", random_state=0,
            backend=backend, **kw,
        ).fit(X, y)
        torch.cuda.synchronize()
        return gs, time.perf_counter() - t0
    finally:
        del os.environ["SKDIST_COMPACTION"]


def sgd_lane_problem(torch, X, y, alphas, max_iter=20):
    """The SGD fit problem of a round of ``5 * len(alphas)`` lanes on the
    card (alpha-major, lane t on fold mask ``t % 5``), for the step
    profile and the slot check: ``(meta, static, op, y, sw, hyper)``."""
    from skdist_tpu_torch import SGDClassifier
    from skdist_tpu_torch.models.linear import _freeze, to_device_X

    est = SGDClassifier(max_iter=max_iter, random_state=0)
    data, meta = est._prep_fit_data(X, y)
    static = _freeze(est._static_config(meta))
    op = SGDClassifier._linear_op(to_device_X(X, "cuda"), static)
    n, T = X.shape[0], 5 * len(alphas)
    folds = torch.arange(n, device="cuda") % 5
    sw = (folds[None, :] != torch.arange(T, device="cuda")[:, None] % 5
          ).to(torch.float32)
    full = dict(dtype=torch.float32, device="cuda")
    hyper = {"alpha": torch.tensor(np.repeat(alphas, 5), **full),
             "eta0": torch.full((T,), 0.01, **full),
             "l1_ratio": torch.full((T,), 0.15, **full),
             "tol": torch.full((T,), 1e-3, **full)}
    return meta, static, op, torch.as_tensor(data["y"]).cuda(), sw, hyper


def profile_sgd_steps(torch, X, y, alphas):
    """Host microseconds a step of the 300-lane round's bare batch loop
    (2000 steps) and a ``torch.profiler`` split of 50 of them."""
    from skdist_tpu_torch import SGDClassifier
    from skdist_tpu_torch.models import solvers
    from skdist_tpu_torch.utils.draws import epoch_permutation

    meta, static, op, yd, sw, hyper = sgd_lane_problem(torch, X, y, alphas)
    pb = SGDClassifier._build_fit_problem(meta, static)(op, yd, sw, hyper)
    T, n = sw.shape
    padded = -(-n // 64) * 64
    rows = epoch_permutation(0, 0, padded, n, "cuda").expand(T, padded)
    n_batches, batch = pb["batches"](rows)
    n_timed = min(2000, n_batches)
    w0 = pb["W0"]
    carry4 = (w0, (torch.zeros(T, device="cuda"), torch.zeros_like(w0)),
              torch.zeros(T, dtype=torch.int64, device="cuda"),
              torch.zeros(T, device="cuda"))

    def run(k):
        solvers.sgd_batch_scan(pb["grad_fn"], pb["lr_fn"], pb["post_step"],
                               pb["loss_fn"], carry4, k, batch)
        torch.cuda.synchronize()

    run(min(60, n_batches))
    t0 = time.perf_counter()
    run(n_timed)
    us = 1e6 * (time.perf_counter() - t0) / n_timed
    split = profile_device_split(
        torch, lambda: run(50),
        {"products": ("gemm",), "gathers": ("index",),
         "reductions": ("reduce_kernel",)}, window=True)
    return us, split


def phase_sgd(torch, backend, alphas):
    """Phase 13: BASELINE config 2 at full width, 300 fits plus the
    refit, on the compacted path."""
    from skdist_tpu_torch import SGDClassifier  # noqa: F401

    t0 = time.perf_counter()
    X, y = make_tabular(SGD_ROWS, SGD_D, SGD_K, seed=1)
    n_fits = 5 * len(alphas)
    say(f"phase 13: DistRandomizedSearchCV(SGDClassifier(max_iter="
        f"{SGD_EPOCHS}), {len(alphas)} alpha, n_iter={len(alphas)}, cv=5, "
        f"accuracy) on covtype-shaped {X.shape}, {SGD_K} classes: {n_fits} "
        f"fits + refit (data {time.perf_counter() - t0:.1f}s)")
    say(f"CUT: phase 13 runs {SGD_EPOCHS} epochs, not config 2's 20 (its "
        "steps are launch-bound: the wall goes with the epochs)")
    say(f"CUT: phase 13 runs {SGD_ROWS} of covtype's {SGD_N} rows (the "
        "run's time limit: the steps, and so the wall, go with the rows)")
    torch.cuda.reset_peak_memory_stats()
    gs, wall = sgd_search(torch, X, y, alphas, backend, max_iter=SGD_EPOCHS)
    st = gs.round_stats_[0]
    search = wall - gs.refit_time_
    n_batches = -(-SGD_ROWS // 64)
    epochs = int(np.max(st["lane_n_iter"]))
    refit_epochs = int(gs.best_estimator_.n_iter_)
    say(f"  wall {wall:.1f}s: search {search:.1f}s ({n_fits / search:.2f} "
        f"fits/s), refit {gs.refit_time_:.1f}s ({refit_epochs} epochs)")
    say("  " + lane_readout(st))
    say(f"  steps: the round ran {epochs} epochs x {n_batches} batches = "
        f"{epochs * n_batches} steps of {st['chunk']} lanes, "
        f"{epochs * n_batches / search:.0f} steps/s with scoring; refit "
        f"{refit_epochs * n_batches / gs.refit_time_:.0f} steps/s")
    say(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    alphas_drawn = [float(c["alpha"]) for c in gs.cv_results_["params"][:3]]
    say(f"  best_params_ {gs.best_params_}, best_score_ {gs.best_score_:.6f};"
        f" first three candidates' alpha {alphas_drawn}")
    if st["mode"] != "compacted" or st["tasks"] != n_fits:
        raise AssertionError(f"phase 13 ran {st['mode']} over {st['tasks']}")
    if not np.all(np.isfinite(gs.cv_results_["mean_test_score"])):
        raise AssertionError("non-finite SGD mean_test_score")
    majority = np.bincount(y).max() / len(y)
    if not gs.best_score_ > majority:
        raise AssertionError(
            f"best_score_ {gs.best_score_:.4f} is not above the majority "
            f"share {majority:.4f}")
    live = gs.best_estimator_.predict(X)
    loaded = pickle.loads(pickle.dumps(gs.best_estimator_))
    if not np.array_equal(loaded.predict(X), live):
        raise AssertionError("pickled SGD best_estimator_ predicts differently")
    say(f"  majority share {majority:.4f}; refit accuracy on its training "
        f"data {np.mean(live == y):.4f}; pickled artifact predicts the same")
    us, split = profile_sgd_steps(torch, X, y, alphas)
    line = f"  bare round steps: {us:.1f} us a step (host clock)"
    if split is None:
        line += "; the profiler saw no device time"
    else:
        busy, span = split["window"]
        rest = split["total"] - split["products"] - split["gathers"] \
            - split["reductions"]
        line += (f"; 50 steps under the profiler: device {split['total']:.3f}"
                 f" ms (products {split['products']:.3f}, gathers "
                 f"{split['gathers']:.3f}, reductions "
                 f"{split['reductions']:.3f}, elementwise {rest:.3f}), busy "
                 f"{busy:.3f} of {span:.3f} ms ({100 * busy / span:.1f}%)")
    say(line)


def phase_sgd_ab(torch, backend, alphas):
    """Phase 13b: compacted against classic at equal chunk, and ASHA,
    on config 2 at the JAX package's benchmark size."""
    from skdist_tpu_torch.distribute.adaptive import (
        HalvingSpec,
        RungKilledWarning,
    )

    X, y = make_tabular(SGD_AB_N, SGD_D, SGD_K, seed=1)
    say(f"phase 13b: config 2 on {X.shape}, compacted against classic, "
        "then ASHA")
    say(f"CUT: phase 13b runs {SGD_AB_N} rows, not the JAX package's "
        "benchmark size of 100000")
    comp, wall_c = sgd_search(torch, X, y, alphas, backend)
    st = comp.round_stats_[0]
    say(f"  compacted wall {wall_c:.1f}s: " + lane_readout(st))
    classic, wall_k = sgd_search(torch, X, y, alphas, backend,
                                 compaction=False,
                                 partitions=-(-st["tasks"] // st["chunk"]))
    sk = classic.round_stats_[0]
    say(f"  classic wall {wall_k:.1f}s: {sk['rounds']} rounds x "
        f"{sk['tasks_per_round']} tasks")
    diff = differing_columns(comp, classic)
    if (sk["tasks_per_round"] != st["chunk"] or diff
            or not np.array_equal(comp.best_estimator_.coef_,
                                  classic.best_estimator_.coef_)):
        raise AssertionError(
            f"SGD compacted and classic differ: chunks {st['chunk']}/"
            f"{sk['tasks_per_round']}, columns {diff}")
    say("  cv_results_ and the refit coef_ bitwise equal")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ginf, wall_inf = sgd_search(torch, X, y, alphas, backend,
                                    refit=False,
                                    adaptive=HalvingSpec(eta=float("inf")))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RungKilledWarning)
            g3, wall3 = sgd_search(torch, X, y, alphas, backend, refit=False,
                                   adaptive=HalvingSpec(eta=3))
    for w in caught:
        if "could not engage" in str(w.message) or \
                OOM_DOWNGRADE in str(w.message):
            raise AssertionError(f"phase 13b: {w.message}")
    diff = differing_columns(comp, ginf)
    say(f"  eta=inf wall {wall_inf:.1f}s, "
        f"{len(ginf.round_stats_[0]['rung_history'])} rungs scored; "
        "cv_results_ against compacted: "
        + ("bitwise equal" if not diff else f"differ in {diff}"))
    if diff:
        raise AssertionError("SGD eta=inf differs from adaptive=None")
    s3 = g3.round_stats_[0]
    rank = comp.cv_results_["rank_test_score"][g3.best_index_]
    say(f"  eta=3 wall {wall3:.1f}s; kills: " + ", ".join(
        f"rung {h['rung']} slice {h['slice']}: {h['n_killed']} of "
        f"{h['n_live']} lanes" for h in s3["rung_history"]))
    say(f"  eta=3 best_params_ {g3.best_params_} best_score_ "
        f"{g3.best_score_:.6f} (rank {rank} of the exhaustive run); "
        f"exhaustive {comp.best_params_} {comp.best_score_:.6f}")
    if s3["retired_rung"] <= 0 or not np.isfinite(g3.best_score_):
        raise AssertionError("SGD eta=3 killed no lane or has no winner")


def row_clocks(t, name):
    """The extra clocks of a row kernel's entry in the kernel line: its
    device, graph and host times a call, its yardstick's device and
    graph times, and the launch floor's (one-element ``fill_``)."""
    return {"device_ms": t[name + "_device"], "graph_ms": t[name + "_graph"],
            "host_ms": t[name + "_host"],
            "library_device_ms": t[name + "_library_device"],
            "library_graph_ms": t[name + "_library_graph"],
            "launch_floor_device_ms": t["launch_floor_device"],
            "launch_floor_graph_ms": t["launch_floor_graph"],
            "launch_floor_host_ms": t["launch_floor_host"]}


def card_line():
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


#: one run of ``--ab-sgd``: config 2's compacted search on argv[2] rows,
#: after a short warm-up search, in the tree given as argv[1] (its own
#: chip_smoke.py and package), printed as one JSON line
AB_SGD_RUN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import chip_smoke as cs
from skdist_tpu_torch import CUDABackend
X, y = cs.make_tabular(int(sys.argv[2]), cs.SGD_D, cs.SGD_K, seed=1)
b = CUDABackend()
cs.sgd_search(torch, X[:20000], y[:20000], cs.SGD_ALPHAS[:6], b)
gs, wall = cs.sgd_search(torch, X, y, cs.SGD_ALPHAS, b)
print(json.dumps({"wall": wall, "refit": gs.refit_time_,
                  "epochs": int(np.max(gs.round_stats_[0]["lane_n_iter"])),
                  "best": float(gs.best_score_)}))
"""


def ab_sgd(parent, pairs, rows):
    """``--ab-sgd``: config 2's compacted search on ``rows`` rows (phase
    13b's 12500 by default, phase 13's 581012 at full size) in turns on
    the tree at ``parent`` and on this checkout, ``pairs`` pairs ordered
    parent, this, this, parent, ..., one process a run. Prints every run and each tree's median, least and largest
    search and refit walls; every run must give the same epochs and
    ``best_score_``. Returns the exit code."""
    import statistics

    say(card_line())
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(parent), "change": here}
    order = (["parent", "change", "change", "parent"] * pairs)[:2 * pairs]
    runs = {"parent": [], "change": []}
    for name in order:
        r = subprocess.run([sys.executable, "-c", AB_SGD_RUN, trees[name],
                            str(rows)],
                           capture_output=True, text=True, cwd=trees[name])
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        run = json.loads(r.stdout.strip().splitlines()[-1])
        runs[name].append(run)
        say(f"  ab-sgd {name}: search {run['wall']:.3f} s, refit "
            f"{run['refit']:.3f} s, epochs {run['epochs']}, best_score_ "
            f"{run['best']:.6f}")
    for name, rs in runs.items():
        for key in ("wall", "refit"):
            v = [r[key] for r in rs]
            say(f"  ab-sgd {name} {key}: median {statistics.median(v):.3f} s,"
                f" least {min(v):.3f}, largest {max(v):.3f} over {len(v)}")
    seen = {(r["epochs"], r["best"]) for rs in runs.values() for r in rs}
    if len(seen) != 1:
        print(f"chip_smoke: the A/B runs disagree: {seen}", file=sys.stderr)
        return 1
    return 0


#: one run of ``--ab-row-kernels``: the row kernels' times at the SGD step's
#: shape and phase 14d's step split, with the package of the tree given
#: as argv[1] and this checkout's chip_smoke.py (argv[2]), printed as one
#: JSON line
AB_ROW_KERNELS_RUN = r"""
import importlib.util, json, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import torch
from skdist_tpu_torch.ops import packed_sparse as ps
X, y = cs.make_20news_sparse(seed=0, n=11314, d=2 ** 18, nnz_row=40, k=20)
idx, val, p = cs.main_plane(torch, X)
(si, sv), _own, W, g = cs.sgd_step_rows(torch, idx, val, p)
t = cs.time_row_step(torch, ps, si, sv, W, g, p)
us, split, steps = cs.profile_ovr_sgd_steps(torch, X, y)
from skdist_tpu_torch import CUDABackend
cs.ovr_sgd_fit(torch, X, y, CUDABackend())
_ovr, fit_wall = cs.ovr_sgd_fit(torch, X, y, CUDABackend())
print(json.dumps({"times": t, "host": cs.host_breakdown(torch, ps),
                  "bounds": cs.row_step_bounds(torch, si, p, 1),
                  "step_us": us, "split": split, "steps": steps,
                  "fit_wall": fit_wall}))
"""


def host_breakdown(torch, ps):
    """Host microseconds a call of the pieces of a row wrapper's launch
    path at the SGD step's output shape: a ``torch.cuda.device`` context,
    ``current_device()``, ``current_stream().cuda_stream`` and the raw
    stream handle, ``torch.empty`` and ``new_empty`` of (20, 64, 1), and
    the row matvec's ctypes call with T = 0 (its C entry returns before
    any launch: the argument conversion alone)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    fn = ps._lib().skdist_packed_row_matvec_f32
    probe = torch.zeros(1, device=dev)

    def device_context():
        with torch.cuda.device(dev):
            pass

    pieces = {
        "device_context": device_context,
        "current_device": torch.cuda.current_device,
        "current_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "raw_stream": lambda: torch._C._cuda_getCurrentRawStream(dev.index),
        "empty": lambda: torch.empty((20, 64, 1), device=dev),
        "new_empty": lambda: probe.new_empty((20, 64, 1)),
        "ctypes_call": lambda: fn(0, 0, 0, 0, 0, 0, 0, 64, 41, 0, 1, 0, 0, 1,
                                  1, 0),
    }
    out = {}
    for name, call in pieces.items():
        call()
        t0 = time.perf_counter()
        for _ in range(2000):
            call()
        out[name] = 1e6 * (time.perf_counter() - t0) / 2000
    torch.cuda.synchronize()
    return out


def ab_row_kernels(parent, pairs):
    """``--ab-row-kernels``: phase 2's row-kernel times at the SGD step's
    shape, phase 14d's step split and its fit's wall (after one warm-up
    fit), in turns on the tree at ``parent`` and on this checkout
    (``pairs`` pairs ordered parent, this, this, parent, ...), one
    process a run, each with its own tree's package. Returns the exit
    code."""
    import statistics

    say(card_line())
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"parent": os.path.abspath(parent), "change": here}
    walls = {"parent": [], "change": []}
    for name in (["parent", "change", "change", "parent"] * pairs)[:2 * pairs]:
        r = subprocess.run(
            [sys.executable, "-c", AB_ROW_KERNELS_RUN, trees[name],
             os.path.join(here, "chip_smoke.py")],
            capture_output=True, text=True, cwd=trees[name])
        if r.returncode:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        run = json.loads(r.stdout.strip().splitlines()[-1])
        say(f"ab-rows {name}:")
        say_row_times(run["times"], *run["bounds"], "    ")
        say("    host pieces (us a call): " + ", ".join(
            f"{k} {v:.2f}" for k, v in run["host"].items()))
        say_step_split(run["step_us"], run["split"], run["steps"],
                       "bare one-vs-rest SGD step")
        say(f"    14d fit wall {run['fit_wall']:.3f} s")
        walls[name].append(run["fit_wall"])
    for name, v in walls.items():
        say(f"ab-rows {name} 14d fit wall: median {statistics.median(v):.3f} "
            f"s, least {min(v):.3f}, largest {max(v):.3f} over {len(v)}")
    return 0


def phase_sgd_card_vs_cpu(torch):
    """Phase 13c: card against CPU, and slot independence."""
    from skdist_tpu_torch import SGDClassifier

    X, y = make_tabular(20000, SGD_D, SGD_K, seed=1)
    X_ulp = X * np.float32(1 + 2.0 ** -23)
    say(f"phase 13c: SGDClassifier(max_iter=3) card against CPU on {X.shape}")
    for loss in ("hinge", "log_loss"):
        kw = dict(loss=loss, max_iter=3, random_state=0)
        card = SGDClassifier(**kw).fit(X, y)._params["W"]
        cpu = SGDClassifier(device="cpu", **kw).fit(X, y)._params["W"]
        card_ulp = SGDClassifier(**kw).fit(X_ulp, y)._params["W"]
        dcoef = float(np.abs(card - cpu).max())
        dulp = float(np.abs(card - card_ulp).max())
        scale = float(np.abs(cpu).max())
        say(f"  {loss}: max|W| {scale:.3e}, card vs cpu max|dW| {dcoef:.3e}, "
            f"card vs card on X*(1+ulp) {dulp:.3e}")
        if not dcoef <= 10 * dulp + 1e-6 * scale:
            raise AssertionError(
                f"SGD {loss}: card and CPU differ by more than 10x what one "
                "ulp of input noise does")
    from skdist_tpu_torch.utils.device import exact_matmuls

    meta, static, op, yd, sw, hyper = sgd_lane_problem(
        torch, X, y, SGD_ALPHAS, max_iter=3)
    kernel = SGDClassifier._build_fit_kernel(meta, static)
    rev = torch.arange(sw.shape[0] - 1, -1, -1, device="cuda")
    with exact_matmuls(), torch.no_grad():
        w1 = kernel(op, yd, sw, hyper)["W"]
        w2 = kernel(op, yd, sw[rev], {k: v[rev] for k, v in hyper.items()})
    same = torch.equal(w1, w2["W"][rev])
    say(f"  slot independence, {sw.shape[0]} lanes against the same lanes "
        "in reverse slots: " + ("bitwise equal" if same else "DIFFER"))
    if not same:
        raise AssertionError("an SGD lane's weights depend on its slot")


# ---------------------------------------------------------------------------
# phases 14-14d: BASELINE config 3, one-vs-rest and one-vs-one
# ---------------------------------------------------------------------------

def svc_ovr(torch, X, y, backend, **kw):
    """A timed ``DistOneVsRestClassifier(LinearSVC(C=1.0, max_iter=100))``
    (BASELINE config 3's estimator); returns the model and its wall."""
    from skdist_tpu_torch import DistOneVsRestClassifier, LinearSVC

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ovr = DistOneVsRestClassifier(LinearSVC(C=1.0, max_iter=100, **kw),
                                  backend=backend).fit(X, y)
    torch.cuda.synchronize()
    return ovr, time.perf_counter() - t0


def hold_binary_fit(torch, X, y, cls, label):
    """One class's binary ``LinearSVC`` fit on the card against the same
    fit on the CPU, held to 10x the gap one ulp of input noise opens on
    the card (plus 1e-6 of max|W|), as phase 3 holds its refit."""
    from skdist_tpu_torch import LinearSVC

    yb = (y == cls).astype(np.int64)
    if hasattr(X, "tocsr"):
        X_ulp = X.copy()
        X_ulp.data *= np.float32(1 + 2.0 ** -23)
    else:
        X_ulp = X * np.float32(1 + 2.0 ** -23)
    kw = dict(C=1.0, max_iter=100)
    card = LinearSVC(**kw).fit(X, yb)
    # engine="xla": on the CPU, 'auto' is the f64 host engine
    cpu = LinearSVC(device="cpu", engine="xla", **kw).fit(X, yb)
    card_ulp = LinearSVC(**kw).fit(X_ulp, yb)
    dW = float(np.abs(card._params["W"] - cpu._params["W"]).max())
    dulp = float(np.abs(card._params["W"] - card_ulp._params["W"]).max())
    scale = float(np.abs(cpu._params["W"]).max())
    say(f"  {label}: class {cls} card ({int(card.n_iter_)} it) vs cpu "
        f"({int(cpu.n_iter_)} it): max|W| {scale:.3e}, card vs cpu max|dW| "
        f"{dW:.3e}, card vs card on X*(1+ulp) {dulp:.3e}")
    if not dW <= 10 * dulp + 1e-6 * scale:
        raise AssertionError(
            f"{label}: card and CPU binary fits differ by more than 10x what "
            "one ulp of input noise does")


def ovr_readout(torch, ovr, X, y, wall_cold, wall_warm, label):
    """Walls, binary fits/s, train accuracy, the classes' n_iter, and the
    pickled model's predictions against the live one's."""
    n_iter = np.asarray([int(e.n_iter_) for e in ovr.estimators_])
    live = ovr.predict(X)
    acc = float(np.mean(live == y))
    loaded = pickle.loads(pickle.dumps(ovr))
    if not np.array_equal(loaded.predict(X), live):
        raise AssertionError(f"{label}: the pickled model predicts differently")
    st = ovr.round_stats_[0]
    say(f"  cold {wall_cold:.2f}s, warm {wall_warm:.2f}s: "
        f"{len(ovr.estimators_) / wall_warm:.2f} binary fits/s warm; "
        f"{st['mode']} path, {st.get('rounds', 1)} round(s) of "
        f"{st.get('tasks_per_round', st.get('chunk'))}; train accuracy "
        f"{acc:.4f}; classes' n_iter min {n_iter.min()} median "
        f"{np.median(n_iter):.0f} max {n_iter.max()}; pickled model "
        "predicts the same")
    if not np.all(np.isfinite(ovr.decision_function(X[:100]))):
        raise AssertionError(f"{label}: non-finite decisions")
    return acc


def phase_config3(torch, backend):
    """Phase 14: BASELINE config 3 as benchmarks/run_all.py:149-183
    defines it, dense 20-class text, cold then warm."""
    Xd, yd = make_20news_shaped()
    say(f"phase 14: BASELINE config 3, DistOneVsRestClassifier(LinearSVC("
        f"C=1.0, max_iter=100)) on 20news-shaped {Xd.shape}, 20 classes")
    _, cold = svc_ovr(torch, Xd, yd, backend)
    ovr, warm = svc_ovr(torch, Xd, yd, backend)
    ovr_readout(torch, ovr, Xd, yd, cold, warm, "phase 14")
    hold_binary_fit(torch, Xd, yd, 0, "phase 14")
    return {"cold": cold, "warm": warm}


def phase_config3_packed(torch, X, y, backend):
    """Phase 14b: config 3's packed stand-in (the main path's hashed
    text, d = 2**18), the same one-vs-rest; K1 and K2 must launch."""
    from skdist_tpu_torch.ops import packed_sparse as ps

    say(f"phase 14b: the same one-vs-rest on the packed stand-in {X.shape}")
    ps.packed_matvec.launches = ps.packed_rmatvec.launches = 0
    _, cold = svc_ovr(torch, X, y, backend)
    launches = {"packed_matvec": ps.packed_matvec.launches,
                "packed_rmatvec": ps.packed_rmatvec.launches}
    ovr, warm = svc_ovr(torch, X, y, backend)
    say(f"  launches of the cold fit {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"phase 14b: a kernel never launched: {launches}")
    if ovr.round_stats_[0]["x_format"] != "packed":
        raise AssertionError("phase 14b did not run packed")
    ovr_readout(torch, ovr, X, y, cold, warm, "phase 14b")
    hold_binary_fit(torch, X, y, 0, "phase 14b")
    return {"cold": cold, "warm": warm}


def phase_ovo(torch, X, y, backend):
    """Phase 14c: ``DistOneVsOneClassifier(LinearSVC(C=1.0,
    max_iter=100))`` on the packed X, 190 pairs: compacted as one round
    (``partitions=1``: every pair runs to ``max_iter``, so the default's
    8 rounds would only multiply the host-paced iterations), then classic
    at the compacted run's chunk; every pair's W bitwise equal."""
    from skdist_tpu_torch import DistOneVsOneClassifier, LinearSVC

    say("phase 14c: DistOneVsOneClassifier(LinearSVC(C=1.0, max_iter=100)) "
        f"on the packed {X.shape}")

    def fit(compaction, **kw):
        os.environ["SKDIST_COMPACTION"] = "1" if compaction else "0"
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ovo = DistOneVsOneClassifier(LinearSVC(C=1.0, max_iter=100),
                                         backend=backend, **kw).fit(X, y)
            torch.cuda.synchronize()
            return ovo, time.perf_counter() - t0
        finally:
            del os.environ["SKDIST_COMPACTION"]

    comp, wall_c = fit(True, partitions=1)
    st = comp.round_stats_[0]
    n_pairs = len(comp.pairs_)
    say(f"  compacted wall {wall_c:.1f}s ({n_pairs / wall_c:.2f} pair fits/s): "
        + lane_readout(st))
    if st["mode"] != "compacted" or st["tasks"] != n_pairs:
        raise AssertionError(f"phase 14c ran {st['mode']} over {st['tasks']}")
    parts = -(-n_pairs // st["chunk"])
    classic, wall_k = fit(False, partitions=parts)
    sk = classic.round_stats_[0]
    say(f"  classic (SKDIST_COMPACTION=0, partitions={parts}) wall "
        f"{wall_k:.1f}s: {sk['rounds']} rounds x {sk['tasks_per_round']}")
    differ = [t for t, (a, b) in enumerate(zip(comp.estimators_,
                                               classic.estimators_))
              if not np.array_equal(a._params["W"], b._params["W"])]
    if sk["tasks_per_round"] != st["chunk"] or differ:
        raise AssertionError(
            f"OvO compacted and classic differ: chunks {st['chunk']}/"
            f"{sk['tasks_per_round']}, pairs {differ[:5]} ({len(differ)})")
    live = comp.predict(X)
    loaded = pickle.loads(pickle.dumps(comp))
    if not np.array_equal(loaded.predict(X), live):
        raise AssertionError("phase 14c: the pickled model predicts differently")
    say(f"  every pair's W bitwise equal; train accuracy "
        f"{np.mean(live == y):.4f}; pickled model predicts the same")
    return {"compacted": wall_c, "classic": wall_k}


def sgd_ovr_lanes(torch, X, y, max_iter):
    """The one-vs-rest SGD fit problem of the 20 class lanes on the card:
    ``(meta, static, op, y_bin (20, n), sw, hyper)``."""
    from skdist_tpu_torch import SGDClassifier
    from skdist_tpu_torch.distribute.multiclass import _binary_prep
    from skdist_tpu_torch.models.linear import _freeze, to_device_X

    est = SGDClassifier(loss="hinge", max_iter=max_iter, random_state=0)
    X_arr, meta = _binary_prep(est, X)
    static = _freeze(est._static_config(meta))
    op = SGDClassifier._linear_op(to_device_X(X_arr, "cuda"), static)
    classes = np.unique(y)
    yb = torch.as_tensor((y[None, :] == classes[:, None]).astype(np.int32)).cuda()
    T, n = yb.shape
    sw = torch.ones((T, n), device="cuda")
    full = dict(dtype=torch.float32, device="cuda")
    hyper = {"alpha": torch.full((T,), 1e-4, **full),
             "eta0": torch.full((T,), 0.01, **full),
             "l1_ratio": torch.full((T,), 0.15, **full),
             "tol": torch.full((T,), 1e-3, **full)}
    return meta, static, op, yb, sw, hyper


def profile_ovr_sgd_steps(torch, X, y, steps=50):
    """Phase 14d's step alone: the 20 class lanes' SGD batch loop over
    packed X (one row order every lane shares, as the resident round
    draws it). Host microseconds a step over one epoch, then a
    ``torch.profiler`` split of ``steps`` steps: ``row`` (the row
    kernels), ``memset`` (a zeroing pass on the stream), ``big`` (the
    dense ``(T, p, k)`` passes: device time of the PyTorch operators
    that take a tensor of ``T * (p - 1) * k`` elements or more), the
    total and the window's busy time and span. Returns ``(us, split,
    steps)``."""
    from skdist_tpu_torch import SGDClassifier
    from skdist_tpu_torch.models import solvers
    from skdist_tpu_torch.utils.draws import epoch_permutation

    meta, static, op, yb, sw, hyper = sgd_ovr_lanes(torch, X, y, max_iter=20)
    pb = SGDClassifier._build_fit_problem(meta, static)(op, yb, sw, hyper)
    T, n = sw.shape
    padded = -(-n // 64) * 64
    rows = epoch_permutation(0, 0, padded, n, "cuda").expand(T, padded)
    n_batches, batch = pb["batches"](rows)
    w0 = pb["W0"]
    carry4 = (w0, (torch.zeros(T, device="cuda"), torch.zeros_like(w0)),
              torch.zeros(T, dtype=torch.int64, device="cuda"),
              torch.zeros(T, device="cuda"))

    def run(k):
        solvers.sgd_batch_scan(pb["grad_fn"], pb["lr_fn"], pb["post_step"],
                               pb["loss_fn"], carry4, k, batch)
        torch.cuda.synchronize()

    run(min(20, n_batches))
    t0 = time.perf_counter()
    run(n_batches)
    us = 1e6 * (time.perf_counter() - t0) / n_batches
    k = w0.shape[1] // op.p
    split = profile_device_split(
        torch, lambda: run(steps),
        {"row": ("packed_row_",), "memset": ("Memset", "memset")},
        window=True, big=T * (op.p - 1) * k)
    return us, split, steps


def say_step_split(us, split, steps, label):
    """One line of :func:`profile_ovr_sgd_steps`'s readings."""
    line = f"  {label}: {us:.1f} us a step (host clock)"
    if split is None:
        say(line + "; the profiler saw no device time")
        return
    busy, span = split["window"]
    rest = split["total"] - split["row"] - split["memset"] - split["big"]
    say(line + f"; {steps} steps under the profiler: device "
        f"{split['total']:.3f} ms (row kernels {split['row']:.3f}, memset "
        f"{split['memset']:.3f}, dense (T, p, k) passes {split['big']:.3f}, "
        f"the rest {rest:.3f}), busy {busy:.3f} of {span:.3f} ms "
        f"({100 * busy / span:.1f}%); of the busy time: row kernels "
        f"{100 * split['row'] / busy:.1f}%, dense passes "
        f"{100 * split['big'] / busy:.1f}%")


def ovr_sgd_fit(torch, X, y, backend):
    """Phase 14d's fit, ``DistOneVsRestClassifier(SGDClassifier(loss=
    "hinge", max_iter=20, random_state=0))``: ``(model, wall seconds)``."""
    from skdist_tpu_torch import DistOneVsRestClassifier, SGDClassifier

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ovr = DistOneVsRestClassifier(
        SGDClassifier(loss="hinge", max_iter=20, random_state=0),
        backend=backend).fit(X, y)
    torch.cuda.synchronize()
    return ovr, time.perf_counter() - t0


def phase_ovr_sgd(torch, X, y, backend):
    """Phase 14d: ``DistOneVsRestClassifier(SGDClassifier(loss="hinge",
    max_iter=20, random_state=0))`` on the packed X: SGD over packed X
    through the row kernels; card against CPU; slot independence."""
    from skdist_tpu_torch import DistOneVsRestClassifier, SGDClassifier
    from skdist_tpu_torch.ops import packed_sparse as ps
    from skdist_tpu_torch.utils.device import exact_matmuls

    say("phase 14d: DistOneVsRestClassifier(SGDClassifier(loss='hinge', "
        f"max_iter=20)) on the packed {X.shape}")
    ps.packed_row_matvec.launches = ps.packed_row_rmatvec.launches = 0
    ovr, wall = ovr_sgd_fit(torch, X, y, backend)
    launches = {"packed_row_matvec": ps.packed_row_matvec.launches,
                "packed_row_rmatvec": ps.packed_row_rmatvec.launches}
    epochs = np.asarray([int(e.n_iter_) for e in ovr.estimators_])
    n_batches = -(-X.shape[0] // 64)
    steps = int(epochs.max()) * n_batches
    say(f"  wall {wall:.2f}s; lanes' epochs min {epochs.min()} median "
        f"{np.median(epochs):.0f} max {epochs.max()}; the round ran "
        f"{epochs.max()} epochs x {n_batches} batches = {steps} steps, "
        f"{steps / wall:.0f} steps/s; launches {launches}")
    if launches != {"packed_row_matvec": 2 * steps,
                    "packed_row_rmatvec": steps}:
        raise AssertionError(
            f"phase 14d: the row kernels' launches {launches} are not the "
            f"steps' ({steps}: two row matvecs and one row rmatvec a step)")
    live = ovr.predict(X)
    loaded = pickle.loads(pickle.dumps(ovr))
    if not np.array_equal(loaded.predict(X), live):
        raise AssertionError("phase 14d: the pickled model predicts differently")
    say(f"  train accuracy {np.mean(live == y):.4f}; pickled model predicts "
        "the same")

    Xs, ys = X[:2000], y[:2000]
    X_ulp = Xs.copy()
    X_ulp.data *= np.float32(1 + 2.0 ** -23)
    kw = dict(loss="hinge", max_iter=3, random_state=0)

    def stacked(device, Xi):
        m = DistOneVsRestClassifier(SGDClassifier(device=device, **kw)).fit(
            Xi, ys)
        return np.stack([e._params["W"] for e in m.estimators_])

    card, cpu, card_ulp = stacked(None, Xs), stacked("cpu", Xs), \
        stacked(None, X_ulp)
    dW = float(np.abs(card - cpu).max())
    dulp = float(np.abs(card - card_ulp).max())
    scale = float(np.abs(cpu).max())
    say(f"  card against CPU on {Xs.shape}, max_iter=3: max|W| {scale:.3e}, "
        f"card vs cpu max|dW| {dW:.3e}, card vs card on X*(1+ulp) {dulp:.3e}")
    if not dW <= 10 * dulp + 1e-6 * scale:
        raise AssertionError(
            "phase 14d: card and CPU differ by more than 10x what one ulp of "
            "input noise does")
    meta, static, op, yb, sw, hyper = sgd_ovr_lanes(torch, X, y, max_iter=3)
    kernel = SGDClassifier._build_fit_kernel(meta, static)
    rev = torch.arange(yb.shape[0] - 1, -1, -1, device="cuda")
    with exact_matmuls(), torch.no_grad():
        w1 = kernel(op, yb, sw, hyper)["W"]
        w2 = kernel(op, yb[rev], sw[rev], {k: v[rev] for k, v in hyper.items()})
    same = torch.equal(w1, w2["W"][rev])
    say(f"  slot independence, {yb.shape[0]} class lanes against the same "
        "lanes in reverse slots: " + ("bitwise equal" if same else "DIFFER"))
    if not same:
        raise AssertionError("an OvR SGD lane's weights depend on its slot")
    say_step_split(*profile_ovr_sgd_steps(torch, X, y), "bare step")
    return {"wall": wall, "steps": steps}, launches


# ---------------------------------------------------------------------------
# phases 15-16: BASELINE config 5 (batch prediction) and the generic search
# ---------------------------------------------------------------------------

#: config 5's scoring rows (``benchmarks/run_all.py:256``)
PREDICT_N = 1_000_000

#: device activities of a prediction call, by name
PREDICT_SPLIT = {"h2d": ("Memcpy HtoD",), "d2h": ("Memcpy DtoH",),
                 "products": ("gemm", "Gemm", "cutlass", "gemv"),
                 "softmax": ("softmax", "SoftMax")}


def timed_call(torch, fn):
    """``(result, wall seconds)`` of ``fn()``, the device synchronised
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_config5(torch, backend):
    """Phase 15: config 5, ``batch_predict`` of a 10-class logistic
    regression over 1M dense rows, cold then warm, its profiler split and
    its gates. Returns the warm wall."""
    from skdist_tpu_torch import LocalBackend, LogisticRegression, \
        batch_predict
    from skdist_tpu_torch.convert import logistic_regression_from_reference
    from skdist_tpu_torch.distribute.predict import (
        _default_batch_size,
        device_predict_plan,
    )

    X, y, model, Xs = config5_recipe()
    say(f"phase 15: BASELINE config 5, batch_predict(LogisticRegression("
        f"max_iter=40), predict_proba) over {Xs.shape} float32 "
        f"({Xs.nbytes / 1e6:.0f} MB in, {PREDICT_N * 10 * 4 / 1e6:.0f} MB "
        "out)")

    def run(**kw):
        return batch_predict(model, Xs, method="predict_proba",
                             backend=backend, **kw)

    cold, t_cold = timed_call(torch, run)
    warm, t_warm = timed_call(torch, run)
    again, _ = timed_call(torch, run)
    plan = device_predict_plan(model, "predict_proba")
    block = _default_batch_size(PREDICT_N, backend, plan)
    n_blocks = -(-PREDICT_N // block)
    say(f"  cold {t_cold:.3f}s, warm {t_warm:.3f}s, "
        f"{PREDICT_N / t_warm:.0f} rows/s warm; blocks of {block} rows, "
        f"{n_blocks} blocks (the last padded by "
        f"{n_blocks * block - PREDICT_N} rows)")
    if warm.shape != (PREDICT_N, 10):
        raise AssertionError(f"phase 15: output shape {warm.shape}")
    row_err = float(np.abs(warm.sum(axis=1, dtype=np.float64) - 1.0).max())
    if not row_err <= 1e-5:
        raise AssertionError(f"phase 15: rows sum to 1 only within {row_err}")
    if not (np.array_equal(warm, again) and np.array_equal(warm, cold)):
        raise AssertionError("phase 15: repeated calls differ")
    cut = 300_000
    own = np.concatenate([model.predict_proba(Xs[i:i + cut])
                          for i in range(0, PREDICT_N, cut)])
    own_err = float(np.abs(warm - own).max())
    labels = batch_predict(model, Xs, method="predict", backend=backend)
    if not np.array_equal(labels, model.classes_[np.argmax(warm, axis=1)]):
        raise AssertionError("phase 15: predict is not the argmax of "
                             "predict_proba through classes_")
    cpu_model = LogisticRegression(max_iter=40, device="cpu",
                                   engine="xla").fit(X, y)
    card_model = logistic_regression_from_reference(cpu_model._params,
                                                    cpu_model._meta)
    head = Xs[:20000]
    on_cpu = batch_predict(cpu_model, head, method="predict_proba",
                           backend=LocalBackend(device="cpu"))
    on_card = batch_predict(card_model, head, method="predict_proba",
                            backend=backend)
    cpu_err = float(np.abs(on_card - on_cpu).max())
    loaded = pickle.loads(pickle.dumps(model))
    same_pickle = np.array_equal(
        batch_predict(loaded, head, method="predict_proba", backend=backend),
        warm[:20000])
    say(f"  rows sum to 1 within {row_err:.2e}; repeated calls bitwise "
        f"equal; against predict_proba cut at {cut} rows max|d| "
        f"{own_err:.2e}; predict = argmax through classes_; card against "
        f"CPU (converted weights) on {head.shape[0]} rows max|d| "
        f"{cpu_err:.2e}; pickled model "
        + ("predicts the same" if same_pickle else "DIFFERS"))
    if not own_err <= 1e-6:
        raise AssertionError("phase 15: batch_predict and predict_proba "
                             "differ by more than 1e-6")
    if not cpu_err <= 1e-5:
        raise AssertionError("phase 15: card and CPU differ by more than "
                             "1e-5")
    if not same_pickle:
        raise AssertionError("phase 15: the pickled model predicts "
                             "differently")
    # the profiler of a process that has run the earlier phases has been
    # seen to record no device time here, so the split is taken in a
    # process of its own
    res = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--profile-config5"],
        capture_output=True, text=True, timeout=600)
    for line in res.stdout.splitlines():
        say("  " + line)
    if res.returncode != 0:
        raise AssertionError("phase 15: the profiling process failed:\n"
                             + res.stderr[-3000:])
    return t_warm


def config5_recipe():
    """Config 5's model and scoring rows (``benchmarks/run_all.py:240-258``):
    ``(X, y, model fitted on the card, Xs)``."""
    from skdist_tpu_torch import LogisticRegression

    X, y = make_tabular(5000, 64, 10, seed=3)
    model = LogisticRegression(max_iter=40).fit(X, y)
    Xs = np.random.RandomState(4).rand(PREDICT_N, 64).astype(np.float32)
    return X, y, model, Xs


def profile_config5(torch):
    """``--profile-config5``: one warm call of phase 15 under
    ``torch.profiler`` (host-to-device copies, products, softmax,
    device-to-host copies, the device's busy share); raises if the
    profiler records no device time. Returns the exit code."""
    from skdist_tpu_torch import CUDABackend, batch_predict

    _X, _y, model, Xs = config5_recipe()
    backend = CUDABackend()

    def run():
        return batch_predict(model, Xs, method="predict_proba",
                             backend=backend)

    run()
    run()
    split = profile_device_split(torch, run, PREDICT_SPLIT, top=3,
                                 window=True)
    if split is None:
        raise AssertionError("phase 15: the profiler recorded no device "
                             "time for a warm call")
    busy, span = split["window"]
    parts = {k: split[k] for k in PREDICT_SPLIT}
    rest = split["total"] - sum(parts.values())
    pace = max(parts, key=parts.get)
    print("one warm call under torch.profiler (a process of its own): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items())
          + f", rest {rest:.3f} ms (of {split['total']:.3f} ms device "
          f"time); busy {busy:.1f} of {span:.1f} ms "
          f"({100 * busy / span:.1f}%); the largest device share is {pace}; "
          "top of the rest " + ", ".join(
              f"{k[:60]} {v:.3f}" for k, v in split["top_rest"]),
          flush=True)
    return 0


def phase_sparse_predict(torch, X, y, backend):
    """Phase 15b: sparse prediction through K1 at the main path's width.
    Returns K1's launches and the row blocks."""
    from skdist_tpu_torch import LogisticRegression, batch_predict
    from skdist_tpu_torch.distribute.predict import (
        _default_batch_size,
        device_predict_plan,
    )
    from skdist_tpu_torch.ops import packed_sparse as ps

    model = LogisticRegression(max_iter=20).fit(X, y)
    t0 = time.perf_counter()
    Xp, _ = make_20news_sparse(seed=1, n=200_000, d=X.shape[1], nnz_row=40,
                               k=20)
    n, d = Xp.shape
    say(f"phase 15b: batch_predict(LogisticRegression(max_iter=20), "
        f"predict_proba) over sparse {Xp.shape}, nnz {Xp.nnz} "
        f"({time.perf_counter() - t0:.1f}s to make)")
    block = _default_batch_size(n, backend,
                                device_predict_plan(model, "predict_proba"))
    n_blocks = -(-n // block)
    ps.packed_matvec.launches = 0
    out, wall = timed_call(torch, lambda: batch_predict(
        model, Xp, method="predict_proba", backend=backend))
    launches = ps.packed_matvec.launches
    say(f"  wall {wall:.3f}s, {n / wall:.0f} rows/s; {n_blocks} blocks of "
        f"{block} rows, K1 launches {launches}; a dense block would need "
        f"{block * d * 4 / 2**30:.1f} GiB at d={d} (the packed block "
        f"{block * int(np.diff(Xp.indptr).max()) * 8 / 2**20:.1f} MiB)")
    if launches != n_blocks:
        raise AssertionError(f"phase 15b: K1 launched {launches} times for "
                             f"{n_blocks} row blocks")
    if out.shape != (n, 20) or not np.all(np.isfinite(out)):
        raise AssertionError("phase 15b: output not finite of shape "
                             f"({n}, 20)")
    head = Xp[:2000]
    dec = batch_predict(model, head, method="decision_function",
                        backend=backend).astype(np.float64)
    W = np.asarray(model._params["W"], np.float64)
    dense = head.toarray().astype(np.float64)
    exact = dense @ W[:d] + W[d]
    m = int(np.diff(head.indptr).max())
    tol = 2 * (m + 1) * U32 * (np.abs(dense) @ np.abs(W[:d])
                               + np.abs(W[d]))
    err = np.abs(dec - exact)
    say(f"  first 2000 rows' decision against float64: max|d| "
        f"{err.max():.3e} (max|z| {np.abs(exact).max():.3e}, the "
        f"tolerance's least {tol.min():.3e})")
    if not np.all(err <= tol):
        raise AssertionError("phase 15b: the decision through K1 is off the "
                             "float64 product by more than K1's tolerance")
    labels = batch_predict(model, Xp, method="predict", backend=backend)
    if not np.array_equal(labels, model.predict(Xp)):
        raise AssertionError("phase 15b: labels differ from model.predict")
    if not np.array_equal(labels, model.classes_[np.argmax(out, axis=1)]):
        raise AssertionError("phase 15b: labels are not the argmax of the "
                             "probabilities")
    say("  labels equal model.predict on the same rows")
    return launches, n_blocks


def phase_host_predict(torch):
    """Phase 15c: a forest through the host-model path at two thread
    counts, and the prediction function's rows."""
    from skdist_tpu_torch import LocalBackend, batch_predict, \
        get_prediction_udf
    from skdist_tpu_torch.models.forest import RandomForestClassifier

    X, y = make_tabular(FOREST_N, FOREST_D, 2, seed=2)
    forest = RandomForestClassifier(n_estimators=32, max_depth=8).fit(X, y)
    say(f"phase 15c: batch_predict(RandomForestClassifier(32 trees, depth "
        f"8), predict_proba, batch_size=50000) on {X.shape}, host chunks")
    whole, t_whole = timed_call(torch, lambda: forest.predict_proba(X))
    walls = {}
    for n_jobs in (1, 4):
        out, walls[n_jobs] = timed_call(torch, lambda: batch_predict(
            forest, X, method="predict_proba",
            backend=LocalBackend(n_jobs=n_jobs), batch_size=50000))
        if not np.array_equal(out, whole):
            raise AssertionError(
                f"phase 15c: n_jobs={n_jobs} differs from predict_proba "
                f"by {float(np.abs(out - whole).max()):.3e}")
    rows = get_prediction_udf(forest, "predict_proba")(
        *[X[:, j] for j in range(X.shape[1])])
    if rows.shape != (X.shape[0],) or not np.array_equal(np.stack(rows),
                                                         whole):
        raise AssertionError("phase 15c: the prediction function's rows "
                             "differ")
    say(f"  predict_proba {t_whole:.3f}s; n_jobs=1 {walls[1]:.3f}s, "
        f"n_jobs=4 {walls[4]:.3f}s, both bitwise equal to it; the "
        "prediction function's rows equal it")


def phase_generic_search(torch):
    """Phase 16: ``DistGridSearchCV`` over a forest on the generic path at
    one and four host threads and at the default (``n_jobs=None``: a
    thread a CPU core). Returns K4's launches (of all three runs)."""
    from skdist_tpu_torch import DistGridSearchCV
    from skdist_tpu_torch.models.forest import RandomForestClassifier
    from skdist_tpu_torch.ops import hist as kh
    from skdist_tpu_torch.parallel.backend import effective_jobs

    rng = np.random.RandomState(5)
    X = rng.rand(50_000, 28).astype(np.float32)
    s = X @ rng.randn(28) + 0.5 * rng.randn(50_000)
    y = (s > np.median(s)).astype(np.int64)
    grid = {"max_depth": [4, 6, 8], "min_samples_leaf": [1, 20]}
    n_fits = 6 * 3 + 1 + 3
    say(f"phase 16: DistGridSearchCV(RandomForestClassifier(n_estimators=32"
        f"), {grid}, cv=3, scoring=[accuracy, roc_auc], preds=True) on "
        f"{X.shape}, class shares {np.bincount(y) / len(y)}; {n_fits} fits "
        "a run (18 + refit + 3 out-of-fold)")
    kh.level_histogram.launches = 0
    runs, walls = {}, {}
    for n_jobs in (1, 4, None):
        runs[n_jobs], walls[n_jobs] = timed_call(torch, lambda: (
            DistGridSearchCV(
                RandomForestClassifier(n_estimators=32, random_state=0),
                grid, cv=3, scoring=["accuracy", "roc_auc"], refit="roc_auc",
                preds=True, n_jobs=n_jobs).fit(X, y)))
    launches = kh.level_histogram.launches
    # one K4 launch a tree level of each fit (its 32 trees are one round):
    # the grid's 18 fits, then the refit and 3 out-of-fold fits at the
    # best depth, in each of the three runs
    per_run = 3 * sum(grid["max_depth"]) * len(grid["min_samples_leaf"]) \
        + 4 * runs[1].best_params_["max_depth"]
    a, b = runs[1], runs[4]
    keys = [k for k in a.cv_results_ if "_test_" in k]
    differ = [(n_jobs, k) for n_jobs in (4, None) for k in keys
              if not np.array_equal(a.cv_results_[k],
                                    runs[n_jobs].cv_results_[k])]
    scores = np.concatenate([np.ravel(a.cv_results_[k]) for k in keys])
    live = b.best_estimator_.predict_proba(X)
    loaded = pickle.loads(pickle.dumps(b.best_estimator_))
    same_pickle = np.array_equal(loaded.predict_proba(X), live)
    threads = effective_jobs(-1, 18)
    say("  " + ", ".join(
        f"n_jobs={n_jobs} {walls[n_jobs]:.2f}s "
        f"({n_fits / walls[n_jobs]:.2f} fits/s)" for n_jobs in (1, 4))
        + f", default n_jobs=None ({threads} threads for the 18 fits) "
        f"{walls[None]:.2f}s ({n_fits / walls[None]:.2f} fits/s); "
        f"mode {b.round_stats_[0]['mode']}; K4 launches {launches} (3 runs "
        f"x {per_run}, one a tree level of each fit); "
        f"best_params_ {b.best_params_}, best roc_auc {b.best_score_:.6f}; "
        "cv_results_ between n_jobs: "
        + ("bitwise equal" if not differ else f"differ in {differ}"))
    if launches != 3 * per_run:
        raise AssertionError(f"phase 16: K4 launched {launches} times, not "
                             f"3 x {per_run} (one a tree level of each fit)")
    if not np.all(np.isfinite(scores)):
        raise AssertionError("phase 16: a score is not finite")
    if differ:
        raise AssertionError(f"phase 16: n_jobs=1 and {differ} differ")
    if b.preds_.shape != (50_000, 2):
        raise AssertionError(f"phase 16: preds_ shape {b.preds_.shape}")
    if not same_pickle:
        raise AssertionError("phase 16: the pickled best_estimator_ predicts "
                             "differently")
    say(f"  preds_ {b.preds_.shape}; pickled best_estimator_ predicts the "
        "same")
    return launches


# ---------------------------------------------------------------------------
# phases 17-19: the f64 host engine, DistMultiModelSearch, the options
# ---------------------------------------------------------------------------

#: phase 17's depth, cut: ``logspace(-2, 2, 4)``'s first 2 C values,
#: 3 folds (of 5) and the flagship's first 1500 of 11314 rows
#: (its full 4096 features and 20 classes). The uncut phase (4 C x 5
#: folds, all rows) took 557 s on the 8-core host of an H100 machine,
#: ~21 s a fit: scipy's L-BFGS-B update over 4097 x 20 weights costs
#: ~0.15 s an iteration there whatever the rows, the products the rest
HOST_CS = list(np.logspace(-2, 2, 4))[:2]
HOST_ROWS = 1500
HOST_FOLDS = 3


def phase_host_engine(torch, backend):
    """Phase 17: ``DistGridSearchCV(LogisticRegression(engine="host",
    max_iter=100))`` over 4 C x 5 folds on the dense flagship data under
    ``CUDABackend``: the warm C path of the f64 host engine, its gates,
    and its fits/s and iterations warm against cold."""
    from skdist_tpu_torch import DistGridSearchCV, LogisticRegression
    from skdist_tpu_torch.utils.cv import check_cv

    X, y = make_20news_shaped()
    X, y = X[:HOST_ROWS], y[:HOST_ROWS]
    say(f"phase 17: DistGridSearchCV(LogisticRegression(engine='host', "
        f"max_iter=100), {len(HOST_CS)} C x {HOST_FOLDS} folds, accuracy) on "
        f"the dense {X.shape}, under CUDABackend")
    say(f"CUT: phase 17 runs the first {HOST_ROWS} of 11314 rows (all 4096 "
        f"features, 20 classes), {HOST_FOLDS} of 5 folds and "
        f"{len(HOST_CS)} of logspace(-2, 2, 4)'s C values: scipy's L-BFGS-B "
        "update over 4097 x 20 weights sets the host fits' time")
    gs, wall = timed_call(torch, lambda: DistGridSearchCV(
        LogisticRegression(engine="host", max_iter=100), {"C": HOST_CS},
        cv=HOST_FOLDS, scoring="accuracy", backend=backend).fit(X, y))
    st = gs.round_stats_[0]
    fits = st["tasks"] + st["cold_refits"] + 1
    seeded = np.asarray(st["lane_seeded"], bool)
    its = np.asarray(st["lane_n_iter"])
    say(f"  wall {wall:.2f}s for {fits} host fits ({st['tasks']} tasks, "
        f"{st['cold_refits']} capped warm fits refit cold, the refit): "
        f"{fits / wall:.3f} fits/s; the search alone {st['wall_s']:.2f}s in "
        f"{st['chains']} chains; mode {st['mode']}, host fits "
        f"{st['host_fits']} of {st['tasks']}, warm-seeded {st['warm_seeded']}")
    say(f"  iterations a fit: warm-seeded mean {its[seeded].mean():.1f} "
        f"(min {its[seeded].min()}, max {its[seeded].max()}), cold (each "
        f"chain's first) mean {its[~seeded].mean():.1f}; best_params_ "
        f"{gs.best_params_}, best accuracy {gs.best_score_:.6f}")
    if st["mode"] != "host_warm" or st["host_fits"] != st["tasks"] or \
            not hasattr(gs.best_estimator_, "_w_opt64"):
        raise AssertionError("phase 17: a fit did not run the host engine")
    if st["warm_seeded"] < 1:
        raise AssertionError("phase 17: no fit was warm-seeded")
    # fold 0's warm-seeded fits again, each cold and alone (the chain's
    # first fit is cold already)
    train, test = next(iter(check_cv(HOST_FOLDS, y, classifier=True).split(
        X, y)))
    warm_scores = gs.cv_results_["split0_test_score"]
    cold_its, gaps = [], []
    t0 = time.perf_counter()
    for i, C in enumerate(HOST_CS):
        if not seeded[i * HOST_FOLDS]:
            continue
        cold = LogisticRegression(engine="host", max_iter=100, C=C).fit(
            X[train], y[train])
        cold_its.append(int(cold.n_iter_))
        score = float(np.mean(cold.predict(X[test]) == y[test]))
        converged = cold._w_opt64 is not None
        gaps.append((C, converged, abs(score - float(warm_scores[i]))))
    t_cold = time.perf_counter() - t0
    say(f"  fold 0's seeded fits cold, alone: {t_cold:.2f}s for "
        f"{len(cold_its)} fits ({len(cold_its) / t_cold:.3f} fits/s), "
        f"iterations {cold_its} against the chain's "
        f"{list(its[0::HOST_FOLDS])}; |score gap| by C (converged?): "
        + ", ".join(f"{c:.3g} ({conv}) {g:.1e}" for c, conv, g in gaps))
    bad = [(c, g) for c, conv, g in gaps if conv and g > 1e-5]
    if bad:
        raise AssertionError(f"phase 17: tol-converged fits score apart from "
                             f"the warm chain's: {bad}")
    if not any(conv for _c, conv, _g in gaps):
        raise AssertionError("phase 17: no seeded fold-0 fit converged, so "
                             "the warm/cold comparison held nothing")
    loaded = pickle.loads(pickle.dumps(gs))
    keys = [k for k in gs.cv_results_ if k.startswith(("split", "mean_test",
                                                        "rank_test"))]
    if not (all(np.array_equal(loaded.cv_results_[k], gs.cv_results_[k])
                for k in keys)
            and np.array_equal(loaded.predict(X), gs.predict(X))
            and not hasattr(loaded.best_estimator_, "_w_opt64")):
        raise AssertionError("phase 17: the pickled search differs")
    say("  converged fits score as the warm chain's within 1e-5; the "
        "pickled search equals the live one")
    return {"wall": wall, "fits": fits}


MM_N = 4


def multimodel_models():
    """Phase 18's three families (the main path's estimator, config 3's
    and config 2's), 8 values each."""
    from skdist_tpu_torch import LinearSVC, LogisticRegression, SGDClassifier

    return [
        ("lr", LogisticRegression(max_iter=100),
         {"C": list(np.logspace(-2, 2, 8))}),
        ("svc", LinearSVC(max_iter=100), {"C": list(np.logspace(-3, 1, 8))}),
        ("sgd", SGDClassifier(max_iter=20, random_state=0),
         {"alpha": list(np.logspace(-6, -2, 8))}),
    ]


def phase_multimodel(torch, X, y, backend):
    """Phase 18: ``DistMultiModelSearch`` over LogisticRegression,
    LinearSVC and SGDClassifier on the main path's hashed text (packed):
    K1, K2 and both row forms on one search. Returns ``(search,
    launches)``."""
    from skdist_tpu_torch import DistMultiModelSearch
    from skdist_tpu_torch.ops import packed_sparse as ps

    names = ("packed_matvec", "packed_rmatvec", "packed_row_matvec",
             "packed_row_rmatvec")
    say(f"phase 18: DistMultiModelSearch(lr, svc, sgd; n={MM_N}, cv=5, "
        f"accuracy) on the packed {X.shape}")
    for name in names:
        getattr(ps, name).launches = 0
    mm, wall = timed_call(torch, lambda: DistMultiModelSearch(
        multimodel_models(), n=MM_N, cv=5, scoring="accuracy",
        random_state=0, backend=backend).fit(X, y))
    launches = {name: getattr(ps, name).launches for name in names}
    res = mm.cv_results_
    scores = np.asarray(res["mean_test_score"])
    fams = np.asarray(res["model_name"])
    n_batches = -(-X.shape[0] // 64)
    epochs = launches["packed_row_rmatvec"] // n_batches
    say(f"  wall {wall:.2f}s for {len(scores) * 5 + 1} fits; "
        + "; ".join(
            f"{s['model_name']}: {s['round_stats'][0]['mode']}, "
            f"{s['round_stats'][0].get('rounds', '-')} rounds, best "
            f"{np.nanmax(scores[fams == s['model_name']]):.6f}"
            for s in mm.round_stats_)
        + f"; winner {mm.best_model_name_} {mm.best_params_} "
        f"{mm.best_score_:.6f}, worst {mm.worst_score_:.6f}")
    say(f"  launches {launches}; the SGD round's row launches: "
        f"{epochs} epochs x {n_batches} batches")
    if min(launches.values()) <= 0:
        raise AssertionError(f"phase 18: a kernel never launched: {launches}")
    if (launches["packed_row_matvec"] != 2 * launches["packed_row_rmatvec"]
            or launches["packed_row_rmatvec"] % n_batches):
        raise AssertionError(
            f"phase 18: the row kernels' launches {launches} are not two row "
            f"matvecs and one row rmatvec a step of whole {n_batches}-step "
            "epochs")
    split_keys = [k for k in res if k.startswith("split")]
    for fam in ("lr", "svc", "sgd"):
        seg = fams == fam
        if seg.sum() != MM_N or not all(
                np.all(np.isfinite(np.asarray(res[k])[seg]))
                for k in split_keys + ["mean_test_score"]):
            raise AssertionError(f"phase 18: segment {fam} is not {MM_N} "
                                 "finite candidates")
    if mm.best_index_ != int(np.nanargmax(scores)):
        raise AssertionError("phase 18: best_index_ is not the nan-argmax")
    live = mm.predict(X)
    if not np.array_equal(live, mm.best_estimator_.predict(X)):
        raise AssertionError("phase 18: predict differs from the refit's")
    loaded = pickle.loads(pickle.dumps(mm))
    if not (np.array_equal(loaded.predict(X), live)
            and np.array_equal(np.asarray(loaded.cv_results_[
                "mean_test_score"]), scores)):
        raise AssertionError("phase 18: the pickled search differs")
    say(f"  every segment finite; best_index_ {mm.best_index_} is the "
        f"nan-argmax; predict = best_estimator_.predict (accuracy "
        f"{np.mean(live == y):.4f}); the pickled search equals the live one")
    return mm, launches


#: phase 19(a)'s ladder of tolerances for a cold fit that converges
WARM_TOLS = (1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0)


def phase_warm_refit(torch, X, y, mm):
    """Phase 19(a): the phase-18 winner's family refit on the packed X
    from its own fitted coefficients: a cold fit at the winner's params,
    its ``tol`` raised along :data:`WARM_TOLS` until it converges before
    ``max_iter`` (at tighter ones float32 L-BFGS stalls on this data:
    its Armijo steps fall below an ulp of the loss and it runs on to
    ``max_iter``); the seeded refit must then stop at once (its start
    meets ``tol``) with ``coef_`` within solver tolerance. A seeded SGD
    fit restarts its step-size schedule, so its own endpoint does not
    stop it early (in the JAX package too): when SGD wins, the best
    L-BFGS family of the search is refit instead, and SGD's seeded
    refit is only printed. Returns the refit's K1/K2 launches."""
    from skdist_tpu_torch.base import clone
    from skdist_tpu_torch.ops import packed_sparse as ps

    res = mm.cv_results_
    est = clone(mm.best_estimator_)
    if type(est).__name__ == "SGDClassifier":
        cold = mm.best_estimator_
        warm = clone(est).fit(X, y, coef_init=cold.coef_,
                              intercept_init=cold.intercept_)
        say(f"phase 19a: the winner is SGD ({mm.best_params_}): seeded with "
            f"its own coef_ it ran {int(warm.n_iter_)} epochs (cold "
            f"{int(cold.n_iter_)}); refitting the best L-BFGS family instead")
        names = np.asarray(res["model_name"])
        scores = np.asarray(res["mean_test_score"])
        lbfgs = np.flatnonzero(names != "sgd")
        i = int(lbfgs[np.nanargmax(scores[lbfgs])])
        base = dict((n, e) for n, e, _d in mm.models)[names[i]]
        est = clone(base).set_params(**res["params"][i])
    max_iter = est.max_iter
    for tol in WARM_TOLS:
        est.set_params(tol=tol)
        cold, t_cold = timed_call(torch, lambda: clone(est).fit(X, y))
        if int(np.max(cold.n_iter_)) < max_iter:
            break
    ps.packed_matvec.launches = ps.packed_rmatvec.launches = 0
    warm, t_warm = timed_call(torch, lambda: clone(est).fit(
        X, y, coef_init=cold.coef_, intercept_init=cold.intercept_))
    launches = {"packed_matvec": ps.packed_matvec.launches,
                "packed_rmatvec": ps.packed_rmatvec.launches}
    dcoef = float(np.abs(warm.coef_ - cold.coef_).max())
    scale = float(np.abs(cold.coef_).max())
    n_cold, n_warm = int(np.max(cold.n_iter_)), int(np.max(warm.n_iter_))
    say(f"phase 19a: warm refit of {type(est).__name__}(C={est.C:.4g}, "
        f"tol={est.tol:g}) on the packed X: cold {t_cold:.2f}s {n_cold} it, "
        f"seeded with its own coef_/intercept_ {t_warm:.2f}s {n_warm} it; "
        f"max|dcoef| {dcoef:.3e} of max|coef| {scale:.3e}; launches "
        f"{launches}")
    if n_cold >= max_iter:
        raise AssertionError("phase 19a: no cold fit converged")
    if not n_warm <= max(1, n_cold // 4):
        raise AssertionError("phase 19a: the seeded refit did not stop well "
                             "before the cold fit's iterations")
    if not dcoef <= 1e-6 * max(1.0, scale):
        raise AssertionError("phase 19a: the seeded refit moved coef_ beyond "
                             "solver tolerance")
    if min(launches.values()) <= 0:
        raise AssertionError(f"phase 19a: a kernel never launched: {launches}")
    return launches


def clf_data():
    """The JAX package's ``clf_data`` test problem (``tests/conftest.py``):
    180 x 8 rows from three well separated gaussians, 3 classes."""
    rng = np.random.RandomState(0)
    X = np.vstack([rng.normal(loc=c, scale=0.5, size=(60, 8))
                   for c in (-2.0, 0.0, 2.0)]).astype(np.float32)
    y = np.repeat([0, 1, 2], 60)
    perm = rng.permutation(len(y))
    return X[perm], y[perm]


def phase_bf16(torch, X, y):
    """Phase 19(b)-(c): ``matmul_dtype='bfloat16'``. (b) The flagship's
    dense ``LogisticRegression(max_iter=100)`` in bf16 against float32:
    the score within 1e-3; its probabilities' largest gap is printed.
    The 0.05 probability contract is the JAX package's contract test's
    (``tests/test_models_linear.py``), on its own problem, where it is
    defined: both gates on ``clf_data`` on the card. (c) The main path's
    packed operator under bf16: bitwise its gather-contract expression,
    within 0.02 relative of K1's float32 matvec, both timed."""
    from skdist_tpu_torch import LogisticRegression
    from skdist_tpu_torch.sparse import LinearOperator, PackedX, pack_csr_rows
    from skdist_tpu_torch.utils.device import exact_matmuls

    Xd, yd = make_20news_shaped()
    Xc, yc = clf_data()
    for label, Xi, yi in (("the flagship's", Xd, yd), ("clf_data's", Xc, yc)):
        f32, t32 = timed_call(torch, lambda: LogisticRegression(
            max_iter=100).fit(Xi, yi))
        bf, tbf = timed_call(torch, lambda: LogisticRegression(
            max_iter=100, matmul_dtype="bfloat16").fit(Xi, yi))
        ds = abs(f32.score(Xi, yi) - bf.score(Xi, yi))
        dp = float(np.abs(f32.predict_proba(Xi)
                          - bf.predict_proba(Xi)).max())
        say(f"phase 19b: LogisticRegression(max_iter=100) on {label} "
            f"{Xi.shape}: float32 {t32:.2f}s ({int(f32.n_iter_)} it, "
            f"accuracy {f32.score(Xi, yi):.6f}), bf16 {tbf:.2f}s "
            f"({int(bf.n_iter_)} it, accuracy {bf.score(Xi, yi):.6f}); "
            f"|score gap| {ds:.2e}, max|proba gap| {dp:.3e}")
        if hasattr(bf, "_w_opt64") or hasattr(f32, "_w_opt64"):
            raise AssertionError("phase 19b: 'auto' picked the host engine "
                                 "on the card")
        if not ds <= 1e-3:
            raise AssertionError(f"phase 19b: bf16's score on {label} data "
                                 "is outside 1e-3 of float32's")
    if not dp <= 0.05:
        raise AssertionError("phase 19b: bf16's probabilities on clf_data "
                             "are outside 0.05 of float32's")
    del Xd
    idx, val = pack_csr_rows(X)
    packed = PackedX(idx, val, X.shape[1]).to("cuda")
    op16 = LinearOperator(packed, True, matmul_dtype="bfloat16")
    op32 = LinearOperator(packed, True)
    W = torch.as_tensor(0.1 * np.random.RandomState(19).randn(
        op32.p, 20).astype(np.float32), device="cuda")
    with exact_matmuls(), torch.no_grad():
        out = op16.matvec(W)
        expr = (op16.pval.to(torch.bfloat16)[:, :, None]
                * W.to(torch.bfloat16)[op16.pidx.long()]).float().sum(1)
        ref = op32.matvec(W)
        ms16 = cuda_ms(torch, lambda: op16.matvec(W), 20)
        ms32 = cuda_ms(torch, lambda: op32.matvec(W), 20)
    same = torch.equal(out, expr)
    rel = float(((out - ref).abs() / ref.abs().clamp(min=1.0)).max())
    say(f"phase 19c: packed bf16 matvec at the main path's shape (n="
        f"{X.shape[0]}, m={idx.shape[1] + 1}, p={op32.p}, k=20): "
        + ("bitwise" if same else "NOT bitwise")
        + f" its gather expression; max relative gap to K1's float32 "
        f"{rel:.2e}; bf16 gather {ms16:.3f} ms, K1 {ms32:.3f} ms a call")
    if not same or not rel < 0.02:
        raise AssertionError("phase 19c: the packed bf16 matvec breaks its "
                             "contract")


def phase_log_proba(torch, backend):
    """Phase 19(d): the repaired ``batch_predict(..., 'predict_log_proba')``
    on config 5's model equals ``model.predict_log_proba`` on a 300000-row
    cut within 1e-6."""
    from skdist_tpu_torch import batch_predict

    _X, _y, model, Xs = config5_recipe()
    cut = Xs[:300_000]
    out, wall = timed_call(torch, lambda: batch_predict(
        model, cut, method="predict_log_proba", backend=backend))
    own = model.predict_log_proba(cut)
    err = float(np.abs(out - own).max())
    say(f"phase 19d: batch_predict(config 5's model, {cut.shape}, "
        f"'predict_log_proba') {wall:.3f}s, shape {out.shape}; against "
        f"model.predict_log_proba max|d| {err:.2e}")
    if out.shape != (300_000, 10) or not err <= 1e-6:
        raise AssertionError("phase 19d: batch_predict's predict_log_proba "
                             "is not the model's")


def new_phases(torch, X, y, backend):
    """Phases 17-19 (``--phases-17-19`` runs only these): their walls and
    the launches they read."""
    t0 = time.perf_counter()
    phase_host_engine(torch, backend)
    t17 = time.perf_counter()
    mm, mm_launches = phase_multimodel(torch, X, y, backend)
    t18 = time.perf_counter()
    warm_launches = phase_warm_refit(torch, X, y, mm)
    phase_bf16(torch, X, y)
    phase_log_proba(torch, backend)
    t19 = time.perf_counter()
    say(f"phases 17-19 seconds: {t17 - t0:.1f}, {t18 - t17:.1f}, "
        f"{t19 - t18:.1f}")
    return mm_launches, warm_launches


# ---------------------------------------------------------------------------
# phase 20: trees on the batched paths, the BYO forests, the bin memos and
# the host C engine
# ---------------------------------------------------------------------------

#: phase 20a's grid, cv=5: depths around the forest's 8, and a leaf floor
TREE_GRID = {"max_depth": [4, 6, 8], "min_samples_leaf": [1, 50]}
#: 20a's candidate the CPU repeats: the two depth-4 candidates took
#: 19.6 s of plain-torch scatter on the card's host
TREE_CPU_GRID = {"max_depth": [4], "min_samples_leaf": [50]}


def balanced_tabular(n, seed=5):
    """Phase 16's problem at ``n`` rows: uniform features and a balanced
    binary target, a random projection split at its median."""
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 28).astype(np.float32)
    s = X @ rng.randn(28) + 0.5 * rng.randn(n)
    return X, (s > np.median(s)).astype(np.int64)


def tree_lanes_vs_lone(torch, X, y, splits):
    """20a's lane check: the deepest candidate's five fold lanes as the
    search grows them (the same contract calls), against lone fits of
    lanes 0 and 3; returns the keys that differ."""
    from skdist_tpu_torch.models.linear import _freeze
    from skdist_tpu_torch.models.tree import DecisionTreeClassifier

    est = DecisionTreeClassifier(max_depth=8, min_samples_leaf=1)
    data, meta = est._prep_fit_data(X, y)
    static = _freeze(est._static_config(meta))
    kernel = type(est)._build_fit_kernel(meta, static)
    W = np.zeros((len(splits), len(y)), np.float32)
    for i, (train, _test) in enumerate(splits):
        W[i, train] = 1.0
    with torch.no_grad():
        Xb = type(est)._fit_operand(torch.as_tensor(data["X"]).cuda(), meta,
                                    static)
        Y = torch.as_tensor(data["y"]).cuda()
        Wd = torch.as_tensor(W).cuda()
        batch = kernel(Xb, Y, Wd, {})
        differ = []
        for t in (0, 3):
            lone = kernel(Xb, Y, Wd[t:t + 1], {})
            differ += [(t, k) for k in lone
                       if not torch.equal(batch[k][t], lone[k][0])]
    return differ


def phase_tree_search(torch):
    """20a: ``DistGridSearchCV(DecisionTreeClassifier(), TREE_GRID,
    cv=5)`` on 200000 x 28 rows on the card, batched; its K4 launches,
    two lanes against lone fits, the CPU on 20a's depth-4 candidates,
    and the generic path on the same grid. Returns the K4 launches."""
    from skdist_tpu_torch import CUDABackend, DistGridSearchCV
    from skdist_tpu_torch.models.tree import DecisionTreeClassifier
    from skdist_tpu_torch.ops import hist as kh
    from skdist_tpu_torch.utils.cv import check_cv

    X, y = balanced_tabular(200_000)
    n_fits = 6 * 5
    say(f"phase 20a: DistGridSearchCV(DecisionTreeClassifier(), {TREE_GRID}, "
        f"cv=5) on {X.shape}, class shares {np.bincount(y) / len(y)}: "
        f"{n_fits} fits + refit, batched on the card")
    kh.level_histogram.launches = 0
    gs, wall = timed_call(torch, lambda: DistGridSearchCV(
        DecisionTreeClassifier(), TREE_GRID, cv=5).fit(X, y))
    launches = kh.level_histogram.launches
    modes = [st["mode"] for st in gs.round_stats_]
    # one launch a level of each round (a candidate is a bucket of five
    # fold lanes), then the refit's levels
    want = sum(st["rounds"] * p["max_depth"] for st, p in
               zip(gs.round_stats_, gs.cv_results_["params"])) \
        + gs.best_params_["max_depth"]
    say(f"  batched: wall {wall:.3f} s ({n_fits / wall:.2f} fits/s, refit "
        f"{gs.refit_time_:.3f} s), modes {modes}, rounds "
        f"{[st['rounds'] for st in gs.round_stats_]} x "
        f"{[st['tasks_per_round'] for st in gs.round_stats_]} lanes; K4 "
        f"launches {launches} (levels of the rounds + the refit's: {want}); "
        f"best_params_ {gs.best_params_}, best accuracy {gs.best_score_:.6f}")
    if modes != ["classic"] * 6:
        raise AssertionError(f"phase 20a did not run batched: {modes}")
    if launches != want:
        raise AssertionError(f"phase 20a: K4 launched {launches} times, not "
                             f"the {want} levels of its rounds and refit")
    scores = gs.cv_results_["mean_test_score"]
    if not np.all(np.isfinite(scores)):
        raise AssertionError("phase 20a: a score is not finite")
    splits = list(check_cv(5, y, classifier=True).split(X, y))
    differ = tree_lanes_vs_lone(torch, X, y, splits)
    say("  lanes 0 and 3 of the (max_depth=8, min_samples_leaf=1) round "
        "against lone fits of their weights: "
        + ("bitwise equal" if not differ else f"differ in {differ}"))
    if differ:
        raise AssertionError(f"phase 20a: lanes differ from lone fits: "
                             f"{differ}")
    say(f"CUT: phase 20a's CPU run repeats the {TREE_CPU_GRID} candidate "
        "(1 of 6) on all 200000 rows")
    cpu, wall_cpu = timed_call(torch, lambda: DistGridSearchCV(
        DecisionTreeClassifier(device="cpu"), TREE_CPU_GRID, cv=5,
        backend=CUDABackend(device="cpu")).fit(X, y))
    keys = [k for k in cpu.cv_results_ if k.endswith("test_score")
            and not k.startswith("rank")]
    card_rows = [i for i, p in enumerate(gs.cv_results_["params"])
                 if all(p[k] in v for k, v in TREE_CPU_GRID.items())]
    apart = [k for k in keys if not np.array_equal(
        cpu.cv_results_[k], np.asarray(gs.cv_results_[k])[card_rows])]
    say(f"  CPU ({wall_cpu:.2f} s, the scatter engine): scores against the "
        "card's " + ("equal" if not apart else f"differ in {apart}"))
    if apart:
        raise AssertionError(f"phase 20a: card and CPU scores differ: {apart}")
    # the generic path on the same grid: a scalar sample_weight is not a
    # full-length vector, so the search fans out one fit a task, each
    # binning its own training fold (other edges: other scores)
    gen, wall_gen = timed_call(torch, lambda: DistGridSearchCV(
        DecisionTreeClassifier(), TREE_GRID, cv=5).fit(X, y,
                                                       sample_weight=1.0))
    if gen.round_stats_[0]["mode"] != "generic":
        raise AssertionError("phase 20a: the generic comparison ran "
                             f"{gen.round_stats_[0]['mode']}")
    say(f"  generic path, same grid: wall {wall_gen:.3f} s "
        f"({n_fits / wall_gen:.2f} fits/s), best_params_ {gen.best_params_},"
        f" best accuracy {gen.best_score_:.6f}; batched {wall_gen / wall:.2f}x"
        " faster")
    loaded = pickle.loads(pickle.dumps(gs))
    if not np.array_equal(loaded.predict(X[:5000]), gs.predict(X[:5000])):
        raise AssertionError("phase 20a: the pickled search differs")
    return launches


def phase_tree_ovr(torch):
    """20b: one-vs-rest over a tree base on a 7-class tabular target,
    batched. Returns the K4 launches."""
    from skdist_tpu_torch import DistOneVsRestClassifier
    from skdist_tpu_torch.models.tree import DecisionTreeClassifier
    from skdist_tpu_torch.ops import hist as kh

    X, y = make_tabular(200_000, 28, 7, seed=6)
    say(f"phase 20b: DistOneVsRestClassifier(DecisionTreeClassifier("
        f"max_depth=8)) on {X.shape}, 7 classes, class shares "
        f"{np.round(np.bincount(y) / len(y), 3)}")
    kh.level_histogram.launches = 0
    ovr, wall = timed_call(torch, lambda: DistOneVsRestClassifier(
        DecisionTreeClassifier(max_depth=8)).fit(X, y))
    launches = kh.level_histogram.launches
    st = ovr.round_stats_[0]
    proba = ovr.predict_proba(X)
    acc = float(np.mean(ovr.predict(X) == y))
    majority = float(np.bincount(y).max() / len(y))
    say(f"  wall {wall:.3f} s ({7 / wall:.2f} binary fits/s), mode "
        f"{st['mode']}, {st['rounds']} round(s) x {st['tasks_per_round']} "
        f"class lanes, K4 launches {launches}; train accuracy {acc:.4f} "
        f"(majority share {majority:.4f})")
    if st["mode"] != "classic" or st["tasks"] != 7:
        raise AssertionError(f"phase 20b did not run batched: {st}")
    if launches != 8 * st["rounds"]:
        raise AssertionError(f"phase 20b: K4 launched {launches} times, not "
                             f"8 levels x {st['rounds']} rounds")
    if proba.shape != (len(y), 7) or not np.all(np.isfinite(proba)) \
            or not acc > majority:
        raise AssertionError("phase 20b: predict_proba or accuracy off")
    lone = DecisionTreeClassifier(max_depth=8).fit(X, (y == 0).astype(int))
    lane = ovr.estimators_[0]
    differ = [k for k in lone._params
              if not np.array_equal(lone._params[k], lane._params[k])]
    say("  class 0's lane against a lone fit of its binary labels: "
        + ("bitwise equal" if not differ else f"differ in {differ}"))
    if differ:
        raise AssertionError(f"phase 20b: class 0's lane differs: {differ}")
    loaded = pickle.loads(pickle.dumps(ovr))
    if not np.array_equal(loaded.predict_proba(X[:5000]), proba[:5000]):
        raise AssertionError("phase 20b: the pickled model differs")
    return launches


def phase_byo_forest(torch):
    """20c: ``DistForestClassifier(DecisionTreeClassifier(max_features=
    "sqrt"), n_estimators=32)`` on the card, threads against a serial
    ``LocalBackend``."""
    from skdist_tpu_torch import CUDABackend, DistForestClassifier, LocalBackend
    from skdist_tpu_torch.models.tree import DecisionTreeClassifier

    X, y = balanced_tabular(25_000)
    say(f"phase 20c: DistForestClassifier(DecisionTreeClassifier("
        f"max_features='sqrt'), n_estimators=32, random_state=0) on "
        f"{X.shape}: CUDABackend's host threads against a serial "
        "LocalBackend")
    runs, walls = {}, {}
    for label, backend in (("threads", CUDABackend()),
                           ("serial", LocalBackend())):
        runs[label], walls[label] = timed_call(torch, lambda: (
            DistForestClassifier(DecisionTreeClassifier(max_features="sqrt"),
                                 n_estimators=32, random_state=0,
                                 backend=backend).fit(X, y)))
    a, b = runs["threads"], runs["serial"]
    differ = [t for t, (ea, eb) in enumerate(zip(a.estimators_,
                                                 b.estimators_))
              if any(not np.array_equal(ea._params[k], eb._params[k])
                     for k in ea._params)]
    proba = a.predict_proba(X)
    row_err = float(np.abs(proba.sum(axis=1) - 1.0).max())
    loaded = pickle.loads(pickle.dumps(a))
    same_pickle = np.array_equal(loaded.predict_proba(X), proba)
    say(f"  threads {walls['threads']:.2f} s, serial {walls['serial']:.2f} s"
        f" ({32 / walls['threads']:.1f} and {32 / walls['serial']:.1f} "
        f"trees/s); trees " + ("bitwise equal" if not differ
                              else f"differ at {differ}")
        + f"; rows sum to 1 within {row_err:.1e}; train accuracy "
        f"{float(np.mean(a.predict(X) == y)):.4f}; pickled = live: "
        f"{same_pickle}")
    if differ or row_err > 1e-6 or not same_pickle:
        raise AssertionError("phase 20c: threads and serial differ, rows do "
                             "not sum to 1, or the pickle differs")


def phase_forest_memo(torch, warm_wall):
    """20d: two fits of phase 6's forest under ``CUDABackend(
    reuse_broadcast=True)``: the second reads the bin memos."""
    from skdist_tpu_torch import CUDABackend, DistRandomForestClassifier
    from skdist_tpu_torch.models import forest as fm

    X, y = make_tabular(FOREST_N, FOREST_D, 2, seed=2)
    fm._EDGE_MEMO.clear()
    fm._XB_MEMO.clear()
    bk = CUDABackend(reuse_broadcast=True)
    first, wall1 = timed_call(torch, lambda: DistRandomForestClassifier(
        backend=bk, **FOREST).fit(X, y))
    xb = next(iter(fm._XB_MEMO.values()))[2]
    second, wall2 = timed_call(torch, lambda: DistRandomForestClassifier(
        backend=bk, **FOREST).fit(X, y))
    hit = next(iter(fm._XB_MEMO.values()))[2] is xb \
        and len(fm._EDGE_MEMO) == 1 and len(fm._XB_MEMO) == 1
    differ = [k for k in first._trees
              if not np.array_equal(first._trees[k], second._trees[k])]
    say(f"phase 20d: DistRandomForestClassifier({FOREST}) on {X.shape} "
        f"under CUDABackend(reuse_broadcast=True): first fit {wall1:.3f} s, "
        f"second {wall2:.3f} s (phase 6's warm fit without the memos "
        f"{warm_wall:.3f} s); memo hit {hit}; trees "
        + ("bitwise equal" if not differ else f"differ in {differ}"))
    if not hit or differ:
        raise AssertionError("phase 20d: the bin memos missed or the trees "
                             "differ")
    fm._EDGE_MEMO.clear()
    fm._XB_MEMO.clear()


def phase_native_engine(torch):
    """20e: the host C engine built on this machine's host, then a
    16-tree forest on the CPU against the torch engine's."""
    from skdist_tpu_torch import native
    from skdist_tpu_torch.models.forest import RandomForestClassifier

    # built in phase 1, from this checkout's source, by this host's cc
    if not native.hist_tree_available():
        raise AssertionError(f"phase 20e: the C engine did not build: "
                             f"{native.build_error()}")
    X, y = balanced_tabular(20_000, seed=4)
    kw = dict(n_estimators=16, max_depth=8, bootstrap=True,
              max_features=None, random_state=0, device="cpu")
    nat, w_nat = timed_call(torch, lambda: RandomForestClassifier(
        hist_mode="native", **kw).fit(X, y))
    tor, w_tor = timed_call(torch, lambda: RandomForestClassifier(
        hist_mode="scatter", **kw).fit(X, y))
    differ = [k for k in ("feat", "thr", "is_split", "leaf", "seed")
              if not np.array_equal(nat._trees[k], tor._trees[k])]
    # a gain is sl + sr - st over sums of squares: float32 cancellation
    # moves a small gain's relative bits, so the gap is read against the
    # largest gain
    gain = float(np.max(np.abs(nat._trees["gain"] - tor._trees["gain"]))
                 / np.max(np.abs(tor._trees["gain"])))
    say(f"phase 20e: the host C engine (built in phase 1); "
        f"RandomForestClassifier({kw}) on {X.shape}: native {w_nat:.2f} s, "
        f"torch engine (scatter) {w_tor:.2f} s; trees "
        + ("equal (feat, thr, is_split, leaf, seed)" if not differ
           else f"differ in {differ}")
        + f", recorded gains (float64 in C, float32 in torch) within "
        f"{gain:.1e} of the largest")
    if differ or gain > 1e-5:
        raise AssertionError("phase 20e: the native forest is not the torch "
                             "engine's")


def phase_trees(torch, warm_wall):
    """Phase 20 (``--phase-20`` runs only it): returns the K4 launches of
    20a and 20b."""
    t0 = time.perf_counter()
    search_launches = phase_tree_search(torch)
    ovr_launches = phase_tree_ovr(torch)
    phase_byo_forest(torch)
    phase_forest_memo(torch, warm_wall)
    phase_native_engine(torch)
    say(f"phase 20 seconds: {time.perf_counter() - t0:.1f}")
    return search_launches, ovr_launches


# ---------------------------------------------------------------------------
# phase 21: histogram gradient boosting on K4's Newton channels, and naive
# Bayes
# ---------------------------------------------------------------------------

#: 21c's grid, cv=3: 8 log-spaced learning rates x two lambdas = 48 lanes
GBDT_GRID = {"learning_rate": list(np.logspace(-2, 0, 8)),
             "l2_regularization": [0.0, 1.0]}
#: K4 at the boosting round's shapes: lanes a launch (one binary fit, one
#: 7-class round, 21c's compacted round of 6, and all 48 of its lanes)
#: and the levels of max_depth=5
GBDT_K4_T = (1, 6, 7, 48)
GBDT_K4_NL = (1, 2, 4, 8, 16)
#: 21f's grids at cv=5: 12 values each, 60 lanes
NB_ALPHAS = list(np.logspace(-3, 1, 12))
NB_SMOOTHING = list(np.logspace(-9, -1, 12))
#: the JAX-fitted models of 21e (build_tools/make_torch_reference_models.py)
REFERENCE_MODELS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "build_tools", "torch_reference_models.npz")


class FittedReference:
    """A fitted JAX estimator's state as the port's converters read it:
    ``_params``, ``_meta`` and ``get_params``, rebuilt from the arrays of
    ``REFERENCE_MODELS`` (the card's machine has no JAX)."""

    def __init__(self, params, meta, est_params):
        self._params, self._meta, self._est_params = params, meta, est_params

    def get_params(self, deep=False):
        return dict(self._est_params)


def reference_models():
    """``(X, {name: (fitted reference, JAX proba, JAX decision)})``: the
    rows the JAX package predicted and its GBDT and GaussianNB."""
    z = np.load(REFERENCE_MODELS)
    X, _ = balanced_tabular(int(z["n_fit"]), seed=int(z["seed"]))
    out = {}
    for name, cls_name in (("gbdt", "DistHistGradientBoostingClassifier"),
                           ("gnb", "GaussianNB")):
        head = f"{name}.params."
        params = {k[len(head):]: z[k] for k in z.files if k.startswith(head)}
        meta = json.loads(str(z[f"{name}.meta"]))
        meta["classes"] = np.asarray(meta["classes"])
        ref = type(cls_name, (FittedReference,), {})(
            params, meta, json.loads(str(z[f"{name}.get_params"])))
        out[name] = (ref, z[f"{name}.proba"], z[f"{name}.decision"])
    return X[:int(z["n_check"])], out


def newton_lanes(torch, y, T, n, seed):
    """A boosting round's channels of ``T`` lanes: sigmoid gradients and
    hessians of random margins on the labels ``y``, each lane under its
    cv=3 fold mask (lane t trains on the rows outside fold ``t % 3``)."""
    from skdist_tpu_torch.models.tree import newton_channels

    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.sigmoid(torch.randn((T, n), generator=g, device="cuda"))
    yt = torch.as_tensor(y[:n], dtype=torch.float32).cuda()
    fold = torch.arange(n, device="cuda") % 3
    w = (fold[None] != torch.arange(T, device="cuda")[:, None] % 3).float()
    return newton_channels(p - yt, p * (1 - p), w), g


def gbdt_k4(torch, X, y):
    """21k: K4 against its plain version at the boosting round's shapes
    (n=200000, d=28, B=64, C=3 Newton channels, T lanes a launch, every
    level of max_depth=5), its time a level beside the bound and the
    ``index_add_`` yardstick; the plain version's time at T=48, nl=16.
    Returns (max error, {(T, nl): times})."""
    from skdist_tpu_torch.ops import hist as kh
    from skdist_tpu_torch.ops.binning import apply_bins, quantile_bin_edges

    n, d = X.shape
    B = 64
    Xb = apply_bins(torch.as_tensor(X).cuda(), quantile_bin_edges(X, B))
    Xs = kh.kernel_bins(Xb, B)
    errs, times = [], {}
    for T in GBDT_K4_T:
        Y, g = newton_lanes(torch, y, T, n, seed=T)
        proof = kh.integer_channels(Y)
        if proof is None or proof.mask != 0b100:
            raise AssertionError("phase 21k: the count channel's proof is "
                                 f"not the only one: {proof and proof.mask}")
        src = Y[:, None].expand(T, d, n, 3).reshape(-1, 3)
        live = torch.any(Y != 0, dim=-1)
        for nl in GBDT_K4_NL:
            key = torch.randint(0, nl, (T, n), generator=g, device="cuda",
                                dtype=torch.int32)
            key = torch.where(live, key, nl).to(torch.int32)
            err, exact = check_k4(torch, kh, Xs, Xb, key, Y, nl, B,
                                  f"GBDT T={T} nl={nl}")
            if exact != [2]:
                raise AssertionError(f"phase 21k: channels {exact} held "
                                     "bitwise, not the count channel")
            errs.append(err)
            ms = cuda_ms(torch, lambda: kh.level_histogram(
                Xs, key, Y, nl, B, integer=proof), 5)
            lib_call, lib_result = k4_yardstick(torch, Xb, key, Y, nl, B, src)
            lib_ms = cuda_ms(torch, lib_call, 2)
            del lib_call, lib_result
            times[(T, nl)] = {"ms": ms, "library_ms": lib_ms, "err": err,
                              "bound": k4_bound(key, Xs, 3, nl, B, d)}
        del src
        torch.cuda.empty_cache()
    times["plain_ms"] = cuda_ms(
        torch, lambda: kh.level_histogram_ref(Xb, key, Y, nl, B), 2)
    say(f"phase 21k: K4 at the boosting round's shapes (n={n}, d={d}, B={B},"
        " C=3: s*g, s*h fractional in float cells, the count in int32 "
        "cells under its proof; cv=3 fold masks folded out of the keys): "
        "count channel bitwise, g and h within the float32 summation "
        f"bound, max err {max(errs):.3e}")
    for T in GBDT_K4_T:
        row = [times[(T, nl)] for nl in GBDT_K4_NL]
        say(f"  T={T}: " + "; ".join(
            f"nl={nl} {v['ms']:.4f} ms (bound {v['bound'][0]:.4f} ms "
            f"{v['bound'][1]}, {v['ms'] / v['bound'][0]:.1f}x; index_add_ "
            f"{v['library_ms']:.3f} ms)"
            for nl, v in zip(GBDT_K4_NL, row)))
        say(f"    the 5 levels: K4 {sum(v['ms'] for v in row):.4f} ms, bound "
            f"{sum(v['bound'][0] for v in row):.4f} ms, index_add_ "
            f"{sum(v['library_ms'] for v in row):.3f} ms")
    say(f"  plain version at T=48, nl=16: {times['plain_ms']:.3f} ms")
    return max(errs), times


def ulp_weights(n, seed):
    """Sample weights of one ulp of noise: 1 +- 2**-23 at random. A
    tree's bins absorb an ulp of noise in X (both sides of every edge
    move together), so a boosted fit's own rounding scale is read through
    the weights, which scale every gradient and hessian term."""
    rng = np.random.RandomState(seed)
    return (1.0 + rng.choice([-1.0, 1.0], n) * 2.0 ** -23).astype(np.float32)


def hold_to_ulp(label, z, z_other, z_ulps):
    """Gate: ``z_other`` within 10x of what one ulp of weight noise moves
    the card's own decisions ``z`` (the largest gap of ``z_ulps``), plus
    1e-5 of max|z| for fits the noise leaves unmoved. Returns the gaps."""
    gap = float(np.abs(z - z_other).max())
    ulp = max(float(np.abs(z - u).max()) for u in z_ulps)
    scale = float(np.abs(z).max())
    if not gap <= 10 * ulp + 1e-5 * scale:
        raise AssertionError(f"{label}: gap {gap:.3e} is over 10x the ulp "
                             f"gap {ulp:.3e} (+1e-5 of {scale:.3e})")
    return gap, ulp, scale


def gbdt_binary(torch):
    """21a: one binary fit at full width with the JAX package's defaults
    (early stopping on above 10000 rows); its K4 launches, two identical
    fits' bits, rows summing to 1, the pickle, a profiled 5-round fit,
    and the card against the CPU on 20000 rows. Returns (model, X,
    launches)."""
    from skdist_tpu_torch import DistHistGradientBoostingClassifier as GBC
    from skdist_tpu_torch.ops import hist as kh

    X, y = balanced_tabular(200_000)
    say(f"phase 21a: DistHistGradientBoostingClassifier() on {X.shape} "
        "(max_iter=100, max_depth=5, max_bins=64, learning_rate=0.1, "
        "early_stopping='auto': on)")
    kh.level_histogram.launches = 0
    est, wall = timed_call(torch, lambda: GBC().fit(X, y))
    launches = kh.level_histogram.launches
    again, wall2 = timed_call(torch, lambda: GBC().fit(X, y))
    same = [k for k in est._params
            if np.array_equal(est._params[k], again._params[k])]
    proba = est.predict_proba(X)
    row_err = float(np.abs(proba.sum(axis=1) - 1.0).max())
    acc = float(np.mean(est.predict(X) == y))
    loaded = pickle.loads(pickle.dumps(est))
    pickled = all(np.array_equal(loaded._params[k], est._params[k])
                  for k in est._params) and np.array_equal(
        loaded.predict_proba(X[:5000]), proba[:5000])
    say(f"  wall {wall:.3f} s (again {wall2:.3f} s), n_iter_ {est.n_iter_} "
        f"({est.n_iter_ / wall:.1f} rounds/s), K4 launches {launches} "
        f"(n_iter_ x 5 = {est.n_iter_ * 5}); train accuracy {acc:.4f}; rows "
        f"sum to 1 within {row_err:.1e}; pickled = live: {pickled}; a "
        "second identical fit: "
        + ("bitwise equal" if len(same) == len(est._params)
           else f"equal only in {same}, n_iter_ {again.n_iter_}"))
    if launches != est.n_iter_ * 5 or row_err > 1e-6 or not pickled:
        raise AssertionError("phase 21a: K4 launches, rows or the pickle")
    split = profile_device_split(
        torch, lambda: GBC(max_iter=5, early_stopping=False).fit(X, y),
        {"K4": ("level_histogram",)}, window=True, top=4)
    if split is None:
        say("  profiled 5-round fit: the profiler saw no device time")
    else:
        busy, span = split["window"]
        say(f"  profiled 5-round fit: device {split['total'] / 5:.3f} ms a "
            f"round, K4 {split['K4'] / 5:.3f} ms, glue "
            f"{(split['total'] - split['K4']) / 5:.3f} ms; busy {busy:.1f} "
            f"of {span:.1f} ms ({100 * busy / span:.1f}%); top glue "
            + ", ".join(f"{k[:40]} {v:.2f} ms" for k, v in split["top_rest"]))
    # the card against the CPU, and against one ulp of weight noise
    Xs, ys = X[:20_000], y[:20_000]
    kw = dict(max_iter=20, early_stopping=False)
    card = GBC(**kw).fit(Xs, ys)
    cpu, wall_cpu = timed_call(torch, lambda: GBC(device="cpu", **kw).fit(
        Xs, ys))
    ulps = [GBC(**kw).fit(Xs, ys, sample_weight=ulp_weights(len(ys), s))
            for s in (1, 2)]
    z = card.decision_function(Xs)
    gap, ulp, scale = hold_to_ulp(
        "phase 21a card vs CPU", z, cpu.decision_function(Xs),
        [u.decision_function(Xs) for u in ulps])
    trees = sum(np.array_equal(card._params[k], cpu._params[k])
                for k in ("feat", "thr", "is_split"))
    say(f"  card vs CPU ({kw}, 20000 rows; CPU {wall_cpu:.2f} s): max|dz| "
        f"{gap:.3e}, one ulp of weight noise moves the card's fit "
        f"{ulp:.3e}, max|z| {scale:.3e}; trees "
        + ("equal" if trees == 3 else "differ (a near tie broken by another "
           "summation order)"))
    return est, launches


def gbdt_multiclass(torch):
    """21b: a 7-class fit on phase 20b's problem; K trees ride each
    launch. Returns the K4 launches."""
    from skdist_tpu_torch import DistHistGradientBoostingClassifier as GBC
    from skdist_tpu_torch.ops import hist as kh

    X, y = make_tabular(200_000, 28, 7, seed=6)
    kh.level_histogram.launches = 0
    est, wall = timed_call(torch, lambda: GBC().fit(X, y))
    launches = kh.level_histogram.launches
    proba = est.predict_proba(X)
    acc = float(np.mean(est.predict(X) == y))
    majority = float(np.bincount(y).max() / len(y))
    row_err = float(np.abs(proba.sum(axis=1) - 1.0).max())
    say(f"phase 21b: DistHistGradientBoostingClassifier() on {X.shape}, 7 "
        f"classes: wall {wall:.3f} s, n_iter_ {est.n_iter_} (7 trees a "
        f"round), K4 launches {launches} (n_iter_ x 5 = {est.n_iter_ * 5}); "
        f"train accuracy {acc:.4f} (majority {majority:.4f}); rows sum to 1 "
        f"within {row_err:.1e}")
    if launches != est.n_iter_ * 5 or proba.shape != (len(y), 7) \
            or row_err > 1e-6 or not acc > majority:
        raise AssertionError("phase 21b: K4 launches, proba or accuracy off")
    return launches


def gbdt_lanes_vs_lone(torch, X, y):
    """21c's lane check: six lanes of the grid (its compacted round's
    width) fitted as one batch, lanes 0 and 1 (one learning rate, lambda
    0 and 1, folds 0 and 1) against lone fits of their candidates on
    their folds, each held to 10x what one ulp of weight noise moves the
    lone fit. Returns the gaps."""
    from skdist_tpu_torch import DistHistGradientBoostingClassifier as GBC
    from skdist_tpu_torch.models.linear import _freeze

    est = GBC(early_stopping=False)
    data, meta = est._prep_fit_data(X, y)
    static = _freeze(est._static_config(meta))
    kernel = GBC._build_fit_kernel(meta, static)
    decide = GBC._build_decision_kernel(meta, static)
    lrs = GBDT_GRID["learning_rate"]
    cands = [(lrs[5], 0.0), (lrs[5], 1.0), (lrs[7], 0.0), (lrs[7], 1.0),
             (lrs[2], 0.0), (lrs[2], 1.0)]
    n = len(y)
    fold = np.arange(n) % 3
    W = np.stack([(fold != t % 3).astype(np.float32) for t in range(6)])
    hyper = {"learning_rate": np.float32([c[0] for c in cands]),
             "l2_regularization": np.float32([c[1] for c in cands]),
             "tol": np.full(6, 1e-7, np.float32)}
    with torch.no_grad():
        Xd = torch.as_tensor(X).cuda()
        Xb = GBC._fit_operand(Xd, meta, static)
        yd = torch.as_tensor(data["y"]).cuda()
        Wd = torch.as_tensor(W).cuda()
        hd = {k: torch.as_tensor(v).cuda() for k, v in hyper.items()}
        batch = decide(kernel(Xb, yd, Wd, hd), Xd).cpu().numpy()
        gaps = []
        for t in (0, 1):
            one = {k: v[t:t + 1] for k, v in hd.items()}
            lone = decide(kernel(Xb, yd, Wd[t:t + 1], one), Xd)[0]
            ulps = [decide(kernel(Xb, yd, Wd[t:t + 1] * torch.as_tensor(
                ulp_weights(n, 3 + t)).cuda(), one), Xd)[0].cpu().numpy()]
            gaps.append(hold_to_ulp(f"phase 21c lane {t}",
                                    lone.cpu().numpy(), batch[t], ulps))
    return gaps


def gbdt_search(torch):
    """21c: ``DistGridSearchCV`` over GBDT_GRID, cv=3 (48 lanes) on
    200000 x 28, compacted; two lanes against lone fits; then
    ``HalvingSpec(eta=3, min_slices=4)``. Returns the K4 launches of the
    search."""
    from skdist_tpu_torch import (DistGridSearchCV, HalvingSpec,
                                  DistHistGradientBoostingClassifier as GBC)
    from skdist_tpu_torch.ops import hist as kh

    X, y = balanced_tabular(200_000)
    say(f"phase 21c: DistGridSearchCV(DistHistGradientBoostingClassifier("
        f"early_stopping=False), 8 log-spaced learning_rate x "
        f"l2_regularization {{0, 1}}, cv=3, neg_log_loss) on {X.shape}: 48 "
        "fits + refit")
    kh.level_histogram.launches = 0
    est = GBC(early_stopping=False)
    gs, wall = timed_call(torch, lambda: DistGridSearchCV(
        est, GBDT_GRID, cv=3, scoring="neg_log_loss").fit(X, y))
    launches = kh.level_histogram.launches
    st = gs.round_stats_[0]
    say(f"  wall {wall:.3f} s ({48 / (wall - gs.refit_time_):.2f} fits/s; "
        f"refit {gs.refit_time_:.3f} s), K4 launches {launches} (5 levels x "
        f"100 rounds x {-(-48 // st['chunk'])} rounds of lanes + the "
        f"refit's); " + lane_readout(st))
    say(f"  best_params_ {gs.best_params_}, best_score_ {gs.best_score_:.6f}")
    if st["mode"] != "compacted" or st["tasks"] != 48:
        raise AssertionError(f"phase 21c ran {st['mode']} over {st['tasks']}")
    if not np.all(np.isfinite(gs.cv_results_["mean_test_score"])):
        raise AssertionError("phase 21c: a score is not finite")
    # no lane stops early: every round of lanes boosts all 100 rounds, 5
    # levels each, and so does the refit
    want = 5 * (100 * -(-48 // st["chunk"]) + gs.best_estimator_.n_iter_)
    if launches != want:
        raise AssertionError(f"phase 21c: K4 launched {launches} times, not "
                             f"{want}")
    gaps = gbdt_lanes_vs_lone(torch, X, y)
    say("  lanes 0 and 1 of a six-lane batch (lambda 0 and 1) against lone "
        "fits: max|dz| " + ", ".join(f"{g:.3e} (ulp gap {u:.3e})"
                                     for g, u, _ in gaps))
    # a rung every 4 slices (52 of 100 rounds): with one every slice the
    # last rung fell at 39 rounds, where the fastest rate leads, and the
    # race kept learning_rate=1.0 over the exhaustive best's 0.518 on an
    # H100 (PERF.md)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ad, wall_ad = timed_call(torch, lambda: DistGridSearchCV(
            est, GBDT_GRID, cv=3, scoring="neg_log_loss",
            adaptive=HalvingSpec(eta=3, min_slices=4)).fit(X, y))
    rung = np.asarray(ad.cv_results_["rung_"])
    sa = ad.round_stats_[0]
    say(f"  HalvingSpec(eta=3, min_slices=4): wall {wall_ad:.3f} s against "
        f"{wall:.3f} s exhaustive; rung history "
        f"{[(h['slice'], h['n_groups'], h['n_killed']) for h in sa['rung_history']]}"
        " (slice, candidates, lanes killed)")
    say(f"  candidates killed {int((rung >= 0).sum())} of 16 "
        f"(rungs {sorted(set(rung[rung >= 0].tolist()))}), lanes "
        f"rung-killed {sa['retired_rung']}, best_params_ {ad.best_params_}")
    if not (rung >= 0).any() or rung[ad.best_index_] != -1 \
            or ad.best_params_ != gs.best_params_:
        raise AssertionError("phase 21c: the race killed nothing or lost the "
                             "exhaustive best")
    return launches


def gbdt_regressor(torch):
    """21d: the regressor (defaults) on a regression target of 21a's X.
    Returns the K4 launches."""
    from skdist_tpu_torch import DistHistGradientBoostingRegressor as GBR
    from skdist_tpu_torch.ops import hist as kh

    X, _ = balanced_tabular(200_000)
    rng = np.random.RandomState(8)
    t = (X @ rng.randn(28) + 0.5 * rng.randn(len(X))).astype(np.float32)
    kh.level_histogram.launches = 0
    est, wall = timed_call(torch, lambda: GBR().fit(X, t))
    launches = kh.level_histogram.launches
    r2 = est.score(X, t)
    say(f"phase 21d: DistHistGradientBoostingRegressor() on {X.shape}: wall "
        f"{wall:.3f} s, n_iter_ {est.n_iter_}, K4 launches {launches}; train "
        f"r2 {r2:.4f}")
    if launches != est.n_iter_ * 5 or not r2 > 0.5:
        raise AssertionError("phase 21d: K4 launches or r2 off")
    return launches


def gbdt_predict(torch, est):
    """21e: ``batch_predict`` of 21a's model over 1M rows against its own
    ``predict_proba``; the JAX-fitted GBDT and GaussianNB converted and
    predicted on the card."""
    from skdist_tpu_torch import batch_predict, convert

    X, _ = balanced_tabular(PREDICT_N)
    cold, wall_cold = timed_call(torch, lambda: batch_predict(
        est, X, "predict_proba"))
    warm, wall_warm = timed_call(torch, lambda: batch_predict(
        est, X, "predict_proba"))
    direct = est.predict_proba(X)
    err = float(np.abs(warm - direct).max())
    say(f"phase 21e: batch_predict(21a's model, {X.shape}, 'predict_proba'):"
        f" cold {wall_cold:.3f} s, warm {wall_warm:.3f} s "
        f"({PREDICT_N / wall_warm:.0f} rows/s); against predict_proba max "
        f"err {err:.1e}; repeat bitwise: {np.array_equal(cold, warm)}")
    if err > 1e-6:
        raise AssertionError("phase 21e: batch_predict differs")
    rows, refs = reference_models()
    for name, (ref, proba, dec) in refs.items():
        conv = (convert.gbdt_from_reference if name == "gbdt"
                else convert.naive_bayes_from_reference)(ref)
        z = conv.decision_function(rows)
        dz = float(np.abs(z - dec).max()) / float(np.abs(dec).max())
        dp = float(np.abs(conv.predict_proba(rows) - proba).max())
        tol = 1e-6 if name == "gbdt" else 1e-5
        say(f"  the JAX package's {type(ref).__name__} converted, on the "
            f"card: decisions within {dz:.1e} of the largest, probabilities "
            f"within {dp:.1e} of the JAX package's (gate {tol:g} of the "
            "largest decision)")
        if dz > tol or dp > tol * max(1.0, float(np.abs(dec).max())):
            raise AssertionError(f"phase 21e: the converted {name} differs")


def nb_searches(torch):
    """21f: naive Bayes searches on the dense flagship; a MultinomialNB
    candidate's scores on the CPU against the card's, GaussianNB's
    decisions card against CPU, and a DistMultiModelSearch of GaussianNB
    beside LogisticRegression."""
    from skdist_tpu_torch import (CUDABackend, DistGridSearchCV,
                                  DistMultiModelSearch, GaussianNB,
                                  LogisticRegression, MultinomialNB)

    X, y = make_20news_shaped()
    say(f"phase 21f: naive Bayes on the dense flagship {X.shape}, 20 "
        "classes, cv=5")
    out = {}
    for name, est, grid in (
            ("MultinomialNB", MultinomialNB(), {"alpha": NB_ALPHAS}),
            ("GaussianNB", GaussianNB(), {"var_smoothing": NB_SMOOTHING})):
        gs, wall = timed_call(torch, lambda: DistGridSearchCV(
            est, grid, cv=5).fit(X, y))
        st = gs.round_stats_[0]
        scores = gs.cv_results_["mean_test_score"]
        say(f"  {name}, {len(next(iter(grid.values())))} values x 5 folds: "
            f"wall {wall:.3f} s ({60 / (wall - gs.refit_time_):.1f} fits/s), "
            f"{st['mode']}, {st['rounds']} round(s) x {st['tasks_per_round']}"
            f" lanes; best_params_ {gs.best_params_}, best accuracy "
            f"{gs.best_score_:.4f}")
        if st["mode"] != "classic" or not np.all(np.isfinite(scores)):
            raise AssertionError(f"phase 21f: {name}'s search")
        out[name] = gs
    alpha = NB_ALPHAS[6]
    cpu, wall_cpu = timed_call(torch, lambda: DistGridSearchCV(
        MultinomialNB(device="cpu"), {"alpha": [alpha]}, cv=5,
        backend=CUDABackend(device="cpu")).fit(X, y))
    keys = [k for k in cpu.cv_results_ if k.startswith("split")]
    gap = max(abs(float(cpu.cv_results_[k][0])
                  - float(out["MultinomialNB"].cv_results_[k][6]))
              for k in keys)
    say(f"  MultinomialNB(alpha={alpha:.4g}) on the CPU ({wall_cpu:.2f} s): "
        f"split scores within {gap:.1e} of the card's")
    if gap > 1e-5:
        raise AssertionError("phase 21f: the CPU's scores differ")
    # GaussianNB card against CPU at the search's best var_smoothing. At
    # the default 1e-9 a feature a class never uses has a variance that is
    # the float32 residual of its centred moments (about 1e-11 against a
    # smoothing of about 1e-10), so both devices' decisions there are
    # rounding noise (on an H100: 0.33 of the largest apart, 98.2% of the
    # predictions equal; PERF.md); it is printed, not gated
    for vs, gated in ((NB_SMOOTHING[-1], True), (1e-9, False)):
        g_card = GaussianNB(var_smoothing=vs).fit(X, y)
        g_cpu = GaussianNB(var_smoothing=vs, device="cpu").fit(X, y)
        z = g_card.decision_function(X)
        dz = float(np.abs(z - g_cpu.decision_function(X)).max()
                   / np.abs(z).max())
        agree = float(np.mean(g_card.predict(X) == g_cpu.predict(X)))
        say(f"  GaussianNB(var_smoothing={vs:g}) card vs CPU: decisions "
            f"within {dz:.1e} of the largest ({float(np.abs(z).max()):.3e});"
            f" predictions agree on {agree:.6f} of the rows"
            + ("" if gated else " (not gated)"))
        if gated and dz > 1e-5:
            raise AssertionError("phase 21f: GaussianNB's card and CPU "
                                 "differ")
    mm, wall_mm = timed_call(torch, lambda: DistMultiModelSearch(
        [("gnb", GaussianNB(), {"var_smoothing": NB_SMOOTHING[:4]}),
         ("lr", LogisticRegression(max_iter=30), {"C": [0.1, 1.0]})],
        n=2, cv=3, scoring="accuracy", random_state=0).fit(X, y))
    modes = [s["round_stats"][0]["mode"] for s in mm.round_stats_]
    say(f"  DistMultiModelSearch(GaussianNB, LogisticRegression(max_iter=30))"
        f": wall {wall_mm:.3f} s, modes {modes}, best "
        f"{mm.best_model_name_} {mm.best_params_} {mm.best_score_:.4f}")
    if not np.all(np.isfinite(mm.cv_results_["mean_test_score"])):
        raise AssertionError("phase 21f: a multi-model score is not finite")


def phase_gbdt(torch):
    """Phase 21 (``--phase-21`` runs only it): returns the K4 launches of
    21a-21d and 21k's K4 times."""
    t0 = time.perf_counter()
    X, y = balanced_tabular(200_000)
    k4_err, k4_times = gbdt_k4(torch, X, y)
    torch.cuda.empty_cache()
    est, fit_launches = gbdt_binary(torch)
    multi_launches = gbdt_multiclass(torch)
    search_launches = gbdt_search(torch)
    reg_launches = gbdt_regressor(torch)
    torch.cuda.empty_cache()
    gbdt_predict(torch, est)
    torch.cuda.empty_cache()
    nb_searches(torch)
    say(f"phase 21 seconds: {time.perf_counter() - t0:.1f}")
    return {"gbdt_fit": fit_launches, "gbdt_multiclass": multi_launches,
            "gbdt_search": search_launches, "gbdt_regressor": reg_launches}, \
        k4_err, k4_times


# ---------------------------------------------------------------------------
# phase 22: feature elimination (BASELINE row 7's covtype shape) and the
# voter
# ---------------------------------------------------------------------------

#: BASELINE row 7: covtype's shape, 581012 x 54, 7 classes, 14 junk columns
COVTYPE_N = 581012
#: the repo example's eliminator settings (examples/eliminate/covtype.py):
#: 12 feature sets x 5 folds = 60 lanes
ELIM_KW = dict(min_features_to_select=10, step=4, cv=5, scoring="accuracy")
#: the rows of 22a's classic and CPU checks, and 22d's voter rows
ELIM_CPU_N = 3_000
VOTER_N = 20_000


def make_covtype_shaped(n=40_000, seed=0, d=54, k=7, n_junk=14):
    """Covtype-shaped synthetic problem (a copy of
    ``examples/eliminate/covtype.py``'s): ``d - n_junk`` informative
    gaussian columns, a 7-class label from a random projection plus
    noise, and ``n_junk`` pure-noise columns at random places. Returns
    ``(X, y, junk column set)``."""
    rng = np.random.RandomState(seed)
    d_inf = d - n_junk
    W = rng.normal(size=(d_inf, k))
    X_inf = rng.normal(size=(n, d_inf)).astype(np.float32)
    y = (X_inf @ W + 2.0 * rng.normal(size=(n, k))).argmax(1)
    X = np.empty((n, d), dtype=np.float32)
    junk_cols = rng.choice(d, size=n_junk, replace=False)
    inf_cols = np.setdiff1d(np.arange(d), junk_cols)
    X[:, inf_cols] = X_inf
    X[:, junk_cols] = rng.normal(size=(n, n_junk))
    return X, y, set(junk_cols.tolist())


class FitWalls:
    """Records the wall of every ``cls.fit`` call (the device synchronised
    before and after) while active: the eliminator's initial fit is the
    first, its refit the last."""

    def __init__(self, torch, cls):
        self.torch, self.cls, self.walls = torch, cls, []

    def __enter__(self):
        torch, walls, orig = self.torch, self.walls, self.cls.fit
        self.own = "fit" in vars(self.cls)
        self.orig = orig

        def fit(est, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(est, *a, **k)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            return out

        self.cls.fit = fit
        return self

    def __exit__(self, *exc):
        if self.own:
            self.cls.fit = self.orig
        else:
            del self.cls.fit


def eliminate(torch, est, X, y, **kw):
    """A timed ``DistFeatureEliminator(est, **ELIM_KW, **kw).fit(X, y)``
    on the card; returns the model, its wall and its (initial, refit)
    fit walls."""
    from skdist_tpu_torch import DistFeatureEliminator

    with FitWalls(torch, type(est)) as fw:
        fe, wall = timed_call(torch, lambda: DistFeatureEliminator(
            est, **{**ELIM_KW, **kw}).fit(X, y))
    return fe, wall, (fw.walls[0], fw.walls[-1])


def elim_readout(fe, wall, fits, junk, label):
    """One model's walls, scheduler counts, scores and kept columns."""
    st = fe.round_stats_[0]
    grid = st.get("wall_s", sum(st.get("round_walls_s", [])))
    kept = set(fe.best_features_.tolist())
    say(f"  {label}: wall {wall:.2f} s (initial fit {fits[0]:.2f} s, "
        f"{len(fe.scores_) * ELIM_KW['cv']}-lane grid {grid:.2f} s, refit "
        f"{fits[1]:.2f} s)")
    if st["mode"] == "compacted":
        say("    " + lane_readout(st))
    else:
        say(f"    {st['mode']}, {st['rounds']} round(s) x "
            f"{st['tasks_per_round']} lanes, bytes per task "
            f"{st['bytes_per_task'] / 2**20:.1f} MiB")
    say(f"    scores_ {np.round(fe.scores_, 6).tolist()}")
    say(f"    best_features_ ({fe.n_features_}) {fe.best_features_.tolist()}"
        f", best_score_ {fe.best_score_:.6f}; junk columns kept "
        f"{len(kept & junk)}/{len(junk)}")


def ulp_noise(X, seed):
    """``X`` with one ulp of noise in every entry: ``X * (1 +- 2**-23)``,
    the sign at random. Unlike a uniform ``1 + 2**-23`` scale, which moves
    every term of a sum the same way, it perturbs a fit as a change of
    summation order does."""
    rng = np.random.RandomState(seed)
    return X * (1.0 + rng.choice([-1.0, 1.0], X.shape)
                * 2.0 ** -23).astype(np.float32)


#: iterations of 22a's lane checks (the eliminator's fits run 40)
LANE_ITERS = 10


def masked_lanes(torch, X, y, masks, weights):
    """One round of the eliminator's kernel on the card:
    ``LogisticRegression(max_iter=LANE_ITERS)`` fits of ``weights (T, n)``
    over X seen through the mask view under ``masks (T, d)`` (or, for
    ``masks=None``, over X itself); returns their ``W (T, p, 7)``."""
    from skdist_tpu_torch import LogisticRegression
    from skdist_tpu_torch.models.linear import _freeze
    from skdist_tpu_torch.sparse import LinearOperator, MaskedLinearOperator
    from skdist_tpu_torch.utils.device import exact_matmuls

    est = LogisticRegression(max_iter=LANE_ITERS)
    data, meta = est._prep_fit_data(X, y)
    kernel = LogisticRegression._build_fit_kernel(
        meta, _freeze(est._static_config(meta)))
    T = len(weights)
    with exact_matmuls(), torch.no_grad():
        op = LinearOperator(torch.as_tensor(X).cuda(), True)
        if masks is not None:
            op = MaskedLinearOperator(op, torch.as_tensor(masks).cuda())
        return kernel(op, torch.as_tensor(data["y"]).cuda(),
                      torch.as_tensor(weights).cuda(),
                      {"C": torch.ones(T, device="cuda"),
                       "tol": torch.full((T,), 1e-4, device="cuda")}
                      )["W"].cpu().numpy()


def masked_lanes_vs_lone(torch, X, y, sets, splits, picks):
    """22a's lane check, for each (set, fold) lane of ``picks`` run as a
    round of one (a lane's bits on the card depend on its round's shape,
    printed for a round of all three): bitwise the same round over the
    materialised ``X * fmask``; against a lone fit of its column-dropped
    X (the fold's training rows as sample weights, as the lane has them)
    within 10x what one ulp of input noise moves the lane (the round on
    :func:`ulp_noise` of X), plus 1e-6 of max|W|; masked weights exactly
    0."""
    from skdist_tpu_torch import LogisticRegression

    d = X.shape[1]
    masks = np.ones((len(picks), d), np.float32)
    sw = np.zeros((len(picks), len(y)), np.float32)
    for i, (s, f) in enumerate(picks):
        masks[i, np.setdiff1d(np.arange(d), sets[s])] = 0.0
        sw[i, splits[f][0]] = 1.0
    X_ulp = ulp_noise(X, 22)
    W3 = masked_lanes(torch, X, y, masks, sw)
    shape_gap = 0.0
    for i, (s, f) in enumerate(picks):
        keep = sets[s]
        one = slice(i, i + 1)
        W = masked_lanes(torch, X, y, masks[one], sw[one])[0]
        Wz = masked_lanes(torch, X * masks[i], y, None, sw[one])[0]
        W_ulp = masked_lanes(torch, X_ulp, y, masks[one], sw[one])[0]
        lone = LogisticRegression(max_iter=LANE_ITERS).fit(
            X[:, keep], y, sample_weight=sw[i])._params["W"]
        rows = np.concatenate([keep, [d]])
        dropped = np.setdiff1d(np.arange(d), keep)
        dW = float(np.abs(W[rows] - lone).max())
        dulp = float(np.abs(W - W_ulp).max())
        scale = float(np.abs(lone).max())
        zero = bool(np.all(W[dropped] == 0))
        exact = np.array_equal(W, Wz)
        shape_gap = max(shape_gap, float(np.abs(W3[i] - W).max()))
        say(f"    lane (set {s}, fold {f}, {len(keep)} columns): over "
            "X * fmask " + ("bitwise equal" if exact else "DIFFERS")
            + f"; max|W| {scale:.3e}, against the lone fit max|dW| "
            f"{dW:.3e}, on ulp-noised X {dulp:.3e}; masked weights "
            + ("exactly 0" if zero else "NOT 0"))
        if not (exact and zero and dW <= 10 * dulp + 1e-6 * scale):
            raise AssertionError(
                f"phase 22a: lane (set {s}, fold {f}) is not its lone fit")
    say(f"    the three lanes in one round against the same lanes alone: "
        f"max|dW| {shape_gap:.3e} (the round's shape sets cuBLAS's "
        "summation order)")


def elim_subset_checks(torch, X, y):
    """22a's checks on ``ELIM_CPU_N`` rows, at the default's 8 rounds of
    8 lanes (``partitions=8`` on both paths, so that the rounds are
    equal): the card's eliminator on the compacted path against the
    classic path (``SKDIST_COMPACTION=0``), bitwise, where the compacted
    run must have retired a lane before ``max_iter`` and merged rounds
    (else the comparison would be trivial); and against the same
    eliminator on the CPU.
    A set's score may differ from the CPU's by three flipped test rows (a
    mean over the folds of accuracy: 1 / n a row); the best sets must be
    equal, or a near tie the card scores within twice that; where they
    are equal, the refits' W within 10x of what one ulp of input noise
    moves the card's refit (plus 1e-6 of max|W|)."""
    from skdist_tpu_torch import DistFeatureEliminator, LogisticRegression

    Xs, ys = X[:ELIM_CPU_N], y[:ELIM_CPU_N]
    tol = 3.0 / ELIM_CPU_N

    def run(device=None):
        return DistFeatureEliminator(
            LogisticRegression(max_iter=40, engine="xla", device=device),
            partitions=8, **ELIM_KW).fit(Xs, ys)

    say(f"CUT: phase 22a's classic and CPU checks run {ELIM_CPU_N} of "
        f"{len(y)} rows")
    card, wall_card = timed_call(torch, run)
    os.environ["SKDIST_COMPACTION"] = "0"
    try:
        classic, wall_classic = timed_call(torch, run)
    finally:
        del os.environ["SKDIST_COMPACTION"]
    st, sc = card.round_stats_[0], classic.round_stats_[0]
    say("    " + lane_readout(st))
    retired = st["lanes_stalled"] + st["lanes_converged"]
    if retired < 1 or st["compactions"] < 1:
        raise AssertionError(
            f"phase 22a: lanes retired before max_iter {retired}, "
            f"compactions {st['compactions']}: the compacted path's lane "
            "retirement went untested")
    same = (np.array_equal(classic.scores_, card.scores_)
            and np.array_equal(classic.estimator_._params["W"],
                               card.estimator_._params["W"]))
    say(f"  22a on {Xs.shape}: compacted {wall_card:.2f} s ({st['mode']}, "
        f"chunk {st['chunk']}), classic {wall_classic:.2f} s ({sc['mode']}, "
        f"{sc['rounds']} rounds of {sc['tasks_per_round']}): scores_ and the "
        "refit " + ("bitwise equal" if same else "DIFFER"))
    if st["mode"] != "compacted" or sc["mode"] != "classic" or not same \
            or sc["tasks_per_round"] != st["chunk"]:
        raise AssertionError("phase 22a: compacted and classic differ")
    cpu, wall_cpu = timed_call(torch, lambda: run("cpu"))
    ds = float(np.abs(card.scores_ - cpu.scores_).max())
    same = np.array_equal(card.best_features_, cpu.best_features_)
    b_card = int(np.argmax(card.scores_ == card.best_score_))
    b_cpu = int(np.argmax(cpu.scores_ == cpu.best_score_))
    tie = abs(card.scores_[b_card] - card.scores_[b_cpu])
    say(f"  card against CPU ({wall_cpu:.2f} s): scores max|d| {ds:.3e} "
        f"(three test rows {tol:.1e}); best_features_ "
        + ("equal" if same else f"differ: sets {b_card} and {b_cpu}, "
           f"{tie:.1e} apart on the card"))
    if not ds <= tol:
        raise AssertionError("phase 22a: card and CPU scores differ by more "
                             "than three test rows")
    if not same and not tie <= 2 * tol:
        raise AssertionError("phase 22a: card and CPU choose different "
                             "feature sets")
    if same:
        keep = card.best_features_
        Wc = card.estimator_._params["W"]
        Wp = cpu.estimator_._params["W"]
        Wu = LogisticRegression(max_iter=40, engine="xla").fit(
            ulp_noise(Xs, 23)[:, keep], ys)._params["W"]
        dW = float(np.abs(Wc - Wp).max())
        dWu = float(np.abs(Wc - Wu).max())
        scale = float(np.abs(Wp).max())
        say(f"    refits: max|W| {scale:.3e}, card vs CPU {dW:.3e}, card vs "
            f"card on ulp-noised X {dWu:.3e}")
        if not dW <= 10 * dWu + 1e-6 * scale:
            raise AssertionError("phase 22a: card and CPU refits differ")


def phase_eliminate_linear(torch, X, y, junk):
    """22a and 22b: the repo example's eliminator on the full covtype
    shape, compacted; classic against compacted; three lanes against
    lone fits; the card against the CPU; pickle; then the ASHA race."""
    from skdist_tpu_torch import HalvingSpec, LogisticRegression
    from skdist_tpu_torch.distribute.adaptive import RungKilledWarning
    from skdist_tpu_torch.utils.cv import check_cv

    say(f"phase 22a: DistFeatureEliminator(LogisticRegression(max_iter=40), "
        f"{ELIM_KW}) on covtype-shaped {X.shape}, 7 classes, "
        f"{len(junk)} junk columns")
    say("  the 60 lanes as one compacted round (partitions=1): every lane "
        "runs to max_iter, so the default's 8 rounds of 8 would only "
        "multiply the solver's host-paced iterations")
    torch.cuda.reset_peak_memory_stats()
    fe, wall, fits = eliminate(torch, LogisticRegression(max_iter=40), X, y,
                               partitions=1)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    elim_readout(fe, wall, fits, junk, "compacted")
    st = fe.round_stats_[0]
    say(f"    peak device memory {peak:.2f} GiB (one copy of X a lane "
        f"would be {60 * X.nbytes / 2**30:.1f} GiB)")
    if not np.all(np.isfinite(fe.scores_)):
        raise AssertionError("phase 22a: a set's score is not finite")
    if st["mode"] != "compacted" or st["regime"] != "resident" \
            or st["tasks"] != 60:
        raise AssertionError(f"phase 22a did not run its 60 lanes compacted "
                             f"and resident: {st['mode']}, "
                             f"{st.get('regime')}")
    splits = list(check_cv(5, y, classifier=True).split(X, y))
    say(f"CUT: phase 22a's lane checks run {LANE_ITERS} of the fits' 40 "
        "iterations")
    masked_lanes_vs_lone(torch, X, y, removal_sets(fe, X, y), splits,
                         [(0, 0), (6, 2), (11, 4)])
    elim_subset_checks(torch, X, y)
    loaded = pickle.loads(pickle.dumps(fe))
    if not np.array_equal(loaded.predict(X[:20000]), fe.predict(X[:20000])):
        raise AssertionError("phase 22a: the pickled eliminator differs")
    say("  pickled eliminator predicts as the live one")

    say("phase 22b: the same grid with adaptive=HalvingSpec(eta=3), at "
        "the default rounds (8 of 8: the race frees whole rounds)")
    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        warnings.filterwarnings("error", message=OOM_DOWNGRADE)
        ad, wall_a, _ = eliminate(torch, LogisticRegression(max_iter=40), X,
                                  y, adaptive=HalvingSpec(eta=3))
    sa = ad.round_stats_[0]
    hist = sa.get("rung_history", [])
    kills = [h["n_killed"] for h in hist]
    killed = ad.rung_ >= 0
    best = int(np.nanargmax(np.asarray(ad.scores_)))
    say(f"  wall {wall_a:.2f} s (the grid {sa['wall_s']:.2f} s, "
        f"{sa['rounds']} round-slices); "
        f"{len(hist)} rungs, lanes killed at each {kills}; rung_ "
        f"{ad.rung_.tolist()}; best_features_ ({ad.n_features_}) "
        + ("the exhaustive run's" if np.array_equal(
            ad.best_features_, fe.best_features_) else
           f"differ from the exhaustive run's ({fe.n_features_})")
        + f", best_score_ {ad.best_score_:.6f}")
    if not hist or not killed.any():
        raise AssertionError("phase 22b: no rung fired or killed a set")
    if not any(issubclass(w.category, RungKilledWarning) for w in ws):
        raise AssertionError("phase 22b: no RungKilledWarning")
    if len(ad.rung_) != len(ad.scores_) \
            or not np.isnan(np.asarray(ad.scores_)[killed]).all() \
            or ad.rung_[best] != -1:
        raise AssertionError("phase 22b: a killed set scored or won")


def removal_sets(fe, X, y):
    """The kept columns of each of ``fe``'s feature sets, ranked as its
    fit ranks them: the initial fit's squared coefficients summed over
    the classes, removed ``step`` at a time."""
    from skdist_tpu_torch import LogisticRegression

    coefs = LogisticRegression(max_iter=40).fit(X, y).coef_
    d = X.shape[1]
    ranks = np.argsort((coefs ** 2).sum(axis=0))[
        : d - ELIM_KW["min_features_to_select"]]
    sets = [np.arange(d)]
    removed = 0
    while removed < d - ELIM_KW["min_features_to_select"]:
        removed += ELIM_KW["step"]
        sets.append(np.setdiff1d(np.arange(d), ranks[:removed]))
    # the eliminator's choice: the last best score (ties to fewer columns)
    best = len(fe.scores_) - 1 - int(np.argmax(fe.scores_[::-1]))
    if len(sets) != len(fe.scores_) or not np.array_equal(
            sets[best], fe.best_features_):
        raise AssertionError("phase 22a: the removal sets do not rebuild")
    return sets


def phase_eliminate_tree(torch, X, y, junk):
    """22c: the eliminator over ``DecisionTreeClassifier(max_depth=8)`` on
    22a's X: K4 under per-lane feature masks. Returns its K4 launches and
    K4's times a level at this shape."""
    from skdist_tpu_torch.models.tree import DecisionTreeClassifier
    from skdist_tpu_torch.ops import hist as kh
    from skdist_tpu_torch.ops.binning import apply_bins
    from skdist_tpu_torch.sparse import MaskedColumns

    say(f"phase 22c: DistFeatureEliminator(DecisionTreeClassifier("
        f"max_depth=8), {ELIM_KW}) on {X.shape}: K4 under feature masks")
    # the masked rounds as the eliminator runs them: their kernel, bins,
    # masks, labels, weights and trees
    rounds = []
    orig = DecisionTreeClassifier._build_fit_kernel

    def build(cls, meta, static):
        kernel = orig(meta, static)

        def recording(op, yd, sw, hyper):
            out = kernel(op, yd, sw, hyper)
            if isinstance(op, MaskedColumns):
                rounds.append((kernel, meta, op.base, op.mask, yd, sw, out))
            return out

        return recording

    DecisionTreeClassifier._build_fit_kernel = classmethod(build)
    try:
        kh.level_histogram.launches = 0
        fe, wall, fits = eliminate(torch, DecisionTreeClassifier(max_depth=8),
                                   X, y)
        launches = kh.level_histogram.launches
    finally:
        del DecisionTreeClassifier._build_fit_kernel
    elim_readout(fe, wall, fits, junk, "batched")
    st = fe.round_stats_[0]
    want = 8 * st["rounds"] + 8 + 8
    say(f"    K4 launches {launches} (8 levels x {st['rounds']} round(s), "
        f"+ 8 of the initial fit and 8 of the refit: {want})")
    if st["mode"] != "classic" or launches != want or len(rounds) != 1:
        raise AssertionError(f"phase 22c: {st['mode']} path in "
                             f"{len(rounds)} rounds, K4 launched {launches} "
                             f"times, not {want}")
    if not np.all(np.isfinite(fe.scores_)):
        raise AssertionError("phase 22c: a set's score is not finite")
    # the round's lanes: no split on a masked feature, and three lanes
    # against lone fits of their column-zeroed X under the same edges
    kernel, meta, Xb, masks, yd, sw, trees = rounds[0]
    T = masks.shape[0]
    with torch.no_grad():
        bad = [t for t in range(T) if not bool(
            masks[t][trees["feat"][t][trees["is_split"][t]].long()].all())]
        Xd = torch.as_tensor(X).cuda()
        differ = []
        for t in (0, T // 2, T - 1):
            Xz = apply_bins(Xd * masks[t].float(), meta["edges"])
            lone = kernel(Xz, yd, sw[t:t + 1], {})
            differ += [(t, k) for k in lone
                       if not torch.equal(trees[k][t], lone[k][0])]
        n_splits = int(trees["is_split"].sum())
        del Xd
    say(f"    the round's {T} lanes: {n_splits} splits, lanes splitting a "
        f"masked feature {bad}; lanes 0, {T // 2}, {T - 1} against lone "
        "fits of their column-zeroed X under the same edges: "
        + ("bitwise equal" if not differ else f"differ in {differ}"))
    if bad or differ:
        raise AssertionError(f"phase 22c: masked lanes {bad}, {differ}")
    times = tree_k4_times(torch, kh, Xb, sw, yd, T)
    del rounds, Xb, trees
    return launches, times


def tree_k4_times(torch, kh, Xb, sw, y, T):
    """K4 at 22c's round shape (T lanes, n x d bins, B=32, C=8: the 7
    classes' weights and the count), at levels nl = 1, 16 and 128: held
    to its plain version on the same inputs at each level (every channel
    is a whole-number sum, so every channel bitwise), then timed beside
    its bound and its plain version (at nl = 128, one call)."""
    from skdist_tpu_torch.models.tree import classification_channels

    n, d = Xb.shape
    B = 32
    Ych = classification_channels(y, sw, 7)
    proof = kh.integer_channels(Ych)
    if proof is None or proof.mask != 2 ** 8 - 1:
        raise AssertionError("phase 22c: the round's channels are not all "
                             f"whole numbers: {proof and proof.mask}")
    Xs = kh.kernel_bins(Xb, B)
    live = torch.any(Ych != 0, dim=-1)
    g = torch.Generator(device="cuda").manual_seed(22)
    times = {}
    for nl in (1, 16, 128):
        key = torch.randint(0, nl, (T, n), generator=g, device="cuda",
                            dtype=torch.int32)
        key = torch.where(live, key, nl).to(torch.int32)
        err, exact = check_k4(torch, kh, Xs, Xb, key, Ych, nl, B,
                              f"eliminator T={T} nl={nl}")
        if exact != list(range(8)) or err != 0.0:
            raise AssertionError(f"phase 22c: K4 at nl={nl} holds channels "
                                 f"{exact} bitwise, max err {err:.3e}")
        ms = cuda_ms(torch, lambda: kh.level_histogram(
            Xs, key, Ych, nl, B, integer=proof), 3)
        lib_ms, groups = k4_yardstick_by_lanes(torch, kh, Xs, Xb, key, Ych,
                                               nl, B, proof)
        times[nl] = {"ms": ms, "bound": k4_bound(key, Xs, 8, nl, B, d),
                     "library_ms": lib_ms, "library_calls": groups}
    times["plain_ms"] = cuda_ms(
        torch, lambda: kh.level_histogram_ref(Xb, key, Ych, 128, B), 1)
    say(f"    K4 at T={T}, n={n}, d={d}, B={B}, C=8 against its plain "
        "version at nl = 1, 16, 128: every channel bitwise equal; the "
        "index_add_ yardstick of each lane group bitwise K4's lanes")
    say(f"    K4 a level at T={T}, n={n}, d={d}, B={B}, C=8: " + "; ".join(
        f"nl={nl} {v['ms']:.3f} ms (bound {v['bound'][0]:.3f} ms "
        f"{v['bound'][1]}, {v['ms'] / v['bound'][0]:.1f}x; index_add_ "
        f"{v['library_ms']:.3f} ms, a sum of {v['library_calls']} calls "
        f"of {K4_YARDSTICK_LANES} lanes)"
        for nl, v in times.items() if nl != "plain_ms")
        + f"; plain version at nl=128 {times['plain_ms']:.1f} ms")
    return times


#: lanes of one index_add_ call of the eliminator's K4 yardstick: its
#: (lanes, d, n, C) source takes ~1.0 GB a lane at covtype's shape, so
#: the round's 60 lanes (~60 GB) are timed in groups, a call each
K4_YARDSTICK_LANES = 12


def k4_yardstick_by_lanes(torch, kh, Xs, Xb, key, Y, nl, B, proof):
    """K4's ``index_add_`` yardstick at a round too wide for one source
    tensor: one call a group of :data:`K4_YARDSTICK_LANES` lanes, each
    group's result bitwise K4's output for those lanes (whole-number
    channels); returns (the sum of the groups' device ms, the number of
    calls)."""
    T, n = key.shape
    d, C = Xb.shape[1], Y.shape[-1]
    out = kh.level_histogram(Xs, key, Y, nl, B, integer=proof)
    total, calls = 0.0, 0
    for t0 in range(0, T, K4_YARDSTICK_LANES):
        t1 = min(T, t0 + K4_YARDSTICK_LANES)
        src = Y[t0:t1, None].expand(t1 - t0, d, n, C).reshape(-1, C)
        call, result = k4_yardstick(torch, Xb, key[t0:t1], Y[t0:t1], nl, B,
                                    src)
        total += cuda_ms(torch, call, 1)
        calls += 1
        if not torch.equal(result(), out[t0:t1]):
            raise AssertionError(
                f"phase 22c: the index_add_ yardstick of lanes {t0}-{t1} "
                f"disagrees with K4 at nl={nl}")
        del src, call, result
        torch.cuda.empty_cache()
    return total, calls


def phase_voter(torch, X, y):
    """22d: ``SimpleVoter`` over three card-fitted members, hard and
    soft, each against a numpy recount of the members' outputs."""
    from skdist_tpu_torch import (DistRandomForestClassifier, GaussianNB,
                                  LogisticRegression, SimpleVoter)

    Xv, yv = X[:VOTER_N], y[:VOTER_N]
    members = [
        ("lr", LogisticRegression(max_iter=40).fit(Xv, yv)),
        ("rf", DistRandomForestClassifier(n_estimators=16, max_depth=8,
                                          random_state=0).fit(Xv, yv)),
        ("nb", GaussianNB().fit(Xv, yv)),
    ]
    classes = np.arange(7)
    weights = [1.0, 2.0, 1.5]
    say(f"phase 22d: SimpleVoter over LogisticRegression, "
        f"DistRandomForestClassifier(16 trees) and GaussianNB fitted on the "
        f"card on {Xv.shape} (a printed cut), weights {weights}")
    say(f"CUT: phase 22d's members fit on {VOTER_N} of {len(y)} rows")
    hard = SimpleVoter(members, classes, voting="hard", weights=weights)
    soft = SimpleVoter(members, classes, voting="soft", weights=weights)
    ph, pp, ps_ = hard.predict(Xv), soft.predict_proba(Xv), soft.predict(Xv)
    preds = np.stack([m.predict(Xv) for _, m in members], axis=1)
    tally = np.zeros((len(yv), 7))
    for j, w in enumerate(weights):
        tally[np.arange(len(yv)), preds[:, j]] += w
    want_hard = tally.argmax(1)
    probas = [m.predict_proba(Xv).astype(np.float64) for _, m in members]
    want_pp = sum(w * p for w, p in zip(weights, probas)) / sum(weights)
    accs = {name: float(np.mean(m.predict(Xv) == yv)) for name, m in members}
    say(f"  accuracy on its rows: members {accs}, hard "
        f"{np.mean(ph == yv):.4f}, soft {np.mean(ps_ == yv):.4f}")
    if not (np.array_equal(ph, want_hard) and np.allclose(pp, want_pp,
                                                          atol=1e-12)
            and np.array_equal(ps_, want_pp.argmax(1))):
        raise AssertionError("phase 22d: a vote differs from its recount")
    for v in (hard, soft):
        loaded = pickle.loads(pickle.dumps(v))
        if not np.array_equal(loaded.predict(Xv), v.predict(Xv)):
            raise AssertionError("phase 22d: the pickled voter differs")
    say("  hard and soft votes equal their numpy recounts; pickled voters "
        "predict as the live ones")


def phase_eliminate(torch):
    """Phase 22 (``--phase-22`` runs only it): returns 22c's K4 launches
    and times."""
    t0 = time.perf_counter()
    X, y, junk = make_covtype_shaped(COVTYPE_N)
    say(f"phase 22 data: covtype-shaped {X.shape}, "
        f"{time.perf_counter() - t0:.1f} s")
    phase_eliminate_linear(torch, X, y, junk)
    torch.cuda.empty_cache()
    launches, times = phase_eliminate_tree(torch, X, y, junk)
    torch.cuda.empty_cache()
    phase_voter(torch, X, y)
    say(f"phase 22 seconds: {time.perf_counter() - t0:.1f}")
    return launches, times


#: 20newsgroups' sizes: BASELINE row 9's 1000 documents, the train split
NEWS_DOCS, NEWS_TRAIN = 1000, 11314


def made_up_vocabulary(rng, size):
    """``size`` distinct made-up lowercase words of 2-12 letters."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = set()
    while len(words) < size:
        lens = np.clip(rng.geometric(0.22, size=size), 2, 12)
        for L in lens:
            words.add("".join(rng.choice(letters, L)))
            if len(words) == size:
                break
    return np.array(sorted(words), dtype=object)[rng.permutation(size)]


def make_20news_text(n_docs, seed=0, vocab_size=30000, k=20):
    """20newsgroups-shaped raw text: ``k`` classes, each drawing words
    from its own skewed distribution over a seeded vocabulary of made-up
    words (a shared Zipf backbone times an 8x boost on 400 words of the
    class's own), long-tailed document lengths (lognormal, as 20news'
    are), an occasional capital and full stop. Returns ``(docs, y)``."""
    rng = np.random.RandomState(seed)
    vocab = made_up_vocabulary(rng, vocab_size)
    base = 1.0 / (np.arange(vocab_size) + 10.0) ** 1.07
    lengths = np.clip(rng.lognormal(5.2, 0.9, n_docs), 12, 6000).astype(int)
    y = rng.randint(0, k, n_docs)
    words = np.empty(n_docs, dtype=object)
    for c in range(k):
        p = base.copy()
        p[rng.choice(vocab_size, 400, replace=False)] *= 8.0
        rows = np.flatnonzero(y == c)
        ids = rng.choice(vocab_size, int(lengths[rows].sum()), p=p / p.sum())
        for r, chunk in zip(rows, np.split(ids, np.cumsum(lengths[rows])[:-1])):
            words[r] = vocab[chunk]
    docs = []
    for w in words:
        w = w.copy()
        w[::17] = [t.capitalize() for t in w[::17]]
        w[11::13] = [t + "." for t in w[11::13]]
        docs.append(" ".join(w))
    return docs, y


def news_frame(n_docs, seed=0):
    """The 23b frame as a dict of columns (the card's machine has no
    pandas): 20news-shaped text, a numeric column with None, a 20-value
    categorical, a list column and a dict column."""
    rng = np.random.RandomState(seed + 1)
    docs, y = make_20news_text(n_docs, seed)
    groups = [f"grp{c:02d}" for c in range(20)]
    tags = np.array(["news", "sci", "rec", "talk", "comp", "misc", "alt"])
    frame = {
        "body": docs,
        "lines": [None if rng.rand() < 0.1 else float(rng.lognormal(3, 1))
                  for _ in range(n_docs)],
        "group": [groups[int(g)] for g in rng.randint(0, 20, n_docs)],
        "tags": [list(rng.choice(tags, rng.randint(1, 4), replace=False))
                 for _ in range(n_docs)],
        "meta": [{"org": f"org{int(rng.randint(0, 50))}",
                  "replies": float(rng.poisson(2))} for _ in range(n_docs)],
    }
    return frame, y


def pickled_equal(enc, frame, out):
    """Whether a pickled encoder's ``transform`` equals the live one's
    (no differing entry)."""
    loaded = pickle.loads(pickle.dumps(enc))
    again = loaded.transform(frame)
    return again.shape == out.shape and (again != out).nnz == 0


def counting(module, name, counts):
    """Wrap ``module.name`` so that its calls are counted in
    ``counts[name]``; returns the restorer."""
    real = getattr(module, name)

    def wrapped(*args, **kw):
        counts[name] = counts.get(name, 0) + 1
        return real(*args, **kw)

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, real)


def phase_encoder_search(torch):
    """23a: BASELINE row 9's protocol (``examples/encoder/basic_usage.py``)
    on 1000 20news-shaped documents: ``Encoderizer`` at sizes small,
    medium and large fitted unsupervised, then the flagship
    ``DistGridSearchCV(LogisticRegression(max_iter=100), {"C": [0.1, 1,
    10]}, cv=5, scoring="f1_weighted")`` on the card over its CSR output,
    routed packed (K1/K2) or densified (``densify.c`` from 2**22
    elements) by the port's own rule. Returns K1/K2 launches a size."""
    from skdist_tpu_torch import DistGridSearchCV, Encoderizer
    from skdist_tpu_torch import LogisticRegression, native
    from skdist_tpu_torch.ops import packed_sparse as ps
    from skdist_tpu_torch.sparse import would_pack

    t0 = time.perf_counter()
    docs, y = make_20news_text(NEWS_DOCS, seed=9)
    lens = np.array([len(d.split()) for d in docs])
    say(f"phase 23a: 20news-shaped text, {NEWS_DOCS} documents, 20 classes, "
        f"words a document median {np.median(lens):.0f}, p99 "
        f"{np.percentile(lens, 99):.0f}, max {lens.max()} "
        f"({time.perf_counter() - t0:.1f} s)")
    frame = {"text": docs}
    majority = np.bincount(y).max() / len(y)
    out = {}
    for size in ("small", "medium", "large"):
        t0 = time.perf_counter()
        enc = Encoderizer(size=size).fit(frame)
        X = enc.transform(frame)
        encode = time.perf_counter() - t0
        width = X.shape[1]
        if width != sum(enc.transformer_lengths):
            raise AssertionError(f"phase 23a {size}: width {width} is not "
                                 f"{sum(enc.transformer_lengths)}")
        if not pickled_equal(enc, frame, X):
            raise AssertionError(f"phase 23a {size}: the pickled encoder "
                                 "transforms differently")
        route = "packed (K1/K2)" if would_pack(X) else "dense"
        counts = {}
        restore = counting(native, "csr_to_dense_f32", counts)
        ps.packed_matvec.launches = 0
        ps.packed_rmatvec.launches = 0
        try:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            gs = DistGridSearchCV(
                LogisticRegression(max_iter=100), {"C": [0.1, 1.0, 10.0]},
                cv=5, scoring="f1_weighted").fit(X, y)
            torch.cuda.synchronize()
            search = time.perf_counter() - t1
        finally:
            restore()
        launches = {"packed_matvec": ps.packed_matvec.launches,
                    "packed_rmatvec": ps.packed_rmatvec.launches}
        scores = gs.cv_results_["mean_test_score"]
        say(f"  {size}: steps {enc.step_names}, width {width}, nnz a row "
            f"{X.nnz / X.shape[0]:.1f}, encode {encode:.2f} s; route "
            f"{route}, densify.c calls {counts.get('csr_to_dense_f32', 0)}, "
            f"K1/K2 launches {launches['packed_matvec']}/"
            f"{launches['packed_rmatvec']}; search {search:.2f} s "
            f"({gs.round_stats_[0]['mode']}), scores "
            f"{np.round(scores, 6).tolist()}, best {gs.best_params_} "
            f"{gs.best_score_:.6f} (majority share {majority:.4f}); "
            "pickled encoder = live")
        if not np.all(np.isfinite(scores)):
            raise AssertionError(f"phase 23a {size}: a score is not finite")
        if not gs.best_score_ > majority:
            raise AssertionError(f"phase 23a {size}: best score "
                                 f"{gs.best_score_} not above the majority "
                                 f"share {majority}")
        if route.startswith("packed") and min(launches.values()) <= 0:
            raise AssertionError(f"phase 23a {size}: packed, but a kernel "
                                 f"never launched: {launches}")
        out[size] = launches
        del gs, X
        torch.cuda.empty_cache()
    return out


def same_abs(a, b):
    """max | |a| - |b| | over max |b|."""
    return float(np.abs(np.abs(a) - np.abs(b)).max() / np.abs(b).max())


def phase_encoder_wide(torch):
    """23b: the 20news train size, every encoder type; the SVD on the card
    against the CPU's, dense and sparse; the C kernels against their
    Python forms and scipy, bitwise."""
    from skdist_tpu_torch import Encoderizer, TruncatedSVDTransformer, native
    from skdist_tpu_torch.featurize.text import HashingVectorizer
    from skdist_tpu_torch.preprocessing import FastHashingVectorizer
    from skdist_tpu_torch.sparse import sparse_to_dense_f32

    t0 = time.perf_counter()
    frame, _ = news_frame(NEWS_TRAIN, seed=10)
    say(f"phase 23b: {NEWS_TRAIN} rows x {len(frame)} columns (text, "
        f"numeric with None, 20-value categorical, lists, dicts), "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    enc = Encoderizer(size="small").fit(frame)
    fit_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    X = enc.transform(frame)
    tr_wall = time.perf_counter() - t0
    say(f"  Encoderizer(size='small'): steps {enc.step_names}, widths "
        f"{enc.transformer_lengths}; fit {fit_wall:.2f} s, transform "
        f"{tr_wall:.2f} s; {X.shape}, nnz {X.nnz}")
    kinds = {"body_word_vec", "lines_scaler", "group_onehot",
             "tags_multihot", "meta_dict_encoder"}
    if set(enc.step_names) != kinds or X.shape[1] != sum(
            enc.transformer_lengths):
        raise AssertionError(f"phase 23b: steps {enc.step_names}")

    # the densifier: C against scipy, bitwise
    t0 = time.perf_counter()
    dense_c = native.csr_to_dense_f32(X)
    c_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    dense_py = np.ascontiguousarray(X.toarray(), dtype=np.float32)
    py_ms = 1e3 * (time.perf_counter() - t0)
    if not np.array_equal(dense_c.view(np.uint32), dense_py.view(np.uint32)):
        raise AssertionError("phase 23b: csr_to_dense_f32 is not bitwise "
                             "scipy's toarray")
    if not np.array_equal(sparse_to_dense_f32(X), dense_c):
        raise AssertionError("phase 23b: sparse_to_dense_f32 differs")
    say(f"  csr_to_dense_f32 (C, {native.default_threads()} threads) "
        f"{c_ms:.1f} ms, scipy toarray {py_ms:.1f} ms: bitwise equal")

    # TruncatedSVDTransformer: the card against the CPU, dense and sparse
    k = 128
    walls, fits = {}, {}
    for name, device, Xin in (("card", None, dense_c),
                              ("cpu", "cpu", dense_c),
                              ("sparse", None, X.astype(np.float32))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svd = TruncatedSVDTransformer(n_components=k, random_state=0,
                                      device=device).fit(Xin)
        Xt = svd.transform(Xin)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        fits[name] = (svd, Xt)
    card, cpu = fits["card"], fits["cpu"]
    for other in ("cpu", "sparse"):
        sv_gap = float(np.max(np.abs(fits[other][0].singular_values_
                                     - card[0].singular_values_)
                              / fits[other][0].singular_values_))
        t_gap = same_abs(card[1], fits[other][1])
        say(f"  TruncatedSVDTransformer({k}) card {walls['card']:.2f} s vs "
            f"{other} {walls[other]:.2f} s: singular values within "
            f"{sv_gap:.2e} relative (gate 1e-3), |transform| within "
            f"{t_gap:.2e} of its largest (gate 1e-2)")
        if not (sv_gap <= 1e-3 and t_gap <= 1e-2):
            raise AssertionError(f"phase 23b: the card's SVD and the "
                                 f"{other}'s disagree")
    if not np.all(np.isfinite(card[1])) or card[1].shape != (X.shape[0], k):
        raise AssertionError("phase 23b: the SVD output is not finite")
    loaded = pickle.loads(pickle.dumps(card[0]))
    if not np.array_equal(loaded.components_, card[0].components_):
        raise AssertionError("phase 23b: the pickled SVD differs")

    # the hashing kernels against their Python forms
    docs = frame["body"][:200]
    for kw in (dict(n_features=2 ** 12), dict(n_features=2 ** 12,
                                              ngram_range=(1, 2)),
               dict(n_features=2 ** 13, analyzer="char_wb",
                    ngram_range=(3, 4))):
        a = FastHashingVectorizer(**kw).transform(docs)
        b = FastHashingVectorizer(force_python=True, **kw).transform(docs)
        if (a != b).nnz or not np.array_equal(a.indices, b.indices):
            raise AssertionError(f"phase 23b: FastHashingVectorizer {kw}: "
                                 "C and Python differ")
    spans = HashingVectorizer(ngram_range=(1, 2))._feature_spans(docs)
    buf, starts, lengths = spans[0], spans[1], spans[2]
    t0 = time.perf_counter()
    h_c = native.murmurhash3_32_spans(buf, starts, lengths)
    c_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    h_py = [native.murmurhash3_32_py(buf[a:a + n])
            for a, n in zip(starts.tolist(), lengths.tolist())]
    py_ms = 1e3 * (time.perf_counter() - t0)
    if h_c.tolist() != h_py:
        raise AssertionError("phase 23b: the MurmurHash3 C kernel and its "
                             "Python form differ")
    say(f"  on the first 200 documents: FastHashingVectorizer C = Python "
        f"(word 1, word 1-2, char_wb 3-4), bitwise; MurmurHash3 of "
        f"{len(h_py)} n-grams C {c_ms:.1f} ms = Python {py_ms:.0f} ms, "
        "bitwise")


def phase_featurize(torch):
    """Phase 23 (``--phase-23`` runs only it): returns 23a's K1/K2
    launches a size."""
    t0 = time.perf_counter()
    launches = phase_encoder_search(torch)
    torch.cuda.empty_cache()
    phase_encoder_wide(torch)
    torch.cuda.empty_cache()
    say(f"phase 23 seconds: {time.perf_counter() - t0:.1f}")
    return launches


#: phase 24's data (the main path's 20news-shaped hashed text, a million
#: rows) and its blocks: 16 blocks of 65536 rows
STREAM_N = 1_048_576
STREAM_BLOCK = 65_536
#: phase 24b's max_iter: 50 of the 100 the slice asks for, a printed
#: cut that keeps the whole run near its target
STREAM_ITERS = 50
#: the streamed fit's peak device memory beyond the solver's state may be
#: this many blocks plus STREAM_SLACK bytes
STREAM_BLOCKS_HELD = 4
STREAM_SLACK = 64 << 20


def stream_pass_bitwise(torch, est, ds, y):
    """Phase 24a's second gate: one value-and-gradient pass of the
    streamed LogisticRegression objective at a fixed seeded W, fed
    serially (``sync=True``) and pipelined, must be bitwise equal. Returns
    the two feeds' stats and the passes' K1/K2 launches."""
    from skdist_tpu_torch.models.linear import _freeze
    from skdist_tpu_torch.models.streaming import (StreamedObjective,
                                                   _make_block_read)
    from skdist_tpu_torch.ops import packed_sparse as ps

    y_enc, sw, meta = est._prep_stream_fit(ds, y)
    static = _freeze(est._static_config(meta))
    hyper = {"C": np.ones(1, np.float32), "tol": np.full(1, 1e-4, np.float32)}
    p, k = ds.n_features + 1, meta["n_classes"]
    W = torch.as_tensor(0.01 * np.random.RandomState(5).standard_normal(
        (1, p * k)).astype(np.float32), device="cuda")
    rows = {"y": y_enc, "sw": sw}

    def objective(sync):
        return StreamedObjective(type(est), meta, static, ds, rows, hyper,
                                 "cuda", sync=sync)

    out, stats = {}, {}
    ps.packed_matvec.launches = 0
    ps.packed_rmatvec.launches = 0
    for sync in (True, False):
        with objective(sync) as obj:
            (f, g), wall = timed_call(torch, lambda: obj.value_and_grad(W))
        out[sync] = (f.cpu().numpy(), g.cpu().numpy())
        stats[sync] = dict(obj.stats, wall=wall)
    launches = {"packed_matvec": ps.packed_matvec.launches,
                "packed_rmatvec": ps.packed_rmatvec.launches}
    same = all(np.array_equal(a, b) for a, b in zip(out[True], out[False]))
    ser, pip = stats[True], stats[False]
    hidden = 1.0 - pip["feed_wait_s"] / ser["feed_wait_s"]
    say(f"  one value-and-gradient pass at a seeded W: serial "
        f"{ser['wall']:.3f}s (feed_wait_s {ser['feed_wait_s']:.3f}), "
        f"pipelined {pip['wall']:.3f}s (feed_wait_s "
        f"{pip['feed_wait_s']:.3f}, read_place_s {pip['read_place_s']:.3f});"
        f" share of the feed hidden {hidden:.3f}; f and g "
        + ("bitwise equal" if same else "DIFFER") + f"; launches {launches}")
    if not same:
        raise AssertionError("phase 24a: the serial and pipelined passes "
                             "differ")
    nb = ds.n_blocks
    if launches != {"packed_matvec": 2 * nb, "packed_rmatvec": 2 * nb}:
        raise AssertionError(f"phase 24a: two passes over {nb} blocks "
                             f"launched {launches}")
    stream_pass_plain(torch, objective, _make_block_read(ds, rows), nb, W,
                      f, g, k)
    return launches


def stream_pass_plain(torch, objective, read, n_blocks, W, f, g, k):
    """Phase 24a's third gate: the pass at ``W`` (``f``, ``g``: the
    kernels' pipelined pass) held to the same pass with K1 and K2
    replaced by their plain versions (``packed_matvec_ref``, whose
    autograd is the scatter-add that K2 replaces), fed serially. It must
    launch no kernel. Tolerance, summed block by block over the plain
    pass's own blocks (``X~`` the block with its intercept column, ``u``
    float32's unit roundoff): K1's bound of check_pair on each logit,
    ``dz = 2 m u |X~| |W|``, moves a row's loss and each of its
    softmax residuals ``r = sw (softmax(z) - onehot)`` by at most
    ``2 sw max(dz)``; each gradient entry is a column sum of ``c``
    products (c its entry count), two orders of which differ by at most
    ``2 c u |X~|^T |r|``; the loss's sums over the block's ``n`` rows and
    the block-order sums of both add at most ``2 n u`` and ``2 n_blocks
    u`` times the sum of their (non-negative, or absolute) terms."""
    import skdist_tpu_torch.sparse as tsp
    from skdist_tpu_torch.ops import packed_sparse as ps
    from skdist_tpu_torch.parallel.backend import BlockFeeder

    class PlainMatvec:
        @staticmethod
        def apply(Wk, idx, val, columns):
            return ps.packed_matvec_ref(idx, val, Wk)

    before = (ps.packed_matvec.launches, ps.packed_rmatvec.launches)
    kernels = tsp.PackedMatvec
    tsp.PackedMatvec = PlainMatvec
    try:
        with objective(True) as obj:
            fp, gp = obj.value_and_grad(W)
    finally:
        tsp.PackedMatvec = kernels
    if (ps.packed_matvec.launches, ps.packed_rmatvec.launches) != before:
        raise AssertionError("phase 24a: the plain pass launched a kernel")
    tol_f = torch.zeros((), dtype=torch.float64, device="cuda")
    tol_g = torch.zeros_like(gp)
    absg = torch.zeros_like(gp)
    feeder = BlockFeeder(read, n_blocks, "cuda", sync=True)
    p = W.shape[1] // k
    W3 = W.reshape(1, p, k)
    with torch.no_grad():
        for _i, block in feeder:
            op = tsp.LinearOperator(block["X"], True, sort_columns=False)
            idx, val = op.pidx, op.pval
            m, n = idx.shape[1], idx.shape[0]
            sw = block["sw"]
            z = ps.packed_matvec_ref(idx, val, W3)[0]
            dz = (2 * m * U32 * ps.packed_matvec_ref(
                idx, val.abs(), W3.abs())[0]).amax(1)
            onehot = torch.nn.functional.one_hot(block["y"].long(), k)
            loss = sw * (torch.logsumexp(z, 1) - (onehot * z).sum(1))
            r = sw[:, None] * (torch.softmax(z, 1) - onehot)
            cols = ps.build_columns(idx, val, p)
            counts = (cols.col_ptr[1:] - cols.col_ptr[:-1]).to(torch.float32)
            a = ps.packed_rmatvec_ref(idx, val.abs(), r.abs()[None], p)
            tol_f += float((2 * sw * dz).sum() + 2 * n * U32 * loss.sum())
            moved = (2 * sw * dz)[None, :, None].expand(1, n, k)
            tol_g += (2 * counts[None, :, None] * U32 * a
                      + ps.packed_rmatvec_ref(idx, val.abs(),
                                              moved.contiguous(), p)
                      ).reshape(gp.shape)
            absg += a.reshape(gp.shape)
    tol_f += 2 * n_blocks * U32 * float(fp.abs().sum())
    tol_g += 2 * n_blocks * U32 * absg
    err_f = float((f - fp).abs().max())
    err_g = (g - gp).abs()
    ratio = float((err_g / tol_g.clamp_min(1e-30)).max())
    say(f"  the pass against its plain version (no kernel launched): |df| "
        f"{err_f:.3e} (tolerance {float(tol_f):.3e}, |f| "
        f"{float(fp.abs().max()):.6e}), max|dg| {float(err_g.max()):.3e} "
        f"(max|g| {float(gp.abs().max()):.3e}; at most {ratio:.3f} of its "
        "tolerance)")
    if not (err_f <= float(tol_f) and bool((err_g <= tol_g).all())):
        raise AssertionError("phase 24a: the kernels' pass disagrees with "
                             "its plain version")


def stream_block_kernels(torch, ds):
    """Phase 24a's first kernel gate: block 0 as the pinned feeder puts it
    on the card, with the intercept column the streamed operator appends
    (m = 40 + 1, p = 2**18 + 1), through check_pair: K1, K2 and the
    PackedMatvec gradient against their plain versions at T=1, k=20, the
    streamed fit's shape, with check_pair's tolerance."""
    from skdist_tpu_torch.ops import packed_sparse as ps
    from skdist_tpu_torch.parallel.backend import BlockFeeder
    from skdist_tpu_torch.sparse import LinearOperator

    with BlockFeeder(lambda i: {"X": ds.read_block(i).X}, 1, "cuda") as fd:
        _i, block = fd.next()
        op = LinearOperator(block["X"], True, sort_columns=False)
        check_pair(torch, ps, op.pidx, op.pval, op.p, T=1, k=20, seed=24,
                   label="a streamed block (24a)")


def phase_stream_data(torch, X, y, tmp):
    """Phase 24a: the dataset in memory, saved, loaded memory-mapped; the
    loaded blocks bitwise the in-memory ones; one pass serial and
    pipelined. Returns the loaded dataset and the pass's launches."""
    from skdist_tpu_torch import ChunkedDataset, LogisticRegression

    ds = ChunkedDataset.from_arrays(X, y, block_rows=STREAM_BLOCK, pack=True)
    _, t_save = timed_call(torch, lambda: ds.save(tmp))
    ld = ChunkedDataset.load(tmp)
    say(f"phase 24a: ChunkedDataset {ds.n_blocks} blocks x "
        f"{ds.block_rows} rows, m={ds.packed_m}, {ds.block_nbytes / 2**20:.1f}"
        f" MiB a block, {ds.nbytes_estimate / 2**20:.0f} MiB of idx+val; "
        f"save {t_save:.2f}s")
    t0 = time.perf_counter()
    for i in range(ds.n_blocks):
        a, b = ds.read_block(i), ld.read_block(i)
        if not (np.array_equal(a.X.idx, b.X.idx)
                and np.array_equal(a.X.val, b.X.val)
                and np.array_equal(a.y, b.y) and np.array_equal(a.sw, b.sw)
                and (a.start, a.n_real) == (b.start, b.n_real)):
            raise AssertionError(f"phase 24a: loaded block {i} differs")
    say(f"  loaded blocks bitwise the in-memory ones "
        f"({time.perf_counter() - t0:.1f}s to read both)")
    stream_block_kernels(torch, ld)
    launches = stream_pass_bitwise(torch, LogisticRegression(C=1.0), ld, y)
    return ld, launches


def stream_fit(torch, fit, label):
    """``(model, wall, peak bytes above the start, K1/K2 launches)`` of
    ``fit()`` on the card."""
    from skdist_tpu_torch.ops import packed_sparse as ps

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ps.packed_matvec.launches = 0
    ps.packed_rmatvec.launches = 0
    model, wall = timed_call(torch, fit)
    peak = torch.cuda.max_memory_allocated() - base
    launches = {"packed_matvec": ps.packed_matvec.launches,
                "packed_rmatvec": ps.packed_rmatvec.launches}
    say(f"  {label}: wall {wall:.2f}s, n_iter {int(np.max(model.n_iter_))}, peak "
        f"device memory {peak / 2**20:.0f} MiB above the start, launches "
        f"{launches}")
    return model, wall, peak, launches


def phase_stream_fit(torch, X, y, ld):
    """Phase 24b: LogisticRegression fitted streamed over the loaded
    dataset, resident on the same rows, and resident with the weights one
    ulp off (the card's own noise). Returns the streamed fit and its
    launches."""
    from skdist_tpu_torch import LogisticRegression
    from skdist_tpu_torch.models.linear import _freeze

    n = X.shape[0]
    kw = dict(C=1.0, max_iter=STREAM_ITERS)
    say(f"phase 24b: LogisticRegression({kw}) streamed over the loaded "
        "dataset, resident on the same rows, resident with weights one ulp "
        "off")
    say(f"CUT: phase 24b fits max_iter={STREAM_ITERS} (of 100), so that the "
        "whole run stays near its time target")
    ms, wall_s, peak_s, launches = stream_fit(
        torch, lambda: LogisticRegression(**kw).fit(ld), "streamed")
    st = ms.stream_stats_
    say(f"    passes {st['passes']} ({st['grad_passes']} value-and-gradient,"
        f" {st['value_passes']} value), streamed_bytes {st['streamed_bytes']}"
        f", feed_wait_s {st['feed_wait_s']:.2f}, read_place_s "
        f"{st['read_place_s']:.2f}, dispatch_s {st['dispatch_s']:.2f}")
    mr, wall_r, peak_r, _ = stream_fit(
        torch, lambda: LogisticRegression(**kw).fit(X, y), "resident")
    mu, _, _, _ = stream_fit(
        torch, lambda: LogisticRegression(**kw).fit(
            X, y, sample_weight=ulp_weights(n, 7)), "resident, weights ulp off")
    nb = ld.n_blocks
    want = {"packed_matvec": nb * st["passes"],
            "packed_rmatvec": nb * st["grad_passes"]}
    if launches != want:
        raise AssertionError(f"phase 24b: launches {launches}, blocks x "
                             f"passes {want}")
    m = ld.packed_m
    pass_bytes = nb * ld.block_rows * (8 * m + 4 + 4)  # idx, val, y, sw
    if st["streamed_bytes"] != st["passes"] * pass_bytes:
        raise AssertionError(
            f"phase 24b: streamed_bytes {st['streamed_bytes']} is not "
            f"{st['passes']} passes x {pass_bytes} bytes")
    y_enc, _sw, meta = ms._prep_stream_fit(ld, y)
    state = LogisticRegression._batched_task_bytes(
        meta, _freeze(ms._static_config(meta)), 0)
    room = state + STREAM_BLOCKS_HELD * ld.block_nbytes + STREAM_SLACK
    say(f"    peak {peak_s / 2**20:.0f} MiB streamed against "
        f"{peak_r / 2**20:.0f} MiB resident; the gate: the solver's state "
        f"{state / 2**20:.0f} MiB + {STREAM_BLOCKS_HELD} blocks + "
        f"{STREAM_SLACK >> 20} MiB = {room / 2**20:.0f} MiB")
    if peak_s > room:
        raise AssertionError("phase 24b: the streamed fit's peak device "
                             "memory is over the solver's state + 4 blocks "
                             "+ 64 MiB")
    cs, cr, cu = ms.coef_, mr.coef_, mu.coef_
    gap = float(np.abs(cs - cr).max())
    ulp = float(np.abs(cr - cu).max())
    scale = float(np.abs(cr).max())
    pred_s, pred_r = ms.predict(X), mr.predict(X)
    agree = float(np.mean(pred_s == pred_r))
    agree_ulp = float(np.mean(mu.predict(X) == pred_r))
    say(f"    n_iter streamed {int(np.max(ms.n_iter_))}, resident "
        f"{int(np.max(mr.n_iter_))}; max|coef| {scale:.3e}, streamed vs resident "
        f"max|dcoef| {gap:.3e}, resident vs its ulp-weighted refit {ulp:.3e};"
        f" predictions equal on {agree:.5f} of rows (the ulp refit's on "
        f"{agree_ulp:.5f}); walls streamed {wall_s:.2f}s, resident "
        f"{wall_r:.2f}s")
    if not np.all(np.isfinite(cs)):
        raise AssertionError("phase 24b: non-finite streamed coef_")
    if not gap <= 10 * ulp + 1e-6 * scale:
        raise AssertionError("phase 24b: the streamed coef_ is over 10x what "
                             "one ulp of weight noise moves the resident fit")
    # holds at 50 iterations; at 100 the float32 loss sum's rounding
    # decides line-search steps, and one ulp of weight noise alone then
    # changes 8.2% of the resident fit's classes (the ulp refit's share
    # is printed above)
    if agree < 0.995:
        raise AssertionError("phase 24b: streamed and resident predictions "
                             "agree on under 99.5% of rows")
    # the coef_ rule for classes: the streamed fit may change at most 10x
    # the rows that one ulp of weight noise changes (at least one row)
    if not 1.0 - agree <= 10 * max(1.0 - agree_ulp, 1.0 / n):
        raise AssertionError("phase 24b: streamed and resident predictions "
                             "differ on over 10x the rows that one ulp of "
                             "weight noise changes")
    return ms, launches


def phase_stream_predict(torch, model, X, ld):
    """Phase 24c: chunked ``batch_predict`` over the loaded dataset
    bitwise the resident sparse path at ``batch_size`` = the block rows,
    K1 launched once a block. Returns its K1 launches."""
    from skdist_tpu_torch import batch_predict
    from skdist_tpu_torch.ops import packed_sparse as ps
    from skdist_tpu_torch.parallel import LocalBackend

    backend = LocalBackend()
    ps.packed_matvec.launches = 0
    out, wall = timed_call(torch, lambda: batch_predict(
        model, ld, "predict_proba", backend=backend))
    launches = ps.packed_matvec.launches
    st = backend.last_round_stats
    ref, wall_r = timed_call(torch, lambda: batch_predict(
        model, X, "predict_proba", backend=backend, batch_size=STREAM_BLOCK))
    n = X.shape[0]
    same = np.array_equal(out, ref)
    say(f"phase 24c: chunked batch_predict(predict_proba) {n / wall:.0f} "
        f"rows/s ({wall:.2f}s, feed_wait_s {st['feed_wait_s']:.2f}), "
        f"resident at batch_size={STREAM_BLOCK} {n / wall_r:.0f} rows/s; "
        f"K1 launches {launches}; " + ("bitwise equal" if same else "DIFFER"))
    if not same or out.shape != (n, 20):
        raise AssertionError("phase 24c: chunked predict is not bitwise the "
                             "resident sparse path")
    if launches != ld.n_blocks:
        raise AssertionError(f"phase 24c: K1 launched {launches} times for "
                             f"{ld.n_blocks} blocks")
    return launches


def phase_streaming(torch):
    """Phase 24 (``--phase-24`` runs only it): returns the K1/K2 launches
    of 24a's passes, 24b's fit and 24c's predict."""
    import tempfile

    t0 = time.perf_counter()
    X, y = make_20news_sparse(seed=3, n=STREAM_N, d=2 ** 18, nnz_row=40,
                              k=20)
    say(f"phase 24: data 20news-shaped CSR {X.shape}, nnz {X.nnz}, "
        f"{time.perf_counter() - t0:.1f}s to make")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
        ld, pass_launches = phase_stream_data(torch, X, y, tmp)
        model, fit_launches = phase_stream_fit(torch, X, y, ld)
        torch.cuda.empty_cache()
        predict_launches = phase_stream_predict(torch, model, X, ld)
        del ld
    say(f"phase 24 seconds: {time.perf_counter() - t0:.1f}")
    return {"pass": pass_launches, "fit": fit_launches,
            "predict": predict_launches}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--candidates", type=int, default=96,
                    help="C and alpha candidates of the grids (default: all)")
    ap.add_argument("--ab-sgd", metavar="DIR",
                    help="run only an A/B of phase 13b's compacted search "
                    "between the checkout at DIR and this one")
    ap.add_argument("--pairs", type=int, default=6,
                    help="parent/change pairs of --ab-sgd and of "
                    "--ab-row-kernels (default 6)")
    ap.add_argument("--ab-rows", type=int, default=SGD_AB_N,
                    help="rows of --ab-sgd's data (default: phase 13b's)")
    ap.add_argument("--profile-config5", action="store_true",
                    help="run only phase 15's profiler split of one warm "
                    "call (phase 15 runs it in a process of its own)")
    ap.add_argument("--phases-17-19", action="store_true",
                    help="build the kernels and run only phases 17-19 (no "
                    "result line): a short check of the newest phases")
    ap.add_argument("--phase-20", action="store_true",
                    help="build the kernels and run only phase 20 (no "
                    "result line): a short check of the tree-family phase")
    ap.add_argument("--phase-21", action="store_true",
                    help="build the kernels and run only phase 21 (no "
                    "result line): a short check of boosting and naive "
                    "Bayes")
    ap.add_argument("--phase-22", action="store_true",
                    help="build the kernels and run only phase 22 (no "
                    "result line): a short check of feature elimination "
                    "and the voter")
    ap.add_argument("--phase-23", action="store_true",
                    help="build the kernels and run only phase 23 (no "
                    "result line): a short check of featurisation")
    ap.add_argument("--phase-24", action="store_true",
                    help="build the kernels and run only phase 24 (no "
                    "result line): a short check of the out-of-core data "
                    "plane, the streamed fit and chunked predict")
    ap.add_argument("--ab-row-kernels", metavar="DIR",
                    help="run only an A/B of the row kernels' times and "
                    "phase 14d's step split between the checkout at DIR "
                    "and this one")
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
    if args.ab_sgd:
        return ab_sgd(args.ab_sgd, args.pairs, args.ab_rows)
    if args.ab_row_kernels:
        return ab_row_kernels(args.ab_row_kernels, args.pairs)
    if args.profile_config5:
        return profile_config5(torch)
    import scipy.sparse as sp

    from skdist_tpu_torch import CUDABackend, DistGridSearchCV, LogisticRegression
    from skdist_tpu_torch.ops import _build
    from skdist_tpu_torch.ops import packed_sparse as ps

    t_all = time.perf_counter()
    warnings.filterwarnings("error", message=OOM_DOWNGRADE)
    # ---- phase 1: device and build -------------------------------------
    say(card_line())
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
    from skdist_tpu_torch import native

    t_cc = time.perf_counter()
    if not native.hist_tree_available():
        raise AssertionError("the host C tree engine did not build: "
                             f"{native.build_error()}")
    say(f"built hist_tree (the host C tree engine): "
        f"{os.path.relpath(native.BUILD_DIR)} cc "
        f"{time.perf_counter() - t_cc:.1f}s")
    say(f"phase 1 build seconds: {time.perf_counter() - t0:.1f}")
    lap()
    if args.phase_20:
        phase_trees(torch, float("nan"))
        say(f"total seconds {time.perf_counter() - t_all:.1f}")
        return 0
    if args.phase_21:
        phase_gbdt(torch)
        say(f"total seconds {time.perf_counter() - t_all:.1f}")
        return 0
    if args.phase_22:
        phase_eliminate(torch)
        say(f"total seconds {time.perf_counter() - t_all:.1f}")
        return 0
    if args.phase_23:
        phase_featurize(torch)
        say(f"total seconds {time.perf_counter() - t_all:.1f}")
        return 0
    if args.phase_24:
        phase_streaming(torch)
        say(f"total seconds {time.perf_counter() - t_all:.1f}")
        return 0

    # ---- data of the main path (needed for the main kernel shape) ------
    n, d, k = 11314, 2 ** 18, 20
    t0 = time.perf_counter()
    X, y = make_20news_sparse(seed=0, n=n, d=d, nnz_row=40, k=k)
    say(f"data: 20news-shaped CSR {X.shape}, nnz {X.nnz}, "
        f"{time.perf_counter() - t0:.1f}s")
    if args.phases_17_19:
        new_phases(torch, X, y, CUDABackend())
        say(f"total seconds {time.perf_counter() - t_all:.1f}")
        return 0
    Cs = np.logspace(-3, 2, 96)
    if args.candidates < len(Cs):
        say(f"CUT: C grid cut to its first {args.candidates} of 96 points")
        Cs = Cs[: args.candidates]
    # phase 3 runs every fourth C (24 of 96, the span kept), so that the
    # whole run stays inside its time limit; phase 2's main path shape is
    # this grid's round
    Cs_main = Cs[::4]
    n_fits = len(Cs_main) * 5

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
    # shapes that reach each branch of K1's and K2's design
    i_, v_ = random_packed(torch, rng, 3000, 40, 8)  # ~480 entries a column
    errs.append(check_pair(torch, ps, i_, v_, 40, 5, 20, seed=1,
                           label="long columns"))
    i_, v_ = segmented_packed(torch, rng, 2000, 5000, 6)
    errs.append(check_pair(torch, ps, i_, v_, 5000, 7, 8, seed=2,
                           label="segments and an empty stretch"))
    errs.append(check_pair(torch, ps, i_, v_, 5000, 6, 20, seed=3,
                           label="sliced operands", sliced=True))
    errs.append(check_pair(torch, ps, i_[:300], v_[:300], 5000, 2, 300,
                           seed=4, label="wide k, sliced", sliced=True))
    idx, val, p = main_plane(torch, X)
    est = LogisticRegression(max_iter=100)
    meta = {"n_features": d, "n_classes": k}
    static = tuple(sorted(est._static_config(meta).items()))
    backend = CUDABackend()
    T1 = backend.plan_round_size(
        n_fits, LogisticRegression._batched_task_bytes(meta, static, n))
    errs.append(check_pair(torch, ps, idx, val, p, T1, k, seed=7,
                           label="main path shape"))
    errs.append(check_pair(torch, ps, idx, val, p, 96, 1, seed=8,
                           label="main path shape, binary (k=1)"))
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
        f"({k2_by}); against torch.sparse.mm: K1 "
        f"{times['K1'] / times['K1_library']:.2f}x, K2 "
        f"{times['K2'] / times['K2_library']:.2f}x (1.00x = as fast)")
    del X_csr
    torch.cuda.empty_cache()
    row_errs, row_times, row_mv_bound, row_rmv_bound = phase_row_kernels(
        torch, ps, idx, val, p)

    # ---- phase 3: the sparse main path at full size --------------------
    say(f"phase 3: sparse DistGridSearchCV, {len(Cs_main)} C x 5 folds = "
        f"{n_fits} fits on the card")
    say(f"CUT: phase 3 runs every fourth C of the grid ({len(Cs_main)} of "
        f"{len(Cs)}, the span kept)")
    ps.packed_matvec.launches = 0
    ps.packed_rmatvec.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gs = DistGridSearchCV(
        LogisticRegression(max_iter=100), {"C": Cs_main}, cv=5,
        scoring="f1_weighted", backend=backend,
    ).fit(X, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"packed_matvec": ps.packed_matvec.launches,
                "packed_rmatvec": ps.packed_rmatvec.launches}
    stats = gs.round_stats_[0]
    say(f"  wall {wall:.1f}s, {n_fits / wall:.2f} fits/s")
    say("  " + lane_readout(stats))
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
    on_cpu = LogisticRegression(C=best_C, max_iter=100, device="cpu",
                                engine="xla").fit(X, y)
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
    profile_logreg_round(torch, X, y, Cs_main, stats["tasks_per_round"],
                         backend)
    phase_sparse_ab(torch, X, y, Cs_main)
    lap("phases 2-3b")

    # ---- phase 4: the dense headline -----------------------------------
    Xd, yd = make_20news_shaped()
    # every sixth C (16 of 96, the span kept), so that the whole run
    # stays inside its time limit; as one round: every lane runs to
    # max_iter, so the default's 8 rounds only multiply the host-paced
    # iterations
    Cs_d = Cs[::6]
    nd_fits = 5 * len(Cs_d)
    say(f"phase 4: dense DistGridSearchCV on {Xd.shape}, {nd_fits} fits as "
        "one round (partitions=1)")
    say(f"CUT: phases 4 and 4b run every sixth C of the grid "
        f"({len(Cs_d)} of {len(Cs)}, the span kept)")
    gd, wall_d = fit_grid(torch, Xd, yd, Cs_d, backend, partitions=1)
    sd = gd.round_stats_[0]
    if not np.all(np.isfinite(gd.cv_results_["mean_test_score"])):
        raise AssertionError("non-finite dense mean_test_score")
    say(f"  wall {wall_d:.1f}s, {nd_fits / wall_d:.2f} fits/s, best_params_ "
        f"{gd.best_params_}, best_score_ {gd.best_score_:.6f}")
    say("  " + lane_readout(sd))
    # the classic path at the compacted run's chunk (by default it would
    # run all its lanes as one round, another shape)
    parts = -(-nd_fits // sd["chunk"])
    gk, wall_k = fit_grid(torch, Xd, yd, Cs_d, backend, compaction=False,
                          partitions=parts)
    sk = gk.round_stats_[0]
    diff = differing_columns(gd, gk)
    say(f"  classic (SKDIST_COMPACTION=0, partitions={parts}): wall "
        f"{wall_k:.1f}s, {sk['rounds']} rounds x {sk['tasks_per_round']}; "
        "cv_results_ against compacted: "
        + ("bitwise equal" if not diff else f"differ in {diff}"))
    if diff or sk["tasks_per_round"] != sd["chunk"]:
        raise AssertionError("dense compacted and classic differ")
    del gk
    phase_asha(torch, Xd, yd, Cs_d, backend, gd)
    lap("phases 4-4b")

    # ---- phases 5-8: K4 and the forest path ----------------------------
    del gs, gd
    torch.cuda.empty_cache()
    Xf, yf = make_tabular(FOREST_N, FOREST_D, 2, seed=2)
    k4_err, k4_times, (k4_bound_ms, k4_by) = phase_k4(torch, Xf, yf)
    torch.cuda.empty_cache()
    forest_walls, k4_launches = phase_forest(torch, Xf, yf, backend)
    phase_card_vs_cpu(torch)
    phase_extra_trees_regressor(torch)
    lap("phases 5-8")

    # ---- phases 9-11: K3 and the ridge path ----------------------------
    from skdist_tpu_torch import RidgeClassifier

    del Xf, yf
    torch.cuda.empty_cache()
    alphas = np.logspace(-2, 3, 96)
    reg_alphas = np.logspace(-2, 3, 16)
    if args.candidates < len(alphas):
        say(f"CUT: alpha grids cut to their first {args.candidates} points")
        alphas = alphas[: args.candidates]
        reg_alphas = reg_alphas[: args.candidates]
    t0 = time.perf_counter()
    Xr, yr = ridge_data()
    say(f"ridge data: 20news-shaped CSR {Xr.shape}, nnz {Xr.nnz}, "
        f"{time.perf_counter() - t0:.1f}s")
    r_meta = {"n_features": RIDGE_D, "n_classes": 20, "x_format": "packed"}
    r_static = (("class_weight", None), ("fit_intercept", True))
    round_lanes = backend.plan_round_size(
        5 * len(alphas),
        RidgeClassifier._batched_task_bytes(r_meta, r_static, Xr.shape[0]),
        bytes_per_round=RidgeClassifier._batched_round_bytes(
            r_meta, r_static, Xr.shape[0]))
    k3_err, k3_times, (k3_bound_ms, k3_by), ridge_errs = phase_k3(
        torch, Xr, yr, round_lanes)
    errs += ridge_errs
    say(f"CUT: phase 10 runs every second alpha ({len(alphas[::2])} of "
        f"{len(alphas)}, the span kept)")
    r_launches = phase_ridge(torch, Xr, yr, alphas[::2], backend)
    phase_ridge_regressor(torch, Xr, reg_alphas, backend)
    lap("phases 9-11")

    # ---- phases 13-13c: BASELINE config 2, the SGD search --------------
    del Xr, yr
    torch.cuda.empty_cache()
    sgd_alphas = SGD_ALPHAS
    if args.candidates < len(sgd_alphas):
        say(f"CUT: config 2's alphas (and n_iter) cut to the first "
            f"{args.candidates}")
        sgd_alphas = sgd_alphas[: args.candidates]
    phase_sgd(torch, backend, sgd_alphas)
    torch.cuda.empty_cache()
    phase_sgd_ab(torch, backend, sgd_alphas)
    phase_sgd_card_vs_cpu(torch)
    lap("phases 13-13c")

    # ---- phases 14-14d: BASELINE config 3, one-vs-rest and one-vs-one --
    torch.cuda.empty_cache()
    phase_config3(torch, backend)
    phase_config3_packed(torch, X, y, backend)
    phase_ovo(torch, X, y, backend)
    _sgd, row_launches = phase_ovr_sgd(torch, X, y, backend)
    lap("phases 14-14d")

    # ---- phases 15-16: config 5, batch prediction, the generic search --
    torch.cuda.empty_cache()
    phase_config5(torch, backend)
    predict_launches, _blocks = phase_sparse_predict(torch, X, y, backend)
    phase_host_predict(torch)
    generic_launches = phase_generic_search(torch)
    lap("phases 15-16")

    # ---- phases 17-19: the host engine, DistMultiModelSearch, options --
    torch.cuda.empty_cache()
    mm_launches, warm_launches = new_phases(torch, X, y, backend)

    # ---- phase 20: trees batched, BYO forests, bin memos, C engine -----
    torch.cuda.empty_cache()
    tree_search_launches, tree_ovr_launches = phase_trees(
        torch, forest_walls["warm"])

    # ---- phase 21: boosting on K4's Newton channels, naive Bayes --------
    torch.cuda.empty_cache()
    gbdt_launches, gbdt_k4_err, _gbdt_k4_times = phase_gbdt(torch)

    # ---- phase 22: feature elimination (K4 under masks), the voter ------
    torch.cuda.empty_cache()
    elim_launches, _elim_k4_times = phase_eliminate(torch)

    # ---- phase 23: featurisation feeding the flagship search -----------
    torch.cuda.empty_cache()
    enc_launches = phase_featurize(torch)

    # ---- phase 24: out of core: the data plane, streamed fit, predict ---
    torch.cuda.empty_cache()
    stream_launches = phase_streaming(torch)

    # ---- phase 12: the kernel line and the result line -----------------
    source = "skdist_tpu_torch/csrc/packed_sparse.cu"
    kernels = [
        {"name": "packed_matvec", "route": "cuda", "source": source,
         "replaces": "skdist_tpu/ops/pallas_sparse.py:130",
         "launches": launches["packed_matvec"],
         "max_abs_err": max(e[0] for e in errs),
         "ms": times["K1"], "plain_ms": times["K1_plain"],
         "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": times["K1_library"],
         "paths": {"logreg_grid": launches["packed_matvec"],
                   "sparse_predict": predict_launches,
                   "multimodel": mm_launches["packed_matvec"],
                   "warm_refit": warm_launches["packed_matvec"],
                   **{f"encoder_{size}": v["packed_matvec"]
                      for size, v in enc_launches.items()},
                   "streamed_pass": stream_launches["pass"]["packed_matvec"],
                   "streamed_fit": stream_launches["fit"]["packed_matvec"],
                   "chunked_predict": stream_launches["predict"]}},
        {"name": "packed_rmatvec", "route": "cuda", "source": source,
         "replaces": "skdist_tpu/ops/pallas_sparse.py:180",
         "launches": launches["packed_rmatvec"],
         "max_abs_err": max(e[1] for e in errs),
         "ms": times["K2"], "plain_ms": times["K2_plain"],
         "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": times["K2_library"],
         "paths": {"logreg_grid": launches["packed_rmatvec"],
                   "multimodel": mm_launches["packed_rmatvec"],
                   "warm_refit": warm_launches["packed_rmatvec"],
                   **{f"encoder_{size}": v["packed_rmatvec"]
                      for size, v in enc_launches.items()},
                   "streamed_pass": stream_launches["pass"]["packed_rmatvec"],
                   "streamed_fit": stream_launches["fit"]["packed_rmatvec"]}},
        {"name": "packed_weighted_gram", "route": "cuda",
         "source": "skdist_tpu_torch/csrc/packed_gram.cu",
         "replaces": "skdist_tpu/ops/pallas_sparse.py:263",
         "launches": r_launches["packed_weighted_gram"],
         "max_abs_err": k3_err, "ms": k3_times["K3"],
         "plain_ms": k3_times["K3_plain"], "bound_ms": k3_bound_ms,
         "bound_by": k3_by, "library_ms": k3_times["sparse_mm"]},
        {"name": "level_histogram", "route": "cuda",
         "source": "skdist_tpu_torch/csrc/level_histogram.cu",
         "replaces": "skdist_tpu/ops/pallas_hist.py:124",
         "launches": k4_launches, "max_abs_err": max(k4_err, gbdt_k4_err),
         "ms": k4_times["K4"], "plain_ms": k4_times["K4_plain"],
         "bound_ms": k4_bound_ms, "bound_by": k4_by,
         "library_ms": k4_times["K4_library"],
         "paths": {"forest": k4_launches,
                   "generic_search": generic_launches,
                   "tree_search": tree_search_launches,
                   "tree_ovr": tree_ovr_launches, **gbdt_launches,
                   "eliminator_tree": elim_launches}},
        {"name": "packed_row_matvec", "route": "cuda", "source": source,
         "replaces": "skdist_tpu/ops/pallas_sparse.py:130",
         "launches": row_launches["packed_row_matvec"],
         "max_abs_err": max(e[0] for e in row_errs),
         "ms": row_times["row_matvec"],
         "plain_ms": row_times["row_matvec_plain"],
         "bound_ms": row_mv_bound[0], "bound_by": row_mv_bound[1],
         "library_ms": row_times["row_matvec_library"],
         **row_clocks(row_times, "row_matvec"),
         "paths": {"ovr_sgd": row_launches["packed_row_matvec"],
                   "multimodel": mm_launches["packed_row_matvec"]}},
        {"name": "packed_row_rmatvec", "route": "cuda", "source": source,
         "replaces": "skdist_tpu/ops/pallas_sparse.py:180",
         "launches": row_launches["packed_row_rmatvec"],
         "max_abs_err": max(e[1] for e in row_errs),
         "ms": row_times["row_rmatvec"],
         "plain_ms": row_times["row_rmatvec_plain"],
         "bound_ms": row_rmv_bound[0], "bound_by": row_rmv_bound[1],
         "library_ms": row_times["row_rmatvec_library"],
         **row_clocks(row_times, "row_rmatvec"),
         "paths": {"ovr_sgd": row_launches["packed_row_rmatvec"],
                   "multimodel": mm_launches["packed_row_rmatvec"]},
         "library_zeroed_ms": row_times["row_rmatvec_library_zeroed"],
         "library_zeroed_device_ms":
             row_times["row_rmatvec_library_zeroed_device"],
         "library_zeroed_graph_ms":
             row_times["row_rmatvec_library_zeroed_graph"]},
    ]
    for kk in kernels:
        for key, v in kk.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise AssertionError(f"{kk['name']} {key} is not finite")
        if kk["launches"] <= 0:
            raise AssertionError(f"{kk['name']} never launched on its path")
    say(f"total seconds {time.perf_counter() - t_all:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
