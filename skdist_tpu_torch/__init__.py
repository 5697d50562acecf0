"""
skdist_tpu_torch: the PyTorch / CUDA port of skdist_tpu, for NVIDIA
Hopper (H100).

It keeps the JAX package's layout, names and public estimator API
(sklearn-style ``fit``/``predict``/``cv_results_``, clone, pickle-clean
fitted artifacts). Plain tensor code is PyTorch; each Pallas TPU kernel
on a ported path is a CUDA kernel written by hand for ``sm_90a`` under
``csrc/``, built with ``nvcc`` at first use and bound with ``ctypes``.
Entry points run on the card unless the caller passes ``device="cpu"``,
which runs every kernel's plain PyTorch version.

This package never imports ``jax``, ``skdist_tpu``, scikit-learn or
pandas.

Ported so far: ``DistGridSearchCV(LogisticRegression)`` over dense or
packed-CSR sparse X, with the packed matvec/rmatvec kernels; the
histogram trees, forests and their ``Dist*`` wrappers, with the
level-histogram kernel; the ridge family (``Ridge``,
``LinearRegression``, ``RidgeClassifier``) over dense or packed X, with
the packed weighted-gram kernel;
``DistRandomizedSearchCV(SGDClassifier)`` (mini-batch SGD; over packed X
its steps run the packed kernels in per-lane row form); ``LinearSVC``
and the multiclass meta-estimators ``DistOneVsRestClassifier`` and
``DistOneVsOneClassifier`` (the class or class-pair axis as one batched
fit); batch prediction (``batch_predict``, ``get_prediction_udf``: dense
blocks, packed sparse blocks through the packed matvec kernel, host
chunks for models without a plan); the searches' generic per-task path
over ``LocalBackend``/``CUDABackend`` host threads (any estimator, host
scorers, any fit params, ``preds``); the f64 host engine of
``LogisticRegression``/``LinearSVC`` (``engine='host'``, and ``'auto'``
where ``device="cpu"``) with the searches' warm C path;
``DistMultiModelSearch``; warm start (``coef_init``/``intercept_init``)
and ``matmul_dtype='bfloat16'``; histogram gradient boosting
(``DistHistGradientBoostingClassifier``/``Regressor``, on the
level-histogram kernel's Newton channels, batched in the searches and
one-vs-rest) and naive Bayes (``GaussianNB``, ``MultinomialNB``);
feature elimination (``DistFeatureEliminator``: the (feature set x fold)
grid as batched lanes with a column mask each) and ``SimpleVoter``;
featurisation (``Encoderizer`` with its default encoders,
``preprocessing``, and the port's own copies of the scikit-learn
transformers they use, under ``featurize/``; ``TruncatedSVDTransformer``
runs its dense products on the card). The
searches' convergence-compacted path
(iteration-sliced L-BFGS and epoch-sliced SGD; on by default,
``SKDIST_COMPACTION=0`` switches it off) and adaptive successive
halving (``adaptive=HalvingSpec(...)``). ROADMAP.md lists what is still
to port.
"""

__version__ = "0.1.0"

_EXPORTS = {
    **{name: "skdist_tpu_torch.distribute.search" for name in (
        "DistGridSearchCV", "DistRandomizedSearchCV",
        "DistMultiModelSearch")},
    **{name: "skdist_tpu_torch.models.linear" for name in (
        "LogisticRegression", "LinearSVC", "SGDClassifier", "Ridge",
        "LinearRegression", "RidgeClassifier")},
    **{name: "skdist_tpu_torch.models.gbdt" for name in (
        "DistHistGradientBoostingClassifier",
        "DistHistGradientBoostingRegressor")},
    **{name: "skdist_tpu_torch.models.naive_bayes" for name in (
        "GaussianNB", "MultinomialNB")},
    **{name: "skdist_tpu_torch.distribute.multiclass" for name in (
        "DistOneVsRestClassifier", "DistOneVsOneClassifier")},
    **{name: "skdist_tpu_torch.parallel" for name in (
        "CUDABackend", "LocalBackend")},
    **{name: "skdist_tpu_torch.distribute.predict" for name in (
        "batch_predict", "get_prediction_udf", "device_predict_plan")},
    **{name: "skdist_tpu_torch.distribute.adaptive" for name in (
        "HalvingSpec", "RungKilledWarning")},
    "DistFeatureEliminator": "skdist_tpu_torch.distribute.eliminate",
    **{name: "skdist_tpu_torch.distribute.encoder" for name in (
        "Encoderizer", "EncoderizerExtractor")},
    "TruncatedSVDTransformer": "skdist_tpu_torch.preprocessing",
    "SimpleVoter": "skdist_tpu_torch.postprocessing",
    **{name: "skdist_tpu_torch.distribute.ensemble" for name in (
        "DistRandomForestClassifier", "DistRandomForestRegressor",
        "DistExtraTreesClassifier", "DistExtraTreesRegressor",
        "DistRandomTreesEmbedding", "DistForestClassifier",
        "DistForestRegressor")},
}


def __getattr__(name):
    """Lazy top-level conveniences (``skdist_tpu_torch.DistGridSearchCV``
    ...); resolved attributes are cached in the module namespace."""
    from importlib import import_module

    if name in _EXPORTS:
        obj = getattr(import_module(_EXPORTS[name]), name)
        globals()[name] = obj
        return obj
    raise AttributeError(
        f"module 'skdist_tpu_torch' has no attribute {name!r}"
    )
