"""Hygiene of the port: its CV splitters and parameter grid against
scikit-learn's, its import isolation (no jax, no skdist_tpu, no sklearn,
no pandas, in the package and in chip_smoke.py), and its refusal to fall back to
the CPU quietly when no card is present.
"""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
from sklearn.model_selection import KFold as SkKFold
from sklearn.model_selection import ParameterGrid as SkParameterGrid
from sklearn.model_selection import StratifiedKFold as SkStratifiedKFold
from sklearn.model_selection import check_cv as sk_check_cv

from skdist_tpu_torch.utils import cv as tcv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "skdist_tpu", "sklearn", "pandas")


def _targets():
    rng = np.random.RandomState(0)
    return [
        rng.randint(0, 3, 50),                           # balanced-ish
        np.array([0] * 30 + [1] * 7 + [2] * 13),         # sorted, skewed
        rng.choice(np.array(["b", "a", "c"]), 41),       # string labels
        rng.randint(0, 2, 37).astype(np.float64),        # integral floats
    ]


def _same_splits(ours, theirs):
    assert len(ours) == len(theirs)
    for (tr, te), (str_, ste) in zip(ours, theirs):
        np.testing.assert_array_equal(tr, str_)
        np.testing.assert_array_equal(te, ste)


@pytest.mark.parametrize("case", range(4))
@pytest.mark.parametrize("n_splits", [3, 5])
def test_splits_match_sklearn(case, n_splits):
    y = _targets()[case]
    X = np.zeros((len(y), 2))
    _same_splits(list(tcv.StratifiedKFold(n_splits).split(X, y)),
                 list(SkStratifiedKFold(n_splits).split(X, y)))
    _same_splits(list(tcv.KFold(n_splits).split(X, y)),
                 list(SkKFold(n_splits).split(X, y)))
    _same_splits(
        list(tcv.StratifiedKFold(n_splits, shuffle=True,
                                 random_state=3).split(X, y)),
        list(SkStratifiedKFold(n_splits, shuffle=True,
                               random_state=3).split(X, y)))
    _same_splits(
        list(tcv.KFold(n_splits, shuffle=True, random_state=3).split(X, y)),
        list(SkKFold(n_splits, shuffle=True, random_state=3).split(X, y)))
    # an int cv resolves as sklearn's check_cv does
    for classifier in (True, False):
        ours = tcv.check_cv(n_splits, y, classifier=classifier)
        theirs = sk_check_cv(n_splits, y, classifier=classifier)
        assert type(ours).__name__ == type(theirs).__name__
        _same_splits(list(ours.split(X, y)), list(theirs.split(X, y)))


def test_check_cv_passthrough_and_continuous_target():
    y = np.linspace(0, 1, 20)  # continuous: KFold even for a classifier
    assert isinstance(tcv.check_cv(4, y, classifier=True), tcv.KFold)
    splitter = tcv.KFold(4)
    assert tcv.check_cv(splitter, y) is splitter
    pairs = [(np.arange(10), np.arange(10, 20))]
    wrapped = tcv.check_cv(pairs, y)
    assert wrapped.get_n_splits() == 1
    _same_splits(list(wrapped.split()), pairs)


def test_parameter_grid_matches_sklearn():
    grids = [
        {"C": [1.0, 0.1, 10.0]},
        {"C": [1, 2], "tol": [1e-3, 1e-4], "fit_intercept": [True, False]},
        [{"C": [1, 2]}, {"tol": [0.1], "C": [3]}],
    ]
    for grid in grids:
        assert list(tcv.ParameterGrid(grid)) == list(SkParameterGrid(grid))
        assert len(tcv.ParameterGrid(grid)) == len(SkParameterGrid(grid))


def _imported_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_no_reference_no_sklearn():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "skdist_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    for path in files:
        for name in _imported_names(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    code = (
        "import sys\n"
        "import skdist_tpu_torch as p\n"
        "from skdist_tpu_torch import convert, metrics, sparse\n"
        "from skdist_tpu_torch.distribute import ensemble, multiclass, search\n"
        "from skdist_tpu_torch.distribute import predict\n"
        "from skdist_tpu_torch.models import forest, linear, tree\n"
        "from skdist_tpu_torch.models import native_forest\n"
        "from skdist_tpu_torch import native\n"
        "native.hist_tree_available()\n"
        "from skdist_tpu_torch.ops import binning, hist, packed_sparse, _build\n"
        "from skdist_tpu_torch.utils import cv, device, draws, validation\n"
        "p.DistGridSearchCV, p.LogisticRegression, p.CUDABackend\n"
        "p.DistRandomForestClassifier, p.DistRandomTreesEmbedding\n"
        "p.DistForestClassifier, p.DistForestRegressor\n"
        "p.Ridge, p.RidgeClassifier, p.LinearRegression\n"
        "p.LinearSVC, p.DistOneVsRestClassifier, p.DistOneVsOneClassifier\n"
        "p.LocalBackend, p.batch_predict, p.get_prediction_udf\n"
        "p.device_predict_plan, predict.batch_predict\n"
        "convert.tree_from_reference\n"
        "convert.multiclass_from_reference, convert.linear_svc_from_reference\n"
        "convert.ridge_from_reference, sparse.packed_to_dense\n"
        "packed_sparse.packed_weighted_gram, packed_sparse.build_pairs\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules\n"
        f"       if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_quiet_cpu_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available: the no-card path cannot run")
    from skdist_tpu_torch import CUDABackend, LogisticRegression, RidgeClassifier

    with pytest.raises(RuntimeError, match="device='cpu'"):
        CUDABackend()
    X = np.random.RandomState(0).randn(20, 3).astype(np.float32)
    y = (X[:, 0] > 0).astype(int)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LogisticRegression().fit(X, y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RidgeClassifier().fit(X, y)
    assert CUDABackend(device="cpu").device.type == "cpu"

    # chip_smoke.py exits nonzero and prints no result line without a
    # card, in the checkout and alone in a directory
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), alone)
    for cwd, script in ((ROOT, "chip_smoke.py"), (str(tmp_path), str(alone))):
        res = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
