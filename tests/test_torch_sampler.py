"""The port's parameter sampler against scikit-learn's: the candidates of
``skdist_tpu_torch.utils.cv.ParameterSampler`` must be scikit-learn's,
value for value and in order, for every way scikit-learn draws them:

- all-list grids whose ``n_iter / grid size`` ratio takes each branch of
  scikit-learn's ``sample_without_replacement(method="auto")`` (a
  permutation strictly between 0.01 and 0.99, tracking selection at or
  below 0.01, reservoir sampling at or above 0.99, config 2's own 60
  alphas with ``n_iter=60`` among them);
- ``scipy.stats`` distributions (``loguniform``, ``uniform``,
  ``randint``) beside lists, and a list of dicts;
- ``n_iter`` above the grid's size, with scikit-learn's warning.

``ParameterGrid.__getitem__`` must index scikit-learn's order, and
``check_n_iter`` must cap ``n_iter`` as the JAX package's does. Only the
tests import scikit-learn; the package does not.
"""

import warnings

import numpy as np
import pytest
from scipy.stats import loguniform, randint, uniform
from sklearn.model_selection import ParameterGrid as SkGrid
from sklearn.model_selection import ParameterSampler as SkSampler
from sklearn.utils.random import (
    sample_without_replacement as sk_sample_without_replacement,
)

from skdist_tpu.utils.validation import check_n_iter as jax_check_n_iter
from skdist_tpu_torch.distribute.search import DistRandomizedSearchCV
from skdist_tpu_torch.models import SGDClassifier
from skdist_tpu_torch.utils.cv import (
    ParameterGrid,
    ParameterSampler,
    check_random_state,
    sample_without_replacement,
)
from skdist_tpu_torch.utils.validation import check_n_iter


def _assert_same(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key] == b[key] and type(a[key]) is type(b[key]), \
                (key, a[key], b[key])


#: (grid, n_iter): config 2's grid (ratio 1.0, reservoir sampling); a
#: permutation (ratio 0.5); tracking selection (ratio 0.005 and exactly
#: 0.01); reservoir sampling at ratio 0.99; a two-key grid
LIST_GRIDS = [
    ({"alpha": list(np.logspace(-6, -2, 60))}, 60),
    ({"alpha": list(np.logspace(-6, -2, 60))}, 30),
    ({"a": list(range(40)), "b": list(range(50))}, 10),
    ({"a": list(range(100))}, 1),
    ({"a": list(range(100))}, 99),
    ({"a": [1, 2, 3], "b": ["x", "y"], "c": [0.5]}, 4),
]


@pytest.mark.parametrize("grid,n_iter", LIST_GRIDS)
@pytest.mark.parametrize("random_state", [0, 3])
def test_list_grids_sample_as_sklearn(grid, n_iter, random_state):
    _assert_same(ParameterSampler(grid, n_iter, random_state=random_state),
                 SkSampler(grid, n_iter, random_state=random_state))
    assert len(ParameterSampler(grid, n_iter)) == len(SkSampler(grid, n_iter))


@pytest.mark.parametrize("n_population,n_samples", [
    (60, 60), (100, 50), (2000, 10), (100, 1), (100, 99), (1000, 150),
    (5, 0), (0, 0)])
@pytest.mark.parametrize("random_state", [0, 11])
def test_sample_without_replacement_as_sklearn(n_population, n_samples,
                                               random_state):
    ours = sample_without_replacement(n_population, n_samples,
                                      random_state=random_state)
    theirs = sk_sample_without_replacement(n_population, n_samples,
                                           random_state=random_state)
    np.testing.assert_array_equal(ours, theirs)


def test_sample_without_replacement_rejects_as_sklearn():
    with pytest.raises(ValueError):
        sample_without_replacement(3, 4)
    with pytest.raises(ValueError):
        sample_without_replacement(-1, 0)


def test_distributions_sample_as_sklearn():
    dists = {"alpha": loguniform(1e-6, 1e-2), "eta0": uniform(0.0, 0.1),
             "batch_size": randint(16, 128), "loss": ["hinge", "log_loss"]}
    _assert_same(ParameterSampler(dists, 25, random_state=5),
                 SkSampler(dists, 25, random_state=5))
    # a RandomState instance is shared, not copied: two samplers in a row
    # continue one stream, as in scikit-learn
    ours_rng, sk_rng = np.random.RandomState(2), np.random.RandomState(2)
    for _ in range(2):
        _assert_same(ParameterSampler(dists, 5, random_state=ours_rng),
                     SkSampler(dists, 5, random_state=sk_rng))


def test_list_of_dicts_samples_as_sklearn():
    dists = [{"alpha": loguniform(1e-6, 1e-2), "penalty": ["l2"]},
             {"alpha": [1e-4, 1e-3], "penalty": ["l1", "elasticnet"],
              "l1_ratio": uniform(0, 1)}]
    _assert_same(ParameterSampler(dists, 30, random_state=1),
                 SkSampler(dists, 30, random_state=1))
    grids = [{"a": [1, 2]}, {"b": [3, 4, 5]}]
    _assert_same(ParameterSampler(grids, 4, random_state=1),
                 SkSampler(grids, 4, random_state=1))


def test_n_iter_above_grid_size_warns_as_sklearn():
    grid = {"a": [1, 2], "b": [3, 4]}
    with pytest.warns(UserWarning, match="smaller than n_iter=10") as ours:
        got = list(ParameterSampler(grid, 10, random_state=0))
    with warnings.catch_warnings(record=True) as theirs:
        warnings.simplefilter("always")
        want = list(SkSampler(grid, 10, random_state=0))
    _assert_same(got, want)
    assert str(ours[0].message) == str(theirs[0].message)


def test_sampler_rejects_as_sklearn():
    with pytest.raises(TypeError):
        ParameterSampler(5, 3)
    with pytest.raises(TypeError):
        ParameterSampler([{"a": [1]}, 7], 3)
    with pytest.raises(TypeError):
        ParameterSampler({"a": 1}, 3)
    with pytest.raises(ValueError):
        check_random_state("seed")


@pytest.mark.parametrize("grid", [
    {"a": [1, 2, 3], "b": [4, 5]},
    [{"a": [1, 2, 3], "b": [4, 5]}, {}, {"c": [7, 8], "a": [0]}],
    [{}, {"z": list(range(5)), "y": ["p", "q"], "x": [None]}],
])
def test_grid_getitem_in_sklearn_order(grid):
    ours, theirs = ParameterGrid(grid), SkGrid(grid)
    assert len(ours) == len(theirs)
    _assert_same([ours[i] for i in range(len(ours))], list(theirs))
    _assert_same(list(ours), list(theirs))
    with pytest.raises(IndexError):
        ours[len(ours)]


@pytest.mark.parametrize("dists,n_iter", [
    ({"alpha": list(np.logspace(-6, -2, 60))}, 60),
    ({"alpha": list(np.logspace(-6, -2, 60))}, 100),
    ({"a": [1, 2], "b": [3, 4, 5]}, 4),
    ({"alpha": loguniform(1e-6, 1e-2), "b": [1, 2]}, 100),
])
def test_check_n_iter_as_the_jax_package(dists, n_iter):
    assert check_n_iter(n_iter, dists) == jax_check_n_iter(n_iter, dists)


def test_check_n_iter_takes_a_list_of_dicts():
    assert check_n_iter(50, [{"a": [1, 2]}, {"b": [3, 4, 5]}]) == 5
    assert check_n_iter(50, [{"a": [1, 2]}, {"b": uniform()}]) == 50


def test_randomized_search_draws_sklearn_candidates():
    dists = {"alpha": list(np.logspace(-6, -2, 60)),
             "tol": [1e-3, 1e-4, None]}
    search = DistRandomizedSearchCV(SGDClassifier(device="cpu"), dists,
                                    n_iter=25, random_state=4)
    _assert_same(search._get_param_iterator(),
                 SkSampler(dists, 25, random_state=4))
