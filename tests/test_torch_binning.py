"""The port's quantile binning (skdist_tpu_torch.ops.binning) against
the JAX package's (skdist_tpu.ops.binning), on the same numpy inputs:
the edges, the torch ``apply_bins`` against the JAX ``apply_bins`` and
against ``apply_bins_np``, bit for bit, with NaN, constant columns,
duplicate edges, values on the edges and infinities.

Tolerance: none. Bins are counts of comparisons, so every form must
give identical int32 ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skdist_tpu.ops import binning as jb
from skdist_tpu_torch.ops import binning as tb


def _data(seed, n=300, d=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    X[:, 1] = 3.0  # constant column: all +inf edges
    X[:, 2] = rng.randint(0, 3, n)  # low cardinality: duplicate edges
    X[:, 3] = np.round(X[:, 3], 1)  # many ties
    X[rng.rand(n) < 0.05, 4] = np.nan
    return X


@pytest.mark.parametrize("n_bins", [2, 4, 32, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_edges_and_bins_match(n_bins, seed):
    X = _data(seed)
    fit_X = np.where(np.isnan(X), 0.0, X)  # the edges are fit on finite X
    edges = tb.quantile_bin_edges(fit_X, n_bins)
    np.testing.assert_array_equal(edges, jb.quantile_bin_edges(fit_X, n_bins))

    # score on X with NaN, values exactly on the edges and +-inf
    Xs = X.copy()
    Xs[:5, 0] = edges[0, : min(5, n_bins - 1)].repeat(5)[:5]
    Xs[5, :] = np.inf
    Xs[6, :] = -np.inf
    ours = tb.apply_bins(torch.as_tensor(Xs), torch.as_tensor(edges))
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), tb.apply_bins_np(Xs, edges))
    np.testing.assert_array_equal(
        ours.numpy(), np.asarray(jb.apply_bins(jnp.asarray(Xs),
                                               jnp.asarray(edges))))
    np.testing.assert_array_equal(ours.numpy(), jb.apply_bins_np(Xs, edges))
    assert (ours[np.isnan(Xs)] == 0).all()
    # the constant column lands in one bin (rows 5 and 6 hold +-inf)
    assert len(np.unique(ours[7:, 1])) == 1


def test_bad_shapes_and_bins_raise():
    with pytest.raises(ValueError, match="n_bins"):
        tb.quantile_bin_edges(np.zeros((4, 2), np.float32), 1)
    with pytest.raises(ValueError, match="do not fit"):
        tb.apply_bins(torch.zeros(4, 3), torch.zeros(2, 7))
