"""The feature eliminator's masked lanes on the card: the masked operator
against a materialised ``X * fmask`` (dense, and packed through K1/K2), a
60-lane masked round whose peak memory shows that no lane holds a copy of
X, and ``build_tree_kernel(feature_mask=...)`` on K4 against the plain
histogram. Marked ``cuda``: they skip on a machine without a CUDA device.
On the card, without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_eliminate_cuda.py

Tolerances: the operator's products within the float32 summation-order
bound of every entry, ``2 m u sum|terms|`` over its ``m`` terms (TF32
off; the view and the materialised matrix sum the same terms in orders
the library picks by shape); the trees bitwise (unweighted
classification channels are whole numbers, which K4 sums exactly in
int32 cells).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from skdist_tpu_torch import DistFeatureEliminator, LogisticRegression
from skdist_tpu_torch.models.tree import (
    build_tree_kernel,
    classification_channels,
)
from skdist_tpu_torch.ops import hist as kh
from skdist_tpu_torch.ops.binning import apply_bins, quantile_bin_edges
from skdist_tpu_torch.sparse import (
    LinearOperator,
    MaskedLinearOperator,
    PackedX,
    pack_csr_rows,
)
from skdist_tpu_torch.utils.device import exact_matmuls

pytestmark = pytest.mark.cuda

U32 = 2.0 ** -24  # unit roundoff of float32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (module docstring)")
    return torch.device("cuda")


@pytest.mark.parametrize("packed", [False, True])
def test_masked_operator_on_card(cuda, packed):
    rng = np.random.RandomState(0)
    n, d, T, k = 5000, 300, 6, 7
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[rng.rand(n, d) < 0.9] = 0.0
    fmask = torch.as_tensor(rng.rand(T, d) < 0.7, device=cuda)
    W = torch.as_tensor(rng.normal(size=(T, d + 1, k)), dtype=torch.float32,
                        device=cuda)
    Xt = torch.as_tensor(X, device=cuda)
    if packed:
        idx, val = pack_csr_rows(sp.csr_matrix(X))
        base = PackedX(torch.as_tensor(idx, device=cuda),
                       torch.as_tensor(val, device=cuda), d)
    else:
        base = Xt
    r = torch.as_tensor(rng.normal(size=(T, n, k)), dtype=torch.float32,
                        device=cuda)
    with exact_matmuls():
        view = MaskedLinearOperator(LinearOperator(base, True), fmask)
        z = view.matvec(W)
        g = view.rmatvec(r)
        for t in range(T):
            ref = LinearOperator(Xt * fmask[t].float(), True)
            zr, gr = ref.matvec(W[t]), ref.rmatvec(r[t])
            Xa = ref.Xa.abs()
            # two float32 sums of the same m terms in different orders
            # differ by at most 2 m u sum|terms|
            assert ((z[t] - zr).abs()
                    <= 2 * (d + 1) * U32 * (Xa @ W[t].abs())).all()
            assert ((g[t] - gr).abs()
                    <= 2 * n * U32 * (Xa.T @ r[t].abs())).all()
            assert (g[t][:d][~fmask[t]] == 0).all()


def test_masked_round_holds_no_copy_of_x(cuda, monkeypatch):
    """A 60-lane (12 sets x 5 folds) masked round of binary logistic
    regressions at n = 200000, d = 54, in one classic round: the peak
    device memory of the whole fit stays under half of what one copy of
    X a lane would take alone."""
    rng = np.random.RandomState(0)
    n, d = 200_000, 54
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, :20] @ rng.normal(size=20) + rng.normal(size=n) > 0).astype(int)
    monkeypatch.setenv("SKDIST_COMPACTION", "0")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fe = DistFeatureEliminator(LogisticRegression(max_iter=5),
                               min_features_to_select=10, step=4, cv=5,
                               partitions=1, scoring="accuracy").fit(X, y)
    peak = torch.cuda.max_memory_allocated() - base
    st = fe.round_stats_[0]
    assert st["mode"] == "classic" and st["tasks_per_round"] == 60
    assert np.all(np.isfinite(fe.scores_))
    assert peak < 60 * n * d * 4 / 2, peak


@pytest.mark.parametrize("extra", [False, True])
def test_tree_feature_mask_on_k4(cuda, extra):
    """``feature_mask`` on K4 (``hist_mode="pallas"``) grows the plain
    histogram's trees bitwise, with one K4 launch a level for the whole
    round; each lane equals the lone fit of its column-zeroed X under the
    same edges, and no lane splits a masked feature."""
    rng = np.random.RandomState(1)
    n, d, T, K, D = 50_000, 54, 8, 7, 6
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X[:, :10] @ rng.normal(size=(10, K))).argmax(1)
    edges = quantile_bin_edges(X, 32)
    Xb = apply_bins(torch.as_tensor(X, device=cuda), edges)
    masks = torch.as_tensor(rng.rand(T, d) < 0.5, device=cuda)
    sw = (torch.rand((T, n), device=cuda) < 0.8).float()
    Ych = classification_channels(torch.as_tensor(y, device=cuda), sw, K)
    seeds = torch.arange(T, device=cuda)

    def grow(mode):
        return build_tree_kernel(
            n_features=d, n_bins=32, channels=K + 1, max_depth=D,
            max_features=d, min_samples_split=2, min_samples_leaf=5,
            min_impurity_decrease=0.0, extra=extra, classification=True,
            hist_mode=mode)

    with torch.no_grad():
        kh.level_histogram.launches = 0
        out = grow("pallas")(Xb, Ych, seeds, feature_mask=masks)
        assert kh.level_histogram.launches == D
        ref = grow("scatter")(Xb, Ych, seeds, feature_mask=masks)
        for key in out:
            assert torch.equal(out[key], ref[key]), key
        for t in (0, T - 1):
            used = out["feat"][t][out["is_split"][t]].long()
            assert masks[t][used].all()
            Xz = apply_bins(torch.as_tensor(X, device=cuda)
                            * masks[t].float(), edges)
            lone = grow("pallas")(Xz, Ych[t:t + 1], seeds[t:t + 1])
            for key in out:
                assert torch.equal(out[key][t], lone[key][0]), (t, key)
