"""Batch prediction on the card: the resident dense path against the
CPU, the sparse path through K1 (one launch a row block), and a forest's
host chunks on threads against the serial walk. Marked ``cuda``: they
skip on a machine without a CUDA device. On the card, without the JAX
test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_predict_cuda.py

Tolerance: the card's float32 products against the CPU's, within 1e-5
absolute on probabilities (another summation order; TF32 is off under
``exact_matmuls``); labels equal; the forest bitwise (each row's walk
and its mean over trees do not depend on the other rows).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from skdist_tpu_torch.distribute import predict as tp
from skdist_tpu_torch.models import LogisticRegression
from skdist_tpu_torch.models.forest import RandomForestClassifier
from skdist_tpu_torch.ops import packed_sparse as ps
from skdist_tpu_torch.parallel import CUDABackend, LocalBackend

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (module docstring)")
    return torch.device("cuda")


def _data(n=3000, d=64, k=10, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32)
    y = np.argmax(X @ rng.randn(d, k) + 0.3 * rng.randn(n, k), axis=1)
    return X, y


def test_dense_card_equals_cpu(cuda):
    X, y = _data()
    cpu_model = LogisticRegression(max_iter=20, device="cpu").fit(X, y)
    card_model = LogisticRegression(max_iter=20)
    card_model._set_fitted(dict(cpu_model._params), cpu_model._meta)
    cpu = tp.batch_predict(cpu_model, X, "predict_proba",
                           backend=LocalBackend(device="cpu"),
                           batch_size=700)
    card = tp.batch_predict(card_model, X, "predict_proba",
                            backend=CUDABackend(), batch_size=700)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-5)
    again = tp.batch_predict(card_model, X, "predict_proba",
                             backend=CUDABackend(), batch_size=700)
    np.testing.assert_array_equal(card, again)
    np.testing.assert_array_equal(
        tp.batch_predict(card_model, X, "predict", backend=CUDABackend(),
                         batch_size=700),
        card_model.classes_[np.argmax(card, axis=1)])


def test_sparse_launches_k1_once_a_block(cuda):
    rng = np.random.RandomState(1)
    n, d, k = 2500, 1 << 14, 5
    X = sp.random(n, d, density=0.003, format="csr", random_state=rng,
                  dtype=np.float32)
    y = rng.randint(0, k, n)
    model = LogisticRegression(max_iter=10).fit(X, y)
    assert model._meta["x_format"] == "packed"
    ps.packed_matvec.launches = 0
    out = tp.batch_predict(model, X, "predict_proba", backend=CUDABackend(),
                           batch_size=600)
    assert ps.packed_matvec.launches == -(-n // 600)
    np.testing.assert_allclose(out, model.predict_proba(X), rtol=0,
                               atol=1e-5)
    dense = tp.batch_predict(model, X.toarray(), "predict_proba",
                             backend=CUDABackend(), batch_size=600)
    np.testing.assert_allclose(out, dense, rtol=0, atol=1e-5)


def test_forest_threads_bitwise_serial(cuda):
    X, y = _data(n=20000, d=12, k=2, seed=2)
    forest = RandomForestClassifier(n_estimators=16, max_depth=6).fit(X, y)
    whole = forest.predict_proba(X)
    serial = tp.batch_predict(forest, X, "predict_proba",
                              backend=LocalBackend(n_jobs=1),
                              batch_size=5000)
    threads = tp.batch_predict(forest, X, "predict_proba",
                               backend=LocalBackend(n_jobs=4),
                               batch_size=5000)
    np.testing.assert_array_equal(serial, whole)
    np.testing.assert_array_equal(threads, serial)
