"""The port's mini-batch SGD on the card (chip_smoke.py phase 13c's
checks at a small size). Marked ``cuda``: they skip on a machine without
a CUDA device. On the card, without the JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_sgd_cuda.py

- the card draws the CPU's row orders (integer hash and stable sort);
- a card fit is held to the same fit on the CPU: the gap in the weights
  is at most 10x what one ulp of input noise moves the card's own fit
  (plus 1e-6 of max|W| for a fit that absorbs the ulp entirely);
- a lane's weights do not depend on its slot in a round, bit for bit.
"""

import numpy as np
import pytest
import torch

from skdist_tpu_torch.models import SGDClassifier
from skdist_tpu_torch.models.linear import _freeze, to_device_X
from skdist_tpu_torch.utils.device import exact_matmuls
from skdist_tpu_torch.utils.draws import epoch_permutation

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (module docstring)")
    return torch.device("cuda")


def _data(n=3000, d=12, k=4, seed=1):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d).astype(np.float32)
    y = np.argmax(X @ rng.normal(size=(d, k)) + 0.7 * rng.normal(size=(n, k)),
                  axis=1)
    return X, y


def test_card_draws_the_cpu_orders(cuda):
    for seed, epoch, padded, n in ((0, 0, 3008, 3000), (7, 5, 640, 600)):
        card = epoch_permutation(seed, epoch, padded, n, cuda).cpu()
        assert torch.equal(card, epoch_permutation(seed, epoch, padded, n))


@pytest.mark.parametrize("loss", ["hinge", "log_loss"])
def test_card_fit_matches_cpu_fit(cuda, loss):
    X, y = _data()
    kw = dict(loss=loss, max_iter=3, random_state=0)
    card = SGDClassifier(**kw).fit(X, y)._params["W"]
    cpu = SGDClassifier(device="cpu", **kw).fit(X, y)._params["W"]
    ulp = SGDClassifier(**kw).fit(X * np.float32(1 + 2.0 ** -23),
                                  y)._params["W"]
    gap, noise = np.abs(card - cpu).max(), np.abs(card - ulp).max()
    assert gap <= 10 * noise + 1e-6 * np.abs(cpu).max(), (gap, noise)


def test_lane_bits_do_not_depend_on_slot(cuda):
    X, y = _data()
    est = SGDClassifier(max_iter=3, random_state=0)
    data, meta = est._prep_fit_data(X, y)
    static = _freeze(est._static_config(meta))
    op = SGDClassifier._linear_op(to_device_X(X, cuda), static)
    T = 40
    folds = torch.arange(X.shape[0], device=cuda) % 5
    sw = (folds[None] != torch.arange(T, device=cuda)[:, None] % 5).float()
    hyper = {"alpha": torch.logspace(-6, -2, T, device=cuda),
             "eta0": torch.full((T,), 0.01, device=cuda),
             "l1_ratio": torch.full((T,), 0.15, device=cuda),
             "tol": torch.full((T,), 1e-3, device=cuda)}
    kernel = SGDClassifier._build_fit_kernel(meta, static)
    yd = torch.as_tensor(data["y"]).to(cuda)
    rev = torch.arange(T - 1, -1, -1, device=cuda)
    with exact_matmuls(), torch.no_grad():
        w1 = kernel(op, yd, sw, hyper)["W"]
        w2 = kernel(op, yd, sw[rev], {k: v[rev] for k, v in hyper.items()})
    assert torch.equal(w1, w2["W"][rev])
