"""The streaming data plane on the card: the block feeder's pinned ring
and copy stream, and the streamed fit's kernel launches. Marked ``cuda``:
they skip on a machine without a CUDA device. On the card, without the
JAX test harness:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_streaming_cuda.py

Contracts: the feeder's host buffers are pinned, and a buffer that cannot
be pinned raises (no pageable fallback); blocks handed to a consumer
whose stream is kept busy (``torch.cuda._sleep`` before each block's
use) are not overwritten by later copies, so their sums are bitwise
those of the serial feed, also over repeated passes of one cycling feeder,
whose ring of pinned buffers is allocated once; a streamed fit launches K1 once a block a pass
and K2 once a block a value-and-gradient pass, and chunked prediction K1
once a block.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from skdist_tpu_torch import LocalBackend, batch_predict
from skdist_tpu_torch.data import ChunkedDataset
from skdist_tpu_torch.models import LinearSVC, LogisticRegression
from skdist_tpu_torch.ops import packed_sparse as ps
from skdist_tpu_torch.parallel import backend as pb
from skdist_tpu_torch.sparse import PackedX

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card (module docstring)")
    return torch.device("cuda")


def _read(i, rows=4096, m=24):
    rng = np.random.RandomState(i)
    return {"X": PackedX(rng.randint(0, 5000, (rows, m)).astype(np.int32),
                         rng.rand(rows, m).astype(np.float32), 5000),
            "sw": rng.rand(rows).astype(np.float32)}


def _dataset(n=3000, d=4000, k=3, seed=0):
    rng = np.random.RandomState(seed)
    X = sp.random(n, d, density=0.01, format="csr", random_state=seed,
                  dtype=np.float32)
    y = np.asarray(X @ rng.normal(size=(d, k))).argmax(1)
    return X, y, ChunkedDataset.from_arrays(X, y, block_rows=700, pack=True)


def test_feeder_pins_and_places_on_the_card(cuda):
    feeder = pb.BlockFeeder(_read, 5, cuda)
    got = list(feeder)
    assert all(slot.buf.is_pinned() for slot in feeder._ring)
    feeder.close()
    for i, tree in got:
        host = _read(i)
        assert tree["X"].idx.is_cuda and tree["sw"].is_cuda
        assert torch.equal(tree["X"].idx.cpu(), torch.from_numpy(host["X"].idx))
        assert torch.equal(tree["X"].val.cpu(), torch.from_numpy(host["X"].val))
        assert torch.equal(tree["sw"].cpu(), torch.from_numpy(host["sw"]))


def test_a_buffer_that_cannot_be_pinned_raises(cuda, monkeypatch):
    monkeypatch.setattr(pb, "_pinned_buffer", lambda nbytes: torch.empty(
        int(nbytes), dtype=torch.uint8))  # pageable
    for sync in (True, False):
        feeder = pb.BlockFeeder(_read, 3, cuda, sync=sync)
        with pytest.raises(RuntimeError, match="pinned"):
            feeder.next()
        feeder.close()


def _block_sums(feeder, sleep_cycles):
    sums = []
    for _i, tree in feeder:
        if sleep_cycles:
            torch.cuda._sleep(sleep_cycles)  # the consumer lags the copies
        sums.append(torch.stack([tree["X"].val.sum(),
                                 tree["X"].idx.sum().float(),
                                 tree["sw"].sum()]))
    feeder.close()
    return torch.stack(sums).cpu()


def test_blocks_survive_a_slow_consumer(cuda):
    serial = _block_sums(pb.BlockFeeder(_read, 12, cuda, sync=True), 0)
    for _ in range(2):
        slow = _block_sums(pb.BlockFeeder(_read, 12, cuda), 20_000_000)
        assert torch.equal(slow, serial)


def test_one_ring_serves_repeated_passes(cuda):
    serial = _block_sums(pb.BlockFeeder(_read, 5, cuda, sync=True), 0)
    feeder = pb.BlockFeeder(_read, 5, cuda, cycle=True)
    ring = None
    for _pass in range(3):
        sums = []
        for i in range(5):
            j, tree = feeder.next()
            assert j == i
            torch.cuda._sleep(20_000_000)  # the consumer lags the copies
            sums.append(torch.stack([tree["X"].val.sum(),
                                     tree["X"].idx.sum().float(),
                                     tree["sw"].sum()]))
        assert torch.equal(torch.stack(sums).cpu(), serial)
        # the next pass's first block is already in flight
        assert [j for j, _ in feeder._pending] == [5 * (_pass + 1)]
        ptrs = [slot.buf.data_ptr() for slot in feeder._ring]
        assert ring in (None, ptrs)  # allocated once, then reused
        ring = ptrs
    feeder.close()


@pytest.mark.parametrize("family", ["logreg", "svc"])
def test_streamed_fit_launches_blocks_times_passes(cuda, family):
    X, y, ds = _dataset()
    est = (LogisticRegression(max_iter=15) if family == "logreg"
           else LinearSVC(C=0.05, max_iter=15))
    ps.packed_matvec.launches = 0
    ps.packed_rmatvec.launches = 0
    est.fit(ds)
    st = est.stream_stats_
    assert ps.packed_matvec.launches == ds.n_blocks * st["passes"]
    assert ps.packed_rmatvec.launches == ds.n_blocks * st["grad_passes"]
    assert np.all(np.isfinite(est.coef_))
    # the same fit on the CPU, within the rounding of 15 iterations
    cpu = type(est)(**{**est.get_params(), "device": "cpu"}).fit(ds)
    scale = float(np.abs(cpu.coef_).max())
    assert np.abs(est.coef_ - cpu.coef_).max() <= 1e-3 * scale


def test_chunked_predict_launches_k1_once_a_block(cuda):
    X, y, ds = _dataset()
    model = LogisticRegression(max_iter=10).fit(X, y)
    backend = LocalBackend()
    ps.packed_matvec.launches = 0
    out = batch_predict(model, ds, "predict_proba", backend=backend)
    assert ps.packed_matvec.launches == ds.n_blocks
    want = batch_predict(model, X, "predict_proba", backend=backend,
                         batch_size=ds.block_rows)
    np.testing.assert_array_equal(out, want)
