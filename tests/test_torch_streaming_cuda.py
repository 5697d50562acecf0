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
once a block; K3 and the row forms on a fed block equal their plain
versions (whole numbers: bitwise); the streamed ridge and SGD fits give
the same bits fed serially and pipelined, the SGD fit those of the
resident fit.
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


def _fed_block(ds, cuda):
    """Block 0 of ``ds`` fed to the card, and its operator."""
    from skdist_tpu_torch.sparse import LinearOperator

    with pb.BlockFeeder(lambda i: {"X": ds.read_block(i).X}, 1, cuda) as fd:
        _i, block = fd.next()
        return LinearOperator(block["X"], True)


def test_k3_and_the_row_forms_on_a_fed_block(cuda):
    """K3 over a fed block's lanes and the row forms on a batch gathered
    from it, against their plain versions: bitwise on whole numbers (each
    term is the plain version's), and each repeats bitwise."""
    rng = np.random.RandomState(4)
    X = sp.random(2000, 3000, density=0.01, format="csr", random_state=4,
                  dtype=np.float32)
    X.data[:] = rng.randint(-3, 4, X.nnz)
    ds = ChunkedDataset.from_arrays(X, np.zeros(2000), block_rows=1024,
                                    pack=True)
    op = _fed_block(ds, cuda)
    sw = torch.as_tensor(rng.randint(0, 4, (3, 1024)).astype(np.float32),
                         device=cuda)
    G = ps.packed_weighted_gram(op.pidx, op.pval, sw, op.p)
    assert torch.equal(G, ps.packed_weighted_gram(op.pidx, op.pval, sw, op.p))
    for t in range(3):
        assert torch.equal(G[t], ps.packed_weighted_gram_ref(
            op.pidx, op.pval, sw[t], op.p))
    rows = op.row_batch(torch.arange(256, device=cuda).reshape(2, 128))
    W = torch.as_tensor(rng.randint(-4, 5, (2, op.p, 3)).astype(np.float32),
                        device=cuda)
    g = torch.as_tensor(rng.randint(-4, 5, (2, 128, 3)).astype(np.float32),
                        device=cuda)
    out = ps.packed_row_matvec(*rows, W)
    back = ps.packed_row_rmatvec(*rows, g, op.p)
    assert torch.equal(out, ps.packed_row_matvec_ref(*rows, W))
    assert torch.equal(back, ps.packed_row_rmatvec_ref(*rows, g, op.p))
    assert torch.equal(back, ps.packed_row_rmatvec(*rows, g, op.p))


@pytest.mark.parametrize("family", ["ridge", "sgd"])
def test_serial_feed_is_the_pipelined_feed(cuda, family):
    """The gram and SGD kinds: a serial feed and the pipelined one give
    the same bits; the SGD fit is also bitwise the resident one, K3
    launches once a block a round and the row forms per step."""
    from skdist_tpu_torch.models import RidgeClassifier, SGDClassifier
    from skdist_tpu_torch.models.streaming import stream_fit_estimator

    X, y, ds = _dataset()
    ds = ChunkedDataset.from_arrays(X, y, block_rows=640, pack=True)

    def est():
        return (RidgeClassifier(alpha=1.0) if family == "ridge" else
                SGDClassifier(batch_size=64, max_iter=3, shuffle=False,
                              tol=None))

    ps.packed_weighted_gram.launches = 0
    ps.packed_row_rmatvec.launches = 0
    fits = [stream_fit_estimator(est(), ds, sync=sync)
            for sync in (True, False)]
    for a, b in zip(fits[0].coef_, fits[1].coef_):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(fits[0].intercept_, fits[1].intercept_)
    st = fits[0].stream_stats_
    if family == "ridge":
        assert ps.packed_weighted_gram.launches == 2 * ds.n_blocks
    else:
        assert ps.packed_row_rmatvec.launches == 2 * st["steps"]
        resident = est().fit(X, y)
        np.testing.assert_array_equal(fits[0].coef_, resident.coef_)
        np.testing.assert_array_equal(fits[0].n_iter_, resident.n_iter_)
