"""The port's out-of-core data plane (``skdist_tpu_torch/data.py`` and the
block feeder of ``skdist_tpu_torch/parallel/backend.py``) against the JAX
package's (``skdist_tpu/data.py``), on the CPU, on the same numpy inputs
made from a seed.

Contracts: a dataset's blocks (X, y, sample weights, padding, ``start``,
``n_real``), sizes and ``content_digest`` equal the JAX package's; a
directory saved by either package loads in the other with every block
bitwise equal; ``map_blocks``, ``materialize``, ``load_y``/``load_sw`` and
the one-shot reader's ``NonSeekableReaderError`` behave as there. The
feeder hands blocks out in order in both modes, counts what it fed,
replays a block after ``seek`` and raises a read error at ``next``.
"""

import json
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from skdist_tpu import data as jdata
from skdist_tpu_torch import data as tdata
from skdist_tpu_torch.parallel.backend import BlockFeeder, tree_nbytes
from skdist_tpu_torch.sparse import PackedX


def _arrays(seed=0, n=203, d=17):
    rng = np.random.RandomState(seed)
    Xd = rng.normal(size=(n, d)).astype(np.float32)
    Xs = sp.random(n, 300, density=0.03, format="csr", random_state=seed,
                   dtype=np.float32)
    y = rng.randint(0, 3, n)
    sw = rng.uniform(0.2, 2.0, n).astype(np.float32)
    return Xd, Xs, y, sw


CASES = [  # (X kind, with y, with sw, block_rows)
    ("dense", True, True, 50), ("dense", False, False, 64),
    ("packed", True, True, 40), ("packed", True, False, 203),
    ("csr_dense", True, True, 70),
]


def _pair(kind, with_y, with_sw, block_rows, seed=0):
    Xd, Xs, y, sw = _arrays(seed)
    X = Xd if kind == "dense" else Xs
    pack = {"dense": None, "packed": True, "csr_dense": False}[kind]
    args = dict(y=y if with_y else None,
                sample_weight=sw if with_sw else None,
                block_rows=block_rows, pack=pack)
    return (jdata.ChunkedDataset.from_arrays(X, **args),
            tdata.ChunkedDataset.from_arrays(X, **args))


def _same_block(a, b):
    assert (a.start, a.n_real, a.stop) == (b.start, b.n_real, b.stop)
    if isinstance(b.X, PackedX):
        np.testing.assert_array_equal(np.asarray(a.X.idx), b.X.idx)
        np.testing.assert_array_equal(np.asarray(a.X.val), b.X.val)
        assert a.X.n_cols == b.X.n_cols
        assert b.X.idx.dtype == np.int32 and b.X.val.dtype == np.float32
    else:
        np.testing.assert_array_equal(np.asarray(a.X), b.X)
        assert b.X.dtype == np.float32
    np.testing.assert_array_equal(a.sw, b.sw)
    assert b.sw.dtype == np.float32
    if a.y is None:
        assert b.y is None
    else:
        np.testing.assert_array_equal(a.y, b.y)


@pytest.mark.parametrize("case", CASES)
def test_blocks_sizes_and_digest_match_jax(case):
    ref, ours = _pair(*case)
    for key in ("n_rows", "n_features", "block_rows", "x_format",
                "packed_m", "has_y", "has_sw", "n_blocks", "shape",
                "block_nbytes", "nbytes_estimate"):
        assert getattr(ours, key) == getattr(ref, key), key
    assert len(ours) == len(ref)
    for i in range(ours.n_blocks):
        assert ours.block_range(i) == ref.block_range(i)
        for pad in (True, False):
            _same_block(ref.read_block(i, pad=pad), ours.read_block(i, pad=pad))
    assert ours.content_digest() == ref.content_digest()
    for a, b in ((ref.load_y(), ours.load_y()), (ref.load_sw(), ours.load_sw())):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


def test_padding_rows_weigh_nothing():
    _ref, ours = _pair("packed", True, True, 40)
    b = ours.read_block(ours.n_blocks - 1)
    tail = slice(b.n_real, None)
    assert b.n_real == 203 - 5 * 40 and b.X.idx.shape[0] == 40
    assert not b.sw[tail].any() and not b.X.val[tail].any()
    assert (b.y[tail] == b.y[b.n_real - 1]).all()
    with pytest.raises(IndexError):
        ours.read_block(ours.n_blocks)


@pytest.mark.parametrize("kind", ["dense", "packed"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_saved_directories_load_in_the_other_package(tmp_path, kind, writer):
    ref, ours = _pair(kind, True, True, 48)
    src = ours if writer == "port" else ref
    src.save(str(tmp_path))
    reader = jdata if writer == "port" else tdata
    loaded = reader.ChunkedDataset.load(str(tmp_path))
    with open(os.path.join(tmp_path, "chunked_meta.json")) as f:
        meta = json.load(f)
    assert meta["n_rows"] == 203 and meta["x_format"] == src.x_format
    for i in range(src.n_blocks):
        a, b = src.read_block(i), loaded.read_block(i)
        if writer == "port":
            a, b = b, a  # _same_block reads the JAX block first
        _same_block(a, b)
    assert loaded.content_digest() == src.content_digest()
    # a reload at another block size reads the same rows
    again = tdata.ChunkedDataset.load(str(tmp_path), block_rows=100)
    assert again.n_blocks == 3
    if kind == "dense":
        np.testing.assert_array_equal(again.materialize(), ours.materialize())


def test_loaded_blocks_are_read_only_maps_copied_by_the_feeder(tmp_path):
    _ref, ours = _pair("packed", True, True, 64)
    ours.save(str(tmp_path))
    ld = tdata.ChunkedDataset.load(str(tmp_path))
    b = ld.read_block(0)
    assert not b.X.idx.flags.writeable  # a view of the memory map
    feeder = BlockFeeder(lambda i: {"X": ld.read_block(i).X}, ld.n_blocks,
                         "cpu")
    _i, tree = feeder.next()
    feeder.close()
    tree["X"].idx[0, 0] = 7  # a copy: the map is untouched
    assert ld.read_block(0).X.idx[0, 0] == b.X.idx[0, 0]


def test_map_blocks_matches_jax():
    ref, ours = _pair("dense", True, True, 50)

    def fn(block, start, stop):
        X = np.asarray(block["X"])
        return {"X": np.hstack([X * 2.0, np.full((len(X), 1), start,
                                                 np.float32)])}

    a, b = ref.map_blocks(fn, n_features=18), ours.map_blocks(fn, 18)
    assert b.shape == (203, 18) and b.has_y and b.has_sw
    for i in range(b.n_blocks):
        _same_block(a.read_block(i), b.read_block(i))
    np.testing.assert_array_equal(b.load_y(), ours.load_y())
    np.testing.assert_array_equal(b.materialize(), a.materialize())


@pytest.mark.parametrize("kind", ["dense", "packed"])
def test_materialize(kind):
    Xd, Xs, y, _sw = _arrays()
    _ref, ours = _pair(kind, True, False, 64)
    out = ours.materialize()
    if kind == "packed":
        assert sp.issparse(out)
        np.testing.assert_array_equal(out.toarray(), Xs.toarray())
    else:
        np.testing.assert_array_equal(out, Xd)


def _one_shot():
    state = {"calls": 0}

    def once():
        state["calls"] += 1
        if state["calls"] > 1:
            raise StopIteration("the stream is spent")
        return {"X": np.ones((4, 2), np.float32)}

    return once


def test_non_seekable_reader():
    ds = tdata.ChunkedDataset.from_readers([_one_shot()], 4, 2, 4)
    ds.read_block(0)
    with pytest.raises(tdata.NonSeekableReaderError, match="save"):
        ds.read_block(0)
    # the JAX package's dataset raises the same on the same reader
    ref = jdata.ChunkedDataset.from_readers([_one_shot()], 4, 2, 4)
    ref.read_block(0)
    with pytest.raises(jdata.NonSeekableReaderError):
        ref.read_block(0)
    # a reader that is wrong on its first call raises its own error
    bad = tdata.ChunkedDataset.from_readers([lambda: None], 4, 2, 4)
    with pytest.raises(ValueError, match="exhausted"):
        bad.read_block(0)
    with pytest.raises(ValueError, match="readers"):
        tdata.ChunkedDataset.from_readers([_one_shot()] * 2, 4, 2, 4)


def test_binned_cache_waits_for_9c():
    _ref, ours = _pair("dense", True, False, 64)
    for call in (ours.sketch_bin_edges, ours.with_binned_cache):
        with pytest.raises(NotImplementedError, match="item 9c"):
            call()


# ---------------------------------------------------------------------------
# the block feeder
# ---------------------------------------------------------------------------

def _read(i):
    rng = np.random.RandomState(i)
    return {"X": PackedX(rng.randint(0, 9, (5, 3)).astype(np.int32),
                         rng.rand(5, 3).astype(np.float32), 9),
            "y": np.full(5, i, np.int32), "sw": np.ones(5, np.float32)}


@pytest.mark.parametrize("sync", [True, False])
def test_feeder_order_and_stats(sync):
    stats = {}
    feeder = BlockFeeder(_read, 6, "cpu", sync=sync, stats=stats)
    got = list(feeder)
    feeder.close()
    assert [i for i, _ in got] == list(range(6))
    for i, tree in got:
        host = _read(i)
        assert isinstance(tree["X"], PackedX)
        assert torch.equal(tree["X"].idx, torch.from_numpy(host["X"].idx))
        assert torch.equal(tree["y"], torch.full((5,), i, dtype=torch.int32))
    assert stats["stream_mode"] == ("serial" if sync else "pipelined")
    assert stats["blocks_fed"] == 6
    assert stats["streamed_bytes"] == 6 * tree_nbytes(_read(0)) == 6 * 160
    assert stats["peak_block_bytes"] == 160
    assert stats["feed_wait_s"] >= 0 and stats["read_place_s"] > 0
    assert feeder.next() is None


def test_feeder_seek_rereads_and_errors_surface_at_next():
    calls = []

    def read(i):
        calls.append(i)
        if i == 2 and calls.count(2) == 1:
            raise OSError("disk gone")
        return _read(i)

    feeder = BlockFeeder(read, 4, "cpu")
    assert feeder.next()[0] == 0
    assert feeder.next()[0] == 1
    with pytest.raises(OSError, match="disk gone"):
        feeder.next()
    feeder.seek(2)  # the reader opens again at that offset
    assert [i for i, _ in feeder] == [2, 3]
    feeder.seek(1)
    assert feeder.next()[0] == 1
    feeder.close()
    assert calls[:6] == [0, 1, 2, 2, 3, 1]  # a failed read is re-read


@pytest.mark.parametrize("sync", [True, False])
def test_feeder_cycles_for_repeated_passes(sync):
    calls = []

    def read(i):
        calls.append(i)
        return _read(i)

    stats = {}
    feeder = BlockFeeder(read, 3, "cpu", sync=sync, stats=stats, cycle=True)
    got = [feeder.next() for _ in range(7)]
    assert [i for i, _ in got] == [0, 1, 2, 0, 1, 2, 0]
    for i, tree in got:
        assert torch.equal(tree["y"], torch.full((5,), i, dtype=torch.int32))
    # the pipelined feed has read the block after the last one handed out
    # (its read is in flight on the worker thread: wait for it)
    for _j, fut in feeder._pending:
        fut.result()
    assert calls == [0, 1, 2, 0, 1, 2, 0] + ([] if sync else [1])
    feeder.close()
    assert stats["blocks_fed"] == 7  # the discarded prefetch is not fed
    assert stats["streamed_bytes"] == 7 * 160
    assert feeder.next() is None
