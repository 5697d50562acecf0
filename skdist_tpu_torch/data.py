"""
Out-of-core chunked datasets: the host side of the port's streaming data
plane.

Counterpart of ``skdist_tpu/data.py`` (all but the binned block cache of
the streamed boosting fit, which waits for ROADMAP Queue 1 item 9c).
The long row axis of a dataset is cut into uniform row blocks that live
on disk (or behind any lazily sliceable source) and stream to the card
through the backend's block feeder
(:class:`~skdist_tpu_torch.parallel.backend.BlockFeeder`: pinned host
buffers and a copy stream), so a fit or a prediction holds a few blocks
of X at a time, never the matrix.

A dataset is a list of *block readers*: zero-argument callables that
produce one block's host arrays on demand. Blocks are uniform
(``block_rows`` rows; the tail padded on read with zero-weight rows), so
every block of a dataset runs at one shape. Two X representations:

- **dense**: ``X`` blocks are ``(block_rows, d) float32``;
- **packed**: blocks are :class:`~skdist_tpu_torch.sparse.PackedX` pairs
  (numpy leaves) packed to one dataset-wide width ``m`` (the most
  nonzeros of any row of any block), so every block has one shape.

Beside X a dataset may carry per-row ``y`` and ``sample_weight``; the
streamed fits slice their own per-row arrays (encoded labels,
weights) by each block's ``[start, stop)`` range. Labels and weights are
O(n) bytes, bounded host state by design; only X (O(n d)) stays out of
core.

Everything here is host numpy: no tensor is made in this module. The
on-disk format (``.npy`` shards and ``chunked_meta.json``) is the JAX
package's, so a directory either package :meth:`ChunkedDataset.save`\\ s
the other :meth:`ChunkedDataset.load`\\ s.
"""

import hashlib
import json
import os

import numpy as np

from .sparse import (
    PackedX,
    check_densify_budget,
    is_sparse_2d,
    max_nnz_per_row,
    pack_csr_rows,
    would_pack,
)

__all__ = ["ChunkedDataset", "Block", "NonSeekableReaderError",
           "is_chunked", "default_block_rows", "packed_block_dense"]


class NonSeekableReaderError(RuntimeError):
    """A block reader failed on re-invocation.

    Every streaming consumer re-invokes readers: a multi-pass solver reads
    each block once a pass, and ``BlockFeeder.seek(i)`` replays a block. A
    one-shot reader (backed by a generator, a socket or a stream) works
    once and then raises or returns nothing. The remedy is to materialise
    the stream once: ``ChunkedDataset.save(dir)``, then fit on
    ``ChunkedDataset.load(dir)`` (memory-mapped, re-readable)."""


#: target bytes a block when no ``block_rows`` is given: big enough to
#: amortise a launch, small enough that the feeder's in-flight blocks stay
#: far below any host budget
DEFAULT_BLOCK_BYTES = 64 << 20

_META_NAME = "chunked_meta.json"

#: bytes of an array's head and of its tail that :func:`_digest_update_array`
#: hashes
_DIGEST_SLAB = 1 << 20

_REPLAY_REMEDY = (
    " when invoked a second time (streaming re-reads every block: one "
    "pass per solver iteration, plus replays via BlockFeeder.seek). "
    "ChunkedDataset.from_readers requires re-openable readers: a "
    "generator- or stream-backed one-shot reader cannot stream-fit. "
    "Materialise it once with ChunkedDataset.save(dir) and fit on "
    "ChunkedDataset.load(dir) instead."
)


def is_chunked(X):
    """Whether ``X`` is a :class:`ChunkedDataset` (what the entry points
    route to their streamed paths)."""
    return isinstance(X, ChunkedDataset)


def _digest_update_array(h, arr):
    """Feed an array's identity into a hash: shape and dtype always, and
    a bounded sample of its bytes (its first and last MiB), so a digest
    stays O(MB) for any size. A copy of the JAX package's
    ``parallel/faults.py _digest_update_array``: the two packages give a
    dataset one digest."""
    arr = np.ascontiguousarray(arr)
    h.update(repr((arr.shape, str(arr.dtype))).encode())
    raw = arr.view(np.uint8).reshape(-1)
    if raw.nbytes <= 2 * _DIGEST_SLAB:
        h.update(raw.tobytes())
    else:
        h.update(raw[:_DIGEST_SLAB].tobytes())
        h.update(raw[-_DIGEST_SLAB:].tobytes())


def packed_block_dense(packed, n_real=None):
    """Densify one packed block on the host (duplicate indices accumulate,
    as in CSR): what ``materialize`` and the host-model predict loop read,
    bounded by one block's rows."""
    idx = np.asarray(packed.idx)
    val = np.asarray(packed.val)
    if n_real is not None:
        idx, val = idx[:n_real], val[:n_real]
    dense = np.zeros((idx.shape[0], packed.n_cols), np.float32)
    np.add.at(dense, (np.arange(idx.shape[0])[:, None], idx), val)
    return dense


def default_block_rows(n_rows, row_bytes, target_bytes=DEFAULT_BLOCK_BYTES):
    """Rows a block that come to about ``target_bytes``, at most the
    dataset's rows and at least 1."""
    rows = max(1, int(target_bytes) // max(1, int(row_bytes)))
    return int(min(max(1, n_rows), rows))


class Block:
    """One host block: ``X`` (dense ``(rows, d) float32`` or a numpy
    ``PackedX``), ``y`` and ``sw`` (or None), the first global row
    ``start`` and ``n_real``, fewer than ``rows`` only on a padded tail
    (padding rows weigh 0, so a fit ignores them; a prediction slices its
    outputs to ``n_real``)."""

    __slots__ = ("X", "y", "sw", "start", "n_real")

    def __init__(self, X, y, sw, start, n_real):
        self.X = X
        self.y = y
        self.sw = sw
        self.start = start
        self.n_real = n_real

    @property
    def stop(self):
        return self.start + self.n_real


class ChunkedDataset:
    """Row blocks behind lazy readers (see the module docstring).

    Build it with :meth:`from_arrays` (an ndarray, ``np.memmap`` or scipy
    CSR), :meth:`load` (a directory :meth:`save` wrote, memory-mapped) or
    :meth:`from_readers` (any lazily produced blocks). The dataset holds
    readers and O(1) metadata; reading block ``i`` makes about
    ``block_nbytes`` of host memory.
    """

    def __init__(self, readers, n_rows, n_features, block_rows,
                 x_format="dense", packed_m=None, has_y=False,
                 has_sw=False, source=None):
        if block_rows < 1:
            raise ValueError(f"block_rows must be >= 1; got {block_rows}")
        self._readers = list(readers)
        self.n_rows = int(n_rows)
        self.n_features = int(n_features)
        self.block_rows = int(block_rows)
        self.x_format = x_format
        self.packed_m = packed_m if packed_m is None else int(packed_m)
        self.has_y = bool(has_y)
        self.has_sw = bool(has_sw)
        #: where the data came from (the directory of :meth:`load`; None
        #: in memory), for messages only
        self.source = source
        # the whole y/sw (array or memmap) where a constructor has it, so
        # load_y/load_sw read labels without running the block readers
        self._y_direct = None
        self._sw_direct = None
        # blocks whose reader has worked once: a later failure of such a
        # reader is a one-shot reader, not broken input
        self._read_once = set()
        self._content_digest = None
        expect = -(-self.n_rows // self.block_rows)
        if len(self._readers) != expect:
            raise ValueError(
                f"{len(self._readers)} readers for {self.n_rows} rows at "
                f"block_rows={self.block_rows} (expected {expect})"
            )

    # ------------------------------------------------------------------
    # shape
    # ------------------------------------------------------------------
    @property
    def shape(self):
        return (self.n_rows, self.n_features)

    def __len__(self):
        return self.n_rows

    @property
    def n_blocks(self):
        return len(self._readers)

    def block_range(self, i):
        """Global ``[start, stop)`` rows of block ``i`` (``stop`` leaves
        the tail's padding out)."""
        start = i * self.block_rows
        return start, min(start + self.block_rows, self.n_rows)

    @property
    def block_nbytes(self):
        """Bytes of one padded block's X (and y and sw, where the dataset
        carries them)."""
        if self.x_format == "packed":
            x = self.block_rows * self.packed_m * 8  # idx i32 + val f32
        else:
            x = self.block_rows * self.n_features * 4
        per_row_extra = (4 if self.has_y else 0) + (4 if self.has_sw else 0)
        return int(x + self.block_rows * per_row_extra)

    @property
    def nbytes_estimate(self):
        """Bytes of X over all blocks (real rows only)."""
        if self.x_format == "packed":
            return int(self.n_rows) * int(self.packed_m) * 8
        return int(self.n_rows) * int(self.n_features) * 4

    def __repr__(self):  # pragma: no cover - debugging nicety
        return (
            f"ChunkedDataset(n={self.n_rows}, d={self.n_features}, "
            f"{self.n_blocks} x {self.block_rows}-row {self.x_format} "
            f"blocks, ~{self.block_nbytes >> 20} MiB/block)"
        )

    def content_digest(self):
        """A content identity of the dataset that reads two blocks: its
        structural metadata (what ``chunked_meta.json`` records) and
        samples of its first and last blocks (X, and y and sw where
        carried). Cached on the instance (readers are immutable by the
        dataset's contract). Equal to the JAX package's digest of the
        same data."""
        if self._content_digest is not None:
            return self._content_digest
        h = hashlib.blake2b(digest_size=16)
        h.update(repr((
            "chunked", self.n_rows, self.n_features, self.block_rows,
            self.x_format, self.packed_m, self.n_blocks, self.has_y,
            self.has_sw,
        )).encode())
        for i in sorted({0, self.n_blocks - 1}):
            b = self.read_block(i, pad=False)
            if isinstance(b.X, PackedX):
                _digest_update_array(h, np.asarray(b.X.idx))
                _digest_update_array(h, np.asarray(b.X.val))
            else:
                _digest_update_array(h, np.asarray(b.X))
            if b.y is not None:
                _digest_update_array(h, np.asarray(b.y))
            if self.has_sw:
                _digest_update_array(h, np.asarray(b.sw))
        self._content_digest = h.hexdigest()
        return self._content_digest

    # ------------------------------------------------------------------
    # block access
    # ------------------------------------------------------------------
    def _invoke_reader(self, i):
        """Block ``i``'s reader output. A failure on a re-invocation (an
        exception, or None or no ``X`` after a first read that worked) is
        a :class:`NonSeekableReaderError` naming the ``save``/``load``
        remedy; a failure on the first call is the reader's own and
        propagates as it is."""
        replay = i in self._read_once
        try:
            raw = self._readers[i]()
        except Exception as exc:
            if not replay:
                raise
            raise NonSeekableReaderError(
                f"block {i}'s reader failed" + _REPLAY_REMEDY) from exc
        if raw is None or "X" not in raw:
            kind = ("exhausted (returned None)" if raw is None
                    else f"returned keys {sorted(raw)} without 'X'")
            if not replay:
                raise ValueError(
                    f"block {i}'s reader {kind}; readers must return "
                    "{'X': ..., 'y':?, 'sw':?} for the block's rows"
                )
            raise NonSeekableReaderError(
                f"block {i}'s reader {kind}" + _REPLAY_REMEDY)
        self._read_once.add(i)
        return raw

    def read_block(self, i, pad=True):
        """Block ``i`` as a :class:`Block`. ``pad=True`` pads the tail to
        ``block_rows`` rows (zeros for X, the last label repeated for y,
        zero weights for sw), so every block has one shape and padding
        never weighs in a contraction; ``pad=False`` gives the tail at its
        real length."""
        if not 0 <= i < self.n_blocks:
            raise IndexError(f"block {i} of {self.n_blocks}")
        raw = self._invoke_reader(i)
        start, stop = self.block_range(i)
        n_real = stop - start
        X = raw["X"]
        y = raw.get("y")
        sw = raw.get("sw")
        if sw is None:
            sw = np.ones(n_real, dtype=np.float32)
        else:
            sw = np.ascontiguousarray(np.asarray(sw).reshape(-1),
                                      dtype=np.float32)
        if y is not None:
            y = np.asarray(y).reshape(-1)
        pad_rows = self.block_rows - n_real if pad else 0
        if pad_rows:
            if isinstance(X, PackedX):
                X = PackedX(_pad0(X.idx, pad_rows), _pad0(X.val, pad_rows),
                            X.n_cols)
            else:
                X = _pad0(np.asarray(X), pad_rows)
            sw = np.concatenate([sw, np.zeros(pad_rows, dtype=np.float32)])
            if y is not None:
                y = np.concatenate([y, np.repeat(y[-1:], pad_rows)])
        return Block(X, y, sw, start, n_real)

    def load_y(self):
        """All labels as one ``(n_rows,)`` host array (None when the
        dataset carries none)."""
        if not self.has_y:
            return None
        if self._y_direct is not None:
            return np.asarray(self._y_direct).reshape(-1)[: self.n_rows]
        return np.concatenate([
            np.asarray(self._invoke_reader(i)["y"]).reshape(-1)
            for i in range(self.n_blocks)
        ])

    def load_sw(self):
        """All sample weights as one ``(n_rows,)`` float32 array (None
        when the dataset carries none)."""
        if not self.has_sw:
            return None
        if self._sw_direct is not None:
            return np.ascontiguousarray(
                np.asarray(self._sw_direct).reshape(-1)[: self.n_rows],
                dtype=np.float32,
            )
        return np.concatenate([
            np.ascontiguousarray(
                np.asarray(self._invoke_reader(i)["sw"]).reshape(-1),
                dtype=np.float32)
            for i in range(self.n_blocks)
        ])

    def materialize(self):
        """All of X at once: a dense float32 array (its size checked
        against the host's memory before any block is read), or scipy CSR
        for a packed dataset."""
        if self.x_format == "packed":
            from scipy import sparse as sp

            rows = []
            for i in range(self.n_blocks):
                b = self.read_block(i, pad=False)
                rows.append(sp.csr_matrix(packed_block_dense(b.X, b.n_real)))
            return sp.vstack(rows).tocsr()
        check_densify_budget(self.n_rows, self.n_features)
        return np.concatenate([
            np.asarray(self.read_block(i, pad=False).X)
            for i in range(self.n_blocks)
        ], axis=0)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_readers(cls, readers, n_rows, n_features, block_rows,
                     **kwargs):
        """A dataset over any block readers, each a zero-argument callable
        returning ``{"X": ..., "y":?, "sw":?}`` for its block's real rows.

        Readers must be re-openable: every streaming consumer invokes them
        again (a pass of a multi-pass solver, a replay by
        ``BlockFeeder.seek``), and each invocation must return the same
        rows. A one-shot reader is caught at its second invocation
        (:class:`NonSeekableReaderError`)."""
        return cls(readers, n_rows, n_features, block_rows, **kwargs)

    @classmethod
    def from_arrays(cls, X, y=None, sample_weight=None, block_rows=None,
                    pack=None):
        """Lazily read blocks of sliceable arrays (an ndarray,
        ``np.memmap``, pandas or scipy CSR). Nothing is copied up front:
        each reader slices and converts its block. Sparse input packs to
        one dataset-wide width when the port's packing rule says so
        (``pack=None``); ``pack=True``/``False`` force it."""
        if is_sparse_2d(X):
            X = X.tocsr()
            if pack is None:
                pack = would_pack(X)
            if pack:
                return cls._from_csr_packed(X, y, sample_weight, block_rows)
            n, d = X.shape
            block_rows = block_rows or default_block_rows(n, d * 4)
            readers = [_CsrDenseReader(X, y, sample_weight, s, e)
                       for s, e in _ranges(n, block_rows)]
            return cls._with_direct(readers, n, d, block_rows, y,
                                    sample_weight)
        if hasattr(X, "values") and not isinstance(X, np.ndarray):
            X = X.values
        n, d = X.shape[0], (X.shape[1] if X.ndim > 1 else 1)
        block_rows = block_rows or default_block_rows(n, d * 4)
        readers = [_DenseReader(X, y, sample_weight, s, e)
                   for s, e in _ranges(n, block_rows)]
        return cls._with_direct(readers, n, d, block_rows, y, sample_weight)

    @classmethod
    def _with_direct(cls, readers, n, d, block_rows, y, sw, **kwargs):
        ds = cls(readers, n, d, block_rows, has_y=y is not None,
                 has_sw=sw is not None, **kwargs)
        ds._y_direct, ds._sw_direct = y, sw
        return ds

    @classmethod
    def _from_csr_packed(cls, X, y, sample_weight, block_rows):
        n, d = X.shape
        m = max_nnz_per_row(X)  # one width for the whole dataset
        block_rows = block_rows or default_block_rows(n, m * 8)
        readers = [_CsrPackedReader(X, y, sample_weight, s, e, m)
                   for s, e in _ranges(n, block_rows)]
        return cls._with_direct(readers, n, d, block_rows, y, sample_weight,
                                x_format="packed", packed_m=m)

    def map_blocks(self, fn, n_features, x_format="dense", packed_m=None):
        """A lazily transformed dataset: ``fn(block_dict, start, stop) ->
        new block dict`` runs at read time, block by block (the encoder's
        pass-through). y and sw flow through unless ``fn`` replaces
        them."""
        parent = self

        def make_reader(i):
            def read():
                raw = parent._readers[i]()
                start, stop = parent.block_range(i)
                out = fn(dict(raw), start, stop)
                for key in ("y", "sw"):
                    if key not in out and key in raw:
                        out[key] = raw[key]
                return out

            return read

        ds = ChunkedDataset(
            [make_reader(i) for i in range(self.n_blocks)],
            self.n_rows, n_features, self.block_rows,
            x_format=x_format, packed_m=packed_m,
            has_y=self.has_y, has_sw=self.has_sw,
        )
        ds._y_direct, ds._sw_direct = self._y_direct, self._sw_direct
        return ds

    # ------------------------------------------------------------------
    # on-disk format (the JAX package's)
    # ------------------------------------------------------------------
    def save(self, dirpath):
        """Write the dataset to ``dirpath`` as ``.npy`` shards and
        ``chunked_meta.json``, block by block; :meth:`load` memory-maps
        them back."""
        os.makedirs(dirpath, exist_ok=True)
        n, d = self.n_rows, self.n_features

        def shard(name, dtype, width):
            return np.lib.format.open_memmap(
                os.path.join(dirpath, name), mode="w+", dtype=dtype,
                shape=(n, width))

        if self.x_format == "packed":
            maps = {"idx": shard("idx.npy", np.int32, self.packed_m),
                    "val": shard("val.npy", np.float32, self.packed_m)}
        else:
            maps = {"X": shard("X.npy", np.float32, d)}
        y_parts, sw_parts = [], []
        for i in range(self.n_blocks):
            b = self.read_block(i, pad=False)
            s, e = b.start, b.stop
            if self.x_format == "packed":
                maps["idx"][s:e] = b.X.idx
                maps["val"][s:e] = b.X.val
            else:
                maps["X"][s:e] = b.X
            if b.y is not None:
                y_parts.append(np.asarray(b.y))
            if self.has_sw:
                sw_parts.append(b.sw[: b.n_real])
        for mm in maps.values():
            mm.flush()
        if y_parts:
            np.save(os.path.join(dirpath, "y.npy"), np.concatenate(y_parts))
        if sw_parts:
            np.save(os.path.join(dirpath, "sw.npy"),
                    np.concatenate(sw_parts))
        meta = {
            "n_rows": n, "n_features": d, "block_rows": self.block_rows,
            "x_format": self.x_format, "packed_m": self.packed_m,
            "has_y": bool(y_parts), "has_sw": bool(sw_parts),
        }
        with open(os.path.join(dirpath, _META_NAME), "w") as f:
            json.dump(meta, f, indent=1, sort_keys=True)
        return dirpath

    @classmethod
    def load(cls, dirpath, block_rows=None):
        """Memory-map a :meth:`save` directory (the port's or the JAX
        package's). A block read copies only its slice out of the maps."""
        with open(os.path.join(dirpath, _META_NAME)) as f:
            meta = json.load(f)
        block_rows = block_rows or meta["block_rows"]
        n, d = meta["n_rows"], meta["n_features"]

        def shard(name):
            return np.load(os.path.join(dirpath, name), mmap_mode="r")

        y = shard("y.npy") if meta["has_y"] else None
        sw = shard("sw.npy") if meta["has_sw"] else None
        common = dict(has_y=meta["has_y"], has_sw=meta["has_sw"],
                      source=str(dirpath))
        if meta["x_format"] == "packed":
            idx, val = shard("idx.npy"), shard("val.npy")
            readers = [_PackedPairReader(idx, val, y, sw, s, e, d)
                       for s, e in _ranges(n, block_rows)]
            ds = cls(readers, n, d, block_rows, x_format="packed",
                     packed_m=meta["packed_m"], **common)
        else:
            X = shard("X.npy")
            readers = [_DenseReader(X, y, sw, s, e)
                       for s, e in _ranges(n, block_rows)]
            ds = cls(readers, n, d, block_rows, **common)
        ds._y_direct, ds._sw_direct = y, sw
        return ds

    # ------------------------------------------------------------------
    # the binned block cache of the streamed boosting fit (not ported)
    # ------------------------------------------------------------------
    def sketch_bin_edges(self, n_bins=32):
        """Streamed quantile bin edges: part of the streamed boosting fit,
        ROADMAP Queue 1 item 9c."""
        raise NotImplementedError(
            "ChunkedDataset.sketch_bin_edges (the streamed boosting fit's "
            "quantile sketch) is not ported to skdist_tpu_torch yet (see "
            "ROADMAP.md, queue 1 item 9c)")

    def with_binned_cache(self, edges=None, max_bins=32, cache_dir=None):
        """The binned uint8 twin of X: part of the streamed boosting fit,
        ROADMAP Queue 1 item 9c."""
        raise NotImplementedError(
            "ChunkedDataset.with_binned_cache (the streamed boosting fit's "
            "BinnedCache) is not ported to skdist_tpu_torch yet (see "
            "ROADMAP.md, queue 1 item 9c)")


# ---------------------------------------------------------------------------
# readers (picklable, closure-free)
# ---------------------------------------------------------------------------

def _ranges(n, block_rows):
    return [(s, min(s + block_rows, n)) for s in range(0, n, block_rows)]


def _pad0(arr, pad_rows):
    arr = np.asarray(arr)
    return np.concatenate(
        [arr, np.zeros((pad_rows,) + arr.shape[1:], arr.dtype)])


def _slice_ysw(y, sw, s, e):
    out = {}
    if y is not None:
        out["y"] = np.asarray(y[s:e])
    if sw is not None:
        out["sw"] = np.ascontiguousarray(np.asarray(sw[s:e]).reshape(-1),
                                         dtype=np.float32)
    return out


class _DenseReader:
    __slots__ = ("X", "y", "sw", "s", "e")

    def __init__(self, X, y, sw, s, e):
        self.X, self.y, self.sw, self.s, self.e = X, y, sw, s, e

    def __call__(self):
        X = np.asarray(self.X[self.s:self.e])
        if X.ndim == 1:
            X = X.reshape(-1, 1)
        out = {"X": np.ascontiguousarray(X, dtype=np.float32)}
        out.update(_slice_ysw(self.y, self.sw, self.s, self.e))
        return out


class _CsrDenseReader:
    __slots__ = ("X", "y", "sw", "s", "e")

    def __init__(self, X, y, sw, s, e):
        self.X, self.y, self.sw, self.s, self.e = X, y, sw, s, e

    def __call__(self):
        out = {"X": np.ascontiguousarray(self.X[self.s:self.e].toarray(),
                                         dtype=np.float32)}
        out.update(_slice_ysw(self.y, self.sw, self.s, self.e))
        return out


class _CsrPackedReader:
    __slots__ = ("X", "y", "sw", "s", "e", "m")

    def __init__(self, X, y, sw, s, e, m):
        self.X, self.y, self.sw, self.s, self.e, self.m = X, y, sw, s, e, m

    def __call__(self):
        idx, val = pack_csr_rows(self.X[self.s:self.e])
        padw = self.m - idx.shape[1]
        if padw > 0:  # pack to the dataset-wide width
            idx = np.pad(idx, ((0, 0), (0, padw)))
            val = np.pad(val, ((0, 0), (0, padw)))
        out = {"X": PackedX(idx, val, self.X.shape[1])}
        out.update(_slice_ysw(self.y, self.sw, self.s, self.e))
        return out


class _PackedPairReader:
    __slots__ = ("idx", "val", "y", "sw", "s", "e", "d")

    def __init__(self, idx, val, y, sw, s, e, d):
        self.idx, self.val = idx, val
        self.y, self.sw, self.s, self.e, self.d = y, sw, s, e, d

    def __call__(self):
        out = {"X": PackedX(
            np.ascontiguousarray(self.idx[self.s:self.e]),
            np.ascontiguousarray(self.val[self.s:self.e]),
            self.d,
        )}
        out.update(_slice_ysw(self.y, self.sw, self.s, self.e))
        return out
