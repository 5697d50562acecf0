"""
The host C kernels of the port, built on demand: the tree kernels
(``hist_tree.c``), text hashing (``fasthash.c`` and ``murmurhash.c``)
and the CSR densifier (``densify.c``).

Counterpart of ``skdist_tpu/native/__init__.py``: the loader
(:func:`_load_ext`), the entry points of the host forest engine
(``models/native_forest.py``, ``hist_mode="native"``),
:func:`hash_documents` (``preprocessing.FastHashingVectorizer``) and
:func:`csr_to_dense_f32` (``sparse.sparse_to_dense_f32``), plus the
port's own :func:`murmurhash3_32_spans`, which ``featurize/text.py
HashingVectorizer`` hashes its n-grams with. The C sources ship as
package data (``hist_tree.c``, ``fasthash.c`` and ``densify.c`` are
copies of the JAX package's); each is compiled with the system C
compiler (``$CC``, else ``cc``) against CPython's headers at first use,
into ``skdist_tpu_torch/_build/``, and imported as an extension module.
Nothing is built when this module is imported.

A build that fails (no compiler, a read-only tree) leaves that kernel
unavailable and :func:`build_error` says why. The tree engine then
grows trees with torch (an explicit ``hist_mode="native"`` raises,
``models/native_forest.py native_supported_or_raise``);
:func:`hash_documents` and :func:`csr_to_dense_f32` take their Python
and scipy forms, as the JAX package's do; :func:`murmurhash3_32_spans`
raises, so that the vectorizers never fall back to a Python hash loop
quietly. The Python forms (``force_python``, :func:`murmurhash3_32_py`)
stay for the tests that hold the C kernels to them.
"""

import os
import subprocess
import sysconfig
import tempfile
import threading

import numpy as np

__all__ = [
    "best_splits_native",
    "build_error",
    "csr_to_dense_f32",
    "default_threads",
    "forest_walk_native",
    "hash_documents",
    "hist_level",
    "hist_tree_available",
    "murmurhash3_32_py",
    "murmurhash3_32_spans",
    "native_available",
]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

_EXTS = {}
_ERRORS = {}
_LOAD_LOCK = threading.Lock()


def _load_ext(name, extra_flags=()):
    """Import the compiled module ``_<name>`` (from ``<name>.c``),
    building it on first use; None when that fails (the reason is kept
    for :func:`build_error`). Builds go to a temporary file renamed into
    place, so concurrent processes never load a half-written one."""
    with _LOAD_LOCK:
        if name in _EXTS:
            return _EXTS[name]
        try:
            mod = _load_ext_inner(name, extra_flags)
        except Exception as exc:  # any failure: the engine is unavailable
            _ERRORS[name] = f"{type(exc).__name__}: {exc}"
            mod = None
        _EXTS[name] = mod
        return mod


def _load_ext_inner(name, extra_flags):
    import importlib.util

    os.makedirs(BUILD_DIR, exist_ok=True)
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    so_path = os.path.join(BUILD_DIR, f"_{name}{suffix}")
    src = os.path.join(_SRC_DIR, f"{name}.c")
    if not os.path.exists(so_path) or (
        os.path.exists(src)
        and os.path.getmtime(src) > os.path.getmtime(so_path)
    ):
        cc = os.environ.get("CC", "cc")
        include = sysconfig.get_paths()["include"]
        fd, tmp_path = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", *extra_flags,
                 f"-I{include}", src, "-o", tmp_path],
                capture_output=True, text=True, timeout=120,
            )
            if res.returncode != 0:
                raise RuntimeError(
                    f"{cc} failed ({res.returncode}): {res.stderr[-2000:]}")
            os.replace(tmp_path, so_path)
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
    spec = importlib.util.spec_from_file_location(f"_{name}", so_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: extra compiler flags of each C source
_FLAGS = {"hist_tree": ("-pthread",), "densify": ("-pthread",)}


def _hist_tree():
    return _load_ext("hist_tree", _FLAGS["hist_tree"])


def hist_tree_available():
    """Whether the C tree kernels built and loaded (building them at the
    first call)."""
    return _hist_tree() is not None


def build_error(name="hist_tree"):
    """Why the C kernels of ``name.c`` (``"hist_tree"``, ``"fasthash"``,
    ``"murmurhash"`` or ``"densify"``) are unavailable, or None."""
    _load_ext(name, _FLAGS.get(name, ()))
    return _ERRORS.get(name)


def default_threads(n_jobs=None):
    """The C kernels' thread count for a forest's ``n_jobs``, as the JAX
    package's forests read it: a positive ``n_jobs`` is that many
    threads; None, 0 or a negative number (joblib's ``-1``, every core)
    is every core up to 16."""
    if n_jobs is None or n_jobs < 1:
        return min(16, os.cpu_count() or 1)
    return int(n_jobs)


def hist_level(hist, XbT, node_rel, W, cls=None, yv=None, act=None,
               n_threads=None, force_python=False):
    """Accumulate ``(Tb, d, nl, B, C)`` per-level histograms into ``hist``
    (zero-filled first; callers pass ``np.empty``).

    ``XbT (d, n)`` uint8 feature-major bins, ``node_rel (Tb, n)`` int32
    (-1: the sample is not at this level), ``W (Tb, n)`` float32 weights,
    and exactly one of ``cls (n,)`` int32 (classification: channels
    ``[w * onehot(y), w > 0]``) or ``yv (n,)`` float32 (regression:
    ``[w, w*y, w*y**2, w > 0]``). ``act (Tb, d)`` uint8 skips features
    no node of that tree drew this level (their slabs stay zero).
    ``force_python`` (or an unavailable build) takes the numpy form,
    which the tests hold the C kernel to."""
    Tb, d, nl, B, C = hist.shape
    n = XbT.shape[1]
    mod = None if force_python else _hist_tree()
    if mod is not None:
        mod.hist_level(
            hist, XbT, node_rel, W, cls, yv, act,
            n, d, Tb, nl, B, C,
            int(default_threads() if n_threads is None else n_threads),
        )
        return hist
    # ---- numpy form: one scatter per (tree, feature)
    hist[:] = 0.0
    flat = hist.reshape(Tb, d, nl * B, C)
    for t in range(Tb):
        w = W[t]
        live = (node_rel[t] >= 0) & (w != 0)
        if not live.any():
            continue
        nr = node_rel[t][live].astype(np.int64)
        wa = w[live]
        if cls is not None:
            ch = np.zeros((live.sum(), C), np.float32)
            ch[np.arange(len(wa)), cls[live]] = wa
            ch[:, C - 1] = (wa > 0)
        else:
            ya = yv[live]
            ch = np.stack([wa, wa * ya, wa * ya * ya,
                           (wa > 0).astype(np.float32)], axis=1)
        for f in range(d):
            if act is not None and not act[t, f]:
                continue
            seg = nr * B + XbT[f][live]
            np.add.at(flat[t, f], seg, ch)
    return hist


def forest_walk_native(Xb, trees, max_depth, mode="predict",
                       n_threads=None):
    """Walk a stack of trees through the C kernel, or None when it is
    unavailable or the arrays are smaller than ``max_depth`` implies
    (callers then walk with torch).

    ``Xb (n, d)`` bins (any integer type, values below 256), ``trees``
    the stacked ``{feat, thr, is_split, leaf}`` ``(T, N)`` arrays.
    ``mode='predict'`` returns the ``(n, K)`` mean leaf value, ``'apply'``
    the ``(n, T)`` final node ids: a node stays put once a leaf is
    reached, as in ``models/tree.py tree_predict_kernel``."""
    mod = _hist_tree()
    if mod is None:
        return None
    feat = np.ascontiguousarray(trees["feat"], np.int32)
    thr = np.ascontiguousarray(trees["thr"], np.int32)
    sp = np.ascontiguousarray(trees["is_split"], np.uint8)
    T, N = feat.shape
    if 2 ** (int(max_depth) + 1) - 1 > N:
        return None
    n, d = Xb.shape
    Xb = np.ascontiguousarray(Xb, np.uint8)
    n_threads = int(default_threads() if n_threads is None else n_threads)
    if mode == "predict":
        leaf = np.ascontiguousarray(trees["leaf"], np.float32)
        K = leaf.shape[2]
        out = np.empty((n, K), np.float32)
        mod.forest_walk(Xb, feat, thr, sp, leaf, out, None,
                        n, d, T, N, K, int(max_depth), n_threads)
        return out
    out = np.empty((n, T), np.int32)
    mod.forest_walk(Xb, feat, thr, sp, None, None, out,
                    n, d, T, N, 1, int(max_depth), n_threads)
    return out


def best_splits_native(hist, fmask, urand, K, classification,
                       min_samples_leaf, n_threads=None):
    """The best split of every (tree, node) of a level histogram through
    the C kernel, or None when it is unavailable or the channels exceed
    its accumulator cap (callers then score with numpy). Returns
    ``(gain, f, t, cnt_l, cnt_r)``, each ``(Tb, nl)``."""
    mod = _hist_tree()
    Tb, d, nl, B, C = hist.shape
    if mod is None or C > 256 or K > 256:
        return None
    gain = np.empty((Tb, nl), np.float32)
    bf = np.empty((Tb, nl), np.int32)
    bt = np.empty((Tb, nl), np.int32)
    cl = np.empty((Tb, nl), np.float32)
    cr = np.empty((Tb, nl), np.float32)
    mod.best_splits(
        hist, fmask, urand, gain, bf, bt, cl, cr,
        Tb, d, nl, B, C, K, int(classification),
        float(min_samples_leaf),
        int(default_threads() if n_threads is None else n_threads),
    )
    return gain, bf, bt, cl, cr


# ---------------------------------------------------------------------------
# text hashing (fasthash.c): FastHashingVectorizer's kernel
# ---------------------------------------------------------------------------

def _fnv1a(data: bytes) -> int:
    h = 2166136261
    for b in data:
        h ^= b
        h = (h * 16777619) & 0xFFFFFFFF
    return h


def _is_token_char(b):
    return (
        (0x61 <= b <= 0x7A) or (0x41 <= b <= 0x5A) or (0x30 <= b <= 0x39)
        or b == 0x5F or b >= 0x80
    )


def _token_spans(text: bytes, min_len):
    toks, i, n = [], 0, len(text)
    while i < n:
        while i < n and not _is_token_char(text[i]):
            i += 1
        s = i
        while i < n and _is_token_char(text[i]):
            i += 1
        if i - s >= min_len:
            toks.append(text[s:i])
    return toks


def _py_hash_doc(text, n_features, nlo, nhi, analyzer, lowercase):
    if lowercase:
        # ASCII-only lowering, as the C kernel does
        text = bytes(
            b + 32 if 0x41 <= b <= 0x5A else b for b in text.encode("utf-8")
        )
    else:
        text = text.encode("utf-8")
    hashes = []
    if analyzer == 0:  # word: tokens of two bytes or more
        toks = _token_spans(text, 2)
        for n in range(nlo, nhi + 1):
            if n > len(toks):
                break
            for t in range(len(toks) - n + 1):
                gram = b" ".join(toks[t:t + n])
                hashes.append(_fnv1a(gram) % n_features)
    else:  # char_wb: every word, padded with a space each side
        for w in _token_spans(text, 1):
            padded = b" " + w + b" "
            for n in range(nlo, nhi + 1):
                if n > len(padded):
                    break
                for p in range(len(padded) - n + 1):
                    hashes.append(_fnv1a(padded[p:p + n]) % n_features)
    return hashes


def _py_hash_docs(docs, n_features, nlo, nhi, analyzer, lowercase, binary):
    indptr = [0]
    indices, data = [], []
    for doc in docs:
        hashes = sorted(
            _py_hash_doc(doc, n_features, nlo, nhi, analyzer, lowercase)
        )
        i = 0
        while i < len(hashes):
            j = i
            while j < len(hashes) and hashes[j] == hashes[i]:
                j += 1
            indices.append(hashes[i])
            data.append(1.0 if binary else float(j - i))
            i = j
        indptr.append(len(indices))
    return (
        np.asarray(indptr, dtype=np.int64),
        np.asarray(indices, dtype=np.uint32),
        np.asarray(data, dtype=np.float32),
    )


def hash_documents(docs, n_features=2**12, ngram_range=(1, 1),
                   analyzer="word", lowercase=True, binary=False,
                   force_python=False):
    """Hash text documents into a scipy CSR ``(n_docs, n_features)``
    float32 matrix of n-gram counts: word n-grams (tokens of two or more
    ``[A-Za-z0-9_]`` or non-ASCII bytes, joined by one space) or
    ``char_wb`` n-grams (each word padded with a space), FNV-1a hashed
    modulo ``n_features``. The C kernel when it builds, else (or with
    ``force_python``) the Python form, which gives the same matrix."""
    from scipy import sparse

    docs = [d if isinstance(d, str) else str(d) for d in docs]
    nlo, nhi = ngram_range
    a = {"word": 0, "char_wb": 1}[analyzer]
    native = None if force_python else _load_ext("fasthash")
    if native is not None:
        bi, bidx, bdat = native.hash_docs(
            docs, n_features, nlo, nhi, a, int(lowercase), int(binary)
        )
        indptr = np.frombuffer(bi, dtype=np.int64)
        indices = np.frombuffer(bidx, dtype=np.uint32)
        data = np.frombuffer(bdat, dtype=np.float32)
    else:
        indptr, indices, data = _py_hash_docs(
            docs, n_features, nlo, nhi, a, lowercase, binary
        )
    return sparse.csr_matrix(
        (data, indices.astype(np.int32), indptr),
        shape=(len(docs), n_features),
    )


def native_available():
    """Whether the text-hashing C kernel (``fasthash.c``) built."""
    return _load_ext("fasthash") is not None


# ---------------------------------------------------------------------------
# signed MurmurHash3 (murmurhash.c): HashingVectorizer's hash
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rotl32(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def murmurhash3_32_py(data, seed=0):
    """Signed 32-bit MurmurHash3 (x86) of ``data`` (bytes, or a str as
    its UTF-8 bytes): scikit-learn's ``murmurhash3_32(data, seed,
    positive=False)``, in Python. The form the C kernel is held to."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h1 = seed & _M32
    n = len(data)
    nblocks = n // 4
    for i in range(nblocks):
        k1 = int.from_bytes(data[4 * i:4 * i + 4], "little")
        k1 = _rotl32((k1 * c1) & _M32, 15) * c2 & _M32
        h1 = _rotl32(h1 ^ k1, 13)
        h1 = (h1 * 5 + 0xE6546B64) & _M32
    tail = data[4 * nblocks:]
    if tail:
        k1 = int.from_bytes(tail, "little")
        k1 = _rotl32((k1 * c1) & _M32, 15) * c2 & _M32
        h1 ^= k1
    h1 ^= n
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _M32
    h1 ^= h1 >> 16
    return h1 - (1 << 32) if h1 >= 1 << 31 else h1


def murmurhash3_32_spans(buf, starts, lengths, seed=0):
    """Signed MurmurHash3 of every span ``buf[starts[i]:starts[i] +
    lengths[i]]`` of the bytes ``buf``, as an int32 array, through the C
    kernel. Raises when the kernel did not build: the vectorizers do not
    fall back to a Python loop over millions of n-grams quietly."""
    mod = _load_ext("murmurhash")
    if mod is None:
        raise RuntimeError(
            "the MurmurHash3 C kernel (skdist_tpu_torch/native/"
            f"murmurhash.c) did not build: {_ERRORS.get('murmurhash')}")
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    out = np.empty(len(starts), dtype=np.int32)
    mod.hash_spans(buf, starts, lengths, out, len(starts), int(seed))
    return out


# ---------------------------------------------------------------------------
# multithreaded CSR -> dense float32 (densify.c)
# ---------------------------------------------------------------------------

def csr_to_dense_f32(X, force_python=False, n_threads=None):
    """Densify a scipy sparse matrix to a C-contiguous float32 array.

    The host's boundary before a dense product on the card. The C kernel
    partitions rows across threads (zero fill and scatter a block, GIL
    released); the fallback (or ``force_python``) is scipy's
    single-threaded ``toarray``. Duplicate entries accumulate in both,
    as scipy's CSR does."""
    csr = X.tocsr()
    n_rows, n_cols = csr.shape
    mod = None if force_python else _load_ext("densify", _FLAGS["densify"])
    if mod is None or n_rows == 0 or n_cols == 0:
        return np.ascontiguousarray(csr.toarray(), dtype=np.float32)
    data = np.ascontiguousarray(csr.data, dtype=np.float32)
    indices = np.ascontiguousarray(csr.indices)
    if indices.dtype not in (np.int32, np.int64):
        indices = indices.astype(np.int64)
    indptr = np.ascontiguousarray(csr.indptr, dtype=np.int64)
    out = np.empty((n_rows, n_cols), dtype=np.float32)
    mod.csr_to_dense(
        out, data, indices, indptr, n_rows, n_cols,
        indices.dtype.itemsize,
        int(default_threads() if n_threads is None else n_threads),
    )
    return out
