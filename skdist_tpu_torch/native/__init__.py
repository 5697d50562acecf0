"""
The host C tree kernels of the port (``hist_tree.c``), built on demand.

Counterpart of the hist-tree part of ``skdist_tpu/native/__init__.py``:
the loader (:func:`_load_ext`) and the entry points of the host forest
engine (``models/native_forest.py``, ``hist_mode="native"``). The C
source is a copy of the JAX package's and ships as package data; it is
compiled with the system C compiler (``$CC``, else ``cc``) against
CPython's headers at first use, into ``skdist_tpu_torch/_build/``, and
imported as an extension module. Nothing is built when this module is
imported.

A build that fails (no compiler, a read-only tree) leaves the engine
unavailable: :func:`hist_tree_available` is False and
:func:`build_error` says why. ``hist_mode="auto"`` then grows trees with
the torch engine; an explicit ``"native"`` raises
(``models/native_forest.py native_supported_or_raise``).
:func:`hist_level` keeps the JAX package's numpy form (``force_python``)
for the tests that hold the C kernel to it.
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
    "default_threads",
    "forest_walk_native",
    "hist_level",
    "hist_tree_available",
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


def _hist_tree():
    return _load_ext("hist_tree", ("-pthread",))


def hist_tree_available():
    """Whether the C tree kernels built and loaded (building them at the
    first call)."""
    return _hist_tree() is not None


def build_error():
    """Why the C tree kernels are unavailable, or None."""
    _hist_tree()
    return _ERRORS.get("hist_tree")


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
