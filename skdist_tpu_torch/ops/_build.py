"""Build and load the port's CUDA kernels at first use.

Every kernel source lives under ``skdist_tpu_torch/csrc/``. A library is
compiled by ``nvcc`` straight into a shared object with a plain C
interface (no PyTorch headers, so a build takes seconds) and loaded with
``ctypes``. The build directory is ``skdist_tpu_torch/_build/``, and each
library file is keyed by a hash of its sources and flags, so an edited
source rebuilds and an unchanged one is reused. Nothing is built when a
module is imported: the first call that launches a kernel builds it, and
:func:`build` builds every library at once (one ``nvcc`` per library,
all started together).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: every kernel library of the port: name -> its sources under csrc/
LIBRARIES = {
    "packed_sparse": ("packed_sparse.cu",),
    "level_histogram": ("level_histogram.cu",),
    "packed_gram": ("packed_gram.cu",),
}

_LOCK = threading.Lock()
_LOADED = {}
_LAUNCH_LOCK = threading.Lock()


def count_launch(wrapper):
    """Add one to ``wrapper.launches``, the count of its kernel's launches,
    under a lock, so the count is exact when threads launch at once (the
    searches' host fan-out). Readers read the attribute; resetting it to 0
    is for a caller with no launch in flight."""
    with _LAUNCH_LOCK:
        wrapper.launches += 1


def find_nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit PyTorch itself located. Raises when there is none."""
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    try:
        from torch.utils.cpp_extension import CUDA_HOME

        homes.append(CUDA_HOME)
    except ImportError:
        pass
    for home in homes:
        if home:
            cand = os.path.join(home, "bin", "nvcc")
            if os.path.isfile(cand):
                return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc was not found (set CUDA_HOME or put nvcc on PATH); the "
        "port's CUDA kernels are built from skdist_tpu_torch/csrc at first "
        "use and need the CUDA toolkit"
    )


def _lib_path(name):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in LIBRARIES[name]:
        h.update(src.encode())
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=None):
    """Build the named libraries (default: all) that are not built yet,
    one ``nvcc`` process per library, all started together. Returns
    ``{name: (path, seconds, compiler_log)}``; ``seconds`` is 0.0 and the
    log empty for a library that was already built. Raises with the
    compiler's output when a build fails."""
    names = list(LIBRARIES) if names is None else list(names)
    with _LOCK:
        return _build_locked(names)


def _build_locked(names):
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = {}
    procs = {}
    nvcc = None
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path):
            out[name] = (path, 0.0, "")
            continue
        nvcc = nvcc or find_nvcc()
        tmp = f"{path}.{os.getpid()}.tmp"
        srcs = [os.path.join(CSRC_DIR, s) for s in LIBRARIES[name]]
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *srcs]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ), path, tmp, time.perf_counter())
    failures = []
    for name, (proc, path, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, path)
        out[name] = (path, seconds, log)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return out


def load(name):
    """The loaded ``ctypes.CDLL`` of library ``name``, built first when
    needed. The caller declares ``argtypes``/``restype``."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            path, _, _ = _build_locked([name])[name]
            lib = _LOADED[name] = ctypes.CDLL(path)
        return lib
