"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each source in ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). Libraries land in ``build/keyhunt_tpu_torch/<hash>/`` at the
repository root, keyed by a hash of every source and the flags, so an edit
rebuilds and an unchanged tree reuses the last build. All sources compile
in parallel, one ``nvcc`` each.

Nothing here runs at import time: the CPU tests import every module of the
package on machines with no compiler.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)),
                          "build", "keyhunt_tpu_torch")
SOURCES = ("field_kernels.cu", "jacwalk.cu", "hash160.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
#: C signatures of the entry points (all return cudaGetLastError()).
_SIGNATURES = {
    "kh_field_mul": [_VP, _VP, _VP, _I64, _VP],
    "kh_field_sqr": [_VP, _VP, _I64, _VP],
    "kh_batch_inv": [_VP, _VP, _I64, _INT, _VP],
    "kh_giant_scan": [_VP] * 9 + [_I64, _INT, _VP, _VP],
    "kh_hash160_both": [_VP, _VP, _VP, _I64, _VP],
    "kh_hash160_uncompressed": [_VP, _VP, _VP, _I64, _VP],
}

#: kernel launches by kernel name; each wrapper adds one where it launches
LAUNCHES: collections.Counter = collections.Counter()

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: what the last build did: seconds, directory, ptxas report per source
BUILD_INFO: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build() -> dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; returns them by
    source stem. Raises with the compiler's output if a build fails."""
    with _lock:
        if _libs:
            return _libs
        t0 = time.time()
        outdir = os.path.join(BUILD_ROOT, _source_hash())
        os.makedirs(outdir, exist_ok=True)
        procs = {}
        for src in SOURCES:
            stem = src.rsplit(".", 1)[0]
            so = os.path.join(outdir, f"lib{stem}.so")
            if os.path.exists(so):
                continue
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
                   os.path.join(CSRC, src)]
            procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, so)
        report = {}
        for stem, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {stem}.cu:\n{out}")
            with open(os.path.join(outdir, f"{stem}.ptxas.txt"), "w") as fh:
                fh.write(out)
            os.replace(tmp, so)
        for src in SOURCES:
            stem = src.rsplit(".", 1)[0]
            log = os.path.join(outdir, f"{stem}.ptxas.txt")
            if os.path.exists(log):
                with open(log) as fh:
                    report[stem] = fh.read()
            lib = ctypes.CDLL(os.path.join(outdir, f"lib{stem}.so"))
            for fn, argtypes in _SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _libs[stem] = lib
        BUILD_INFO.update(seconds=time.time() - t0, dir=outdir,
                          compiled=sorted(procs), ptxas=report)
        return _libs


def entry(stem: str, fn: str):
    """The ctypes function `fn` of library `stem`, building on first use."""
    return getattr(build()[stem], fn)


def check(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")
