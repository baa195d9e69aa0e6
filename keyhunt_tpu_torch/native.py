"""ctypes bindings for the native host runtime (native/keyhunt_native.cpp).

The port's own binding of the library keyhunt_tpu/native.py binds. The
library accelerates the host side of the dispatch path — BSGS lane
seeding, batch pubkey derivation, candidate hashing, table argsort — the
roles `secp256k1/*.cpp` and `hash/*.cpp` play in the reference.

At first use the source is compiled with ``g++`` into
``build/keyhunt_tpu_torch/native/<hash>/`` at the repository root (keyed
by a hash of the source and the flags, like `_build` keys the CUDA
kernels); nothing that `make -C native` left in ``native/`` is read. On a
machine with no compiler `available()` is False and every caller takes
its pure-Python host path through `ref` (host code, not the device path).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "native", "keyhunt_native.cpp")
BUILD_ROOT = os.path.join(_ROOT, "build", "keyhunt_tpu_torch", "native")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-march=native")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)

_lock = threading.Lock()
_state: dict = {}          # "lib": the loaded CDLL or None once tried


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libkeyhunt_native.so")


def _compile(so: str) -> bool:
    cxx = shutil.which("g++")
    if cxx is None:
        return False
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        print(f"[W] native host library did not build; using the Python "
              f"host path:\n{proc.stderr[-2000:]}", flush=True)
        return False
    os.replace(tmp, so)
    return True


def _bind(path: str):
    lib = ctypes.CDLL(path)
    lib.kh_version.restype = ctypes.c_uint64
    if lib.kh_version() != 1:
        return None
    # the entry points the port calls (all return void)
    lib.kh_keccak256.argtypes = [_u8p, ctypes.c_uint64, _u8p]
    lib.kh_hash160_batch.argtypes = [_u8p, ctypes.c_uint64, ctypes.c_uint64, _u8p]
    lib.kh_ec_pubkey_batch.argtypes = [_u8p, ctypes.c_uint64, _u8p]
    lib.kh_ec_seed_lanes.argtypes = [_u8p, _u8p, _u8p, ctypes.c_uint64, _u8p, _u8p]
    lib.kh_radix_argsort_u64.argtypes = [_u64p, ctypes.c_uint64, _u32p]
    for fn in ("kh_keccak256", "kh_hash160_batch", "kh_ec_pubkey_batch",
               "kh_ec_seed_lanes", "kh_radix_argsort_u64"):
        getattr(lib, fn).restype = None
    return lib


def _load():
    """The bound library, building it on first use; None where it cannot
    be built (the callers then use their Python host path)."""
    if "lib" in _state:
        return _state["lib"]
    with _lock:
        if "lib" not in _state:
            so = _lib_path()
            ok = os.path.exists(so) or _compile(so)
            _state["lib"] = _bind(so) if ok else None
        return _state["lib"]


def available() -> bool:
    """Is the library built (building it now if needed) and loaded?"""
    return _load() is not None


def _buf(b: bytes):
    return ctypes.cast(ctypes.create_string_buffer(b, len(b)), _u8p)


def _np_u8p(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


# -- hashes -------------------------------------------------------------------

def keccak256(data: bytes) -> bytes:
    lib = _load()
    out = np.empty(32, np.uint8)
    lib.kh_keccak256(_buf(data), len(data), _np_u8p(out))
    return out.tobytes()


def hash160_batch(msgs: np.ndarray) -> np.ndarray:
    """(n, L) uint8 fixed-size messages -> (n, 20) uint8 hash160s."""
    lib = _load()
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    n, L = msgs.shape
    out = np.empty((n, 20), np.uint8)
    lib.kh_hash160_batch(_np_u8p(msgs), L, n, _np_u8p(out))
    return out


# -- EC -------------------------------------------------------------------

def _pt_to_be(pt) -> bytes:
    if pt is None:
        return b"\x00" * 64
    return pt[0].to_bytes(32, "big") + pt[1].to_bytes(32, "big")


def _pt_from_be(b: bytes):
    if not any(b):
        return None
    return (int.from_bytes(b[:32], "big"), int.from_bytes(b[32:64], "big"))


def pubkey_batch(keys: list[int]) -> list:
    """[k, ...] -> [(x, y) | None, ...] (None for k ≡ 0 mod n)."""
    lib = _load()
    n = len(keys)
    kin = np.frombuffer(b"".join((k % (1 << 256)).to_bytes(32, "big") for k in keys),
                        dtype=np.uint8).copy()
    out = np.empty(n * 64, np.uint8)
    lib.kh_ec_pubkey_batch(_np_u8p(kin), n, _np_u8p(out))
    raw = out.tobytes()
    return [_pt_from_be(raw[i * 64:(i + 1) * 64]) for i in range(n)]


def seed_lanes(q, c0: int, stride: int, lanes: int):
    """P[l] = Q - (c0 + l*stride)*G for l in range(lanes).

    Returns (xy, inf_mask): xy (lanes, 64) uint8 big-endian x||y rows and a
    (lanes,) uint8 mask marking lanes where Q == (c0 + l*stride)*G (the key
    is exactly c0 + l*stride).
    """
    lib = _load()
    out = np.empty((lanes, 64), np.uint8)
    mask = np.empty(lanes, np.uint8)
    lib.kh_ec_seed_lanes(_buf(_pt_to_be(q)),
                         _buf((c0 % (1 << 256)).to_bytes(32, "big")),
                         _buf((stride % (1 << 256)).to_bytes(32, "big")),
                         lanes, _np_u8p(out), _np_u8p(mask))
    return out, mask


# -- sort -----------------------------------------------------------------

def radix_argsort_u64(keys: np.ndarray) -> np.ndarray:
    """Stable ascending argsort of a uint64 array (LSB radix, native)."""
    lib = _load()
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    perm = np.empty(keys.shape[0], np.uint32)
    lib.kh_radix_argsort_u64(keys.ctypes.data_as(_u64p), keys.shape[0],
                             perm.ctypes.data_as(_u32p))
    return perm
