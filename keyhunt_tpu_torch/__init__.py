"""keyhunt_tpu_torch — the PyTorch/CUDA port of keyhunt_tpu.

The JAX package `keyhunt_tpu` is the reference; this package does the same
work on an NVIDIA H100 with kernels written by hand in CUDA C++ (``csrc/``),
and on the CPU through plain PyTorch versions of the same functions.

Conventions:

- 256-bit field elements keep the JAX layout at every public function:
  limb-major ``(8, B)`` little-endian 32-bit limbs; the giant walk emits
  step-major ``(8, S*L)`` arrays and an ``(S, L)`` degeneracy mask.
- Limb tensors are stored as ``torch.int32`` holding the uint32 bit
  patterns (``u256.to_torch`` / ``u256.to_numpy`` convert). PyTorch on the
  CPU has no uint32 add, subtract or shift, so the plain versions widen to
  int64 for arithmetic; the kernels read the same bits as ``uint32_t*``.
- Routing is by device, never by fallback: a tensor on a CUDA device goes
  through its kernel, a tensor on the CPU through the plain version. The
  CLI's ``--device {cuda,cpu}`` picks the device.

The port imports `torch` and never `jax`, and nothing of the JAX package,
not even its jax-free host modules: it keeps its own copies of them under
the same names (`ref.ecc`, `ref.hashes`, `io.base58`, `io.results`,
`io.targets`, `stats`, `util`) and its own binding of the native host
library (`native`, built from native/keyhunt_native.cpp at first use).
Only the tests import both packages.
"""

__version__ = "0.1.0"
