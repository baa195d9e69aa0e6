"""The u32 micro-benchmark's three bodies (T1), routed by device.

Counterpart of the kernel bodies of tools/bench_vpu.py (`indep_kernel`,
`dep_kernel`, `rot_kernel`, one `pl.pallas_call` each). Each maps uint32
elements, stored as int32 bit patterns of any shape, to the same shape
with NOPS = 512 source operations per element (510 for the rotate mix).

Routing is by device, as in `field.mul`: a CUDA tensor launches its
kernel in ``csrc/bench_vpu.cu`` and counts the launch as "vpu_<body>"
(`_build.count_launch`); a CPU tensor runs the plain version. The
plain versions compute on int64 holding [0, 2^32), masked after each `+`
and `<<` (as `ops.sha256` does), and are device-agnostic, which is how the
card checks each kernel against them.
"""

from __future__ import annotations

import torch

from .. import _build
from .field import _route
from .u256 import MASK32, narrow, widen

NOPS = 512
_LIB = "bench_vpu"


def independent_plain(x: torch.Tensor) -> torch.Tensor:
    """Four accumulator streams, NOPS/8 rounds of 8 add/xor ops."""
    v = widen(x)
    a, b, c, d = v, (v + 1) & MASK32, v ^ 3, (v + 7) & MASK32
    for _ in range(NOPS // 8):
        a = (a + v) & MASK32
        b = b ^ v
        c = (c + b) & MASK32
        d = d ^ a
        a = a ^ d
        b = (b + c) & MASK32
        c = c ^ a
        d = (d + b) & MASK32
    return narrow(a ^ b ^ c ^ d)


def dependent_plain(x: torch.Tensor) -> torch.Tensor:
    """One chain: v = (v + x) ^ x, NOPS/2 times."""
    xw = widen(x)
    v = xw
    for _ in range(NOPS // 2):
        v = ((v + xw) & MASK32) ^ xw
    return narrow(v)


def rotate_mix_plain(x: torch.Tensor) -> torch.Tensor:
    """NOPS/5 rounds of r = rotl(v, 7); v = (r + x) ^ x."""
    xw = widen(x)
    v = xw
    for _ in range(NOPS // 5):
        r = ((v << 7) & MASK32) | (v >> 25)
        v = ((r + xw) & MASK32) ^ xw
    return narrow(v)


def _launch(body: str, x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.int32:
        raise TypeError(f"vpu operand dtype {x.dtype}, expected int32")
    if not x.is_contiguous() or x.numel() == 0:
        raise ValueError("vpu operand must be contiguous and non-empty")
    out = torch.empty_like(x)
    fn = _build.entry(_LIB, f"kh_vpu_{body}")
    _build.check(fn(x.data_ptr(), out.data_ptr(), x.numel(),
                    torch.cuda.current_stream().cuda_stream), f"kh_vpu_{body}")
    _build.count_launch(f"vpu_{body}", x.numel())
    return out


def independent(x: torch.Tensor) -> torch.Tensor:
    return _launch("independent", x) if _route(x) else independent_plain(x)


def dependent(x: torch.Tensor) -> torch.Tensor:
    return _launch("dependent", x) if _route(x) else dependent_plain(x)


def rotate_mix(x: torch.Tensor) -> torch.Tensor:
    return _launch("rotate_mix", x) if _route(x) else rotate_mix_plain(x)


#: body name -> (routed function, plain version, source ops per element),
#: the JAX tool's names and operation counts (tools/bench_vpu.py:87-89)
BODIES = {
    "independent": (independent, independent_plain, NOPS),
    "dependent": (dependent, dependent_plain, NOPS),
    "rotate-mix": (rotate_mix, rotate_mix_plain, NOPS // 5 * 5),
}


def chained(fn, x: torch.Tensor, passes: int) -> torch.Tensor:
    """`passes` passes of a body, each on the last one's output."""
    for _ in range(passes):
        x = fn(x)
    return x


def checksum(out: torch.Tensor) -> int:
    """The JAX tool's checksum: the uint32 sum of ``out[0, ::1024]`` of the
    (B/128, 128) output, which is element [0, 0]."""
    return int(widen(out.reshape(-1, 128)[0, ::1024]).sum()) & MASK32


def sass_per_element() -> dict:
    """Opcode counts of the SASS instructions per element of each body's
    kernel, read from the built library (`_build.sass_instructions`; one
    thread per element); their sum is the instructions per element."""
    counts = _build.sass_instructions(_LIB)
    out = {}
    for body in BODIES:
        kernel = f"vpu_{body.replace('-', '_')}_kernel"
        (out[body],) = [c for name, c in counts.items() if kernel in name]
    return out
