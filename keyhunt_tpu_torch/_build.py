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
import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC)),
                          "build", "keyhunt_tpu_torch")
SOURCES = ("field_kernels.cu", "jacwalk.cu", "hash160.cu", "bench_vpu.cu",
           "field_latency.cu", "probe.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
#: C signatures of the entry points (all return cudaGetLastError()).
_SIGNATURES = {
    "kh_field_mul": [_VP, _VP, _VP, _I64, _VP],
    "kh_field_sqr": [_VP, _VP, _I64, _VP],
    "kh_batch_inv": [_VP, _VP, _VP, _I64, _VP],
    "kh_giant_scan": [_VP] * 9 + [_I64, _INT, _VP, _VP],
    "kh_hash160_both": [_VP, _VP, _VP, _I64, _VP],
    "kh_hash160_uncompressed": [_VP, _VP, _VP, _I64, _VP],
    "kh_vpu_independent": [_VP, _VP, _I64, _VP],
    "kh_vpu_dependent": [_VP, _VP, _I64, _VP],
    "kh_vpu_rotate_mix": [_VP, _VP, _I64, _VP],
    "kh_field_latency": [_VP, _VP, _VP, _VP],
    "kh_probe_packed": [_VP] * 5 + [_I64, _I64, _INT, _INT, _I64, _VP],
}

#: kernel launches by kernel name, and by (kernel name, elements per
#: launch); each wrapper adds one to both where it launches (`count_launch`),
#: and each replay of a CUDA graph what its capture recorded (`graphs`)
LAUNCHES: collections.Counter = collections.Counter()
LAUNCH_WIDTHS: collections.Counter = collections.Counter()

_lock = threading.Lock()
_recording = threading.local()
_libs: dict[str, ctypes.CDLL] = {}
#: what the last build did: seconds, directory, ptxas report per source
BUILD_INFO: dict = {}


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCH_WIDTHS.clear()


def count_launch(name: str, n) -> None:
    """Count one launch of kernel `name` at width n: its element (lane)
    count, for K4 the pair (lanes, steps), for P1 the pair (queries,
    maxlen). Inside `recording_launches` it goes to the record instead."""
    record = getattr(_recording, "launches", None)
    if record is not None:
        record[name, n] += 1
        return
    LAUNCHES[name] += 1
    LAUNCH_WIDTHS[name, n] += 1


def add_launches(widths: collections.Counter) -> None:
    """Count launches by (kernel name, width), as a record of
    `recording_launches` holds them."""
    for (name, n), count in widths.items():
        LAUNCHES[name] += count
        LAUNCH_WIDTHS[name, n] += count


@contextlib.contextmanager
def recording_launches():
    """Within the block, this thread's `count_launch` calls add to the
    Counter it yields, by (kernel name, width), and not to `LAUNCHES`: a
    CUDA graph's capture launches nothing, and each of its replays adds
    the record (`add_launches`)."""
    outer = getattr(_recording, "launches", None)
    _recording.launches = record = collections.Counter()
    try:
        yield record
    finally:
        _recording.launches = outer


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def _cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (nvcc, cuobjdump)."""
    found = shutil.which(name)
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", name)):
        return os.path.join(CUDA_HOME, "bin", name)
    raise RuntimeError(f"{name} not found: the CUDA kernels need the CUDA toolkit")


def nvcc_command(src: str, out: str, *defines: str, csrc: str = CSRC) -> list[str]:
    """The nvcc command that builds `csrc`/`src` into the library `out`."""
    return [_cuda_tool("nvcc"), *NVCC_FLAGS, *defines, "-I", csrc, "-o", out,
            os.path.join(csrc, src)]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the C signature of every entry point `lib` has."""
    for fn, argtypes in _SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_variants(src: str, name: str,
                   variants: dict[str, tuple]) -> dict[str, tuple]:
    """Build `src` once per variant, all in parallel, under
    build/keyhunt_tpu_torch/`name`/: `variants` maps a label to (the -D
    flags, the source directory); returns label -> (the loaded library, its
    path, nvcc's output with the ptxas report). For the tools that time other
    geometries or other versions of a kernel."""
    outdir = os.path.join(BUILD_ROOT, name, _source_hash())
    os.makedirs(outdir, exist_ok=True)
    procs = {}
    for label, (defines, csrc) in variants.items():
        so = os.path.join(outdir, f"lib{label}.so")
        procs[label] = (subprocess.Popen(nvcc_command(src, so, *defines, csrc=csrc),
                                         stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), so)
    built = {}
    for label, (proc, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} ({label}):\n{out}")
        built[label] = (_bind(ctypes.CDLL(so)), so, out)
    return built


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
            procs[stem] = (subprocess.Popen(nvcc_command(src, tmp),
                                            stdout=subprocess.PIPE,
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
            _libs[stem] = _bind(ctypes.CDLL(os.path.join(outdir, f"lib{stem}.so")))
        BUILD_INFO.update(seconds=time.time() - t0, dir=outdir,
                          compiled=sorted(procs), ptxas=report)
        return _libs


def entry(stem: str, fn: str):
    """The ctypes function `fn` of library `stem`, building on first use."""
    return getattr(build()[stem], fn)


def check(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")


def launch(stem: str, fn: str, device, *args) -> None:
    """Call the kernel entry `fn` of library `stem` for operands on the
    CUDA device `device`, with that device's current stream as the last
    argument, and raise if the launch fails. A ctypes call launches on the
    CUDA runtime's current device, not on its operands', so when `device`
    is not the current one the call runs under `torch.cuda.device(device)`:
    a shard's kernel on cuda:i runs on cuda:i, in the order of cuda:i's
    stream."""
    f = entry(stem, fn)
    stream = torch.cuda.current_stream(device).cuda_stream
    if device.index == torch.cuda.current_device():
        rc = f(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = f(*args, stream)
    check(rc, fn)


_SASS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]+?)\s*;")
_BRANCH = re.compile(r"\bBRA(?:\.\S+)?\s.*?0x([0-9a-f]+)")


def _sass_functions(text: str):
    """(mangled name, [(address, instruction)], NOPs left out) of each
    kernel in a ``cuobjdump -sass`` listing."""
    for name, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)",
                                 text, re.S):
        yield name, [(int(at, 16), i) for at, i in _SASS.findall(body) if i != "NOP"]


def _opcode(words: list[str]) -> str:
    return words[1] if words[0].startswith("@") else words[0]


def count_sass(text: str) -> dict[str, collections.Counter]:
    """Opcode counts of the SASS instructions per thread of each kernel in a
    ``cuobjdump -sass`` listing, by (mangled) function name: the kernel's
    instructions up to and including its last unpredicated EXIT, NOPs left
    out (what follows that EXIT is the closing self-branch and padding).
    For straight-line code -- loops unrolled, no branch but a predicated
    exit -- each thread issues each of these once."""
    counts = {}
    for name, listing in _sass_functions(text):
        ins = [i.split() for _, i in listing]
        last_exit = max(n for n, i in enumerate(ins) if i == ["EXIT"])
        counts[name] = collections.Counter(_opcode(i) for i in ins[:last_exit + 1])
    return counts


#: opcodes (their first word) of the two integer pipes of an SM
#: sub-partition, each 16 lanes wide, so each takes a warp instruction every
#: other clock: the ALU pipe, and the FMA-heavy pipe, which takes IMAD in
#: all its forms (.IADD, .SHL, .HI, .MOV, .WIDE). VIADD, sm_90's add of an
#: immediate, is counted on the ALU pipe: the hash kernels' timings fit
#: that (PERF.md).
ALU_OPCODES = frozenset({"IADD3", "VIADD", "LOP3", "SHF", "PRMT", "LEA", "ISETP", "MOV",
                         "SEL", "IMNMX", "IABS", "BMSK", "SGXT", "PLOP3"})
FMA_OPCODES = frozenset({"IMAD"})


def pipe_counts(counts: collections.Counter) -> dict[str, int]:
    """`count_sass` opcode counts split by pipe: ALU, FMA-heavy, and other
    (memory, control, uniform datapath), with their sum."""
    out = {"alu": 0, "fma": 0, "other": 0}
    for op, n in counts.items():
        base = op.split(".")[0]
        out["alu" if base in ALU_OPCODES else "fma" if base in FMA_OPCODES
            else "other"] += n
    out["instructions"] = sum(counts.values())
    return out


def pipe_ceiling(fewest: float, pipes: dict) -> float:
    """The largest share of its bound a body can reach, given the
    instructions it issues (`pipe_counts`): the bound charges `fewest`
    instructions at one a clock, and the body needs at least one clock per
    instruction and two per instruction of either pipe."""
    return fewest / max(pipes["instructions"], 2 * pipes["alu"], 2 * pipes["fma"])


def count_loop_sass(text: str) -> dict[str, collections.Counter]:
    """Opcode counts, as `count_sass` gives them, of the outermost loop of
    each kernel in a ``cuobjdump -sass`` listing: the instructions from the
    target of the backward branch that spans the most code to that branch,
    both included (none for a kernel with no backward branch). Where one
    pass of a loop is one unit of a kernel's work (K4's step), this is
    what a thread issues per unit, less what forward branches inside the
    loop skip."""
    loops = {}
    for name, listing in _sass_functions(text):
        back = [(int(m.group(1), 16), at) for at, i in listing
                if (m := _BRANCH.search(i)) and int(m.group(1), 16) < at]
        lo, hi = max(back, key=lambda b: b[1] - b[0], default=(1, 0))
        loops[name] = collections.Counter(_opcode(i.split()) for at, i in listing
                                          if lo <= at <= hi)
    return loops


def sass_listing(so: str) -> str:
    """``cuobjdump -sass`` of the library `so`."""
    return subprocess.run([_cuda_tool("cuobjdump"), "-sass", so], capture_output=True,
                          text=True, check=True).stdout


def sass_instructions(stem: str) -> dict[str, collections.Counter]:
    """`count_sass` of the built library `stem`."""
    build()
    return count_sass(sass_listing(os.path.join(BUILD_INFO["dir"], f"lib{stem}.so")))


def ptxas_usage(text: str) -> dict[str, dict]:
    """Registers and spill bytes per kernel from nvcc's ``-Xptxas -v``
    output, by (mangled) entry function name."""
    usage = {}
    for fn, body in re.findall(r"Compiling entry function '([^']+)'(.*?)"
                               r"(?=Compiling entry function|\Z)", text, re.S):
        regs = re.search(r"Used (\d+) registers", body)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        usage[fn] = {"registers": int(regs.group(1)) if regs else None,
                     "spill_stores": int(spills.group(1)) if spills else None,
                     "spill_loads": int(spills.group(2)) if spills else None}
    return usage
