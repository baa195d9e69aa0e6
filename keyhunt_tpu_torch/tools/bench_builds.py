"""Time the port's kernels of other source trees beside this package's, on the card.

Builds the sources of the chosen kernels (``field_kernels.cu``,
``jacwalk.cu``, ``hash160.cu``, ``bench_vpu.cu``) from this package's
``csrc/`` (labelled "this") and from each ``--other NAME=DIR`` -- another
directory with the same C entry points, such as an earlier commit's
``keyhunt_tpu_torch/csrc`` unpacked with ``git archive`` into the
git-ignored ``build/`` -- all builds of a source in parallel. Per build it
prints each kernel's registers and spills (``-Xptxas -v``), K4's static
SASS instructions (``cuobjdump -sass``): the whole kernel, and its step
loop with the loop's commonest opcodes; and for K5, K6 and T1's three
bodies the SASS instructions per element split by pipe (ALU, FMA-heavy,
other: `_build.pipe_counts`) with the pipe ceiling (`_build.pipe_ceiling`
of `FEWEST`). Then, for ``--turns`` turns, each case runs every build, in
an order that reverses from case to case: K1 field_mul, K2 field_sqr and
K3 batch_inv, K5 hash160_both and K6 hash160_uncompressed at their path
widths (or ``--widths``), T1's bodies (one pass each) at 2^22, K4
giant_scan at ``--lanes`` x ``--steps`` with lanes 0 and 1 planted at C
and -C (`planted_input`). Each build is held exactly against the plain
version (field elements after `norm`) and timed with the host's issue
hidden (`sweep_batch_inv.device_ms`), rotating through enough operand sets
that the timed calls move more than `L2_ROTATE_BYTES`, twice the H100's
50 MB L2, where one call moves less. One JSON line per build, then one
per turn, case and build.

    python -m keyhunt_tpu_torch.tools.bench_builds --other NAME=DIR ...
        [--kernels field_mul ... hash160_both ... vpu_rotate_mix]
        [--widths N ...] [--lanes 131072] [--steps 16] [--turns 3] [--calls 20]
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import sys

import numpy as np
import torch

from .. import _build
from ..ops import field, jacwalk, u256, vpu
from ..ops import hash160 as h160
from ..ref import ecc
from .sweep_batch_inv import device_ms

#: kernel -> the source that holds it
KERNELS = {"field_mul": "field_kernels.cu", "field_sqr": "field_kernels.cu",
           "batch_inv": "field_kernels.cu", "giant_scan": "jacwalk.cu",
           "hash160_both": "hash160.cu", "hash160_uncompressed": "hash160.cu",
           "vpu_independent": "bench_vpu.cu", "vpu_dependent": "bench_vpu.cu",
           "vpu_rotate_mix": "bench_vpu.cu"}
FIELD = ("field_mul", "field_sqr", "batch_inv")
#: the widths at which the BSGS, walker and minikeys paths launch K1-K3,
#: K5 and K6 (all but K4), and T1's one width
WIDTHS = (64, 512, 131072, 131136, 1 << 18, 1 << 21)
_VPU = {f"vpu_{b.replace('-', '_')}": plain for b, (_, plain, _) in vpu.BODIES.items()}
PATH_WIDTHS = {**dict.fromkeys(FIELD, WIDTHS), "hash160_both": (1 << 18,),
               "hash160_uncompressed": (512, 1 << 18), **dict.fromkeys(_VPU, (1 << 22,))}
L2_ROTATE_BYTES = 100 * 10**6
PLAIN = {"field_mul": field.mul_plain, "field_sqr": field.sqr_plain,
         "batch_inv": field.batch_inv_plain, "giant_scan": jacwalk.giant_scan_plain,
         "hash160_both": h160.hash160_both_plain,
         "hash160_uncompressed": h160.hash160_uncompressed_plain, **_VPU}
#: the fewest instructions per element of the kernels whose pipe split is
#: reported, the bound's count (chip_smoke.py `_bound`): a SHA-256
#: compression 48 schedule words of 10 and 64 rounds of 13, plus 8;
#: RIPEMD-160 of 32 bytes 160 line-rounds of 6 plus the byte swaps and the
#: final adds, 973; T1's bodies per pass, as their first CUDA build issued
#: them (the rotate mix's 102 rounds as LEA.HI + LOP3), so a body that
#: issues more does not raise its own bound
SHA256_OPS, RIPEMD160_OPS = 1320, 973
FEWEST = {"hash160_both": 2 * (SHA256_OPS + RIPEMD160_OPS),
          "hash160_uncompressed": 2 * SHA256_OPS + RIPEMD160_OPS,
          "vpu_independent": 473, "vpu_dependent": 534, "vpu_rotate_mix": 226}


def rotation(nbytes: int) -> int:
    """Operand sets to rotate through so that back-to-back calls that each
    move `nbytes` move more than `L2_ROTATE_BYTES` (at most 64)."""
    return min(-(-L2_ROTATE_BYTES // nbytes), 64)


def planted_input(L: int, S: int, device, m: int = 1 << 26):
    """K4's operands on BSGS's lanes for one target at block 1 + m (L
    lanes, stride 2m), with lanes 0 and 1 replaced by C and -C, where C is
    the walk's advance -(32768 * 2m) G: both are flagged at step 0.
    Returns (X, Y, Z, cx, cy, S), Z = 1."""
    from ..search import bsgs
    cx, cy = ecc.ec_neg(ecc.ec_mul(32768 * 2 * m))
    cfg = bsgs.BsgsConfig(m=m, lanes=L, steps=S)
    px, py = bsgs.seed_lanes(cfg, [ecc.pubkey(20261016)], 1 + m)
    px[:, :2] = u256.from_ints([cx, cx])
    py[:, :2] = u256.from_ints([cy, ecc.P - cy])
    X, Y = u256.to_torch(px, device), u256.to_torch(py, device)
    Z = torch.zeros_like(X)
    Z[0] = 1
    return X, Y, Z, cx, cy, S


def giant_scan_stats(ptxas: str, listing: str) -> dict:
    """K4's registers and spills, its static SASS instructions, and those
    of its step loop (`_build.count_loop_sass`) with the loop's commonest
    opcodes and its split by pipe (`_build.pipe_counts`), from nvcc's
    ptxas report and the library's SASS listing."""
    def pick(table):
        return next(v for fn, v in table.items() if "giant_scan_kernel" in fn)
    step = pick(_build.count_loop_sass(listing))
    if not step:
        raise RuntimeError("giant_scan_kernel: no step loop in its SASS")
    return {**pick(_build.ptxas_usage(ptxas)),
            "sass": sum(pick(_build.count_sass(listing)).values()),
            "sass_step": sum(step.values()),
            "sass_step_opcodes": dict(step.most_common(8)),
            "step_pipes": _build.pipe_counts(step)}


def pipe_stats(listing: str) -> dict[str, dict]:
    """Per kernel of `FEWEST` in a library's SASS listing: its instructions
    per element by pipe (`_build.pipe_counts`), its pipe ceiling and its
    commonest opcodes."""
    out = {}
    for fn, counts in _build.count_sass(listing).items():
        kern = next((k for k in FEWEST if f"{k}_kernel" in fn), None)
        if kern:
            pipes = _build.pipe_counts(counts)
            out[kern] = {**pipes, "pipe_ceiling": _build.pipe_ceiling(FEWEST[kern], pipes),
                         "opcodes": dict(counts.most_common(8))}
    return out


def launch(lib, kern: str, ops: tuple) -> tuple:
    """One call of kernel `kern` of the library `lib`; returns its outputs
    in the order of its plain version's."""
    stream = torch.cuda.current_stream().cuda_stream
    if kern == "giant_scan":
        X, Y, Z, cx, cy, S = ops
        L = X.shape[1]
        outs = [torch.empty_like(X) for _ in range(3)]
        outs += [torch.empty((8, S * L), dtype=torch.int32, device=X.device)
                 for _ in range(2)]
        outs.append(torch.empty((S, L), dtype=torch.int32, device=X.device))
        consts = np.ascontiguousarray(jacwalk._consts(cx, cy).T)
        rc = lib.kh_giant_scan(X.data_ptr(), Y.data_ptr(), Z.data_ptr(),
                               *(o.data_ptr() for o in outs), L, S,
                               consts.ctypes.data, stream)
    elif kern.startswith("vpu_"):
        outs = [torch.empty_like(ops[0])]
        rc = getattr(lib, f"kh_{kern}")(ops[0].data_ptr(), outs[0].data_ptr(),
                                        ops[0].numel(), stream)
    elif kern.startswith("hash160_"):
        n = ops[0].shape[1]
        outs = [torch.empty((5, n), dtype=torch.int32, device=ops[0].device)
                for _ in range(2 if kern == "hash160_both" else 1)]
        rc = getattr(lib, f"kh_{kern}")(*(t.data_ptr() for t in (*ops, *outs)), n, stream)
    else:
        n = ops[0].shape[1]
        outs = [torch.empty_like(ops[0])]
        if kern == "batch_inv":
            scratch = torch.empty(max(field.batch_inv_plan(n).scratch_words, 1),
                                  dtype=torch.int32, device=ops[0].device)
            rc = lib.kh_batch_inv(ops[0].data_ptr(), outs[0].data_ptr(),
                                  scratch.data_ptr(), n, stream)
        else:
            rc = getattr(lib, f"kh_{kern}")(*(t.data_ptr() for t in ops),
                                            outs[0].data_ptr(), n, stream)
    _build.check(rc, kern)
    return tuple(outs)


def exact(kern: str, got: tuple, want: tuple) -> bool:
    """Every output equal to the plain version's, on the host: field
    elements after `norm`; K4's degeneracy flags (its last output), hash
    words and T1's words as they are."""
    for k, (g, w) in enumerate(zip(got, want, strict=True)):
        if kern in FIELD or (kern == "giant_scan" and k < len(got) - 1):
            g, w = field.norm(g), field.norm(w)
        if not torch.equal(g.cpu(), w.cpu()):
            return False
    return True


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", nargs="+", required=True,
                    help="NAME=DIR: build DIR's sources as NAME")
    ap.add_argument("--kernels", nargs="+", choices=list(KERNELS), default=list(KERNELS))
    ap.add_argument("--widths", nargs="+", type=int,
                    help="widths of every kernel but K4 (default: its PATH_WIDTHS)")
    ap.add_argument("--lanes", type=int, default=131072)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[E] the build comparison needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    dirs = {"this": _build.CSRC, **dict(o.split("=", 1) for o in args.other)}
    libs = {label: {} for label in dirs}
    info = {label: {"build": label, "dir": d, "registers": {}} for label, d in dirs.items()}
    for src in sorted({KERNELS[k] for k in args.kernels}):
        built = _build.build_variants(src, f"bench_builds/{src.split('.')[0]}",
                                      {label: ((), d) for label, d in dirs.items()})
        for label, (lib, so, out) in built.items():
            libs[label][src] = lib
            for fn, usage in _build.ptxas_usage(out).items():
                kn = re.search(r"(field_mul|field_sqr|binv_\w+?|giant_scan|hash160_\w+?|"
                               r"vpu_\w+?)_kernel", fn)
                if kn:
                    info[label]["registers"][kn.group(1)] = usage
            if src == "jacwalk.cu":
                info[label]["giant_scan"] = giant_scan_stats(out, _build.sass_listing(so))
            if src in ("hash160.cu", "bench_vpu.cu"):
                info[label].setdefault("pipes", {}).update(
                    pipe_stats(_build.sass_listing(so)))
    for line in info.values():
        print(json.dumps(line), flush=True)

    rng = np.random.default_rng(9)

    def operands(kern, n):
        if kern == "giant_scan":
            return planted_input(*n, dev)
        if kern.startswith("vpu_"):
            return (u256.to_torch(rng.integers(0, 1 << 32, size=n, dtype=np.uint32), dev),)
        limbs = [u256.to_torch(rng.integers(0, 1 << 32, size=(8, n), dtype=np.uint32), dev)
                 for _ in range(2 if kern in ("field_mul", "hash160_uncompressed") else 1)]
        return (field.norm(limbs[0]),) if kern == "batch_inv" else tuple(limbs)

    cases = [(k, (args.lanes, args.steps)) for k in args.kernels if k == "giant_scan"]
    cases += [(k, n) for k in args.kernels if k != "giant_scan"
              for n in args.widths or PATH_WIDTHS[k]]
    filler = torch.zeros(1 << 24, dtype=torch.int32, device=dev)
    labels = list(dirs)
    for turn in range(args.turns):
        for i, (kern, n) in enumerate(cases):
            ops = operands(kern, n)
            want = PLAIN[kern](*ops)
            want = want if isinstance(want, tuple) else (want,)
            nbytes = sum(t.numel() * 4 for t in (*ops, *want) if isinstance(t, torch.Tensor))
            sets = [ops] + [operands(kern, n) for _ in range(rotation(nbytes) - 1)]
            for label in labels if (turn * len(cases) + i) % 2 == 0 else labels[::-1]:
                lib = libs[label][KERNELS[kern]]
                ok = exact(kern, launch(lib, kern, ops), want)
                it = itertools.cycle(sets)
                ms = device_ms(lambda: launch(lib, kern, next(it)), args.calls, filler)
                print(json.dumps({"turn": turn, "kernel": kern, "width": n, "build": label,
                                  "exact": ok, "operand_sets": len(sets), "device_ms": ms}),
                      flush=True)
                if not ok:
                    return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
