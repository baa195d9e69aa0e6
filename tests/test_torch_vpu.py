"""T1, the u32 micro-benchmark: the port's plain versions of the three
bodies (`keyhunt_tpu_torch.ops.vpu`) against the JAX tool's own Pallas
kernels, run in interpret mode on the CPU. tools/bench_vpu.py is run as it
is (through runpy), with `pallas_call` wrapped to pass interpret=True and
to record each call object it builds; the recorded calls then take a
seeded input, at one grid block (B = 8192) and at two (16384)."""

import contextlib
import io
import os
import re
import runpy
import sys

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keyhunt_tpu_torch import _build
from keyhunt_tpu_torch.ops import vpu
from keyhunt_tpu_torch.tools import bench_vpu

TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tools", "bench_vpu.py")
_CHECKSUM = re.compile(r"\[vpu\] (\S+)\s*:.*\(checksum (\d+)\)")


def _checksums(text: str) -> dict[str, int]:
    return {name: int(s) for name, s in _CHECKSUM.findall(text)}


@pytest.fixture(scope="module", params=[8192, 16384])
def jax_tool(request, tmp_path_factory):
    """(B, the three recorded pallas calls in the tool's order, the tool's
    checksums by body name)."""
    B = request.param
    real, calls = pl.pallas_call, []

    def interpreted(*args, **kwargs):
        call = real(*args, **{**kwargs, "interpret": True})
        calls.append(call)
        return call

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", interpreted)
        mp.setattr(sys, "argv", [TOOL, str(B)])
        mp.setenv("KEYHUNT_TPU_CACHE", str(tmp_path_factory.mktemp("xla")))
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exc:
            runpy.run_path(TOOL, run_name="__main__")
    assert exc.value.code == 0
    assert len(calls) == 3
    return B, calls, _checksums(out.getvalue())


def test_plain_bodies_equal_the_jax_kernels(jax_tool):
    B, calls, _ = jax_tool
    x = np.random.default_rng(11).integers(0, 2**32, (B // 128, 128),
                                           dtype=np.uint64).astype(np.uint32)
    xt = torch.from_numpy(x.view(np.int32))
    for call, (name, (_, plain, _)) in zip(calls, vpu.BODIES.items()):
        want = np.asarray(call(jnp.asarray(x)))
        got = plain(xt).numpy().view(np.uint32)
        assert np.array_equal(got, want), name


def test_port_tool_checksums_equal_the_jax_tool(jax_tool, capsys):
    B, _, jax_sums = jax_tool
    assert set(jax_sums) == {"independent", "dependent", "rotate-mix"}
    assert bench_vpu.main([str(B), "--device", "cpu"]) == 0
    assert _checksums(capsys.readouterr().out) == jax_sums


def test_tool_checksums_at_8192():
    """The checksums of the port's tool at B = 8192 on the CPU, as the JAX
    tool printed them in interpret mode."""
    got = {r["name"]: r["checksum"] for r in bench_vpu.run(8192, "cpu")}
    assert got == {"independent": 2616386937, "dependent": 3008266847,
                   "rotate-mix": 2184001127}


def test_routed_bodies_take_the_plain_path_on_the_cpu():
    x = torch.from_numpy(np.arange(-300, 300, dtype=np.int32))
    before = dict(_build.LAUNCHES)
    for fn, plain, _ in vpu.BODIES.values():
        assert torch.equal(fn(x), plain(x))
    assert dict(_build.LAUNCHES) == before


@pytest.mark.parametrize("v", [0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x9E3779B9])
def test_plain_bodies_match_python_ints(v):
    """Each body on single values against a transcription in Python ints."""
    M = 0xFFFFFFFF
    a, b, c, d = v, (v + 1) & M, v ^ 3, (v + 7) & M
    for _ in range(64):
        a = (a + v) & M
        b ^= v
        c = (c + b) & M
        d ^= a
        a ^= d
        b = (b + c) & M
        c ^= a
        d = (d + b) & M
    dep = v
    for _ in range(256):
        dep = ((dep + v) & M) ^ v
    rot = v
    for _ in range(102):
        rot = ((((rot << 7) | (rot >> 25)) & M) + v & M) ^ v
    x = torch.tensor([v], dtype=torch.int64).to(torch.int32)
    got = [int(p(x).numpy().view(np.uint32)[0]) for _, p, _ in vpu.BODIES.values()]
    assert got == [a ^ b ^ c ^ d, dep, rot]


def test_checksum_is_element_0_0():
    out = torch.arange(16384, dtype=torch.int32) * 7 - 5
    assert vpu.checksum(out) == (-5) & 0xFFFFFFFF


def test_tool_refuses_cuda_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_vpu.main(["8192", "--device", "cuda"])


_LISTING = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_122vpu_dependent_kernelEPKjPjl
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0000*/                   LDC R1, c[0x0][0x28] ;          /* 0x00000a00ff017b82 */
                                                                   /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_CTAID.X ;            /* 0x0000000000007919 */
        /*0020*/                   ISETP.GE.U32.AND P0, PT, R0, UR4, PT ;
        /*0030*/               @P0 EXIT ;                          /* 0x000000000000094d */
        /*0040*/                   NOP ;
        /*0050*/                   IADD3 R5, R2, R2, RZ ;
        /*0060*/                   LOP3.LUT R5, R5, R2, RZ, 0x3c, !PT ;
        /*0070*/                   STG.E desc[UR4][R2.64], R5 ;
        /*0080*/                   EXIT ;                          /* 0x000000000000794d */
        /*0090*/                   BRA 0x90;                       /* 0xfffffffc00fc7947 */
        /*00a0*/                   NOP;
		..........

		Function : _ZN12_GLOBAL__N_121vpu_rotate_mix_kernelEPKjPjl
        /*0000*/                   SHF.L.W.U32.HI R3, R2, 0x7, R2 ;
        /*0010*/                   EXIT ;
        /*0020*/                   BRA 0x20;
"""


def test_count_sass_counts_each_kernel_to_its_last_exit():
    counts = _build.count_sass(_LISTING)
    assert counts == {
        "_ZN12_GLOBAL__N_122vpu_dependent_kernelEPKjPjl": {
            "LDC": 1, "S2R": 1, "ISETP.GE.U32.AND": 1, "EXIT": 2, "IADD3": 1,
            "LOP3.LUT": 1, "STG.E": 1},
        "_ZN12_GLOBAL__N_121vpu_rotate_mix_kernelEPKjPjl": {
            "SHF.L.W.U32.HI": 1, "EXIT": 1}}


_LOOP_LISTING = """
		Function : _ZN12_GLOBAL__N_117giant_scan_kernelEv
        /*0000*/                   S2R R0, SR_TID.X ;
        /*0010*/               @P0 EXIT ;
        /*0020*/                   LDG.E R2, desc[UR4][R4.64] ;
        /*0030*/                   IMAD.WIDE.U32 R6, R2, R2, RZ ;
        /*0040*/                   NOP ;
        /*0050*/                   IADD3 R8, R6, 0x1, RZ ;
        /*0060*/               @P1 BRA 0x50 ;
        /*0070*/                   IMAD.WIDE.U32.X R6, R2, R8, R6, P0 ;
        /*0080*/              @!P2 BRA 0x30 ;
        /*0090*/                   STG.E desc[UR4][R4.64], R6 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0;
		Function : _ZN12_GLOBAL__N_110flat_kernelEv
        /*0000*/                   IADD3 R1, R1, R1, RZ ;
        /*0010*/                   EXIT ;
        /*0020*/                   BRA 0x20;
"""


def test_count_loop_sass_counts_the_outermost_loop_body():
    loops = _build.count_loop_sass(_LOOP_LISTING)
    assert loops == {
        "_ZN12_GLOBAL__N_117giant_scan_kernelEv": {
            "IMAD.WIDE.U32": 1, "IADD3": 1, "BRA": 2, "IMAD.WIDE.U32.X": 1},
        "_ZN12_GLOBAL__N_110flat_kernelEv": {}}


_PIPE_LISTING = """
		Function : _ZN12_GLOBAL__N_121hash160_both_kernelEv
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.CONSTANT R3, desc[UR4][R4.64] ;
        /*0020*/                   SHF.R.W.U32 R6, R3, 0x7, R3 ;
        /*0030*/                   LOP3.LUT R8, R6, R3, RZ, 0x3c, !PT ;
        /*0040*/                   IMAD R7, R8, UR6, R3 ;
        /*0050*/                   IMAD.HI.U32 R6, R8, UR6, R6 ;
        /*0060*/                   VIADD R9, R7, 0x428a2f98 ;
        /*0070*/               @P0 IADD3 R9, R9, R6, RZ ;
        /*0080*/                   IMAD.IADD R9, R9, 0x1, R8 ;
        /*0090*/                   STG.E desc[UR4][R4.64], R9 ;
        /*00a0*/                   EXIT ;
        /*00b0*/                   BRA 0xb0;
"""


def test_pipe_counts_split_a_listing_by_pipe():
    """The SASS of a kernel split by pipe: SHF, LOP3, VIADD and IADD3 on
    the ALU pipe (a predicate does not change the opcode), every IMAD form
    on the FMA-heavy pipe, loads, stores and control elsewhere; the pipe
    ceiling charges two clocks per instruction of the busier pipe."""
    (counts,) = _build.count_sass(_PIPE_LISTING).values()
    pipes = _build.pipe_counts(counts)
    assert pipes == {"alu": 4, "fma": 3, "other": 4, "instructions": 11}
    assert _build.pipe_ceiling(6, pipes) == 6 / 11
    assert _build.pipe_ceiling(6, {**pipes, "alu": 8}) == 6 / 16
