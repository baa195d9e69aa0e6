// 32-bit adds placed on the FMA-heavy pipe of the SM.
//
// An H100 SM sub-partition issues one warp instruction per clock to two
// integer pipes, each 16 lanes wide, so each takes a warp instruction only
// every other clock: the ALU pipe (IADD3, VIADD, LOP3, SHF, PRMT, LEA,
// ISETP, MOV) and the FMA-heavy pipe (IMAD and its .IADD, .SHL, .HI, .MOV
// and .WIDE forms). A body of rotations, 3-input logic and adds, as SHA-256
// and RIPEMD-160 are, issues only ALU instructions and so runs at half the
// issue rate at best.
//
// ptxas picks the pipe, and it sends most adds to IADD3 or VIADD. An add
// of two registers is the one such operation that the FMA-heavy pipe does
// in one instruction at its full rate: a * 1 + b. `add` multiplies by a 1
// read from __constant__ memory, which ptxas cannot see through and keeps
// in a uniform register, so each such add stays one IMAD reading two
// registers. What the timings in PERF.md showed not to pay: an add
// of a constant as k * 1 + a (an IMAD with a 32-bit immediate), and
// rotations or shifts as IMAD.HI or IMAD.WIDE; each ran slower than the
// ALU form it replaced. The SASS listing (`_build.pipe_counts`)
// says where the instructions went.
//
// Built with KH_HOST_EMULATION (and no CUDA), the CUDA intrinsics used by
// the hash core and T1's bodies are C++ and the constant a host variable,
// so the bodies can be checked on a CPU (tests/test_torch_hash_host.py).
#pragma once

#include <stdint.h>

#ifndef KH_INLINE
#define KH_INLINE __device__ __forceinline__
#endif

#if defined(KH_HOST_EMULATION) && !defined(__CUDA_ARCH__)
#define __host__
#define __device__
#define __forceinline__ inline
#define __constant__
inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, uint32_t s) {
    s &= 31;
    return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
    s &= 31;
    return s ? (lo >> s) | (hi << (32 - s)) : lo;
}
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
    const uint64_t v = ((uint64_t)y << 32) | x;
    uint32_t r = 0;
    for (int i = 0; i < 4; ++i)
        r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
    return r;
}
#endif

namespace kh_pipe {

static __constant__ uint32_t kOne = 1;

// a + b: one IMAD (a * 1 + b)
KH_INLINE uint32_t add(uint32_t a, uint32_t b) { return a * kOne + b; }

}  // namespace kh_pipe
