// T1's rotate-mix body for one element (bench_vpu.cu): 102 rounds of
// r = rotl(v, 7), v = (r + x) ^ x, from v = x.
//
// A round issues as LEA.HI (rotl(v, 7) + x in one) and LOP3, both on the
// ALU pipe, so the body runs at half the SM's issue rate at best
// (pipes.cuh). Neither has a cheaper form on the FMA-heavy pipe: a
// rotation there is a multiply-high (IMAD.HI, or IMAD.WIDE plus an add)
// and an xor has none. Every split of the rounds across the two pipes
// that was timed ran slower than this body (PERF.md).
#pragma once

#include "pipes.cuh"

namespace kh_vpu {

constexpr int kRotateRounds = 512 / 5;

KH_INLINE uint32_t rotate_mix(uint32_t x) {
    uint32_t v = x;
#pragma unroll
    for (int i = 0; i < kRotateRounds; ++i) v = (__funnelshift_l(v, v, 7) + x) ^ x;
    return v;
}

}  // namespace kh_vpu
