// hash160 = RIPEMD-160(SHA-256(pubkey)) for one element per thread.
//
// Device functions behind kernels K5 and K6 (hash160.cu). Every round is
// unrolled at compile time: the rounds are template functions over their
// index, expanded by a fold over std::make_integer_sequence, so each
// message word, state slot, constant and rotation amount is a compile-time
// constant and the whole state stays in registers. The SHA-256 schedule is
// a 16-word rolling window (slot i & 15 holds w[i - 16] until round i
// overwrites it with w[i]); the eight working variables and the two
// RIPEMD-160 lines rotate through fixed slots instead of being moved.
// Message layout follows keyhunt_tpu/ops/sha256.py:83-117.
//
// The rounds are rotations, 3-input logic and adds. ptxas puts all of
// them on the ALU pipe (SHF, LOP3, IADD3, VIADD, LEA), so an all-ALU
// round issues at half the SM's rate at best (pipes.cuh). Here every add
// of two variables goes to the FMA-heavy pipe as one IMAD (kh_pipe::add):
// the schedule's three, h + K + w with Ch and Sigma1, Sigma0 + Maj, the
// new e and the new a; in RIPEMD-160, a + x and the add of f. Left on the
// ALU pipe: SHF for the rotations and shifts, LOP3 for Ch, Maj, the xor
// trees and the RIPEMD-160 functions, PRMT for the byte swap, LEA.HI for
// RIPEMD-160's rotl(t, s) + e, and VIADD for the adds of a constant (K, a
// padding word), whose IMAD forms timed slower (pipes.cuh). Operands that
// are compile-time constants (a block's padding words and the schedule
// words made only of them, the IV in the first rounds) keep the plain
// forms, so the compiler still folds them: an IMAD hides its operands'
// values from ptxas.
#pragma once

#include <stdint.h>

#include <utility>

#include "pipes.cuh"

namespace kh_hash {

KH_INLINE uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }
KH_INLINE uint32_t rotl(uint32_t x, int n) { return __funnelshift_l(x, x, n); }
KH_INLINE uint32_t bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }
// (hi << 24) | (lo >> 8): the byte-shifted word pairs of the message build
KH_INLINE uint32_t shr8(uint32_t hi, uint32_t lo) { return __funnelshift_r(lo, hi, 8); }

// ---------------------------------------------------------------------------
// SHA-256
// ---------------------------------------------------------------------------

__host__ __device__ constexpr uint32_t sha_k(int i) {
    constexpr uint32_t k[64] = {
        0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu, 0x59f111f1u,
        0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u, 0x243185beu, 0x550c7dc3u,
        0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u, 0xc19bf174u, 0xe49b69c1u, 0xefbe4786u,
        0x0fc19dc6u, 0x240ca1ccu, 0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau,
        0x983e5152u, 0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
        0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu, 0x53380d13u,
        0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u, 0xa2bfe8a1u, 0xa81a664bu,
        0xc24b8b70u, 0xc76c51a3u, 0xd192e819u, 0xd6990624u, 0xf40e3585u, 0x106aa070u,
        0x19a4c116u, 0x1e376c08u, 0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au,
        0x5b9cca4fu, 0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
        0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};
    return k[i];
}

// Bit j set: schedule word w[j] of a block is a compile-time constant,
// given the mask of the 16 message words that are.
__host__ __device__ constexpr uint64_t sha_const_words(uint32_t message) {
    uint64_t m = message & 0xffffu;
    for (int j = 16; j < 64; ++j) {
        const uint64_t need = (1ull << (j - 16)) | (1ull << (j - 15)) |
                              (1ull << (j - 7)) | (1ull << (j - 2));
        if ((m & need) == need) m |= 1ull << j;
    }
    return m;
}

__host__ __device__ constexpr bool is_var(uint64_t const_words, int j) {
    return !((const_words >> j) & 1);
}

// a + b: an IMAD if Fma (both vary), else a plain add, which the compiler
// folds or gives an immediate
template <bool Fma>
KH_INLINE uint32_t add(uint32_t a, uint32_t b) {
    if constexpr (Fma) return kh_pipe::add(a, b);
    else return a + b;
}

KH_INLINE uint32_t sigma0(uint32_t x) { return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3); }
KH_INLINE uint32_t sigma1(uint32_t x) { return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10); }

// Round I on working variables s (a..h at slots (k - I) & 7) and the
// rolling schedule window w. CW: the block's constant schedule words
// (`sha_const_words`); IV: s holds the initial hash value (first block),
// so in round 0 a..h are constants, and d and h stay the IV's to round 3.
template <int I, uint64_t CW, bool IV>
KH_INLINE void sha_round(uint32_t (&s)[8], uint32_t (&w)[16]) {
    if constexpr (I >= 16) {
        constexpr bool v16 = is_var(CW, I - 16), v15 = is_var(CW, I - 15);
        constexpr bool v7 = is_var(CW, I - 7), v2 = is_var(CW, I - 2);
        w[I & 15] = add<(v16 || v7) && (v15 || v2)>(
            add<v16 && v7>(w[I & 15], w[(I + 9) & 15]),
            add<v15 && v2>(sigma0(w[(I + 1) & 15]), sigma1(w[(I + 14) & 15])));
    }
    constexpr int A = (64 - I) & 7, B = (65 - I) & 7, C = (66 - I) & 7, D = (67 - I) & 7;
    constexpr int E = (68 - I) & 7, F = (69 - I) & 7, G = (70 - I) & 7, H = (71 - I) & 7;
    constexpr bool vs = !(IV && I == 0), vdh = !(IV && I < 4), vw = is_var(CW, I);
    const uint32_t e = s[E], a = s[A];
    const uint32_t hkw = add<vdh && vw>(s[H] + sha_k(I), w[I & 15]);
    const uint32_t t1 = add<vs>(add<vs>(hkw, (e & s[F]) ^ (~e & s[G])),
                                rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25));
    const uint32_t t2 = add<vs>(rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22),
                                (a & s[B]) ^ (a & s[C]) ^ (s[B] & s[C]));
    s[D] = add<vdh>(s[D], t1);         // the new e
    s[H] = add<vs>(t1, t2);            // the new a
}

template <uint64_t CW, bool IV, int... I>
KH_INLINE void sha_rounds(uint32_t (&s)[8], uint32_t (&w)[16],
                          std::integer_sequence<int, I...>) {
    (sha_round<I, CW, IV>(s, w), ...);
}

KH_INLINE void sha256_init(uint32_t (&st)[8]) {
    st[0] = 0x6a09e667u; st[1] = 0xbb67ae85u; st[2] = 0x3c6ef372u; st[3] = 0xa54ff53au;
    st[4] = 0x510e527fu; st[5] = 0x9b05688cu; st[6] = 0x1f83d9abu; st[7] = 0x5be0cd19u;
}

// One compression of block w (consumed: the window is overwritten).
// ConstWords: mask of the message words that are compile-time constants;
// IV: st is the initial hash value.
template <uint32_t ConstWords, bool IV>
KH_INLINE void sha256_compress(uint32_t (&st)[8], uint32_t (&w)[16]) {
    uint32_t s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = st[i];
    sha_rounds<sha_const_words(ConstWords), IV>(s, w,
                                                std::make_integer_sequence<int, 64>{});
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] += s[i];      // 64 rounds: slots are home
}

// ---------------------------------------------------------------------------
// RIPEMD-160 of a 32-byte message (a SHA-256 digest)
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int rmd_rl(int j) {
    constexpr int t[80] = {
        0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
        7, 4, 13, 1, 10, 6, 15, 3, 12, 0, 9, 5, 2, 14, 11, 8,
        3, 10, 14, 4, 9, 15, 8, 1, 2, 7, 0, 6, 13, 11, 5, 12,
        1, 9, 11, 10, 0, 8, 12, 4, 13, 3, 7, 15, 14, 5, 6, 2,
        4, 0, 5, 9, 7, 12, 2, 10, 14, 1, 3, 8, 11, 6, 15, 13};
    return t[j];
}

__host__ __device__ constexpr int rmd_rr(int j) {
    constexpr int t[80] = {
        5, 14, 7, 0, 9, 2, 11, 4, 13, 6, 15, 8, 1, 10, 3, 12,
        6, 11, 3, 7, 0, 13, 5, 10, 14, 15, 8, 12, 4, 9, 1, 2,
        15, 5, 1, 3, 7, 14, 6, 9, 11, 8, 12, 2, 10, 0, 4, 13,
        8, 6, 4, 1, 3, 11, 15, 0, 5, 12, 2, 13, 9, 7, 10, 14,
        12, 15, 10, 4, 1, 5, 8, 7, 6, 2, 13, 14, 0, 3, 9, 11};
    return t[j];
}

__host__ __device__ constexpr int rmd_sl(int j) {
    constexpr int t[80] = {
        11, 14, 15, 12, 5, 8, 7, 9, 11, 13, 14, 15, 6, 7, 9, 8,
        7, 6, 8, 13, 11, 9, 7, 15, 7, 12, 15, 9, 11, 7, 13, 12,
        11, 13, 6, 7, 14, 9, 13, 15, 14, 8, 13, 6, 5, 12, 7, 5,
        11, 12, 14, 15, 14, 15, 9, 8, 9, 14, 5, 6, 8, 6, 5, 12,
        9, 15, 5, 11, 6, 8, 13, 12, 5, 12, 13, 14, 11, 8, 5, 6};
    return t[j];
}

__host__ __device__ constexpr int rmd_sr(int j) {
    constexpr int t[80] = {
        8, 9, 9, 11, 13, 15, 15, 5, 7, 7, 8, 11, 14, 14, 12, 6,
        9, 13, 15, 7, 12, 8, 9, 11, 7, 7, 12, 7, 6, 15, 13, 11,
        9, 7, 15, 11, 8, 6, 6, 14, 12, 13, 5, 14, 13, 13, 7, 5,
        15, 5, 8, 11, 14, 14, 6, 14, 6, 9, 12, 9, 12, 5, 15, 8,
        8, 5, 12, 9, 12, 5, 14, 6, 8, 13, 6, 5, 15, 13, 11, 11};
    return t[j];
}

__host__ __device__ constexpr uint32_t rmd_kl(int j) {
    return j < 16 ? 0x00000000u : j < 32 ? 0x5A827999u : j < 48 ? 0x6ED9EBA1u
         : j < 64 ? 0x8F1BBCDCu : 0xA953FD4Eu;
}

__host__ __device__ constexpr uint32_t rmd_kr(int j) {
    return j < 16 ? 0x50A28BE6u : j < 32 ? 0x5C4DD124u : j < 48 ? 0x6D703EF3u
         : j < 64 ? 0x7A6D76E9u : 0x00000000u;
}

template <int J>
KH_INLINE uint32_t rmd_f(uint32_t x, uint32_t y, uint32_t z) {
    if constexpr (J < 16) return x ^ y ^ z;
    else if constexpr (J < 32) return (x & y) | (~x & z);
    else if constexpr (J < 48) return (x | ~y) ^ z;
    else if constexpr (J < 64) return (x & z) | (y & ~z);
    else return x ^ (y | ~z);
}

// Round J of one line. Line state a..e sits at slots (k - J) mod 5: the
// new b (t) overwrites the old a's slot, c is rotated in place. a holds
// the IV's word to round 4, f is a constant in round 0 and message words
// 8-15 are padding; rotl(t, s) + e stays one LEA.HI.
template <int J, int XI>
KH_INLINE void rmd_line(uint32_t (&l)[5], uint32_t f, const uint32_t (&x)[16],
                        uint32_t k, int s) {
    constexpr int A = (80 - J) % 5, C = (82 - J) % 5, E = (84 - J) % 5;
    constexpr bool va = J >= 5, vx = XI < 8;
    const uint32_t t = add<va && vx>(l[A], x[XI]) + k;
    l[A] = rotl(add<(J > 0 && (va || vx))>(f, t), s) + l[E];
    l[C] = rotl(l[C], 10);
}

template <int J>
KH_INLINE void rmd_round(uint32_t (&l)[5], uint32_t (&r)[5], const uint32_t (&x)[16]) {
    constexpr int B = (81 - J) % 5, C = (82 - J) % 5, D = (83 - J) % 5;
    rmd_line<J, rmd_rl(J)>(l, rmd_f<J>(l[B], l[C], l[D]), x, rmd_kl(J), rmd_sl(J));
    rmd_line<J, rmd_rr(J)>(r, rmd_f<79 - J>(r[B], r[C], r[D]), x, rmd_kr(J), rmd_sr(J));
}

template <int... J>
KH_INLINE void rmd_rounds(uint32_t (&l)[5], uint32_t (&r)[5], const uint32_t (&x)[16],
                          std::integer_sequence<int, J...>) {
    (rmd_round<J>(l, r, x), ...);
}

// RIPEMD-160 of the 32 bytes of big-endian words d[8]. out = the digest's
// little-endian words in byte order, [h1, h2, h3, h4, h0] of the final
// state -- keyhunt_tpu/ops/ripemd160.py:85-91.
KH_INLINE void ripemd160_32(const uint32_t (&d)[8], uint32_t (&out)[5]) {
    uint32_t x[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = bswap(d[i]);
    x[8] = 0x80u;
#pragma unroll
    for (int i = 9; i < 14; ++i) x[i] = 0;
    x[14] = 256;
    x[15] = 0;
    const uint32_t h0 = 0x67452301u, h1 = 0xEFCDAB89u, h2 = 0x98BADCFEu,
                   h3 = 0x10325476u, h4 = 0xC3D2E1F0u;
    uint32_t l[5] = {h0, h1, h2, h3, h4};
    uint32_t r[5] = {h0, h1, h2, h3, h4};
    rmd_rounds(l, r, x, std::make_integer_sequence<int, 80>{});
    // after 80 rounds every line variable is back in its home slot
    out[0] = h1 + l[2] + r[3];
    out[1] = h2 + l[3] + r[4];
    out[2] = h3 + l[4] + r[0];
    out[3] = h4 + l[0] + r[1];
    out[4] = h0 + l[1] + r[2];
}

// ---------------------------------------------------------------------------
// Pubkey messages (sx, sy: big-endian words of X and Y, most significant
// first)
// ---------------------------------------------------------------------------

// The padded block of the 33-byte compressed pubkey 02 || X (0x02 prefix;
// 03 differs only in bit 24 of word 0).
KH_INLINE void block_compressed(const uint32_t (&sx)[8], uint32_t (&w)[16]) {
    w[0] = 0x02000000u | (sx[0] >> 8);
#pragma unroll
    for (int i = 1; i < 8; ++i) w[i] = shr8(sx[i - 1], sx[i]);
    w[8] = (sx[7] << 24) | 0x00800000u;
#pragma unroll
    for (int i = 9; i < 15; ++i) w[i] = 0;
    w[15] = 33 * 8;
}

KH_INLINE void hash160_block(const uint32_t (&blk)[16], uint32_t (&out)[5]) {
    uint32_t w[16], st[8];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = blk[i];
    sha256_init(st);
    sha256_compress<0xfe00u, true>(st, w);       // words 9-15: padding
    ripemd160_32(st, out);
}

// hash160 of the 65-byte uncompressed pubkey 04 || X || Y (two blocks).
KH_INLINE void hash160_uncompressed(const uint32_t (&sx)[8], const uint32_t (&sy)[8],
                                    uint32_t (&out)[5]) {
    uint32_t w[16], st[8];
    w[0] = 0x04000000u | (sx[0] >> 8);
#pragma unroll
    for (int i = 1; i < 8; ++i) w[i] = shr8(sx[i - 1], sx[i]);
    w[8] = shr8(sx[7], sy[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) w[8 + i] = shr8(sy[i - 1], sy[i]);
    sha256_init(st);
    sha256_compress<0u, true>(st, w);
    w[0] = (sy[7] << 24) | 0x00800000u;
#pragma unroll
    for (int i = 1; i < 15; ++i) w[i] = 0;
    w[15] = 65 * 8;
    sha256_compress<0xfffeu, false>(st, w);      // words 1-15: padding
    ripemd160_32(st, out);
}

}  // namespace kh_hash
