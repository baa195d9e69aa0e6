// secp256k1 prime-field arithmetic for one element per thread.
//
// Values are eight little-endian 32-bit limbs held in registers. The
// representation is lazy, as in keyhunt_tpu/ops/field.py: every result is
// < 2^256 and congruent to the true value mod p, and only `fe_norm` makes
// it canonical (< p). Reduction uses 2^256 = D (mod p), D = 2^32 + 977.
//
// Replaces the 16-bit half-limb convolution of keyhunt_tpu/ops/pallas_field.py
// (`_conv_terms`, `_accumulate_conv`, `_finish`), which existed only because
// the TPU's vector unit has no 32x32->64 multiply. Only the output contract
// of the TPU kernel carries over: lazy, < 2^256, congruent to the product.
//
// Products, sums and differences run on PTX carry chains. A 32x32 limb
// product enters a chain as a pair, `mad.lo.cc` into word k and
// `madc.hi.cc` into word k + 1, so its halves and the carries between words
// cost no separate adds. The products of a row are split by the parity of
// their weight: one of even weight (i + j) lands on an aligned word pair of
// the even accumulator `e`, one of odd weight on an aligned pair of the odd
// accumulator `o` (held one word down), and the two meet in one add chain
// at the end. Each row thus runs two independent chains, and each pair on
// aligned words issues as one wide multiply-add with carry in and out
// (IMAD.WIDE.U32.X on sm_90a): 64 of them for a product, 36 for a square.
//
// Each primitive is one PTX instruction in its own `asm volatile`
// statement; the carry flag (CC.CF) runs from one statement to the next,
// which nvcc keeps in program order. Built with KH_HOST_EMULATION (and no
// CUDA), the primitives are C++ on a static carry flag, so the arithmetic
// can be checked on a CPU (tests/test_torch_jacwalk.py).
#pragma once

#include <stdint.h>

#define KH_INLINE __device__ __forceinline__

struct fe {
    uint32_t v[8];
};

#if defined(KH_HOST_EMULATION) && !defined(__CUDA_ARCH__)

static uint32_t kh_cf;   // the emulated carry flag (a borrow after a sub)

static inline uint32_t kh_set(uint64_t t) {
    kh_cf = (uint32_t)(t >> 32) & 1u;
    return (uint32_t)t;
}
static inline uint32_t kh_lo(uint32_t a, uint32_t b) { return a * b; }
static inline uint32_t kh_hi(uint32_t a, uint32_t b) {
    return (uint32_t)(((uint64_t)a * b) >> 32);
}
KH_INLINE uint32_t add_cc(uint32_t a, uint32_t b) { return kh_set((uint64_t)a + b); }
KH_INLINE uint32_t addc_cc(uint32_t a, uint32_t b) {
    return kh_set((uint64_t)a + b + kh_cf);
}
KH_INLINE uint32_t addc(uint32_t a, uint32_t b) { return a + b + kh_cf; }
KH_INLINE uint32_t sub_cc(uint32_t a, uint32_t b) { return kh_set((uint64_t)a - b); }
KH_INLINE uint32_t subc_cc(uint32_t a, uint32_t b) {
    return kh_set((uint64_t)a - b - kh_cf);
}
KH_INLINE uint32_t subc(uint32_t a, uint32_t b) { return a - b - kh_cf; }
KH_INLINE uint32_t mul_lo(uint32_t a, uint32_t b) { return kh_lo(a, b); }
KH_INLINE uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return kh_set((uint64_t)kh_lo(a, b) + c);
}
KH_INLINE uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
    return kh_set((uint64_t)kh_lo(a, b) + c + kh_cf);
}
KH_INLINE uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return kh_set((uint64_t)kh_hi(a, b) + c);
}
KH_INLINE uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
    return kh_set((uint64_t)kh_hi(a, b) + c + kh_cf);
}
KH_INLINE uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
    return kh_hi(a, b) + c + kh_cf;
}
KH_INLINE uint32_t shl_funnel(uint32_t lo, uint32_t hi) {   // (hi:lo << 1) >> 32
    return (hi << 1) | (lo >> 31);
}

#else

#define KH_PTX2(name, op)                                                   \
    KH_INLINE uint32_t name(uint32_t a, uint32_t b) {                      \
        uint32_t d;                                                         \
        asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));         \
        return d;                                                           \
    }
#define KH_PTX3(name, op)                                                   \
    KH_INLINE uint32_t name(uint32_t a, uint32_t b, uint32_t c) {          \
        uint32_t d;                                                         \
        asm volatile(op " %0, %1, %2, %3;" : "=r"(d)                       \
                     : "r"(a), "r"(b), "r"(c));                             \
        return d;                                                           \
    }
KH_PTX2(add_cc, "add.cc.u32")
KH_PTX2(addc_cc, "addc.cc.u32")
KH_PTX2(addc, "addc.u32")
KH_PTX2(sub_cc, "sub.cc.u32")
KH_PTX2(subc_cc, "subc.cc.u32")
KH_PTX2(subc, "subc.u32")
KH_PTX2(mul_lo, "mul.lo.u32")
KH_PTX3(mad_lo_cc, "mad.lo.cc.u32")
KH_PTX3(madc_lo_cc, "madc.lo.cc.u32")
KH_PTX3(mad_hi_cc, "mad.hi.cc.u32")
KH_PTX3(madc_hi_cc, "madc.hi.cc.u32")
KH_PTX3(madc_hi, "madc.hi.u32")
#undef KH_PTX2
#undef KH_PTX3
KH_INLINE uint32_t shl_funnel(uint32_t lo, uint32_t hi) {
    return __funnelshift_l(lo, hi, 1);
}

#endif

// One row of products b * a[j], j = J0, J0 + 2, ... <= 7, added into the
// aligned word pairs acc[W0 + j - J0], acc[W0 + j - J0 + 1] as one carry
// chain. The carry out of the last pair is written to the next word when
// CARRY_OUT (that word is 0 before the row); otherwise the caller's bound
// on the accumulated sum makes it 0.
template <int J0, int W0, bool CARRY_OUT, int N>
KH_INLINE void chain_row(uint32_t (&acc)[N], const uint32_t a[8], uint32_t b) {
    acc[W0] = mad_lo_cc(a[J0], b, acc[W0]);
    acc[W0 + 1] = madc_hi_cc(a[J0], b, acc[W0 + 1]);
#pragma unroll
    for (int j = J0 + 2; j < 8; j += 2) {
        acc[W0 + j - J0] = madc_lo_cc(a[j], b, acc[W0 + j - J0]);
        acc[W0 + j - J0 + 1] = madc_hi_cc(a[j], b, acc[W0 + j - J0 + 1]);
    }
    if constexpr (CARRY_OUT) acc[W0 + 2 * ((7 - J0) / 2) + 2] = addc(0u, 0u);
}

// The rows I.. of a * b: row I adds b[I] * a, its products of even weight
// I + j into e (word = weight), those of odd weight into o (word = weight
// - 1). After row I each accumulator holds less than 2^(32 (I + 9)) in
// weight terms, which makes the carry out of the rows that end at weight
// I + 8 zero.
template <int I>
KH_INLINE void mul_rows(uint32_t (&e)[16], uint32_t (&o)[15], const uint32_t a[8],
                        const uint32_t b[8]) {
    if constexpr (I % 2 == 0) {
        chain_row<0, I, true>(e, a, b[I]);       // weights I .. I+7, carry I+8
        chain_row<1, I, false>(o, a, b[I]);      // weights I+1 .. I+8
    } else {
        chain_row<1, I + 1, false>(e, a, b[I]);  // weights I+1 .. I+8
        chain_row<0, I - 1, true>(o, a, b[I]);   // weights I .. I+7, carry I+8
    }
    if constexpr (I < 7) mul_rows<I + 1>(e, o, a, b);
}

// The off-diagonal rows I.. of a^2: row I adds a[I] * a[j] for j > I,
// j = I+2, I+4, ... (even weight) into e and j = I+1, I+3, ... into o.
template <int I>
KH_INLINE void sqr_rows(uint32_t (&e)[16], uint32_t (&o)[15], const uint32_t a[8]) {
    if constexpr (I % 2 == 0) {
        if constexpr (I + 2 < 8) chain_row<I + 2, 2 * I + 2, true>(e, a, a[I]);
        chain_row<I + 1, 2 * I, false>(o, a, a[I]);
    } else {
        chain_row<I + 2, 2 * I + 2, false>(e, a, a[I]);
        chain_row<I + 1, 2 * I, true>(o, a, a[I]);
    }
    if constexpr (I < 6) sqr_rows<I + 1>(e, o, a);
}

// r = e + o, o one word down: one add chain.
KH_INLINE void join_parity(uint32_t r[16], const uint32_t (&e)[16],
                           const uint32_t (&o)[15]) {
    r[0] = e[0];
    r[1] = add_cc(e[1], o[0]);
#pragma unroll
    for (int k = 2; k < 15; ++k) r[k] = addc_cc(e[k], o[k - 1]);
    r[15] = addc(e[15], o[14]);
}

// 512-bit r -> lazy 256-bit residue. Fold 1: s = lo + 977 hi + 2^32 hi
// (< 2^289, a two-word top) as two parity chains, e = lo + 977 h[j] for
// even j and o (one word down) = (hi << 32) + 977 h[j] for odd j, each
// product on an aligned pair; then the top times D, then the last carry
// times D, which reaches word 2 at most (after a wrap the value is < 2^66).
KH_INLINE fe fe_reduce(const uint32_t r[16]) {
    const uint32_t k977 = 977u;
    uint32_t e[9], o[9], s[10];
    e[0] = mad_lo_cc(r[8], k977, r[0]);
    e[1] = madc_hi_cc(r[8], k977, r[1]);
#pragma unroll
    for (int j = 2; j < 8; j += 2) {
        e[j] = madc_lo_cc(r[8 + j], k977, r[j]);
        e[j + 1] = madc_hi_cc(r[8 + j], k977, r[j + 1]);
    }
    e[8] = addc(0u, 0u);
    o[0] = mad_lo_cc(r[9], k977, r[8]);
    o[1] = madc_hi_cc(r[9], k977, r[9]);
#pragma unroll
    for (int j = 3; j < 8; j += 2) {
        o[j - 1] = madc_lo_cc(r[8 + j], k977, r[7 + j]);
        o[j] = madc_hi_cc(r[8 + j], k977, r[8 + j]);
    }
    o[8] = addc(0u, 0u);
    s[0] = e[0];
    s[1] = add_cc(e[1], o[0]);
#pragma unroll
    for (int k = 2; k < 9; ++k) s[k] = addc_cc(e[k], o[k - 1]);
    s[9] = addc(o[8], 0u);
    // top = s[8] + 2^32 s[9] < 2^33, and t = top * D in three words
    uint32_t t0 = mul_lo(s[8], k977);
    uint32_t t1 = mad_hi_cc(s[8], k977, s[8]);
    uint32_t t2 = addc(s[9], 0u);
    t1 = mad_lo_cc(s[9], k977, t1);
    t2 = addc(t2, 0u);
    fe out;
    out.v[0] = add_cc(s[0], t0);
    out.v[1] = addc_cc(s[1], t1);
    out.v[2] = addc_cc(s[2], t2);
#pragma unroll
    for (int i = 3; i < 8; ++i) out.v[i] = addc_cc(s[i], 0u);
    uint32_t c = addc(0u, 0u);
    out.v[0] = add_cc(out.v[0], (0u - c) & k977);
    out.v[1] = addc_cc(out.v[1], c);
    out.v[2] = addc(out.v[2], 0u);
    return out;
}

// a * b mod p, lazy: 64 limb products in 16 chains of 4 pairs.
KH_INLINE fe fe_mul(const fe& a, const fe& b) {
    uint32_t e[16] = {}, o[15] = {}, r[16];
    mul_rows<0>(e, o, a.v, b.v);
    join_parity(r, e, o);
    return fe_reduce(r);
}

// a^2 mod p, lazy: the 28 off-diagonal products, doubled by a one-bit
// funnel shift, plus the 8 squares a[i]^2 on the pairs (2i, 2i + 1) in one
// chain.
KH_INLINE fe fe_sqr(const fe& a) {
    uint32_t e[16] = {}, o[15] = {}, t[16], r[16];
    sqr_rows<0>(e, o, a.v);
    join_parity(t, e, o);                 // < 2^511: doubling loses no bit
    r[0] = t[0] << 1;
#pragma unroll
    for (int k = 1; k < 16; ++k) r[k] = shl_funnel(t[k - 1], t[k]);
    r[0] = mad_lo_cc(a.v[0], a.v[0], r[0]);
    r[1] = madc_hi_cc(a.v[0], a.v[0], r[1]);
#pragma unroll
    for (int i = 1; i < 7; ++i) {
        r[2 * i] = madc_lo_cc(a.v[i], a.v[i], r[2 * i]);
        r[2 * i + 1] = madc_hi_cc(a.v[i], a.v[i], r[2 * i + 1]);
    }
    r[14] = madc_lo_cc(a.v[7], a.v[7], r[14]);
    r[15] = madc_hi(a.v[7], a.v[7], r[15]);
    return fe_reduce(r);
}

// (a + b) mod p, lazy: one carry chain, one fold of the carry by D, and a
// second fold that can only occur after a wrap, when the value is < 2^34
// (words 0-1).
KH_INLINE fe fe_add(const fe& a, const fe& b) {
    fe o;
    o.v[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) o.v[i] = addc_cc(a.v[i], b.v[i]);
    uint32_t c = addc(0u, 0u);
    o.v[0] = add_cc(o.v[0], (0u - c) & 977u);
    o.v[1] = addc_cc(o.v[1], c);
#pragma unroll
    for (int i = 2; i < 8; ++i) o.v[i] = addc_cc(o.v[i], 0u);
    c = addc(0u, 0u);
    o.v[0] = add_cc(o.v[0], (0u - c) & 977u);
    o.v[1] = addc(o.v[1], c);
    return o;
}

// (a - b) mod p, lazy: one borrow chain, D taken off for a borrow, and
// once more only after a second borrow, when the value lies in
// [2^256 - D, 2^256) and the subtraction stays in words 0-1.
KH_INLINE fe fe_sub(const fe& a, const fe& b) {
    fe o;
    o.v[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int i = 1; i < 8; ++i) o.v[i] = subc_cc(a.v[i], b.v[i]);
    uint32_t m = subc(0u, 0u);                        // 0 or 0xFFFFFFFF
    o.v[0] = sub_cc(o.v[0], m & 977u);
    o.v[1] = subc_cc(o.v[1], m & 1u);
#pragma unroll
    for (int i = 2; i < 8; ++i) o.v[i] = subc_cc(o.v[i], 0u);
    m = subc(0u, 0u);
    o.v[0] = sub_cc(o.v[0], m & 977u);
    o.v[1] = subc(o.v[1], m & 1u);
    return o;
}

// Is a lazy a == 0 mod p? For a < 2^256 that is a == 0 or a == p.
KH_INLINE bool fe_is_zero_mod_p(const fe& a) {
    uint32_t any = 0, all = 0xFFFFFFFFu;
#pragma unroll
    for (int i = 0; i < 8; ++i) any |= a.v[i];
#pragma unroll
    for (int i = 2; i < 8; ++i) all &= a.v[i];
    return any == 0 ||
           ((a.v[0] ^ 0xFFFFFC2Fu) | (a.v[1] ^ 0xFFFFFFFEu) | ~all) == 0;
}

// Canonical form: subtract p once if a >= p (a + D carries out exactly then).
KH_INLINE fe fe_norm(const fe& a) {
    fe s;
    uint64_t t = (uint64_t)a.v[0] + 977u;
    s.v[0] = (uint32_t)t;
    t = (t >> 32) + (uint64_t)a.v[1] + 1u;
    s.v[1] = (uint32_t)t;
    uint64_t c = t >> 32;
#pragma unroll
    for (int i = 2; i < 8; ++i) {
        t = (uint64_t)a.v[i] + c;
        s.v[i] = (uint32_t)t;
        c = t >> 32;
    }
    fe o;
#pragma unroll
    for (int i = 0; i < 8; ++i) o.v[i] = c ? s.v[i] : a.v[i];
    return o;
}

KH_INLINE bool fe_is_zero(const fe& a) {
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc |= a.v[i];
    return acc == 0;
}

KH_INLINE fe fe_sqr_n(fe x, int n) {
    for (int i = 0; i < n; ++i) x = fe_sqr(x);
    return x;
}

// x^(p-2) by the secp256k1 addition chain (255 sqr + 15 mul), the chain of
// pallas_field.py `_inv_chain`. Zero maps to zero. The latency probe
// (field_latency.cu) times it beside `fe_inv_var`.
KH_INLINE fe fe_inv(const fe& x) {
    fe x2 = fe_mul(fe_sqr(x), x);
    fe x3 = fe_mul(fe_sqr(x2), x);
    fe x6 = fe_mul(fe_sqr_n(x3, 3), x3);
    fe x9 = fe_mul(fe_sqr_n(x6, 3), x3);
    fe x11 = fe_mul(fe_sqr_n(x9, 2), x2);
    fe x22 = fe_mul(fe_sqr_n(x11, 11), x11);
    fe x44 = fe_mul(fe_sqr_n(x22, 22), x22);
    fe x88 = fe_mul(fe_sqr_n(x44, 44), x44);
    fe x176 = fe_mul(fe_sqr_n(x88, 88), x88);
    fe x220 = fe_mul(fe_sqr_n(x176, 44), x44);
    fe x223 = fe_mul(fe_sqr_n(x220, 3), x3);
    fe t = fe_mul(fe_sqr_n(x223, 23), x22);
    t = fe_mul(fe_sqr_n(t, 5), x);
    t = fe_mul(fe_sqr_n(t, 3), x2);
    return fe_mul(fe_sqr_n(t, 2), x);
}

// ---------------------------------------------------------------------------
// x^-1 by Bernstein-Yang safegcd for one thread (batched inversion's root).
// The variable-time scheme of libsecp256k1's modinv32, also the family of
// the reference's DRS62 (secp256k1/IntMod.cpp): values in 9 signed 30-bit
// limbs; a batch runs 30 divsteps on the low words of (f, g) alone into a
// 2x2 matrix scaled by 2^30, then applies it to (f, g) exactly and to
// (d, e) mod p. About 18 batches for a random input, each a short
// dependent loop (~1,000 SM cycles) and the matrix updates (~450): ~30k
// cycles in all, where the Fermat chain `fe_inv` is 270 dependent field
// products, ~200k (tools/field_latency.py on an H100).
// keyhunt_tpu_torch/ops/field.py `inv_safegcd` runs the same steps in
// Python ints and is held against pow() by the CPU tests.
// ---------------------------------------------------------------------------

struct s30 {
    int32_t v[9];
};

constexpr int32_t kM30 = 0x3FFFFFFF;
// limb i of p = -977 - 4*2^30 + 2^16*2^240 (folds to a constant when
// unrolled); p^-1 mod 2^30
KH_INLINE int32_t p30(int i) { return i == 0 ? -0x3D1 : i == 1 ? -4 : i == 8 ? 65536 : 0; }
constexpr uint32_t kPInv30 = 0x2DDACACFu;
// divsteps from delta = 1 reach g = 0 within 741 for 256-bit inputs
constexpr int kSafegcdMaxBatches = 25;

// 30 divsteps on the low words; returns eta, writes t = (u, v, q, r).
KH_INLINE int32_t divsteps30(int32_t eta, uint32_t f, uint32_t g, int32_t t[4]) {
    uint32_t u = 1, v = 0, q = 0, r = 1;
    int i = 30;
    for (;;) {
        // skip g's low zeros (a sentinel bit stops the count at i)
        int zeros = __ffs((int)(g | (0xFFFFFFFFu << i))) - 1;
        g >>= zeros;
        u <<= zeros;
        v <<= zeros;
        eta -= zeros;
        i -= zeros;
        if (i == 0) break;
        if (eta < 0) {                     // (f, g) <- (g, -f)
            uint32_t s;
            eta = -eta;
            s = f; f = g; g = 0u - s;
            s = u; u = q; q = 0u - s;
            s = v; v = r; r = 0u - s;
        }
        // cancel up to min(eta + 1, i, 8) low bits of g with a multiple of f
        int limit = min(eta + 1, i);
        uint32_t m = (0xFFFFFFFFu >> (32 - limit)) & 255u;
        uint32_t fi = (3u * f) ^ 2u;       // f^-1 mod 2^5
        fi *= 2u - f * fi;                 // mod 2^10
        uint32_t w = (0u - g * fi) & m;
        g += f * w;
        q += u * w;
        r += v * w;
    }
    t[0] = (int32_t)u;
    t[1] = (int32_t)v;
    t[2] = (int32_t)q;
    t[3] = (int32_t)r;
    return eta;
}

// (d, e) <- (t [d, e] + p [md, me]) / 2^30, kept in (-2p, p).
KH_INLINE void update_de30(s30& d, s30& e, const int32_t t[4]) {
    const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
    int32_t sd = d.v[8] >> 31, se = e.v[8] >> 31;
    int32_t md = (u & sd) + (v & se), me = (q & sd) + (r & se);
    int64_t cd = (int64_t)u * d.v[0] + (int64_t)v * e.v[0];
    int64_t ce = (int64_t)q * d.v[0] + (int64_t)r * e.v[0];
    md -= (int32_t)((kPInv30 * (uint32_t)cd + (uint32_t)md) & kM30);
    me -= (int32_t)((kPInv30 * (uint32_t)ce + (uint32_t)me) & kM30);
    cd += (int64_t)p30(0) * md;
    ce += (int64_t)p30(0) * me;
    cd >>= 30;
    ce >>= 30;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        cd += (int64_t)u * d.v[i] + (int64_t)v * e.v[i] + (int64_t)p30(i) * md;
        ce += (int64_t)q * d.v[i] + (int64_t)r * e.v[i] + (int64_t)p30(i) * me;
        d.v[i - 1] = (int32_t)cd & kM30;
        e.v[i - 1] = (int32_t)ce & kM30;
        cd >>= 30;
        ce >>= 30;
    }
    d.v[8] = (int32_t)cd;
    e.v[8] = (int32_t)ce;
}

// (f, g) <- t [f, g] / 2^30, exact.
KH_INLINE void update_fg30(s30& f, s30& g, const int32_t t[4]) {
    const int32_t u = t[0], v = t[1], q = t[2], r = t[3];
    int64_t cf = ((int64_t)u * f.v[0] + (int64_t)v * g.v[0]) >> 30;
    int64_t cg = ((int64_t)q * f.v[0] + (int64_t)r * g.v[0]) >> 30;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        cf += (int64_t)u * f.v[i] + (int64_t)v * g.v[i];
        cg += (int64_t)q * f.v[i] + (int64_t)r * g.v[i];
        f.v[i - 1] = (int32_t)cf & kM30;
        g.v[i - 1] = (int32_t)cg & kM30;
        cf >>= 30;
        cg >>= 30;
    }
    f.v[8] = (int32_t)cf;
    g.v[8] = (int32_t)cg;
}

KH_INLINE void s30_carry(s30& d) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        d.v[i + 1] += d.v[i] >> 30;
        d.v[i] &= kM30;
    }
}

// d in (-2p, p) -> (d * sign) mod p in [0, p), limbs in [0, 2^30).
KH_INLINE void normalize30(s30& d, int32_t sign) {
    int32_t add = d.v[8] >> 31, neg = sign >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) d.v[i] = ((d.v[i] + (p30(i) & add)) ^ neg) - neg;
    s30_carry(d);
    add = d.v[8] >> 31;
#pragma unroll
    for (int i = 0; i < 9; ++i) d.v[i] += p30(i) & add;
    s30_carry(d);
}

// x^-1 mod p for a lazy x, canonical result; 0 maps to 0.
KH_INLINE fe fe_inv_var(const fe& x) {
    fe a = fe_norm(x);
    s30 d = {}, e = {}, f, g;
    e.v[0] = 1;
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        f.v[i] = p30(i);
        int w = 30 * i / 32, s = 30 * i % 32;
        uint64_t bits = a.v[w] | (w < 7 ? (uint64_t)a.v[w + 1] << 32 : 0);
        g.v[i] = (int32_t)(bits >> s) & kM30;
    }
    int32_t eta = -1;
    for (int b = 0; b < kSafegcdMaxBatches; ++b) {
        int32_t t[4];
        eta = divsteps30(eta, (uint32_t)f.v[0], (uint32_t)g.v[0], t);
        update_de30(d, e, t);
        update_fg30(f, g, t);
        int32_t rest = 0;
#pragma unroll
        for (int i = 0; i < 9; ++i) rest |= g.v[i];
        if (rest == 0) break;
    }
    normalize30(d, f.v[8]);
    fe o = {};
#pragma unroll
    for (int i = 0; i < 9; ++i) {
        int w = 30 * i / 32, s = 30 * i % 32;
        o.v[w] |= (uint32_t)d.v[i] << s;
        if (s > 2 && w < 7) o.v[w + 1] |= (uint32_t)d.v[i] >> (32 - s);
    }
    return o;
}

// Limb-major (8, n) layout: limb i of element e sits at p[i*n + e], so a
// warp touching 32 neighbouring elements reads 128 contiguous bytes per limb.
KH_INLINE fe fe_load(const uint32_t* __restrict__ p, int64_t n, int64_t e) {
    fe o;
#pragma unroll
    for (int i = 0; i < 8; ++i) o.v[i] = p[i * n + e];
    return o;
}

KH_INLINE void fe_store(uint32_t* __restrict__ p, int64_t n, int64_t e, const fe& a) {
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i * n + e] = a.v[i];
}
