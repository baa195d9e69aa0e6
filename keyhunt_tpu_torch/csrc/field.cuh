// secp256k1 prime-field arithmetic for one element per thread.
//
// Values are eight little-endian 32-bit limbs held in registers. The
// representation is lazy, as in keyhunt_tpu/ops/field.py: every result is
// < 2^256 and congruent to the true value mod p, and only `fe_norm` makes
// it canonical (< p). Reduction uses 2^256 = D (mod p), D = 2^32 + 977.
//
// Replaces the 16-bit half-limb convolution of keyhunt_tpu/ops/pallas_field.py
// (`_conv_terms`, `_accumulate_conv`, `_finish`), which existed only because
// the TPU's vector unit has no 32x32->64 multiply. Here each limb product is
// one IMAD.WIDE.U32 (a 64-bit result), and carries ride in 64-bit sums, so a
// product is 64 wide multiplies plus two folds. Only the output contract of
// the TPU kernel carries over: lazy, < 2^256, congruent to the product.
#pragma once

#include <stdint.h>

#define KH_INLINE __device__ __forceinline__

struct fe {
    uint32_t v[8];
};

KH_INLINE uint64_t kh_mul_wide(uint32_t a, uint32_t b) {
    return (uint64_t)a * (uint64_t)b;
}

// 512-bit value r[16] -> lazy 256-bit residue mod p.
KH_INLINE fe fe_reduce512(const uint32_t r[16]) {
    fe o;
    // fold 1: lo + hi*977 + (hi << 32); every column sum stays < 2^44
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t t = (uint64_t)r[i] + kh_mul_wide(r[8 + i], 977u) + c;
        if (i > 0) t += r[7 + i];
        o.v[i] = (uint32_t)t;
        c = t >> 32;
    }
    uint64_t top = c + r[15];                 // < 2^33: the new 2^256 digit
    // fold 2: top * D = top*977 + (top << 32)
    uint64_t t = (uint64_t)o.v[0] + top * 977u;
    o.v[0] = (uint32_t)t;
    t = (t >> 32) + (uint64_t)o.v[1] + top;
    o.v[1] = (uint32_t)t;
    c = t >> 32;
#pragma unroll
    for (int i = 2; i < 8; ++i) {
        t = (uint64_t)o.v[i] + c;
        o.v[i] = (uint32_t)t;
        c = t >> 32;
    }
    // fold 3: a last carry bit; the value is then < D, so this cannot wrap
    t = (uint64_t)o.v[0] + c * 977u;
    o.v[0] = (uint32_t)t;
    t = (t >> 32) + (uint64_t)o.v[1] + c;
    o.v[1] = (uint32_t)t;
    c = t >> 32;
#pragma unroll
    for (int i = 2; i < 8; ++i) {
        t = (uint64_t)o.v[i] + c;
        o.v[i] = (uint32_t)t;
        c = t >> 32;
    }
    return o;
}

KH_INLINE fe fe_mul(const fe& a, const fe& b) {
    uint32_t r[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) r[i] = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            uint64_t t = kh_mul_wide(a.v[i], b.v[j]) + r[i + j] + c;
            r[i + j] = (uint32_t)t;
            c = t >> 32;
        }
        r[i + 8] = (uint32_t)c;
    }
    return fe_reduce512(r);
}

// a^2 from the j > i limb products (doubled) plus the diagonal: 36 wide
// multiplies instead of 64, the same saving as pallas_field's
// `_accumulate_conv_sqr`.
KH_INLINE fe fe_sqr(const fe& a) {
    uint32_t r[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) r[i] = 0;
#pragma unroll
    for (int i = 0; i < 7; ++i) {
        uint64_t c = 0;
#pragma unroll
        for (int j = i + 1; j < 8; ++j) {
            uint64_t t = kh_mul_wide(a.v[i], a.v[j]) + r[i + j] + c;
            r[i + j] = (uint32_t)t;
            c = t >> 32;
        }
        r[i + 8] = (uint32_t)c;
    }
    // double the off-diagonal sum (it is < 2^511, so no bit is lost)
#pragma unroll
    for (int i = 15; i > 0; --i) r[i] = (r[i] << 1) | (r[i - 1] >> 31);
    r[0] <<= 1;
    // add the diagonal a_i^2 at limb 2i
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t d = kh_mul_wide(a.v[i], a.v[i]);
        uint64_t t = (uint64_t)r[2 * i] + (uint32_t)d + c;
        r[2 * i] = (uint32_t)t;
        t = (t >> 32) + (uint64_t)r[2 * i + 1] + (d >> 32);
        r[2 * i + 1] = (uint32_t)t;
        c = t >> 32;
    }
    return fe_reduce512(r);
}

// (a + b) mod p, lazy: add, then fold the carry (twice at most).
KH_INLINE fe fe_add(const fe& a, const fe& b) {
    fe o;
    uint64_t c = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t t = (uint64_t)a.v[i] + b.v[i] + c;
        o.v[i] = (uint32_t)t;
        c = t >> 32;
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        uint64_t t = (uint64_t)o.v[0] + c * 977u;
        o.v[0] = (uint32_t)t;
        t = (t >> 32) + (uint64_t)o.v[1] + c;
        o.v[1] = (uint32_t)t;
        c = t >> 32;
#pragma unroll
        for (int i = 2; i < 8; ++i) {
            t = (uint64_t)o.v[i] + c;
            o.v[i] = (uint32_t)t;
            c = t >> 32;
        }
    }
    return o;
}

// (a - b) mod p, lazy: subtract, then take D off for each borrow (twice at
// most; after the first the value is >= 2^256 - D, so the second is final).
KH_INLINE fe fe_sub(const fe& a, const fe& b) {
    fe o;
    uint32_t borrow = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        uint64_t t = (uint64_t)a.v[i] - b.v[i] - borrow;
        o.v[i] = (uint32_t)t;
        borrow = (uint32_t)(t >> 63);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        uint64_t t = (uint64_t)o.v[0] - (uint64_t)borrow * 977u;
        o.v[0] = (uint32_t)t;
        uint32_t b2 = (uint32_t)(t >> 63);
        t = (uint64_t)o.v[1] - borrow - b2;
        o.v[1] = (uint32_t)t;
        b2 = (uint32_t)(t >> 63);
#pragma unroll
        for (int i = 2; i < 8; ++i) {
            t = (uint64_t)o.v[i] - b2;
            o.v[i] = (uint32_t)t;
            b2 = (uint32_t)(t >> 63);
        }
        borrow = b2;
    }
    return o;
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
// pallas_field.py `_inv_chain`. Zero maps to zero.
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
