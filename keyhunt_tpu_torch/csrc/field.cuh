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
