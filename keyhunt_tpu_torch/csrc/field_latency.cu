// Latency probe of the field arithmetic in field.cuh: one thread times
// dependent chains of each piece with clock64() and reports SM cycles per
// call. No TPU kernel stands behind it and no search path launches it;
// keyhunt_tpu_torch/tools/field_latency.py runs it, and chip_smoke.py
// prints its numbers beside K3's, whose trees, sweeps and root inversion
// are chains of exactly these pieces.
//
// cycles[] = {fe_mul, fe_sqr, fe_inv_var, fe_inv, divsteps30, update_de30};
// `sink` keeps the results live.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kChain = 256;

__global__ void field_latency_kernel(const uint32_t* __restrict__ in,
                                     long long* __restrict__ cycles,
                                     uint32_t* __restrict__ sink) {
    fe a = fe_load(in, 2, 0), b = fe_load(in, 2, 1);
    fe m = a, q = a;
    long long t0 = clock64();
    for (int k = 0; k < kChain; ++k) m = fe_mul(m, b);
    long long t1 = clock64();
    for (int k = 0; k < kChain; ++k) q = fe_sqr(q);
    long long t2 = clock64();
    fe iv = fe_inv_var(q);
    long long t3 = clock64();
    fe ic = fe_inv(iv);
    long long t4 = clock64();
    int32_t t[4], eta = -1;
    uint32_t f = ic.v[0] | 1u, g = ic.v[1];
    for (int k = 0; k < kChain; ++k) {
        eta = divsteps30(eta, f, g, t);
        f ^= (uint32_t)t[0] & ~1u;
        g += (uint32_t)t[3];
    }
    long long t5 = clock64();
    s30 d = {}, e = {};
    e.v[0] = 1;
    for (int k = 0; k < kChain; ++k) {
        update_de30(d, e, t);
        t[0] ^= d.v[0] & 1;
    }
    long long t6 = clock64();
    cycles[0] = (t1 - t0) / kChain;
    cycles[1] = (t2 - t1) / kChain;
    cycles[2] = t3 - t2;
    cycles[3] = t4 - t3;
    cycles[4] = (t5 - t4) / kChain;
    cycles[5] = (t6 - t5) / kChain;
#pragma unroll
    for (int i = 0; i < 8; ++i) sink[i] = m.v[i] ^ (uint32_t)d.v[i] ^ f ^ g ^ eta;
    fe_store(sink + 8, 2, 0, fe_norm(ic));
    fe_store(sink + 8, 2, 1, fe_norm(q));
}

}  // namespace

extern "C" {

// `in` holds two field elements as an (8, 2) limb-major array; `sink` 24
// words: 8 of mixed results, then fe_inv(fe_inv_var(q)) and q, canonical,
// as an (8, 2) array: the two inversions agree when its columns are equal.
int kh_field_latency(const uint32_t* in, long long* cycles, uint32_t* sink,
                     void* stream) {
    field_latency_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(in, cycles, sink);
    return (int)cudaGetLastError();
}

}  // extern "C"
