// T1 of the port: the u32 micro-benchmark's three bodies, over n uint32
// elements. Bound to Python with ctypes (keyhunt_tpu_torch/ops/vpu.py);
// every entry point launches on the stream it is given, allocates nothing,
// and returns cudaGetLastError().
//
// They replace the three bodies of tools/bench_vpu.py's `mk` (one
// pallas_call over (B/128, 128) tiles), with NOPS = 512 source operations
// per element:
//   kh_vpu_independent  <- `indep_kernel`: four accumulator streams, 64
//                          rounds of 8 add/xor ops, output a^b^c^d;
//   kh_vpu_dependent    <- `dep_kernel`: one chain v = (v + x) ^ x, 256 times;
//   kh_vpu_rotate_mix   <- `rot_kernel`: 102 rounds of r = rotl(v, 7),
//                          v = (r + x) ^ x.
//
// What bounds them on the H100: integer issue. Each element moves 4 B in and
// 4 B out against hundreds of operations, so memory is idle. The design is
// the simplest that keeps it so: one thread per element, every value in a
// uint32 register, the round loop unrolled at compile time, so each kernel
// is straight-line code with one predicated exit for the tail. The rotate
// is one funnel shift (SHF), where the TPU spent shl + shr + or. Nothing
// stops the compiler from simplifying what it can prove equal: the kernels
// compute what the TPU kernels compute, and the tool reports the SASS
// instructions the card issues for it beside the source-operation count.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bench_vpu.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kNops = 512;

__global__ void vpu_independent_kernel(const uint32_t* __restrict__ in,
                                       uint32_t* __restrict__ out, int64_t n) {
    int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    const uint32_t v = in[e];
    uint32_t a = v, b = v + 1u, c = v ^ 3u, d = v + 7u;
#pragma unroll
    for (int i = 0; i < kNops / 8; ++i) {
        a = a + v;
        b = b ^ v;
        c = c + b;
        d = d ^ a;
        a = a ^ d;
        b = b + c;
        c = c ^ a;
        d = d + b;
    }
    out[e] = a ^ b ^ c ^ d;
}

__global__ void vpu_dependent_kernel(const uint32_t* __restrict__ in,
                                     uint32_t* __restrict__ out, int64_t n) {
    int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    const uint32_t x = in[e];
    uint32_t v = x;
#pragma unroll
    for (int i = 0; i < kNops / 2; ++i) {
        v = v + x;
        v = v ^ x;
    }
    out[e] = v;
}

__global__ void vpu_rotate_mix_kernel(const uint32_t* __restrict__ in,
                                      uint32_t* __restrict__ out, int64_t n) {
    int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    out[e] = kh_vpu::rotate_mix(in[e]);
}

inline unsigned blocks_for(int64_t n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int kh_vpu_independent(const uint32_t* in, uint32_t* out, int64_t n, void* stream) {
    vpu_independent_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        in, out, n);
    return (int)cudaGetLastError();
}

int kh_vpu_dependent(const uint32_t* in, uint32_t* out, int64_t n, void* stream) {
    vpu_dependent_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        in, out, n);
    return (int)cudaGetLastError();
}

int kh_vpu_rotate_mix(const uint32_t* in, uint32_t* out, int64_t n, void* stream) {
    vpu_rotate_mix_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        in, out, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
