// Kernels K5 and K6 of the port: hash160 of secp256k1 public keys over
// limb-major (8, n) uint32 arrays of canonical X (and Y). Bound to Python
// with ctypes (keyhunt_tpu_torch/ops/cuda_hash.py); every entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError().
//
// K5 `kh_hash160_both` replaces keyhunt_tpu/ops/pallas_hash.py
// `_h160_both_kernel` (pallas_call `_h160_both_call`): RIPEMD160(SHA256(
// 02||X)) and RIPEMD160(SHA256(03||X)), two (5, n) outputs. K6
// `kh_hash160_uncompressed` replaces `_h160_uncompressed_kernel`
// (`_h160_uncompressed_call`): RIPEMD160(SHA256(04||X||Y)), one (5, n).
//
// What bounds them on the H100: integer operations. Each element moves 32 B
// in (64 B for K6) and 40 B out (20 B for K6), but K5 runs two SHA-256
// compressions and two RIPEMD-160s, about 4,600 32-bit operations, so
// memory is not the floor. Nor is the issue rate alone: the rounds are
// rotations, 3-input logic and adds, which ptxas sends to the SM's ALU
// pipe, and that pipe takes a warp instruction every other clock, so an
// all-ALU body reaches half the issue rate at best. The hash core
// (hash160.cuh) sends every add of two variables to the FMA-heavy pipe as
// an IMAD (pipes.cuh), which leaves the ALU pipe the rotations, the logic
// and the adds of constants: ~13% fewer ALU instructions, still the
// busier of the two pipes. The design spends nothing on memory
// beyond the operands: one thread per element reads its 8 limbs
// (limb-major, so a warp's reads of one limb are 128 contiguous bytes),
// keeps the message block, the schedule window and both hash states in
// registers through fully unrolled rounds, and writes the five digest
// words coalesced. 128 threads a block; at 2^18 elements the last of ~1.6
// waves costs at most ~4% (timed at whole waves, PERF.md). K5 builds its
// block once: the two prefixes differ only in word 0, but the schedule
// diverges from w16 on, so both compressions run in full. Any n is
// accepted: the last block guards its tail (the TPU kernel wanted a
// multiple of 128 elements, and keyhunt_tpu sent other batches to jnp).
#include <cuda_runtime.h>

#include "hash160.cuh"

namespace {

constexpr int kThreads = 128;

// The big-endian message words of element e: limb 7 first.
__device__ __forceinline__ void load_be(const uint32_t* __restrict__ p, int64_t n,
                                        int64_t e, uint32_t (&s)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = p[(int64_t)(7 - i) * n + e];
}

__device__ __forceinline__ void store5(uint32_t* __restrict__ p, int64_t n, int64_t e,
                                       const uint32_t (&h)[5]) {
#pragma unroll
    for (int i = 0; i < 5; ++i) p[(int64_t)i * n + e] = h[i];
}

__global__ void hash160_both_kernel(const uint32_t* __restrict__ x,
                                    uint32_t* __restrict__ h02,
                                    uint32_t* __restrict__ h03, int64_t n) {
    int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    uint32_t sx[8], blk[16], h[5];
    load_be(x, n, e, sx);
    kh_hash::block_compressed(sx, blk);
    kh_hash::hash160_block(blk, h);
    store5(h02, n, e, h);
    blk[0] |= 0x01000000u;                       // prefix 03
    kh_hash::hash160_block(blk, h);
    store5(h03, n, e, h);
}

__global__ void hash160_uncompressed_kernel(const uint32_t* __restrict__ x,
                                            const uint32_t* __restrict__ y,
                                            uint32_t* __restrict__ out, int64_t n) {
    int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    uint32_t sx[8], sy[8], h[5];
    load_be(x, n, e, sx);
    load_be(y, n, e, sy);
    kh_hash::hash160_uncompressed(sx, sy, h);
    store5(out, n, e, h);
}

inline unsigned blocks_for(int64_t n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int kh_hash160_both(const uint32_t* x, uint32_t* h02, uint32_t* h03, int64_t n,
                    void* stream) {
    hash160_both_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        x, h02, h03, n);
    return (int)cudaGetLastError();
}

int kh_hash160_uncompressed(const uint32_t* x, const uint32_t* y, uint32_t* out,
                            int64_t n, void* stream) {
    hash160_uncompressed_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        x, y, out, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
