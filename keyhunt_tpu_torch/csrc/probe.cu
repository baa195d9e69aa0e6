// Kernel P1 of the port: the BSGS packed-slab probe.
//
// Replaces no TPU kernel: keyhunt_tpu's packed probe was plain jnp
// (keyhunt_tpu/ops/match.py `probe_buckets_packed`, `_ranged`), and the
// port ran it as plain PyTorch until this kernel. That chain gathered each
// query's whole slab row into a (queries, maxlen) temporary, compared it
// into a mask and reduced the mask twice (~21 launches a chunk).
//
// For each query q of (w0, w1): bucket gb = w0 >> shift, residual
// res = (w0 << (32 - shift)) | (w1 >> shift) (`match.pack_residual`). The
// group of lanes that owns q reads row gb - base of the slab once and
// compares res against every slot in registers; lane 0 writes
// hit[q] = any slot equal and pos[q] = gb * maxlen + the first equal slot,
// or gb * maxlen where nothing matches. A query whose row lies outside
// [base, base + rows) reads nothing and misses with its global pos (the
// ranged probe; base = 0 and the whole slab give the plain probe).
//
// What bounds it on the H100 is bytes: each query reads its row,
// maxlen * 4 B, and its two words, and writes a byte and a position, so
// queries * (maxlen * 4 + 17) B in all; the compares are one operation a
// slot. The design keeps those bytes few and in flight:
// - a group of G lanes per query (a power of two from 4 to 32, the
//   smallest for which kWords slots a lane cover the row: 32 at maxlen
//   338, 8 at maxlen 64) reads the row with neighbouring lanes on
//   neighbouring 8-byte words, so each load of a warp is one coalesced
//   stretch of the row (4-byte words where rows are not 8-byte aligned:
//   an odd maxlen or an odd slab start);
// - each lane issues all its loads of a pass (kWords slots) before it
//   compares any of them, so a row is in flight at once and many rows per
//   SM cover the latency of device memory; a longer row (maxlen past
//   G * kWords) takes further passes. Of 2 to 32 slots a lane, 8 timed
//   fastest on the H100 at maxlen 64 to 1280 (PERF.md);
// - each lane keeps its first matching slot, and the group takes the
//   least of them with log2(G) shuffles at the end.
// No order within a row is assumed: host-built rows are sorted, but
// `--dtable` rows hold their babies in ascending j, so every slot of the
// row is read, hit or miss: the bytes do not depend on the data.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 8;              // slots a lane loads per pass
constexpr uint32_t kNone = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t first_slot(uint32_t x, uint32_t res, uint32_t slot) {
    return x == res ? slot : kNone;
}

__device__ __forceinline__ uint32_t first_slot(uint2 x, uint32_t res, uint32_t slot) {
    return x.x == res ? slot : (x.y == res ? slot + 1 : kNone);
}

template <int VEC>
struct Word;
template <>
struct Word<1> { using T = uint32_t; };
template <>
struct Word<2> { using T = uint2; };

template <int G, int VEC>
__global__ void __launch_bounds__(kThreads)
probe_packed_kernel(const uint32_t* __restrict__ slab, const uint32_t* __restrict__ w0,
                    const uint32_t* __restrict__ w1, bool* __restrict__ hit,
                    int64_t* __restrict__ pos, int64_t n, int64_t rows, int maxlen,
                    int shift, int64_t base) {
    using T = typename Word<VEC>::T;
    const int64_t q = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / G;
    if (q >= n) return;                          // whole groups leave together
    const int lane = threadIdx.x & (G - 1);
    const unsigned group = G == 32 ? 0xFFFFFFFFu
                                   : ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
    const uint32_t a = __ldg(w0 + q), b = __ldg(w1 + q);
    const int64_t gb = a >> shift;
    const uint32_t res = (a << (32 - shift)) | (b >> shift);
    const int64_t lb = gb - base;
    constexpr int kLoads = kWords / VEC;
    uint32_t first = kNone;
    if (lb >= 0 && lb < rows) {                  // the same for the whole group
        const T* row = reinterpret_cast<const T*>(slab + lb * maxlen);
        const int nvec = maxlen / VEC;
        for (int c = 0; c < nvec; c += G * kLoads) {
            T v[kLoads];
#pragma unroll
            for (int k = 0; k < kLoads; ++k) {
                const int i = c + k * G + lane;
                if (i < nvec) v[k] = __ldg(row + i);
            }
#pragma unroll
            for (int k = 0; k < kLoads; ++k) {   // a lane's slots ascend
                const int i = c + k * G + lane;
                if (i < nvec && first == kNone) first = first_slot(v[k], res, i * VEC);
            }
        }
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
        first = min(first, __shfl_xor_sync(group, first, o));
    if (lane == 0) {
        hit[q] = first != kNone;
        pos[q] = gb * maxlen + (first == kNone ? 0 : first);
    }
}

template <int VEC>
cudaError_t launch(int g, const uint32_t* slab, const uint32_t* w0, const uint32_t* w1,
                   bool* hit, int64_t* pos, int64_t n, int64_t rows, int maxlen, int shift,
                   int64_t base, cudaStream_t stream) {
    const unsigned blocks = (unsigned)((n * g + kThreads - 1) / kThreads);
    switch (g) {
        case 4:
            probe_packed_kernel<4, VEC><<<blocks, kThreads, 0, stream>>>(
                slab, w0, w1, hit, pos, n, rows, maxlen, shift, base);
            break;
        case 8:
            probe_packed_kernel<8, VEC><<<blocks, kThreads, 0, stream>>>(
                slab, w0, w1, hit, pos, n, rows, maxlen, shift, base);
            break;
        case 16:
            probe_packed_kernel<16, VEC><<<blocks, kThreads, 0, stream>>>(
                slab, w0, w1, hit, pos, n, rows, maxlen, shift, base);
            break;
        default:
            probe_packed_kernel<32, VEC><<<blocks, kThreads, 0, stream>>>(
                slab, w0, w1, hit, pos, n, rows, maxlen, shift, base);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// slab: (rows, maxlen) int32 residual rows holding global buckets
// [base, base + rows); w0, w1: n query words; hit: n bools; pos: n int64.
// shift in [1, 31]; n, rows and maxlen positive.
int kh_probe_packed(const uint32_t* slab, const uint32_t* w0, const uint32_t* w1,
                    bool* hit, int64_t* pos, int64_t n, int64_t rows, int maxlen,
                    int shift, int64_t base, void* stream) {
    const int vec = (maxlen % 2 == 0 && (uintptr_t)slab % 8 == 0) ? 2 : 1;
    int g = 4;
    while (g < 32 && g * kWords < maxlen) g *= 2;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(vec == 2 ? launch<2>(g, slab, w0, w1, hit, pos, n, rows, maxlen, shift, base, s)
                          : launch<1>(g, slab, w0, w1, hit, pos, n, rows, maxlen, shift, base, s));
}

}  // extern "C"
