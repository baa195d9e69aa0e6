// Kernels K1-K3 of the port: mod-p multiply, square and batched inversion
// over limb-major (8, n) uint32 arrays. Bound to Python with ctypes
// (keyhunt_tpu_torch/ops/cuda_field.py); every entry point launches on the
// stream it is given, allocates nothing, and returns cudaGetLastError().
//
// K1 `kh_field_mul` replaces keyhunt_tpu/ops/pallas_field.py `_mul_kernel`
// (pallas_call `_mul_call`), K2 `kh_field_sqr` replaces `_sqr_kernel`
// (`_sqr_call`). One thread per element; the eight limb loads of a warp are
// each 128 contiguous bytes. What bounds them on the H100: device memory --
// 32 B read per operand and 32 B written per element, against 64 (36 for
// the square) IMAD.WIDE plus ~80 adds that the integer units finish sooner
// (K1 moves ~2.3 TB/s at 2^21 elements, PERF.md). The design keeps every
// intermediate in registers, so device memory sees only the operands and
// the result, and masks the ragged edge so that any n is accepted (the TPU
// kernel wanted a multiple of its 8192-element tile).
//
// K3 `kh_batch_inv` replaces the pair `up_kernel` + `down_kernel`
// (`_binv_calls`) and the root inversion `_inv_chain`. The TPU design does
// not carry over: it relied on a sequential grid whose VMEM scratch (the
// root inverses) persists from grid step 0 to later steps, and GPU blocks
// run in no order. Here each thread owns a Montgomery group of `group`
// consecutive elements: a forward pass writes the running prefix products
// into `out`, one Fermat chain (255 sqr + 15 mul) inverts the group product,
// and a backward sweep turns prefixes into inverses. Cost per element is
// 3 multiplies plus 270/group for the chain. What bounds it is memory
// locality more than arithmetic: neighbouring threads walk addresses
// 4*group bytes apart, so each warp keeps ~32*group*8*2*4 bytes of lines
// live in L1 across its sweeps, and the serial chain per thread needs
// many groups in flight to hide its latency. The group size comes from
// the caller (keyhunt_tpu_torch/ops/field.py BATCH_INV_GROUP = 16, chosen
// from a sweep of 4..256 on an H100). A zero (or p) poisons its own
// group only: every element of that group comes out 0. The ragged last
// group is padded with ones in registers.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void field_mul_kernel(const uint32_t* __restrict__ a,
                                 const uint32_t* __restrict__ b,
                                 uint32_t* __restrict__ out, int64_t n) {
    int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    fe x = fe_load(a, n, e);
    fe y = fe_load(b, n, e);
    fe_store(out, n, e, fe_mul(x, y));
}

__global__ void field_sqr_kernel(const uint32_t* __restrict__ a,
                                 uint32_t* __restrict__ out, int64_t n) {
    int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    fe_store(out, n, e, fe_sqr(fe_load(a, n, e)));
}

__global__ void batch_inv_kernel(const uint32_t* __restrict__ x,
                                 uint32_t* __restrict__ out, int64_t n,
                                 int group) {
    int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    int64_t e0 = g * group;
    if (e0 >= n) return;
    int len = (int)((n - e0) < group ? (n - e0) : group);
    // forward: out[e0 + i] = x[e0] * ... * x[e0 + i]
    fe acc = fe_load(x, n, e0);
    fe_store(out, n, e0, acc);
    for (int i = 1; i < len; ++i) {
        acc = fe_mul(acc, fe_load(x, n, e0 + i));
        fe_store(out, n, e0 + i, acc);
    }
    // padding elements are ones: the group product is already complete
    fe inv = fe_inv(acc);
    // backward: inv holds (x[e0] ... x[e0 + i])^-1
    for (int i = len - 1; i > 0; --i) {
        fe prev = fe_load(out, n, e0 + i - 1);
        fe xi = fe_load(x, n, e0 + i);
        fe_store(out, n, e0 + i, fe_mul(inv, prev));
        inv = fe_mul(inv, xi);
    }
    fe_store(out, n, e0, inv);
}

inline unsigned blocks_for(int64_t n) {
    return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int kh_field_mul(const uint32_t* a, const uint32_t* b, uint32_t* out,
                 int64_t n, void* stream) {
    field_mul_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        a, b, out, n);
    return (int)cudaGetLastError();
}

int kh_field_sqr(const uint32_t* a, uint32_t* out, int64_t n, void* stream) {
    field_sqr_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        a, out, n);
    return (int)cudaGetLastError();
}

int kh_batch_inv(const uint32_t* x, uint32_t* out, int64_t n, int group,
                 void* stream) {
    int64_t groups = (n + group - 1) / group;
    batch_inv_kernel<<<blocks_for(groups), kThreads, 0, (cudaStream_t)stream>>>(
        x, out, n, group);
    return (int)cudaGetLastError();
}

}  // extern "C"
