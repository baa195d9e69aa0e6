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
// (`_binv_calls`, pallas_call at pallas_field.py:542 and :558) and their
// root inversion `_inv_chain`. Its function's work is 3 field products per
// element and one inversion per call, 64 bytes per element, but what
// bounds it on the H100 is latency: a call is a chain of ~2 log2(n)
// dependent products (each ~900 SM cycles in one thread) around one
// inversion, and even at 2^21 the passes hold too few warps per scheduler
// to hide a product's chain (PERF.md). The TPU design carries over in structure,
// one Montgomery product tree per call, but not in its mechanics: its
// chunk roots lived in VMEM scratch from grid step 0 to later steps, and
// GPU blocks run in no order, so the tree is split over three launches on
// one stream:
//   up     each block of T threads takes a tile of T*G elements; thread t
//          owns elements tile + t + k*T (k < G), so every limb load and
//          store of a warp is 128 contiguous bytes; it writes its running
//          prefix products to `out`, the block folds the T thread products
//          by a tree in shared memory, and keeps the tree's nodes and the
//          block product in `scratch`;
//   root   one block inverts the nb block products the same way, with a
//          single safegcd inversion (field.cuh `fe_inv_var`, ~30k SM
//          cycles) where the TPU ran a 270-product Fermat chain (~200k
//          cycles of dependent products in one GPU thread);
//   down   each block turns its block inverse into T thread inverses
//          through its stored tree, and each thread sweeps its G elements
//          backwards, turning prefixes into inverses.
// When n <= T*G the root kernel alone does the whole call in one block.
// An element = 0 (mod p) enters the products as 1 and comes out 0; no
// other element depends on it (in the TPU kernel it spoils its chunk). Ragged
// tails are padded with ones in registers. `scratch` holds
// nb * 8 * (T + 2) words when nb > 1 (ops/field.py `batch_inv_plan`).
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

// ---- K3 ----------------------------------------------------------------

// T and G; a build may override them (keyhunt_tpu_torch/tools/sweep_batch_inv.py)
#ifndef KH_BINV_THREADS
#define KH_BINV_THREADS 256
#endif
#ifndef KH_BINV_GROUP
#define KH_BINV_GROUP 4
#endif
constexpr int kBinvThreads = KH_BINV_THREADS;
constexpr int kBinvGroup = KH_BINV_GROUP;
constexpr int kBinvTile = kBinvThreads * kBinvGroup;

// A product tree of up to T leaves in shared memory, limb-major so that a
// warp's accesses to neighbouring nodes hit distinct banks. Heap order:
// node 1 is the root, the children of node i are 2i and 2i + 1, and a tree
// of W leaves (a power of two) keeps them at W..2W-1.
struct Tree {
    uint32_t v[8][2 * kBinvThreads];
};

KH_INLINE fe tree_get(const Tree& s, int i) {
    fe o;
#pragma unroll
    for (int l = 0; l < 8; ++l) o.v[l] = s.v[l][i];
    return o;
}

KH_INLINE void tree_put(Tree& s, int i, const fe& a) {
#pragma unroll
    for (int l = 0; l < 8; ++l) s.v[l][i] = a.v[l];
}

KH_INLINE fe fe_one() {
    fe o = {};
    o.v[0] = 1;
    return o;
}

// Leaves W..2W-1 set -> every inner node the product of its children.
__device__ void tree_up(Tree& s, int W) {
    int t = threadIdx.x;
    for (int h = W / 2; h >= 1; h >>= 1) {
        __syncthreads();
        if (t < h) {
            int i = h + t;
            tree_put(s, i, fe_mul(tree_get(s, 2 * i), tree_get(s, 2 * i + 1)));
        }
    }
    __syncthreads();
}

// Node 1 holds the root's inverse -> leaf W + t holds leaf t's inverse:
// each inner node's inverse times one child is the other child's.
__device__ void tree_down(Tree& s, int W) {
    int t = threadIdx.x;
    for (int h = 1; h < W; h <<= 1) {
        __syncthreads();
        if (t < h) {
            int i = h + t;
            fe inv = tree_get(s, i), a = tree_get(s, 2 * i), b = tree_get(s, 2 * i + 1);
            tree_put(s, 2 * i, fe_mul(inv, b));
            tree_put(s, 2 * i + 1, fe_mul(inv, a));
        }
    }
    __syncthreads();
}

// The zero contract: x = 0 (mod p) counts as 1 in the products.
KH_INLINE bool is_zero_mod_p(const fe& a) { return fe_is_zero(fe_norm(a)); }

// Elements first + k*T (k < g) of an (8, m) array: writes their running
// products to `out` and returns the last (1 if the thread has none).
__device__ fe sweep_up(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                       int64_t m, int64_t first, int g) {
    fe acc = fe_one();
    for (int k = 0; k < g; ++k) {
        int64_t e = first + (int64_t)k * kBinvThreads;
        if (e >= m) break;
        fe v = fe_load(x, m, e);
        if (is_zero_mod_p(v)) v = fe_one();
        acc = k ? fe_mul(acc, v) : v;
        fe_store(out, m, e, acc);
    }
    return acc;
}

// The thread's number of elements first + k*T below m (at most g).
KH_INLINE int owned(int64_t m, int64_t first, int g) {
    if (first >= m) return 0;
    int64_t k = (m - 1 - first) / kBinvThreads + 1;
    return k < g ? (int)k : g;
}

// inv = (product of the thread's elements)^-1 -> each element's inverse
// in `out`, where sweep_up left the running products.
__device__ void sweep_down(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
                           int64_t m, int64_t first, int g, fe inv) {
    int len = owned(m, first, g);
    for (int k = len - 1; k >= 0; --k) {
        int64_t e = first + (int64_t)k * kBinvThreads;
        fe v = fe_load(x, m, e);
        bool z = is_zero_mod_p(v);
        fe r = k ? fe_mul(inv, fe_load(out, m, e - kBinvThreads)) : inv;
        if (z) r = fe{};
        fe_store(out, m, e, r);
        if (k && !z) inv = fe_mul(inv, v);
    }
}

// One block inverts all m elements: thread t owns t + k*T (k < ceil(m/T)),
// the tree spans the W threads that own any, and one thread inverts its
// root by safegcd. The root launch of a multi-block call (x = the block
// products) and the whole of a call with n <= T*G.
__global__ void __launch_bounds__(kBinvThreads)
binv_block_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int64_t m) {
    __shared__ Tree s;
    int t = threadIdx.x;
    int g = (int)((m + kBinvThreads - 1) / kBinvThreads);
    int W = 1;                          // threads t < min(m, T) own elements
    while (W < m && W < kBinvThreads) W <<= 1;
    fe acc = sweep_up(x, out, m, t, g);
    if (t < W) tree_put(s, W + t, acc);
    tree_up(s, W);
    if (t == 0) tree_put(s, 1, fe_inv_var(tree_get(s, 1)));
    tree_down(s, W);
    if (t < W) sweep_down(x, out, m, t, g, tree_get(s, W + t));
}

// Up pass: prefixes to `out`, the tile's tree nodes 0..T-1 to `levels`
// (node 0 unused), the tile's product to column b of the (8, nb) `prod`.
__global__ void __launch_bounds__(kBinvThreads)
binv_up_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int64_t n,
               uint32_t* __restrict__ levels, uint32_t* __restrict__ prod, int64_t nb) {
    __shared__ Tree s;
    int t = threadIdx.x;
    int64_t first = (int64_t)blockIdx.x * kBinvTile + t;
    tree_put(s, kBinvThreads + t, sweep_up(x, out, n, first, kBinvGroup));
    tree_up(s, kBinvThreads);
    uint32_t* lv = levels + (int64_t)blockIdx.x * 8 * kBinvThreads;
#pragma unroll
    for (int l = 0; l < 8; ++l) lv[l * kBinvThreads + t] = s.v[l][t];
    if (t < 8) prod[t * nb + blockIdx.x] = s.v[t][1];
}

// Down pass: column b of `prod_inv` is the tile's inverse; the stored
// inner nodes and each thread's product (its last prefix in `out`) rebuild
// the tree, which hands each thread its inverse for the backward sweep.
__global__ void __launch_bounds__(kBinvThreads)
binv_down_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int64_t n,
                 const uint32_t* __restrict__ levels,
                 const uint32_t* __restrict__ prod_inv, int64_t nb) {
    __shared__ Tree s;
    int t = threadIdx.x;
    int64_t first = (int64_t)blockIdx.x * kBinvTile + t;
    const uint32_t* lv = levels + (int64_t)blockIdx.x * 8 * kBinvThreads;
#pragma unroll
    for (int l = 0; l < 8; ++l)
        s.v[l][t] = t == 1 ? prod_inv[l * nb + blockIdx.x] : lv[l * kBinvThreads + t];
    int len = owned(n, first, kBinvGroup);
    tree_put(s, kBinvThreads + t,
             len ? fe_load(out, n, first + (int64_t)(len - 1) * kBinvThreads) : fe_one());
    tree_down(s, kBinvThreads);
    sweep_down(x, out, n, first, kBinvGroup, tree_get(s, kBinvThreads + t));
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

int kh_batch_inv(const uint32_t* x, uint32_t* out, uint32_t* scratch, int64_t n,
                 void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    int64_t nb = (n + kBinvTile - 1) / kBinvTile;
    if (nb == 1) {
        binv_block_kernel<<<1, kBinvThreads, 0, st>>>(x, out, n);
        return (int)cudaGetLastError();
    }
    uint32_t* levels = scratch;
    uint32_t* prod = levels + nb * 8 * kBinvThreads;
    uint32_t* prod_inv = prod + 8 * nb;
    binv_up_kernel<<<(unsigned)nb, kBinvThreads, 0, st>>>(x, out, n, levels, prod, nb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    binv_block_kernel<<<1, kBinvThreads, 0, st>>>(prod, prod_inv, nb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    binv_down_kernel<<<(unsigned)nb, kBinvThreads, 0, st>>>(x, out, n, levels,
                                                            prod_inv, nb);
    return (int)cudaGetLastError();
}

}  // extern "C"
