// Kernel K4 of the port: the fused Jacobian giant-step scan of BSGS.
//
// Replaces keyhunt_tpu/ops/jacwalk.py `_scan_kernel_body` (pallas_call
// `_scan_call`, step `_madd_const`). Each lane walks S steps of
// P += C (Jacobian X, Y, Z plus the affine constant C, 8 mul + 3 sqr a
// step, `giant_step` in jacwalk.cuh). Before each step it emits (X, Z)
// into step-major (8, S*L) arrays (flat query index s*L + lane, coalesced
// across lanes) and after it the degeneracy flag H == 0 mod p into an
// (S, L) mask. A degenerate lane restarts at (Gx, Gy, 1): the JAX
// docstring says C, but its code restarts at G and the port follows the
// code, so a restarted lane cannot x-equal C again.
//
// One thread per lane with X, Y, Z in registers and C and G in the
// kernel's parameter space. What bounds it on the H100 is integer issue:
// device memory sees the state once in and once out plus 64 B of emission
// and 4 B of flag per lane and step, against ~1,700 SASS instructions in
// the step loop, ~700 of them wide multiply-adds. The design keeps that
// count low: field.cuh's carry chains make each limb product one wide
// multiply-add in a chain and fold once per add or sub, and H is tested
// against 0 and p with no normalisation. Blocks of 128 threads, registers
// not capped:
// capping them at 80 (6 warps per scheduler) spilled and was no faster
// than 3 warps per scheduler at 132 (PERF.md).
#include <cuda_runtime.h>

#include "field.cuh"
#include "jacwalk.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void giant_scan_kernel(const uint32_t* __restrict__ xin,
                                  const uint32_t* __restrict__ yin,
                                  const uint32_t* __restrict__ zin,
                                  uint32_t* __restrict__ xout,
                                  uint32_t* __restrict__ yout,
                                  uint32_t* __restrict__ zout,
                                  uint32_t* __restrict__ xs,
                                  uint32_t* __restrict__ zs,
                                  uint32_t* __restrict__ degen,
                                  int64_t L, int steps, WalkConsts k) {
    int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= L) return;
    fe X = fe_load(xin, L, lane);
    fe Y = fe_load(yin, L, lane);
    fe Z = fe_load(zin, L, lane);
    const int64_t SL = (int64_t)steps * L;
    for (int s = 0; s < steps; ++s) {
        int64_t q = (int64_t)s * L + lane;
        fe_store(xs, SL, q, X);               // emit BEFORE the advance
        fe_store(zs, SL, q, Z);
        degen[q] = giant_step(X, Y, Z, k) ? 1u : 0u;
    }
    fe_store(xout, L, lane, X);
    fe_store(yout, L, lane, Y);
    fe_store(zout, L, lane, Z);
}

}  // namespace

extern "C" {

// consts: 32 words, the limbs of cx, cy, gx, gy (little-endian, 8 each).
int kh_giant_scan(const uint32_t* x, const uint32_t* y, const uint32_t* z,
                  uint32_t* xo, uint32_t* yo, uint32_t* zo, uint32_t* xs,
                  uint32_t* zs, uint32_t* degen, int64_t L, int steps,
                  const uint32_t* consts, void* stream) {
    WalkConsts k;
    for (int i = 0; i < 8; ++i) {
        k.cx.v[i] = consts[i];
        k.cy.v[i] = consts[8 + i];
        k.gx.v[i] = consts[16 + i];
        k.gy.v[i] = consts[24 + i];
    }
    unsigned blocks = (unsigned)((L + kThreads - 1) / kThreads);
    giant_scan_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, y, z, xo, yo, zo, xs, zs, degen, L, steps, k);
    return (int)cudaGetLastError();
}

}  // extern "C"
