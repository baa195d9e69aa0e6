// Kernel K4's giant step (csrc/jacwalk.cu), on field.cuh's carry-chain
// arithmetic. A header of its own so that the CPU tests can build the step
// for the host (KH_HOST_EMULATION) and hold it against the plain version.
#pragma once

#include "field.cuh"

// The constants of a walk: the advance C = (cx, cy) and the restart G.
struct WalkConsts {
    fe cx, cy, gx, gy;
};

// One step P += C of the a = 0 mixed addition, 8M + 3S: the formulas of
// keyhunt_tpu/ops/jacwalk.py `_madd_const`, with Z*H and R moved up to
// where their operands are ready, which ends Z's and S2's lives early. A
// lane whose H is 0 mod p restarts at (Gx, Gy, 1); returns that flag.
KH_INLINE bool giant_step(fe& X, fe& Y, fe& Z, const WalkConsts& k) {
    fe z2 = fe_sqr(Z);
    fe z3 = fe_mul(z2, Z);
    fe u2 = fe_mul(k.cx, z2);
    fe s2 = fe_mul(k.cy, z3);
    fe h = fe_sub(u2, X);
    fe zn = fe_mul(Z, h);
    fe r = fe_sub(s2, Y);
    bool dg = fe_is_zero_mod_p(h);
    fe hh = fe_sqr(h);
    fe hhh = fe_mul(h, hh);
    fe t = fe_mul(X, hh);
    fe x3 = fe_sub(fe_sub(fe_sqr(r), hhh), fe_add(t, t));
    fe y3 = fe_sub(fe_mul(r, fe_sub(t, x3)), fe_mul(Y, hhh));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        X.v[i] = dg ? k.gx.v[i] : x3.v[i];
        Y.v[i] = dg ? k.gy.v[i] : y3.v[i];
        Z.v[i] = dg ? (i == 0 ? 1u : 0u) : zn.v[i];
    }
    return dg;
}
