"""The batched key-range walker of the brute-force modes, on PyTorch.

Counterpart of keyhunt_tpu/search/walker.py (the redesign of the
reference's group-of-1024 thread loop, `thread_process`,
`keyhunt.cpp:3265-3861`), on one device. A step materialises A*W points at
once from A pivot points and a W-wide offset table strided by the pivot
count:

    point[a, j] = pivot_a + (j+1) * (A*stride*G)
    pivot_a key = k0 + (a + 1 - A)*stride
    => key[a, j] = k0 + ((j+1)*A + a + 1 - A)*stride

so one inner step covers exactly [k0+stride, k0+A*W*stride], and the next
pivot (advance by A*W*stride) is exactly the last offset column,
point[a, W-1]: the pivot advance costs no extra inversion. All A*W slope
denominators go through one `field.batch_inv` (kernel K3 on CUDA). The
engine keeps pivot keys clear of +-offset keys, so no denominator is 0 (a
zero would come out 0 and spoil only its own point).

Per inner step, on CUDA: K3, then `curve.add_with_inv` (K1, K2), `norm`,
with -e `endo_x` (K1), the hashes (K5 for the compressed prefixes, K6 for
uncompressed, plain Keccak for eth), the two-word bucket probe or the
vanity range compare, and the top-k. The S inner steps run as a Python
loop; a dispatch returns one packed (S, K+1) int32 tensor, the only thing
the host fetches. Each stage runs inside a `trace.span` named
"walker.<stage>", so a profiler trace of a dispatch gives its breakdown.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import curve, field, match, u256
from ..ops import hash160 as h160
from ..ops.sha256 import bswap32
from ..ops.u256 import widen
from ..ops.match import probe_chunks_for
from ..trace import span

#: variants (candidate forms checked per computed point) per mode
MODE_VARIANTS = {
    "xpoint": ("x",),
    "compressed": ("02", "03"),
    "uncompressed": ("04",),
    "both": ("02", "03", "04"),
    "eth": ("eth",),
}

#: with endomorphism (-e): additionally check beta*X and beta^2*X -- the
#: points of keys lambda*k / lambda^2*k (keyhunt.cpp:3408-3440; x6/x3
#: counting, keyhunt.cpp:2883-2891)
ENDO_VARIANTS = {
    "xpoint": ("x", "bx", "b2x"),
    "compressed": ("02", "03", "02b", "03b", "02b2", "03b2"),
}

#: lambda-power by variant (for key reconstruction on the host)
VARIANT_ENDO_POWER = {
    "x": 0, "02": 0, "03": 0, "04": 0, "eth": 0,
    "bx": 1, "02b": 1, "03b": 1,
    "b2x": 2, "02b2": 2, "03b2": 2,
}


@dataclass(frozen=True)
class WalkerConfig:
    pivots: int = 32          # A
    width: int = 1024         # W
    steps: int = 8            # inner steps per dispatch (S)
    stride: int = 1           # key stride (-I flag in the reference)
    mode: str = "compressed"
    max_hits: int = 8         # top-k hit slots per inner step
    # vanity ranges as a tuple of (lo0, lo1, hi0, hi1) big-endian word pairs
    # (io.targets.ranges_to_words); when non-empty the probe is replaced by
    # hash160-in-range compares (thread_process_vanity, keyhunt.cpp:3867)
    vanity: tuple = ()
    # GLV endomorphism x6/x3 search (-e); compressed/xpoint only (the
    # reference's incompatibility checks, keyhunt.cpp:1185-1194)
    endo: bool = False

    def __post_init__(self):
        if self.endo and self.mode not in ("compressed", "xpoint"):
            raise ValueError("endomorphism requires compressed or xpoint mode")

    @property
    def batch(self) -> int:
        return self.pivots * self.width

    @property
    def keys_per_call(self) -> int:
        return self.steps * self.batch

    @property
    def variants(self) -> tuple[str, ...]:
        if self.endo:
            return ENDO_VARIANTS[self.mode]
        return MODE_VARIANTS[self.mode]

    @property
    def keys_per_point(self) -> int:
        """Effective keys checked per computed point (the x2/x6/x3
        counting rules of `keyhunt.cpp:2883-2891`)."""
        if self.endo:
            return 6 if self.mode == "compressed" else 3
        return 2 if self.mode == "compressed" else 1


def _needs_y(mode: str) -> bool:
    return mode in ("uncompressed", "both", "eth")


def _vanity_mask(h: torch.Tensor, ranges: tuple) -> torch.Tensor:
    """Is the hash's first 8 bytes, as a big-endian (w0, w1) pair, inside
    any [lo, hi] range? Unsigned compares on widened words."""
    hb0, hb1 = bswap32(widen(h[0])), bswap32(widen(h[1]))
    m = torch.zeros(hb0.shape, dtype=torch.bool, device=h.device)
    for lo0, lo1, hi0, hi1 in ranges:
        ge = (hb0 > lo0) | ((hb0 == lo0) & (hb1 >= lo1))
        le = (hb0 < hi0) | ((hb0 == hi0) & (hb1 <= hi1))
        m = m | (ge & le)
    return m


def make_step_fn(cfg: WalkerConfig, shift: int, device: torch.device | str,
                 advance_mult: int = 1):
    """Build the dispatch: run(px, py, slab0, slab1) -> (px', py', packed).

    px, py: (8, A) canonical pivot limbs on `device`; slab0/slab1: the
    two-word bucket slabs of the targets (`TargetSet.bucket_slabs`) on
    `device`, bucket = w0 >> shift. packed: (S, K+1) int32, per inner step
    the flat indices of the first K hits into the (V, A, W) candidate space
    (-1 padded) and the hit count.

    advance_mult: the shard count D of the sharded walker
    (`parallel.mesh`). It strides the offset table by G = D*A global
    pivots, so the shards walk interleaved lanes and every inner step
    advances each pivot by the global batch G*W (keyhunt_tpu's argument of
    the same name)."""
    A, W, S = cfg.pivots, cfg.width, cfg.steps
    device = torch.device(device)
    gtx, gty = (u256.to_torch(a, device) for a in
                curve.offset_table_strided(W, advance_mult * A * cfg.stride))
    want_y = _needs_y(cfg.mode)
    qx, qy = gtx[:, None, :], gty[:, None, :]                 # (8, 1, W)

    def one_step(px, py, slab0, slab1, chunks):
        with span("walker.dx_sub"):
            dx_main = field.sub(qx, px[:, :, None])            # (8, A, W)
        with span("walker.batch_inv"):
            inv_main = field.batch_inv(
                dx_main.reshape(8, A * W)).reshape(8, A, W)
        pxb, pyb = px[:, :, None], py[:, :, None]
        with span("walker.add"):
            if want_y:
                x3, y3 = curve.add_with_inv(pxb, pyb, qx, qy, inv_main)
            else:
                x3 = curve.add_with_inv(pxb, pyb, qx, qy, inv_main, want_y=False)
        with span("walker.norm"):
            xn = field.norm(x3)
            if want_y:
                yn = field.norm(y3)

        def probe(w0, w1):
            with span("walker.probe"):
                hit, _ = match.probe_buckets(slab0, slab1, w0.reshape(-1),
                                             w1.reshape(-1), shift, chunks)
            return hit

        def hash_mask(h):
            if not cfg.vanity:
                return probe(h[0], h[1])
            with span("walker.vanity"):
                return _vanity_mask(h, cfg.vanity)

        x_variants = [xn]
        if cfg.endo:
            with span("walker.endo"):
                bx, b2x = curve.endo_x(xn)
                x_variants += [field.norm(bx), field.norm(b2x)]
        masks = []
        for xv in x_variants:
            if cfg.mode == "xpoint":
                masks.append(probe(xv[7], xv[6]))
            if cfg.mode in ("compressed", "both"):
                with span("walker.hash"):
                    hs = h160.hash160_both_prefixes(xv)
                masks += [hash_mask(h) for h in hs]
        if cfg.mode in ("uncompressed", "both"):
            with span("walker.hash"):
                hu = h160.hash160_uncompressed(xn, yn)
            masks.append(hash_mask(hu))
        if cfg.mode == "eth":
            with span("walker.hash"):
                he = h160.eth_address_words(xn, yn)
            masks.append(probe(he[0], he[1]))
        with span("walker.topk"):
            hits, count = match.topk_indices(
                torch.stack([m.reshape(-1) for m in masks]).reshape(-1),
                cfg.max_hits)

        # the free pivot advance: pivot + A*W*stride*G is the last offset
        # column. Its Y, which the X-only modes never computed, is one
        # (8, A) lambda reconstruction from the shared inverse.
        with span("walker.pivot_advance"):
            px2 = xn[:, :, -1].contiguous()
            if want_y:
                py2 = yn[:, :, -1].contiguous()
            else:
                lam = field.mul(field.sub(gty[:, -1:], py), inv_main[:, :, -1])
                py2 = field.norm(field.sub(
                    field.mul(lam, field.sub(px, x3[:, :, -1])), py))
        return px2, py2, hits, count

    def run(px, py, slab0, slab1):
        chunks = probe_chunks_for(A * W, 2 * int(slab0.shape[1]))
        rows = []
        for _ in range(S):
            px, py, hits, count = one_step(px, py, slab0, slab1, chunks)
            rows.append(torch.cat([hits, count.reshape(1)]))
        return px, py, torch.stack(rows).to(torch.int32)

    return run


def decode_hit(cfg: WalkerConfig, k0: int, step_idx: int, flat_idx: int):
    """Map a device hit back to (variant, key): the inverse of the (V, A, W)
    flattening; key = k0 + (s*A*W + (j+1)*A + a + 1 - A)*stride."""
    aw = cfg.batch
    A, W = cfg.pivots, cfg.width
    v = flat_idx // aw
    a, j = divmod(flat_idx % aw, W)
    key = k0 + (step_idx * aw + (j + 1) * A + a + 1 - A) * cfg.stride
    return cfg.variants[v], key


def seed_pivots(cfg: WalkerConfig, k0: int) -> tuple[np.ndarray, np.ndarray]:
    """Host: (8, A) uint32 X, Y of the pivots for base key k0 -- pivot_a key
    = k0 + (a + 1 - A)*stride (the A keys at and below k0)."""
    A = cfg.pivots
    return curve.points_for_keys([k0 + (a + 1 - A) * cfg.stride for a in range(A)])
