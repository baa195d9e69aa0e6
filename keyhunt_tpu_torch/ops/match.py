"""Target tables and bucket slabs: host build, device probe, hit extraction.

Counterpart of the parts of keyhunt_tpu/ops/match.py that BSGS and the
walker run. The walker probes two-word slabs (`build_buckets`,
`probe_buckets`: the full 64-bit first words of each target hash or X).
BSGS probes packed slabs, which hold one uint32 per slot: the 32 fragment
bits just below the bucket-index bits,

    residual = (w0 << bbits) | (w1 >> shift),     bbits = 32 - shift,

with 0xFFFFFFFF sentinels padding each bucket row to maxlen; a query
probes ONE slab row (its bucket, w0 >> shift) and compares residuals. A
padded position is bucket*maxlen + slot; the host maps it back through
the bucket prefix `starts` (search.bsgs.decode_packed_pos).

The probe and the top-k were plain jnp in the JAX package (no Pallas
kernel), so they are plain PyTorch here, on every device. On device they
take int32 bit-pattern tensors; positions and payloads are int64.
"""

from __future__ import annotations

import numpy as np
import torch

from .u256 import widen, narrow


def build_table(pairs: list[tuple[int, int]]) -> tuple[np.ndarray, np.ndarray]:
    """Host: list of (w0, w1) uint32 pairs -> lexicographically sorted
    parallel arrays (t0, t1), padded to a power-of-two length with
    0xFFFFFFFF sentinels (same arrays as keyhunt_tpu's). A sentinel can
    only match a query equal to 2^64-1, which the exact host verify
    rejects like any other false positive."""
    n = max(len(pairs), 1)
    size = 1 << (n - 1).bit_length()
    t0 = np.full(size, 0xFFFFFFFF, np.uint32)
    t1 = np.full(size, 0xFFFFFFFF, np.uint32)
    if pairs:
        arr = np.array(sorted(pairs), dtype=np.uint64)
        t0[: len(pairs)] = arr[:, 0].astype(np.uint32)
        t1[: len(pairs)] = arr[:, 1].astype(np.uint32)
    return t0, t1


def build_buckets(t0, t1, avg: int = 32):
    """Host: sorted (t0, t1) arrays -> direct-indexed two-word bucket slabs.

    Returns (slab0, slab1, shift): slab* (nbuckets, maxlen) uint32 with
    0xFFFFFFFF sentinel padding, bucket index = w0 >> shift. maxlen is the
    largest bucket, so nothing overflows. The same slabs as keyhunt_tpu's
    (whose padded-permutation output served a BSGS path the port does not
    have)."""
    m = int(t0.shape[0])
    # nb >= 2 keeps shift <= 31
    nb = 1 << max((m // max(avg, 1)).bit_length() - 1, 1)
    shift = 32 - (nb.bit_length() - 1)
    b = (t0.astype(np.uint32) >> np.uint32(shift)).astype(np.int64)
    counts = np.bincount(b, minlength=nb)
    maxlen = max(int(counts.max()), 1)
    starts = np.zeros(nb, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    slots = b * maxlen + np.arange(m, dtype=np.int64) - np.repeat(starts, counts)
    slab0 = np.full(nb * maxlen, 0xFFFFFFFF, np.uint32)
    slab1 = np.full(nb * maxlen, 0xFFFFFFFF, np.uint32)
    slab0[slots] = t0
    slab1[slots] = t1
    return slab0.reshape(nb, maxlen), slab1.reshape(nb, maxlen), shift


def probe_buckets(slab0: torch.Tensor, slab1: torch.Tensor, w0: torch.Tensor,
                  w1: torch.Tensor, shift: int, chunks: int = 1):
    """(hit bool, pos int64) for each query against two-word slabs: one row
    gather per slab and a compare over the bucket; pos = bucket*maxlen +
    first matching slot. Exact (the whole bucket is scanned). The gathers
    materialise (queries, maxlen) temporaries, so the queries run in
    `chunks` sequential slices (search.bsgs.probe_chunks_for sizes them)."""
    maxlen = slab0.shape[1]
    hits, poss = [], []
    for a, b in zip(w0.chunk(chunks), w1.chunk(chunks)):
        bidx = widen(a) >> shift
        eq = (slab0[bidx] == a.unsqueeze(1)) & (slab1[bidx] == b.unsqueeze(1))
        hits.append(eq.any(dim=1))
        poss.append(bidx * maxlen + torch.argmax(eq.to(torch.uint8), dim=1))
    return torch.cat(hits), torch.cat(poss)


def pack_residual(w0, w1, shift: int):
    """The stored/compared uint32 residual of a 64-bit fragment (w0, w1)
    under bucket shift `shift`: numpy uint32 in, numpy uint32 out; int32
    bit-pattern tensors in, int32 bit-pattern tensor out."""
    bbits = 32 - shift
    if isinstance(w0, np.ndarray):
        return ((w0 << np.uint32(bbits)) | (w1 >> np.uint32(shift))) \
            .astype(np.uint32)
    return narrow((widen(w0) << bbits) | (widen(w1) >> shift))


def build_buckets_packed(t0, t1, avg: int = 256):
    """Host: lexicographically sorted fragment arrays -> packed slabs.

    Returns (slab, starts, shift): slab (nbuckets, maxlen) uint32
    residuals with sentinel padding; starts (nbuckets+1,) int64 prefix
    offsets into the SORTED order (bucket b's entries are the sorted
    indices [starts[b], starts[b+1])). Same arrays as keyhunt_tpu's."""
    m = int(t0.shape[0])
    nb = 1 << max((m // max(avg, 1)).bit_length() - 1, 1)
    shift = 32 - (nb.bit_length() - 1)
    t0 = np.asarray(t0)
    t1 = np.asarray(t1)
    b = (t0 >> np.uint32(shift)).astype(np.int64)
    counts = np.bincount(b, minlength=nb)
    maxlen = max(int(counts.max()), 1)
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    offsets = np.arange(m, dtype=np.int64) - starts[b]
    slab = np.full(nb * maxlen, 0xFFFFFFFF, np.uint32)
    slab[b * maxlen + offsets] = pack_residual(t0, t1, shift)
    return slab.reshape(nb, maxlen), starts, shift


def probe_buckets_packed(slab: torch.Tensor, w0: torch.Tensor,
                         w1: torch.Tensor, shift: int):
    """(hit bool, pos int64) for each query: one slab-row gather and a
    residual compare; pos = bucket*maxlen + first matching slot. The
    gather materialises a (queries, maxlen) temporary, so callers chunk
    large query sets (search.bsgs.probe_chunks_for)."""
    maxlen = slab.shape[1]
    bidx = widen(w0) >> shift
    res = pack_residual(w0, w1, shift)
    eq = slab[bidx] == res.unsqueeze(1)                # (Q, maxlen)
    hit = eq.any(dim=1)
    slot = torch.argmax(eq.to(torch.uint8), dim=1)     # first match
    return hit, bidx * maxlen + slot


def first_set(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first k set entries along the last dim (per row of
    a 2-D mask), ascending, -1 padded -- what `lax.top_k` (stable) gives
    on a 0/1 mask. Runs unconditionally: no host sync on the hit count."""
    n = mask.shape[-1]
    # set entries score n - index (unique, descending in index), unset 0
    score = mask.to(torch.int64) * (n - torch.arange(n, device=mask.device))
    vals, idx = torch.topk(score, min(k, n), dim=-1)
    idx = torch.where(vals > 0, idx, -1)
    if k > n:
        pad = torch.full(idx.shape[:-1] + (k - n,), -1, dtype=idx.dtype,
                         device=idx.device)
        idx = torch.cat([idx, pad], dim=-1)
    return idx


def topk_indices(mask_flat: torch.Tensor, k: int):
    """(idx, count): the first k set positions of a flat hit mask (int64,
    ascending, -1 padded) and the number of set positions as a () int64
    tensor. keyhunt_tpu gates its `lax.top_k` behind a `lax.cond` on the
    count; here the extraction runs unconditionally (`first_set`), so no
    host sync on the count sits in the dispatch queue."""
    return first_set(mask_flat, k), mask_flat.sum(dtype=torch.int64)


def topk_with_payload(mask: torch.Tensor, payload: torch.Tensor, k: int):
    """(lanes, payload[lanes], count): up to k set positions of the flat
    `mask`, in ascending order, -1 / 0 padded, and the number of set
    positions as a (1,) tensor. Device-side and unconditional."""
    lanes = first_set(mask, k)
    sel = torch.where(lanes >= 0, payload[lanes.clamp(min=0)],
                      torch.zeros((), dtype=payload.dtype, device=payload.device))
    count = mask.sum(dtype=torch.int64).reshape(1)
    return lanes, sel, count

