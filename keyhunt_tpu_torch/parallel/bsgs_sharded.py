"""BSGS over a mesh: the baby table sharded across the shards' memory,
giant-step queries all-gathered, membership combined with a psum.

Counterpart of keyhunt_tpu/parallel/bsgs_sharded.py. The k-factor (a
bigger baby table, fewer giant steps) becomes the shards' aggregate
memory: D cards hold a table D times larger than one.

Per dispatch (D global shards, T targets, B lanes per target per shard,
Ll = T*B lanes a shard, S steps):
- table: the packed bucket slab split by bucket index into D equal
  stacks, shard d holding rows [d*per, (d+1)*per);
- lanes: each shard walks its (8, Ll) Jacobian lanes with K4 and the
  global advance (D*B*stride)*G, then converts its S*Ll emitted points
  with one deferred K3/K2/K1 affine conversion;
- one all-gather ships every shard's (2, S*Ll) X fragments; the flat query
  index is g = (s*D + d)*Ll + l, step-major then shard-major;
- every shard probes all D*S*Ll queries against its own slab shard
  (`match.probe_buckets_packed_ranged` at the shard's first bucket row); a
  fragment lives in exactly one bucket, so one shard, and the psum of
  (hit, pos+1) is a select, not a vote;
- degenerate-lane flags stay per shard: `degen_slots` global flat lane
  indices a row, rows d*S + s.
On one card with D shards every shard probes D times the queries of the
one-device step, so a covered key costs about D times as much: the mesh
pays off when the shards are D cards whose memory holds a table D times
larger.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..device import to_device
from ..ops import jacwalk, match
from ..ref import ecc
from ..search.bsgs import (DEGEN_SLOTS, BabyTable, BsgsConfig,
                           decode_packed_pos, probe_chunks_for)
from ..trace import span
from .mesh import Mesh


def shard_buckets_packed(tbl: BabyTable, n_devices: int,
                         avg: int | None = None, parts: int = 1):
    """Split the packed bucket slab by BUCKET INDEX into D equal stacks:
    shard d owns buckets [d*per, (d+1)*per) (bucket = w0 >> shift, so a
    query routes by a shift and a compare: the reading of the reference's
    256-way first-byte bloom shards, `keyhunt.cpp:1704-1718`). Sentinel
    rows pad the tail when there are fewer buckets than shards (they never
    match).

    With parts > 1 (table partitions composed with the mesh), each shard's
    bucket range is split again into `parts` contiguous pieces: pass p
    keeps piece p of EVERY shard resident, so a bucket is resident on at
    most one shard in any pass and the psum stays exact.

    Returns (slab, starts, shift), slab shaped (D, parts, per, maxlen):
    shard d's piece p holds global bucket rows [d*parts*per + p*per, ... +
    per); starts is the GLOBAL bucket prefix (host, for `decode_packed_pos`)."""
    slab, starts, shift = tbl.packed(avg)
    slab = np.asarray(slab)
    nb, maxlen = slab.shape
    chunks = n_devices * max(parts, 1)
    if nb % chunks:
        pad = chunks - nb % chunks
        slab = np.concatenate([slab, np.full((pad, maxlen), 0xFFFFFFFF, np.uint32)])
        nb += pad
    per = nb // chunks
    return slab.reshape(n_devices, max(parts, 1), per, maxlen), starts, shift


@dataclass
class ResidentShards:
    """This process's resident slab shards of one pass: one (per, maxlen)
    tensor per local shard, each shard's first global bucket row, and the
    table's global decode."""
    slabs: list
    bases: list
    shift: int
    maxlen: int
    pos_to_j: Callable[[int], int | None]


def resident_shards(tbl: BabyTable, mesh: Mesh, part: int = 0,
                    parts: int = 1, cache: bool = False) -> ResidentShards:
    """Upload piece `part` (of `parts`) of each local shard's bucket range
    (`shard_buckets_packed`) to its shard's device. With `cache`, the
    whole table's shards (parts = 1) are kept on the table per mesh
    layout, as `BabyTable.device_packed` keeps its one-device slab, so
    engines sharing one table (the daemon's per-query engines) upload
    them once; a partition's piece or a ggsb block is uploaded for its
    pass only, as on one device."""
    parts = max(parts, 1)
    if not cache or parts > 1:
        return _upload_shards(tbl, mesh, part, parts)
    shards = tbl.__dict__.setdefault("_dev_shards", {})
    key = (tuple(mesh.devices), mesh.first, mesh.size)
    if key not in shards:
        shards[key] = _upload_shards(tbl, mesh, 0, 1)
    return shards[key]


def _upload_shards(tbl: BabyTable, mesh: Mesh, part: int,
                   parts: int) -> ResidentShards:
    slab4, starts, shift = shard_buckets_packed(tbl, mesh.size, parts=parts)
    per, maxlen = slab4.shape[2], slab4.shape[3]
    slabs = [to_device(np.ascontiguousarray(slab4[mesh.first + i, part]), dev)
             for i, dev in enumerate(mesh.devices)]
    # shard d's piece p starts at global row d*parts*per + p*per
    bases = [(mesh.first + i) * per * parts + part * per
             for i in range(mesh.local)]
    perm = tbl.perm
    return ResidentShards(slabs, bases, shift, maxlen,
                          lambda pos: decode_packed_pos(pos, starts, maxlen, perm))


def make_sharded_giant_step(cfg: BsgsConfig, shards: ResidentShards,
                            mesh: Mesh, n_targets: int = 1,
                            degen_slots: int = DEGEN_SLOTS):
    """The giant step over the mesh (keyhunt_tpu's
    `make_sharded_giant_step`, its table pieces made resident apart by
    `resident_shards`): run(Xs, Ys, Zs) -> (Xs', Ys', Zs', payload). Xs/Ys/Zs: one (8, T*B) Jacobian lane tensor per local shard
    (shard d owns global lanes [d*T*B, (d+1)*T*B), the shard-major (d, t,
    b) layout of `BsgsEngine._seed`). payload, on the mesh's home device
    and the same in every process, has the one-device layout:
    [lanes(K) | jsel(K) | count(1) | flags(D*S*degen_slots)], the first K
    hits as flat indices into the (S, D*T*B) query space, their global
    padded slab positions, the hit count, and each shard's degenerate-lane
    rows. `shards.pos_to_j` decodes a padded position to a baby index
    (None: a sentinel)."""
    D = mesh.size
    B, S, K = cfg.lanes, cfg.steps, cfg.max_hits
    Ll = n_targets * B
    chunks = probe_chunks_for(D * S * Ll, shards.maxlen)
    negadv = ecc.ec_neg(ecc.ec_mul(D * B * cfg.stride))   # global advance

    def local_walk(i, X, Y, Z):
        with span("bsgs.giant_scan"):
            Xo, Yo, Zo, xs, zs, dg = jacwalk.giant_scan(
                X, Y, Z, negadv[0], negadv[1], S)
        with span("bsgs.to_affine"):
            xa = jacwalk.to_affine_x(xs, zs)                # (8, S*Ll)
        with span("bsgs.topk"):
            flags = match.first_set(dg, degen_slots)
            flags = torch.where(flags >= 0, flags + (mesh.first + i) * Ll, -1)
        return (Xo, Yo, Zo), torch.stack([xa[7], xa[6]]), flags

    def local_probe(i, w0, w1):
        dev = mesh.devices[i]
        w0, w1 = w0.to(dev), w1.to(dev)
        hits, poss = [], []
        with span("bsgs.probe"):
            for a, b in zip(w0.chunk(chunks), w1.chunk(chunks)):
                h, p = match.probe_buckets_packed_ranged(
                    shards.slabs[i], a, b, shards.shift, shards.bases[i])
                hits.append(h)
                poss.append(p)
        hit = torch.cat(hits)
        return torch.stack([hit.to(torch.int64),
                            torch.where(hit, torch.cat(poss) + 1, 0)])

    def run(Xs, Ys, Zs):
        walked = [local_walk(i, *xyz) for i, xyz in enumerate(zip(Xs, Ys, Zs))]
        with span("bsgs.all_gather"):
            q = mesh.all_gather([w[1] for w in walked])     # (D, 2, S*Ll)
            q = q.reshape(D, 2, S, Ll).permute(1, 2, 0, 3).reshape(2, -1)
        probed = [local_probe(i, q[0], q[1]) for i in range(mesh.local)]
        with span("bsgs.psum"):
            hit, pos = mesh.psum(probed)                     # one reduce
        with span("bsgs.topk"):
            lanes, possel, count = match.topk_with_payload(hit > 0, pos, K)
            jsel = torch.where(lanes >= 0, possel - 1, 0)
            flags = mesh.all_gather([w[2] for w in walked])  # (D, S, slots)
            payload = torch.cat([lanes, jsel, count, flags.reshape(-1)])
        return ([w[0][0] for w in walked], [w[0][1] for w in walked],
                [w[0][2] for w in walked], payload)

    return run
