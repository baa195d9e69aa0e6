"""BSGS over a mesh: the baby table sharded across the shards' memory,
giant-step queries all-gathered, membership combined with a psum.

Counterpart of keyhunt_tpu/parallel/bsgs_sharded.py. The k-factor (a
bigger baby table, fewer giant steps) becomes the shards' aggregate
memory: D cards hold a table D times larger than one.

Per dispatch (D global shards, T targets, B lanes per target per shard,
Ll = T*B lanes a shard, S steps):
- table: the packed bucket slab cut by bucket index into D equal pieces,
  shard d holding rows [d*per, (d+1)*per) (`BabyTable.resident` with the
  mesh's layout; with table partitions, piece p of every shard's range);
- lanes: each shard walks its (8, Ll) Jacobian lanes with K4 and the
  global advance (D*B*stride)*G, then converts its S*Ll emitted points
  with one deferred K3/K2/K1 affine conversion (`jacwalk.giant_walk_fn`);
- one all-gather ships every shard's (2, S*Ll) X fragments; the flat query
  index is g = (s*D + d)*Ll + l, step-major then shard-major;
- every shard probes all D*S*Ll queries against its own slab piece
  (`match.probe_buckets_packed` at the piece's first bucket row); a
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

import torch

from ..ops import jacwalk, match
from ..search.table import Resident
from ..trace import span
from .mesh import Mesh


def make_sharded_giant_step(cfg, resident: Resident, mesh: Mesh,
                            n_targets: int, degen_slots: int):
    """The giant step over the mesh (keyhunt_tpu's
    `make_sharded_giant_step`) of a `BsgsConfig` `cfg`, on the pass's
    slab pieces `resident` (one per local shard): run(Xs, Ys, Zs) ->
    (Xs', Ys', Zs', payload). Xs/Ys/Zs: one (8, T*B) Jacobian lane tensor
    per local shard (shard d owns global lanes [d*T*B, (d+1)*T*B), the
    shard-major (d, t, b) layout of `BsgsEngine._seed`). payload, on the
    mesh's home device and the same in every process, has the one-device
    layout: [lanes(K) | jsel(K) | count(1) | flags(D*S*degen_slots)], the
    first K hits as flat indices into the (S, D*T*B) query space, their
    global padded slab positions, the hit count, and each shard's
    degenerate-lane rows. `resident.pos_to_j` decodes a padded position to
    a baby index (None: a sentinel)."""
    D = mesh.size
    B, S, K = cfg.lanes, cfg.steps, cfg.max_hits
    Ll = n_targets * B
    walk = jacwalk.giant_walk_fn(D * B * cfg.stride, S)     # global advance

    def local_walk(i, X, Y, Z):
        Xo, Yo, Zo, xa, dg = walk(X, Y, Z)                   # xa (8, S*Ll)
        with span("bsgs.topk"):
            flags = match.first_set(dg, degen_slots)
            flags = torch.where(flags >= 0, flags + (mesh.first + i) * Ll, -1)
        return (Xo, Yo, Zo), torch.stack([xa[7], xa[6]]), flags

    def local_probe(i, w0, w1):
        dev = mesh.devices[i]
        w0, w1 = w0.to(dev), w1.to(dev)
        with span("bsgs.probe"):
            hit, pos = match.probe_buckets_packed(
                resident.slabs[i], w0, w1, resident.shift, resident.bases[i])
        return torch.stack([hit.to(torch.int64), torch.where(hit, pos + 1, 0)])
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
