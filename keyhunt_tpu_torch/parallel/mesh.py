"""The shard mesh, its two collectives, and the sharded key-range walker.

Counterpart of keyhunt_tpu/parallel/mesh.py. keyhunt_tpu runs one SPMD
program over a `jax.sharding.Mesh` with `shard_map`; here a `Mesh` is an
explicit ordered list of this process's shard devices plus, when
`runtime.setup` started a process group, that group. The global shard
count is local shards x processes, and global shard d = rank*local + i.
Each shard runs the one-device step on its own lanes; the two collectives
keyhunt_tpu uses are methods of the mesh:

- `all_gather`: within a process, copies to the first shard's device (peer
  copies between GPUs); across processes, `dist.all_gather_into_tensor`
  (NCCL) or `dist.all_gather` (gloo);
- `psum`: the same, with `dist.all_reduce`.

gloo takes the CUDA tensors these collectives send as they are (it
copies them through host memory itself; two processes x 2 shards of one
H100 found each other's keys over gloo, `tools.multiproc`), so two
processes can share one card over gloo, which NCCL refuses.

A mesh never falls back: asking for more CUDA shards than there are
visible devices raises. Repeated devices are asked for explicitly
(`make_mesh(devices=[cuda:0]*4)`, or eight `cpu` shards): they check the
sharded paths on one card or on the CPU, as keyhunt_tpu's 8-device virtual
CPU mesh does.

The walker (`make_sharded_step_fn`, keyhunt_tpu's `make_sharded_step_fn`,
:63-127): the target slabs are replicated; shard d holds global pivots
g = d*A .. d*A + A-1, the offset table is strided by the global pivot
count D*A, and inner step s covers keys
k0 + (s*D*A*W + (j+1)*D*A + g + 1 - D*A)*stride, so every inner step
advances all pivots by the global batch and chained calls stay contiguous
without reseeding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import runtime
from ..device import resolve_device, to_device
from ..ops import curve
from ..search.walker import WalkerConfig, make_step_fn


class Mesh:
    """`devices`: this process's shard devices, in shard order (repeats
    allowed); `rt`: the multi-process runtime, or None."""

    def __init__(self, devices: list[torch.device],
                 rt: runtime.Runtime | None = None):
        if not devices:
            raise ValueError("a mesh needs at least one shard")
        self.devices = list(devices)
        self.rt = rt
        self.rank = rt.rank if rt else 0
        self.world = rt.world if rt else 1

    @property
    def local(self) -> int:
        return len(self.devices)

    @property
    def size(self) -> int:
        """The global shard count D."""
        return self.local * self.world

    @property
    def first(self) -> int:
        """Global index of this process's first shard."""
        return self.rank * self.local

    @property
    def home(self) -> torch.device:
        """Where collective results land: the first shard's device."""
        return self.devices[0]

    def replicate(self, arr: np.ndarray) -> list[torch.Tensor]:
        """One copy of a host array per shard, shared by the shards of one
        device."""
        per_dev = {d: to_device(arr, d) for d in dict.fromkeys(self.devices)}
        return [per_dev[d] for d in self.devices]

    def all_gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """(D, *shape) on `home`: every shard's `parts` entry (one per local
        shard, equal shapes), in global shard order."""
        local = torch.stack([p.to(self.home) for p in parts])
        if self.world == 1:
            return local
        if self.rt.backend == "gloo":
            outs = [torch.empty_like(local) for _ in range(self.world)]
            dist.all_gather(outs, local)
            return torch.cat(outs)
        out = local.new_empty((self.world * local.shape[0],) + local.shape[1:])
        dist.all_gather_into_tensor(out, local)
        return out

    def psum(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The sum over all shards of `parts` (one per local shard), on
        `home`."""
        total = parts[0].to(self.home)
        for p in parts[1:]:
            total = total + p.to(self.home)
        if self.world == 1:
            return total
        total = total.contiguous()
        dist.all_reduce(total)
        return total


def make_mesh(n_devices: int | None = None, device: str | torch.device = "cuda",
              devices: list | None = None) -> Mesh:
    """The mesh of this process: `devices` as given, or the first
    `n_devices` CUDA devices (default all visible), or `n_devices` shards
    on the CPU (default 1). Joins the process group of `runtime.setup` when
    there is one; every process must then hold the same shard count."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
    else:
        dev = resolve_device(device)
        if dev.type == "cuda":
            have = torch.cuda.device_count()
            n = have if n_devices is None else n_devices
            if not 1 <= n <= have:
                raise ValueError(f"--devices {n}: {have} CUDA device(s) visible")
            devs = [torch.device("cuda", i) for i in range(n)]
        else:
            n = 1 if n_devices is None else n_devices
            if n < 1:
                raise ValueError(f"--devices {n}: need at least one shard")
            devs = [dev] * n
    rt = runtime.current()
    if rt is not None and rt.world > 1:
        key = f"keyhunt:mesh:{rt.barriers}"
        rt.barriers += 1
        rt.store.set(f"{key}:{rt.rank}", str(len(devs)))
        counts = [int(rt.store.get(f"{key}:{r}")) for r in range(rt.world)]
        if len(set(counts)) != 1:
            raise ValueError(f"processes hold different shard counts: {counts}")
    return Mesh(devs, rt)


def as_mesh(devices, device: str | torch.device) -> Mesh | None:
    """An engine's `devices` argument -> its mesh, or None for the
    one-device path: a Mesh is kept, an int (or None) is a shard count for
    `make_mesh`. One shard in a single-process run is the one-device path."""
    if isinstance(devices, Mesh):
        mesh = devices
    elif (devices or 1) == 1 and runtime.current() is None:
        return None
    else:
        mesh = make_mesh(devices or 1, device)
    return mesh if mesh.size > 1 else None


def make_sharded_step_fn(cfg: WalkerConfig, slab0, slab1, mesh: Mesh,
                         shift: int):
    """The sharded walker dispatch: run(pxs, pys) -> (pxs', pys', packed,
    total). pxs/pys: one (8, A) pivot tensor per local shard; slab0/slab1:
    the targets' two-word bucket slabs, host arrays (replicated onto the
    shards) or one tensor per local shard. packed: (D*S, K+1) int32, the
    hit rows of every shard, shard-major (row d*S + s), so every process
    holds all of them; total: the hit count summed over all shards, a (1,)
    tensor."""
    if isinstance(slab0, np.ndarray):
        slab0, slab1 = mesh.replicate(slab0), mesh.replicate(slab1)
    steps = {d: make_step_fn(cfg, shift, d, advance_mult=mesh.size)
             for d in dict.fromkeys(mesh.devices)}

    def run(pxs, pys):
        outs = [steps[d](px, py, s0, s1) for d, px, py, s0, s1
                in zip(mesh.devices, pxs, pys, slab0, slab1)]
        packed = mesh.all_gather([o[2] for o in outs])
        packed = packed.reshape(-1, packed.shape[-1])
        return ([o[0] for o in outs], [o[1] for o in outs], packed,
                packed[:, -1].sum().reshape(1))

    return run


def seed_pivots_sharded(cfg: WalkerConfig, k0: int, n_devices: int):
    """Host: (8, D*A) pivot arrays; global pivot g = d*A + a sits at key
    k0 + (g + 1 - D*A)*stride (the interleaved-lane layout)."""
    ntot = n_devices * cfg.pivots
    return curve.points_for_keys([k0 + (g + 1 - ntot) * cfg.stride
                                  for g in range(ntot)])


def decode_sharded_hit(cfg: WalkerConfig, k0: int, device: int, step_idx: int,
                       flat_idx: int, n_devices: int):
    """A (shard, step, flat) hit -> (variant, key): the candidate space is
    (V, A, W) per shard per step; global pivot g = d*A + a."""
    aw = cfg.batch
    A, W = cfg.pivots, cfg.width
    ntot = n_devices * A
    v = flat_idx // aw
    a, j = divmod(flat_idx % aw, W)
    g = device * A + a
    key = k0 + (step_idx * n_devices * aw + (j + 1) * ntot
                + g + 1 - ntot) * cfg.stride
    return cfg.variants[v], key
