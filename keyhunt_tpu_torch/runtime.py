"""Multi-process runtime: the process group, named barriers, uploads.

Counterpart of keyhunt_tpu/runtime.py. `setup(coordinator=...,
num_processes=..., process_id=...)` (or the KEYHUNT_TPU_COORDINATOR /
_NUM_PROCESSES / _PROCESS_ID environment variables) starts a
`torch.distributed` process group, so one mesh (`parallel.mesh`) spans the
shards of every process: the replacement for the reference's TCP daemon
and host fan-out client (`bsgsd_client.py:284-404`). The backend is NCCL
when the processes search on CUDA devices and gloo on the CPU; gloo may be
asked for on CUDA too (two processes on one card, which NCCL refuses).

keyhunt_tpu's `setup` also turns on XLA's persistent compilation cache.
PyTorch has no counterpart: the port's kernels are built by nvcc at first
use into `build/` (`_build.py`), which is its cache.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .device import to_device

#: host -> device upload; keyhunt_tpu's chunked `fast_put` is one copy here
fast_put = to_device

#: how long a process waits at the rendezvous, a collective or a barrier
#: for the others (a cold start builds the kernels with nvcc: tens of s)
TIMEOUT = datetime.timedelta(hours=1)


class Runtime:
    """The process group of a multi-process run and the store its named
    barriers ride on."""

    def __init__(self, store: dist.Store, rank: int, world: int, backend: str):
        self.store, self.rank, self.world, self.backend = store, rank, world, backend
        self.barriers = 0


_RT: Runtime | None = None


def setup(coordinator: str | None = None, num_processes: int | None = None,
          process_id: int | None = None, device: str | torch.device = "cuda",
          backend: str | None = None) -> Runtime | None:
    """Start the process group when a coordinator HOST:PORT is given (by
    argument or environment); process 0 listens on it. Idempotent; returns
    the runtime, or None for a single-process run."""
    global _RT
    if _RT is not None:
        return _RT
    coordinator = coordinator or os.environ.get("KEYHUNT_TPU_COORDINATOR")
    if not coordinator:
        return None
    if num_processes is None:
        num_processes = int(os.environ["KEYHUNT_TPU_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["KEYHUNT_TPU_PROCESS_ID"])
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..{num_processes - 1}")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    host, _, port = coordinator.rpartition(":")
    store = dist.TCPStore(host or "127.0.0.1", int(port), num_processes,
                          is_master=process_id == 0, timeout=TIMEOUT)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)
    _RT = Runtime(store, process_id, num_processes, backend)
    return _RT


def current() -> Runtime | None:
    """The runtime `setup` started, or None."""
    return _RT


def shutdown() -> None:
    """Leave the process group (a no-op for a single-process run)."""
    global _RT
    if _RT is not None:
        dist.destroy_process_group()
        _RT = None


def sync(name: str) -> None:
    """Rendezvous every process at the named barrier `name` (no-op when
    single-process). It rides the process group's TCP store, not a
    collective, so it tolerates any skew before a process's first
    collective: the nvcc build of the kernels at first use takes tens of
    seconds on one process and nothing on a warm one. Barrier keys are
    sequence-numbered, so every process makes the same sync() calls in the
    same order (the engines run the same deterministic path)."""
    rt = _RT
    if rt is None or rt.world == 1:
        return
    key = f"keyhunt:{name}:{rt.barriers}"
    rt.barriers += 1
    rt.store.set(f"{key}:{rt.rank}", "1")
    rt.store.wait([f"{key}:{r}" for r in range(rt.world)], TIMEOUT)
