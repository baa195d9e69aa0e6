"""Single-thread latencies of the field arithmetic on the card.

Runs ``csrc/field_latency.cu``: one thread times a dependent chain of each
piece of ``csrc/field.cuh`` with clock64() and reports SM cycles per call
-- the carry-chain product `fe_mul` (K1, K3, K4), the square `fe_sqr`
(K2, K3, K4), the safegcd inversion `fe_inv_var` (K3's root), the Fermat
chain `fe_inv`, one batch of 30 divsteps and one (d, e) update. The
kernel runs `reps` times and the last run is kept (the first also loads
the instruction cache). The two inversions must agree.

    python -m keyhunt_tpu_torch.tools.field_latency
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .. import _build
from ..ops import u256

PIECES = ("fe_mul", "fe_sqr", "fe_inv_var", "fe_inv", "divsteps30",
          "update_de30")


def measure(device: torch.device, reps: int = 3) -> dict:
    """SM cycles per call of each piece, and whether the two inversions
    agree."""
    rng = np.random.default_rng(11)
    x = u256.to_torch(rng.integers(0, 1 << 32, size=(8, 2), dtype=np.uint32), device)
    cycles = torch.zeros(len(PIECES), dtype=torch.int64, device=device)
    sink = torch.zeros(24, dtype=torch.int32, device=device)
    fn = _build.entry("field_latency", "kh_field_latency")
    stream = torch.cuda.current_stream(device).cuda_stream
    for _ in range(reps):
        _build.check(fn(x.data_ptr(), cycles.data_ptr(), sink.data_ptr(), stream),
                     "kh_field_latency")
        torch.cuda.synchronize(device)
    back = sink[8:].reshape(8, 2)
    return {"cycles": dict(zip(PIECES, cycles.tolist())),
            "inversions_agree": bool(torch.equal(back[:, 0], back[:, 1]))}


def main() -> int:
    if not torch.cuda.is_available():
        print("[E] the latency probe needs a CUDA GPU", file=sys.stderr)
        return 2
    out = measure(torch.device("cuda", 0))
    print(json.dumps(out))
    return 0 if out["inversions_agree"] else 1


if __name__ == "__main__":
    sys.exit(main())
