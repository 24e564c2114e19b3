"""Measured host<->device link cost (port of tempo_tpu/util/linkcost.py).

The JAX package routes the generator's folds and search to the host
when one round trip costs more than 2 ms. The port takes no host route
yet (every fold runs on the device its caller names); it measures the
round trip so that the crossover can be decided on the card, and
chip_smoke.py logs it.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..ops.device import resolve_device

# device -> best round trip in ms, measured once per process: the link
# does not change while the process runs
_RTT_MS: dict[str, float] = {}
_rtt_lock = threading.Lock()


def link_rtt_ms(device=None) -> float:
    """One tiny put + compute + fetch round trip (8 int32, +1), best of 3,
    in ms; measured at first use on `device` (None: the first card) and
    cached. The lock keeps concurrent first callers from racing
    duplicate probes."""
    dev = resolve_device(device)
    key = str(dev)
    with _rtt_lock:
        if key not in _RTT_MS:
            probe = np.zeros(8, np.int32)
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                (torch.from_numpy(probe).to(dev) + 1).cpu().numpy()
                best = min(best, time.perf_counter() - t0)
            _RTT_MS[key] = best * 1e3
        return _RTT_MS[key]
