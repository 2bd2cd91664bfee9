"""The port's psum: sums and gathers over ``Shards`` in one process.

The JAX package lets GSPMD insert psum / all-gather collectives from its
sharding annotations. Here the sharded loops call these by hand:

* ``sum_shards``: per-shard partials copied to the first shard's device and
  added in shard order, (p0 + p1) + p2 + ...; the result has the same bits
  on every run and for every placement of the same partials on devices.
* ``broadcast``: a replicated tensor on every shard's device (the same
  tensor where the device is its own).
* ``gather_shards``: the real rows of a ``Shards`` concatenated on its first
  device.

No NCCL is needed: the copies are plain device-to-device ``Tensor.to``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from cnmf_tpu_torch.parallel.mesh import Shards


def sum_shards(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Σ of same-shaped partials in shard order, on the first partial's
    device."""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev)
    return total


def broadcast(t: torch.Tensor, devices: Sequence) -> List[torch.Tensor]:
    """``t`` on each of ``devices``."""
    return [t.to(d) for d in devices]


def gather_shards(sh: Shards) -> torch.Tensor:
    """The real rows of ``sh`` as one tensor on its first device."""
    dev = sh.device
    whole = torch.cat([p.to(dev) for p in sh.parts], dim=sh.axis)
    return whole.narrow(sh.axis, 0, sh.n_rows)
