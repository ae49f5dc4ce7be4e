"""Channel planes of bucket rows (port of ``make_channels`` from
``meso_tpu/ops/sweep.py``).

The distributed path hands the halo kernels (K4, K6-halo) every per-row
quantity as a plane (ny, nz, K, nx) of the bucket layout. The XLA sweep of
that module (force_path "bucket") is not ported (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import torch


def make_channels(x, v, tag, mask, h, extra: dict, ncell,
                  capacity: int) -> dict:
    """Reshape per-row tensors into plane channels (no halos): x, y, z, vx,
    vy, vz, tag, valid (the mask as float32, as in the JAX package), "h"
    where ``h`` is given (the halo kernels' per-particle hash) and each
    entry of ``extra`` under its own name. The planes are views where the
    input allows it."""
    nx, ny, nz = ncell
    shape = (ny, nz, capacity, nx)
    ch = {"x": x[:, 0].reshape(shape), "y": x[:, 1].reshape(shape),
          "z": x[:, 2].reshape(shape),
          "vx": v[:, 0].reshape(shape), "vy": v[:, 1].reshape(shape),
          "vz": v[:, 2].reshape(shape),
          "tag": tag.reshape(shape),
          "valid": mask.to(torch.float32).reshape(shape)}
    if h is not None:
        ch["h"] = h.reshape(shape)
    for name, arr in extra.items():
        ch[name] = arr.reshape(shape)
    return ch
