"""Device-mesh setup for multi-device encode / decode (port of
`jxl_tpu/distributed/mesh.py`).

The reference states its mesh as `jax` shardings and lets the compiler
insert the collectives. PyTorch has no such partitioner, so the port's
mesh is what it says: a `[data, space]` grid of `torch.device` slots that
`distributed/sharded.py` walks itself.

- axis "data":  corpus-level data parallelism; each slot row encodes
  different images of the batch.
- axis "space": one image's block columns split over the row's slots. The
  encode of one image is not split (see `distributed/sharded.py`); the axis
  keeps the reference's width check and drives `sharded_epf`.

A device may fill several slots: on a one-card machine a mesh is several
slots of `cuda:0`, and on the CPU every slot is `cpu`. Nothing here picks
a device on its own: `make_mesh` takes the list.

Across processes, `init_multihost()` joins a `torch.distributed` group
over the `gloo` backend. Only container bytes and small tensors cross
processes (`encode_batch_sharded` exchanges them with
`all_gather_object`), so `gloo` serves CPU and CUDA runs alike.

Not carried over: `batch_sharding` / `replicated` (sharding annotations
for the compiler) and `local_batch_to_global` (there is no global array to
assemble: each process encodes its own images and the ranks exchange
bytes).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Mesh:
    """A `[data, space]` object array of `torch.device`, read as the
    reference's call sites read a jax Mesh: `mesh.devices`,
    `mesh.axis_names`, `mesh.shape["data"]`, `mesh.shape["space"]`."""

    devices: np.ndarray
    axis_names: tuple = ("data", "space")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def init_multihost(
    coordinator_address: str | None = None, num_processes: int | None = None, process_id: int | None = None, **kwargs
) -> None:
    """Join (or form) a multi-process `torch.distributed` group (`gloo`
    backend, rendezvous at tcp://<coordinator_address>).

    Idempotent. With no coordinator a single process logs and runs
    standalone, so callers can use it unconditionally; when `num_processes`
    says there are several, the failure is raised."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    try:
        if coordinator_address is None:
            raise ValueError("no coordinator address given")
        dist.init_process_group(
            backend="gloo",
            init_method=f"tcp://{coordinator_address}",
            world_size=1 if num_processes is None else num_processes,
            rank=0 if process_id is None else process_id,
            **kwargs,
        )
    except (ValueError, RuntimeError) as e:
        if num_processes not in (None, 1):
            raise
        logging.getLogger(__name__).info("torch.distributed group not formed (%s); single-process run", e)


def make_mesh(devices, n_devices: int | None = None, data: int | None = None, space: int | None = None) -> Mesh:
    """Build a ("data", "space") mesh over the first n_devices entries of
    `devices` (torch devices or their names; an entry may repeat).

    Defaults: all slots on the data axis (pure corpus data parallelism),
    space=1."""
    devs = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    if data is None and space is None:
        data, space = n_devices, 1
    elif data is None:
        data = n_devices // space
    elif space is None:
        space = n_devices // data
    assert data * space == n_devices == len(devs), (data, space, n_devices, len(devs))
    arr = np.empty(n_devices, dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(data, space))
