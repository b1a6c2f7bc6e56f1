"""Sharded batch encode: the multi-device execution path (port of
`jxl_tpu/distributed/sharded.py`).

The reference runs a batch as one compiled program over a ("data",
"space") mesh and parses each image's packed buffer into a container. The
port keeps the contract (one `.jxt` container per image, byte-identical
to the sequential `encode_image` / `encode_image_grid` with
`modular=False`) and states the distribution in PyTorch's terms:

- image i of the batch runs on the device of mesh row i % data, as the
  whole per-image encode (`codec.encode.encode_image[_grid]`), so the
  bytes are the sequential path's by construction;
- the images run one after another in input order, each on its mesh
  row's device; nothing runs concurrently inside one process;
- in a `torch.distributed` process group (`mesh.init_multihost`) rank r
  encodes images r, r + world, ... and the ranks exchange container bytes
  (`all_gather_object`), so every rank returns every container.

To gain speed from several cards, run one process per card (the process
group), each with a mesh of its own card: the encode is bound by its host
thread, and threads of one interpreter take turns at it. On four NVIDIA
H100 80GB HBM3 (700 W) `probes/mesh_devices.py` encodes 8 images of
2048x3072 in 0.65-0.82 s on one card, in 0.32-0.34 s as four processes,
and in 1.5-2.4 s with one host thread per card in one process, which is
why the port has no such threads.

The encode of ONE image is not split over "space": PyTorch has no
counterpart of the compiler that inserts the cross-shard prefix sums and
histogram reductions for the reference, and the reference's source has no
hand-written form of them to port. The axis keeps its width check here
and does real work in `sharded_epf`, the decoder-side filter with an
explicit halo exchange between the devices of one mesh row. The
reference's `make_sharded_*_step` factories return compiled programs over
packed buffers, which the port does not have; they have no counterpart.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

from jxl_tpu_torch.codec.config import CodecConfig
from jxl_tpu_torch.transforms.epf import epf_filter_ext, epf_sigma


def _group():
    """(rank, world size) of the process group, (0, 1) outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _map_over_mesh(n: int, mesh, fn) -> list:
    """[fn(i, device) for i in range(n)], each item on its mesh row's
    device, in order; across a process group each rank computes items
    rank, rank + world, ... and all ranks return all results (which must
    pickle)."""
    rank, world = _group()
    n_data = int(mesh.shape["data"])
    mine = {i: fn(i, mesh.devices[k % n_data, 0]) for k, i in enumerate(range(rank, n, world))}
    if world > 1:
        import torch.distributed as dist

        parts = [None] * world
        dist.all_gather_object(parts, mine)
        mine = {i: v for part in parts for i, v in part.items()}
    return [mine[i] for i in range(n)]


def _batch_checks(images, mesh, what: str):
    if mesh is None:
        raise ValueError(f"{what} needs an explicit mesh (distributed.mesh.make_mesh(devices, ...))")
    batch = [np.asarray(im) for im in images]
    if any(im.shape != batch[0].shape for im in batch):
        raise ValueError(f"{what} takes images of one geometry")
    w, n_space = int(batch[0].shape[1]), int(mesh.shape["space"])
    assert w % n_space == 0, f"width {w} must divide over the space axis ({n_space})"
    return batch


def encode_batch_sharded(images, config: CodecConfig, distances=None, mesh=None, orig_names=None) -> list[bytes]:
    """Encode a batch of same-geometry images across the mesh; returns one
    `.jxt` container per image, byte-identical to `encode_image`'s output
    under `modular=False`.

    images: list of [H, W, 3] u8 arrays (or one [B, H, W, 3] array).
    distances: per-image distances (default: config.distance for all),
    floored at 0.05. The width must divide evenly over the "space" axis.
    This path always codes VarDCT: the per-image VarDCT-vs-modular pick
    is not part of it (the same contract as the striped path), and d = 0
    comes out at d = 0.05, not lossless."""
    from jxl_tpu_torch.codec.encode import encode_image

    batch = _batch_checks(images, mesh, "encode_batch_sharded")
    b = len(batch)
    if distances is None:
        distances = [config.distance] * b
    distances = [max(float(d), 0.05) for d in distances]
    assert len(distances) == b
    if orig_names is None:
        orig_names = [""] * b
    config = replace(config, modular=False)

    def one(i, dev):
        return encode_image(batch[i], replace(config, distance=distances[i]), orig_names[i], device=dev)

    return _map_over_mesh(b, mesh, one)


def encode_grid_sharded(images, config: CodecConfig, distances, mesh=None, orig_names=None) -> list[list[bytes]]:
    """Encode a batch of same-geometry images at every distance of an RD
    sweep row across the mesh. Returns containers[img][dist],
    byte-identical to per-image `encode_image_grid` output under
    `modular=False` (distances floored at 0.05)."""
    from jxl_tpu_torch.codec.encode import encode_image_grid

    batch = _batch_checks(images, mesh, "encode_grid_sharded")
    dists = [max(float(d), 0.05) for d in distances]
    if orig_names is None:
        orig_names = [""] * len(batch)
    config = replace(config, modular=False)

    def one(i, dev):
        return encode_image_grid(batch[i], config, dists, orig_names[i], device=dev)

    return _map_over_mesh(len(batch), mesh, one)


def sharded_epf(planes: torch.Tensor, eff_mul: torch.Tensor, distance, mesh) -> torch.Tensor:
    """EPF over a width-sharded image with an explicit halo exchange.

    The image's columns are split into one shard per device of the mesh's
    first row ("space" axis). The cross-shaped kernel needs one column of
    its neighbour on either side: each shard receives its left neighbour's
    last column and its right neighbour's first one by explicit copies
    between the devices; the two global borders replicate their own edge
    (no ring wrap), and rows are padded by replication.

    planes: [3, H, W] (W divisible by 8 * the mesh's "space" size),
    eff_mul: [nby, nbx]. Returns the filtered [3, H, W] on the first
    shard's device, equal to `transforms.epf.epf_apply` (every pixel sees
    the same neighbours and the same arithmetic)."""
    h, w = planes.shape[-2:]
    devs = list(mesh.devices[0, :])
    n_space = len(devs)
    assert w % (8 * n_space) == 0, "width must split into whole block columns"
    sig = epf_sigma(eff_mul, distance, h, w)
    ws = w // n_space
    local = [planes[:, :, s * ws : (s + 1) * ws].to(d) for s, d in enumerate(devs)]
    sig_local = [sig[:, s * ws : (s + 1) * ws].to(d) for s, d in enumerate(devs)]
    out = []
    for s, d in enumerate(devs):
        from_left = local[s - 1][:, :, -1:].to(d) if s > 0 else local[s][:, :, :1]
        from_right = local[s + 1][:, :, :1].to(d) if s < n_space - 1 else local[s][:, :, -1:]
        ext = torch.cat([from_left, local[s], from_right], dim=-1)
        ext = F.pad(ext[None], (0, 0, 1, 1), mode="replicate")[0]
        out.append(epf_filter_ext(ext, sig_local[s]).to(devs[0]))
    return torch.cat(out, dim=-1)
