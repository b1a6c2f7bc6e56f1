"""One process of a multi-process `torch.distributed` sharded encode with
the PyTorch port (the counterpart of tools/multihost_worker.py).

Run several of these with the same coordinator address
(tests/test_torch_distributed.py runs two). Each process:

1. joins the process group through `distributed.mesh.init_multihost` (the
   gloo backend over tcp://<coordinator>),
2. builds a mesh of its LOCAL device slots and calls
   `encode_batch_sharded` on the whole batch: it encodes its own share of
   the images (rank, rank + world, ...) and receives the other ranks'
   containers,
3. checks that every container it holds, its own and the received ones,
   is byte-identical to the single-device `encode_image` output, and
   decodes its own.

Usage: python tools/multihost_worker_torch.py <coordinator> <num_procs> <pid> <device>
Prints "MULTIHOST_OK pid=<pid> imgs=<n>" on success (n: images this
process encoded).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LOCAL_SLOTS = 2
H, W = 64, 64


def main():
    if len(sys.argv) != 5:
        sys.exit(__doc__)
    coordinator, num_procs, pid, device = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]

    from dataclasses import replace

    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)

    from jxl_tpu_torch.codec.config import CodecConfig
    from jxl_tpu_torch.codec.decode import decode_bytes
    from jxl_tpu_torch.codec.encode import encode_image
    from jxl_tpu_torch.distributed.mesh import init_multihost, make_mesh
    from jxl_tpu_torch.distributed.sharded import encode_batch_sharded

    init_multihost(coordinator_address=coordinator, num_processes=num_procs, process_id=pid)
    assert dist.is_initialized() and dist.get_world_size() == num_procs and dist.get_rank() == pid
    init_multihost(coordinator_address=coordinator, num_processes=num_procs, process_id=pid)  # idempotent

    def synth(seed):
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        lum = np.clip(0.5 + 0.3 * np.sin(xx / 19.0) * np.cos(yy / 13.0) + rng.normal(0, 0.03, (H, W)), 0, 1)
        return (np.stack([lum, lum * 0.9, lum * 0.8], axis=-1) * 255).astype(np.uint8)

    n_global = num_procs * LOCAL_SLOTS
    imgs = [synth(100 + i) for i in range(n_global)]
    dists = [1.0 + 0.5 * (i % 2) for i in range(n_global)]
    cfg = CodecConfig(distance=1.0, effort=7)

    mesh = make_mesh([device] * LOCAL_SLOTS)
    blobs = encode_batch_sharded(imgs, cfg, distances=dists, mesh=mesh)
    assert len(blobs) == n_global
    n_own = 0
    for i, blob in enumerate(blobs):
        ref = encode_image(imgs[i], replace(cfg, distance=dists[i], modular=False), device=device)
        assert blob == ref, f"pid={pid} img={i}: container != single-device"
        if i % num_procs == pid:
            out = decode_bytes(blob, device=device)
            mse = ((out.astype(np.float64) - imgs[i].astype(np.float64)) ** 2).mean()
            assert 10 * np.log10(255.0**2 / mse) > 25.0
            n_own += 1
    assert n_own == LOCAL_SLOTS, n_own
    dist.barrier()
    dist.destroy_process_group()
    print(f"MULTIHOST_OK pid={pid} imgs={n_own}", flush=True)


if __name__ == "__main__":
    main()
