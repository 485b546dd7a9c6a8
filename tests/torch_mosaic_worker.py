"""Ranks of the port's mosaic on gloo, for tests/test_torch_mosaic.py:
``python tests/torch_mosaic_worker.py PORT WORLD DIR`` spawns WORLD ranks
(torch.multiprocessing) that encode DIR/data.npy with DIR/mask.npy over a
``make_mesh`` of the default group and decode the container with the mesh;
rank r writes DIR/container{r}.bin and DIR/decode{r}.npy."""
import sys

import numpy as np
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, port: int, world: int, out: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank)
    try:
        from lerc_tpu_torch.parallel import sharding

        mesh = sharding.make_mesh(world)
        data, mask = np.load(f"{out}/data.npy"), np.load(f"{out}/mask.npy")
        blob = sharding.MosaicEncoder(mesh, 32, 32, np.float32).encode(data, mask, 0.001)
        with open(f"{out}/container{rank}.bin", "wb") as f:
            f.write(blob)
        np.save(f"{out}/decode{rank}.npy", sharding.decode_mosaic_device(blob, mesh))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    port, world, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    mp.spawn(_rank, args=(port, world, out), nprocs=world, join=True)
