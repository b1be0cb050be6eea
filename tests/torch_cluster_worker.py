"""One rank of the two-rank gloo drill of ``tests/test_torch_observability.py``.

``python tests/torch_cluster_worker.py <rank> <world> <port> <trace_dir>``:
joins a gloo group at ``tcp://127.0.0.1:<port>``, runs three cluster
beats over the real ``all_gather`` (rank 1 reporting 0.9 s steps, the
others 0.1 s: no sleep), exports the span trace (ranks other than 0 first,
then a barrier, then rank 0's merge, so nothing polls), then posts one
desynced beat, and prints one JSON line. Imports torch and the port only.
"""

import json
import os
import sys

import torch.distributed as dist

from trlx_tpu_torch.observability import ClusterDesyncError, Observability


def main(rank: int, world: int, port: int, trace_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        obs = Observability(trace_dir=trace_dir)
        obs.cluster.straggler_patience = 2
        stragglers = []
        for step in range(3):
            with obs.span("train_step", step=step):
                pass
            obs.cluster.note_step(0.9 if rank == 1 else 0.1, tokens_per_sec=100.0,
                                  device_bytes=1e6)
            obs.cluster.beat(False, step=step)
            stragglers.append(obs.cluster.straggler_rank)
        snapshot = obs.metrics.snapshot()
        if rank != 0:
            exported = obs.export()
        dist.barrier()
        if rank == 0:
            exported = obs.export()
        desync = ""
        try:
            obs.cluster.beat(False, step=10 + rank)
        except ClusterDesyncError as e:
            desync = str(e)
        print(json.dumps({"rank": rank, "straggler_by_beat": stragglers,
                          "snapshot": snapshot, "exported": exported, "desync": desync}))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
