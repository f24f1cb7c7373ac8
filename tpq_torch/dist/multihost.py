"""Multi-process wiring and the process-group mesh (port of
tpq/dist/multihost.py).

`init()` reads the same TPQ_COORDINATOR / TPQ_NUM_PROCESSES /
TPQ_PROCESS_ID contract as tpq's and calls
torch.distributed.init_process_group: NCCL for CUDA, gloo for the CPU.
Nothing tells a program of its cluster, so without a coordinator (or a
store) it stays a single-process run and returns False.

ProcessGroupMesh has LocalMesh's interface (mesh.py) with one shard per
rank: every list a collective takes or returns holds this rank's shard
alone. The collectives map as follows:
  * dense all_to_all -> all_to_all_single;
  * ragged all_to_all -> all_to_all_single with split sizes;
  * ring hop -> batched isend/irecv;
  * all_gather -> all_gather; psum / pmax -> all_reduce.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None,
         device="cuda", store=None) -> bool:
    """Initialize torch.distributed from the arguments or the TPQ_*
    environment variables (coordinator "host:port"); `store` (a
    torch.distributed Store) replaces the coordinator. Returns True if a
    process group was initialized, False for the single-process no-op."""
    coordinator_address = coordinator_address or os.environ.get("TPQ_COORDINATOR")
    if num_processes is None and "TPQ_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TPQ_NUM_PROCESSES"])
    if process_id is None and "TPQ_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TPQ_PROCESS_ID"])
    if coordinator_address is None and store is None:
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    where = ({"store": store} if store is not None
             else {"init_method": f"tcp://{coordinator_address}"})
    dist.init_process_group(backend, world_size=num_processes, rank=process_id,
                            **where)
    return True


class ProcessGroupMesh:
    """One shard per rank of the default process group, on `device` (by
    default the rank's card under NCCL, else the CPU). A join on it runs
    eagerly (`programs` None): the ragged exchange reads its split sizes
    on the host, which no CUDA graph can hold."""

    programs = None

    def __init__(self, device=None):
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.shard_ids = [self.rank]
        if device is None:
            nccl = dist.get_backend() == "nccl"
            device = (f"cuda:{self.rank % torch.cuda.device_count()}" if nccl
                      else "cpu")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def all_to_all(self, xs):
        (x,) = xs
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous())
        return [out]

    def ragged_all_to_all(self, cols, send_counts, m, out_len):
        (mine,), (sc,) = cols, send_counts
        recv = self.all_to_all([sc])[0]
        send_l, recv_l = sc.tolist(), recv.tolist()  # split sizes: a host sync
        total = sum(recv_l)
        out = []
        for c in mine:
            src = torch.cat([c[j * m:j * m + send_l[j]] for j in range(self.size)])
            buf = c.new_zeros(out_len)
            dist.all_to_all_single(buf[:total], src, recv_l, send_l)
            out.append(buf)
        return [out]

    def all_gather(self, xs):
        (x,) = xs
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous())
        return [torch.cat(parts)]

    def _reduce(self, xs, op):
        (x,) = xs
        y = x.clone()
        dist.all_reduce(y, op=op)
        return [y]

    def psum(self, xs):
        return self._reduce(xs, dist.ReduceOp.SUM)

    def pmax(self, xs):
        return self._reduce(xs, dist.ReduceOp.MAX)

    def ring_shift(self, xs, t):
        (x,) = xs
        n = self.size
        if t % n == 0:
            return [x]
        src = x.reshape(-1).contiguous()  # p2p moves no 0-d tensors
        out = torch.empty_like(src)
        peer_to, peer_from = (self.rank - t) % n, (self.rank + t) % n
        ops = [dist.P2POp(dist.isend, src, peer_to),
               dist.P2POp(dist.irecv, out, peer_from)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [out.view_as(x)]
