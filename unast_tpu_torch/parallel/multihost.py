"""The multi-process launch of the port, mirroring
`unast_tpu/parallel/multihost.py`: torch.distributed initialised from
torchrun's environment, one process per device, each reading its own
strided shard of the corpus.

    torchrun --nproc_per_node N -m unast_tpu_torch.train.loop --dp N [--zero 1|3]

JAX initialises its distributed runtime from JAX_COORDINATOR_ADDRESS and
assembles the global batch from each host's rows
(make_array_from_process_local_data). Here each rank keeps its rows: the
sharded train step (parallel/mesh.py) computes the global batch's
losses from them, so global_batch_from_local is the identity. Under a
sequence-parallel axis a rank's rows hold whole sequences too: the model
splits the time axis itself (models/networks.py), after the noise,
SpecAugment and the decoders' right shift, which read whole sequences.
"""

import os
from typing import Optional

import torch
import torch.distributed as dist


def launched() -> bool:
    """Whether this process is one rank of a multi-process launch
    (torchrun's WORLD_SIZE above 1)."""
    return int(os.environ.get("WORLD_SIZE", "1") or 1) > 1


def maybe_initialize_distributed(device: Optional[str] = None):
    """unast_tpu/parallel/multihost.py::maybe_initialize_distributed:
    torch.distributed.init_process_group from torchrun's environment
    (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) when launched
    as one of several processes; a no-op in a single process or when the
    group is up already. The backend is NCCL when the device is CUDA
    (`device`, else CUDA if present), gloo otherwise; under NCCL this rank's
    device becomes cuda:LOCAL_RANK. Must run before the rank touches its
    device. Returns the rank's device ('cuda:LOCAL_RANK' under NCCL), or
    `device` unchanged."""
    if not launched() or dist.is_initialized():
        return device
    cuda = (device or ("cuda" if torch.cuda.is_available() else "cpu")).startswith("cuda")
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device("cuda", local))
        return f"cuda:{local}"
    dist.init_process_group("gloo")
    return device


def shutdown_distributed():
    """Destroy the process group maybe_initialize_distributed made, if any."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This rank (jax.process_index); 0 in a single process."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The ranks (jax.process_count); 1 in a single process."""
    return dist.get_world_size() if dist.is_initialized() else 1


_rank, _ranks = process_index, process_count


class HostShardedDataset:
    """unast_tpu/parallel/multihost.py::HostShardedDataset: a view of a
    dataset restricted to this process's strided shard, so each rank reads
    1/process_count of the corpus."""

    def __init__(self, dataset, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        self.ds = dataset
        self.pi = _rank() if process_index is None else process_index
        self.pc = _ranks() if process_count is None else process_count
        self.idx = list(range(self.pi, len(dataset), self.pc))

    def __len__(self):
        return len(self.idx)

    def __getitem__(self, i):
        return self.ds[self.idx[i]]


def global_batch_from_local(mesh, local_batch, batch_axis: str = "dp"):
    """unast_tpu/parallel/multihost.py::global_batch_from_local: the
    batch the sharded step takes on this rank, which is the rank's own
    rows with their whole sequences (an sp rank's time split is the
    model's), so `local_batch` itself."""
    return local_batch
