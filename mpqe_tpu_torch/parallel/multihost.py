"""Several processes over ``torch.distributed`` (counterpart of
``mpqe_tpu/parallel/multihost.py``).

Each process runs the same program: :func:`initialize` joins them into
one process group, each builds its own mesh over its own devices, and
the data-parallel step (``parallel/spmd.py``) sums the count of real
queries, the gradients and the loss across the group, so every process
takes one process's step over the global batch (the concatenation of the
processes' slices, in process order) and the parameters stay equal.

``host_local_batch`` puts this process's slice of a global batch on its
mesh's data devices.  The halo layers and K8 keep their parts in one
process (their collectives are the one controller's copies); spreading
them over processes needs a machine with several cards.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, List, Optional

from mpqe_tpu_torch.parallel import sharding as sharding_lib
from mpqe_tpu_torch.parallel.mesh import Mesh

# torchrun's variables, read when no address is given
_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def default_backend(device) -> str:
    """``nccl`` for the card, ``gloo`` for the CPU."""
    import torch

    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: str = "cuda",
               timeout_s: float = 300.0) -> bool:
    """``torch.distributed.init_process_group`` over ``tcp://`` init;
    returns whether a group is (now) up.

    * a no-op when a group already exists;
    * with ``coordinator_address`` (``host:port``) every failure raises:
      a process that cannot reach its peers does not train alone;
    * otherwise the address, rank and size come from the variables
      ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
      ``WORLD_SIZE``), and without them it is a no-op (one process).

    ``backend`` defaults to :func:`default_backend` of ``device`` (NCCL
    takes one card per rank: two processes on one card name ``gloo``,
    whose ``all_reduce`` and ``broadcast``, all the step uses, take CUDA
    tensors)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if coordinator_address is None:
        if not all(k in os.environ for k in _ENV):
            return False
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError("an explicit coordinator_address needs "
                         "num_processes and process_id")
    dist.init_process_group(
        backend=backend or default_backend(device),
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=timedelta(seconds=timeout_s))
    return True


def process_count() -> int:
    """Processes in the default group (1 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def host_local_batch(mesh: Mesh, local_arrays: Dict,
                     data_axis: str = "data") -> Dict[str, List]:
    """This process's slice of a global batch (numpy arrays or tensors,
    its share of the query axis; the per-formula ``edge_rel`` /
    ``edge_norm`` whole) as per-part lists on its mesh's data devices:
    split over them, ``edge_rel`` / ``edge_norm`` on every part."""
    if data_axis != mesh.axis_names[0]:
        raise ValueError(f"data_axis {data_axis!r} is not the mesh's data "
                         f"axis {mesh.axis_names[0]!r}")
    return sharding_lib.shard_dense_batch_arrays(mesh, **local_arrays)
