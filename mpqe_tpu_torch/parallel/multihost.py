"""Several processes over ``torch.distributed`` (counterpart of
``mpqe_tpu/parallel/multihost.py``).

Each process runs the same program: :func:`initialize` joins them into
one process group, each builds its own mesh over its own devices, and
the data-parallel step (``parallel/spmd.py``) sums the count of real
queries, the gradients and the loss across the group, so every process
takes one process's step over the global batch (the concatenation of the
processes' slices, in process order) and the parameters stay equal.

``host_local_batch`` puts this process's slice of a global batch on its
mesh's data devices.  :func:`global_mesh` is the counterpart of JAX's
global device list: a mesh whose parts are spread over the group's
processes, each holding its own; the halo layers (``parallel/halo.py``)
and K8 (``ops/ring.py``) run over it with every process computing only
its parts, and the parts' blocks cross processes by :func:`exchange`.

Processes on their own cards join under NCCL (:func:`initialize` with
``backend="nccl"``, the default on the card): each process takes one
card, set before the group is made, and two processes of one node
naming one card raise, as NCCL does (two processes on one card name
``gloo``).  The group is then NCCL for CUDA tensors (the spmd step's
``all_reduce`` and ``broadcast``) and gloo for the host's small tensors
and objects (the exchanges' headers and handshakes,
``all_gather_object``).  A process may also hold several cards
(:func:`global_mesh`), as a JAX host holds its chips.

The processes may lie on several nodes, as a TPU pod slice's hosts do.
:func:`initialize` learns each process's node (:func:`nodes`): its host
name, with torchrun's node rank (``GROUP_RANK``) where torchrun set it.
Within a node CUDA tensors cross by CUDA IPC (``parallel/ipc.py``);
between nodes, where no process can map another's memory, by NCCL
(:func:`exchange`'s collective, K8's sends and receives).  Run on one
host of four H100s: two processes on one card each under NCCL, two
processes of two cards each, and two node groups (two ``torchrun
--nnodes 2`` launches, each over its own cards, NCCL's peer-to-peer and
shared-memory transports off, so its traffic between the groups goes by
sockets, ``NET/Socket``, as between hosts without InfiniBand); two real
hosts have not run.
"""

from __future__ import annotations

import atexit
import os
import socket
import zlib
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mpqe_tpu_torch.parallel import mesh as mesh_lib
from mpqe_tpu_torch.parallel import sharding as sharding_lib
from mpqe_tpu_torch.parallel.mesh import Mesh

# torchrun's variables, read when no address is given
_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
_NODES: Optional[List[int]] = None  # each rank's node, learned by initialize
_CARD: Optional[int] = None  # the card this process took under NCCL


def default_backend(device) -> str:
    """``nccl`` for the card, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device: str = "cuda",
               timeout_s: float = 300.0) -> bool:
    """``torch.distributed.init_process_group`` over a ``tcp://`` store;
    returns whether a group is (now) up.

    * a no-op when a group already exists;
    * with ``coordinator_address`` (``host:port``) every failure raises:
      a process that cannot reach its peers does not train alone;
    * otherwise the address, rank and size come from the variables
      ``torchrun`` sets (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
      ``WORLD_SIZE``), and without them it is a no-op (one process).
      Under torchrun the store is torchrun's own (``dist.rendezvous``).

    ``backend`` defaults to :func:`default_backend` of ``device``.  Under
    NCCL each process takes one card before the group is made
    (:func:`nccl_card`: ``device``'s index, else ``LOCAL_RANK``, else
    ``process_id`` modulo the visible cards), and ``RuntimeError``
    refuses two processes of one node on one card; the group carries
    CUDA tensors by NCCL and CPU tensors by gloo.  Two processes on one
    card name ``gloo``, whose ``all_reduce`` and ``broadcast``, all the
    spmd step uses, take CUDA tensors.  Every process learns each
    process's node (:func:`nodes`): through the store under NCCL, by one
    ``all_gather_object`` under gloo.  The group is destroyed at the
    interpreter's exit (:func:`_leave`)."""
    import torch.distributed as dist

    global _CARD, _NODES
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
    backend = backend or default_backend(device)
    world, rank = int(num_processes), int(process_id)
    timeout = timedelta(seconds=timeout_s)
    if backend != "nccl":
        dist.init_process_group(
            backend=backend, init_method=f"tcp://{coordinator_address}",
            world_size=world, rank=rank, timeout=timeout)
        atexit.register(_leave)
        every = [None] * world
        dist.all_gather_object(every, node_name())
        _NODES = node_indices(every)
        return True
    card = nccl_card(device, rank)
    torch.cuda.set_device(card)
    store, _, _ = next(dist.rendezvous(f"tcp://{coordinator_address}",
                                       rank=rank, world_size=world,
                                       timeout=timeout))
    nodes = refuse_shared_cards(store, world, rank, card)
    dist.init_process_group(backend="cpu:gloo,cuda:nccl", store=store,
                            world_size=world, rank=rank, timeout=timeout)
    atexit.register(_leave)
    _CARD, _NODES = card, node_indices(nodes)
    return True


def _leave() -> None:
    """At the interpreter's exit, the group :func:`initialize` made is
    destroyed first: the interpreter's own teardown of a live gloo group
    aborts a process now and then ("terminate called without an active
    exception")."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def node_name() -> str:
    """This process's node: the host name, and torchrun's node rank
    (``GROUP_RANK``) where torchrun set it.  Without ``GROUP_RANK`` the
    processes of one host are one node."""
    group = os.environ.get("GROUP_RANK")
    host = socket.gethostname()
    return host if group is None else f"{host}/node{group}"


def node_indices(names: Sequence[str]) -> List[int]:
    """Each rank's node index from the ranks' node names: nodes numbered
    in order of their first rank."""
    index: Dict[str, int] = {}
    return [index.setdefault(n, len(index)) for n in names]


def nodes() -> List[int]:
    """Each rank's node index (``[0]`` without a group).  Learned by
    :func:`initialize`; for a group made elsewhere, gathered here once
    (collective: every process calls it, as every caller here does from
    a collective)."""
    import torch.distributed as dist

    global _NODES
    if not (dist.is_available() and dist.is_initialized()):
        return [0]
    if _NODES is None or len(_NODES) != dist.get_world_size():
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, node_name())
        _NODES = node_indices(every)
    return _NODES


def same_node(a: int, b: int) -> bool:
    """Whether ranks ``a`` and ``b`` are on one node."""
    every = nodes()
    return every[a] == every[b]


def single_node() -> bool:
    """Whether every process of the group is on one node."""
    return len(set(nodes())) == 1


def has_nccl() -> bool:
    """Whether the group carries CUDA tensors by NCCL."""
    import torch.distributed as dist

    return "nccl" in str(dist.get_backend()).lower()


def nccl_device() -> torch.device:
    """This process's NCCL card: the one :func:`initialize` took, else
    the current card."""
    return torch.device("cuda", torch.cuda.current_device()
                        if _CARD is None else _CARD)


def transport(device) -> str:
    """How CUDA or CPU tensors on ``device`` cross this group's processes:
    ``gloo`` (CPU tensors), ``ipc`` (CUDA tensors within one node) or
    ``nccl`` (CUDA tensors over several nodes).  ``ValueError`` for
    another device, and for CUDA tensors over several nodes of a group
    without NCCL (no backend is switched to, nothing is staged through
    the host)."""
    import torch.distributed as dist

    device = torch.device(device)
    if device.type == "cpu":
        return "gloo"
    if device.type != "cuda":
        raise ValueError(f"exchange: no transport for {device} (CPU "
                         "tensors cross by gloo, CUDA tensors by CUDA IPC "
                         "within a node and by NCCL between nodes)")
    if single_node():
        return "ipc"
    if not has_nccl():
        raise ValueError(
            f"CUDA tensors between nodes cross by NCCL, and this group's "
            f"backend is {dist.get_backend()}: join the processes with "
            "backend nccl (a card each); nothing is staged through the "
            "host")
    return "nccl"


def nccl_card(device, rank: int) -> int:
    """The card an NCCL process takes: ``device``'s index where it names
    one, else ``LOCAL_RANK`` (torchrun's), else ``rank`` modulo the
    visible cards."""
    d = torch.device(device)
    if d.type != "cuda":
        raise ValueError(f"NCCL takes CUDA devices, got {d}")
    if d.index is not None:
        return d.index
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % torch.cuda.device_count()


def refuse_shared_cards(store, world: int, rank: int, card: int
                        ) -> List[str]:
    """Every process posts its node (:func:`node_name`) and card to
    ``store`` and reads the others'; ``RuntimeError`` in every process
    when two processes of one node name one card (NCCL takes one card
    per process).  Returns every rank's node name."""
    key = "mpqe_tpu_torch/nccl_card/"
    mine = (f"{node_name()} "
            f"{os.environ.get('CUDA_VISIBLE_DEVICES', '')} {card}")
    store.set(f"{key}{rank}", mine)
    keys = [f"{key}{r}" for r in range(world)]
    store.wait(keys)
    every = [store.get(k).decode() for k in keys]
    # the store lives in process 0: it leaves only once every process
    # has read (a refusal ends every process)
    store.set(f"{key}read/{rank}", "1")
    if rank == 0:
        store.wait([f"{key}read/{r}" for r in range(world)])
    seen: Dict[str, int] = {}
    for r, where in enumerate(every):
        if where in seen:
            raise RuntimeError(
                f"processes {seen[where]} and {r} both name cuda:"
                f"{where.rsplit(' ', 1)[-1]} under NCCL, which takes one "
                "card per process: give each its own card, or name gloo "
                "for processes that share one")
        seen[where] = r
    return [where.split(" ", 1)[0] for where in every]


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


def global_mesh(shape, local_devices: Sequence,
                axis_names=("data", "model")) -> Mesh:
    """A ``shape`` mesh over every process's ``local_devices``, gathered
    over the group in process order (JAX's ``make_mesh`` over the global
    device list): the entries are the concatenation of the processes'
    lists, row-major, each naming its process in ``Mesh.procs``.  Without
    a group, :func:`mesh_lib.make_mesh` of ``local_devices``.  A process
    may list several devices, distinct cards or one repeated (JAX's
    multi-host shape: each host a process over its chips); the cards are
    named as every process of one node sees them (do not restrict
    ``CUDA_VISIBLE_DEVICES`` per process within a node).  ``ValueError`` when the
    processes list different numbers of devices."""
    local = [mesh_lib._device(d) for d in local_devices]
    if process_count() == 1:
        return mesh_lib.make_mesh(shape, axis_names, local)
    import torch.distributed as dist

    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, [str(d) for d in local])
    if len({len(a) for a in lists}) != 1:
        raise ValueError(f"global_mesh: the processes list "
                         f"{[len(a) for a in lists]} devices; each must "
                         "list as many")
    devices = [torch.device(d) for a in lists for d in a]
    procs = [r for r, a in enumerate(lists) for _ in a]
    mesh = mesh_lib.make_mesh(shape, axis_names, devices)
    return Mesh(mesh.devices, mesh.axis_names, procs=np.asarray(procs),
                rank=dist.get_rank())


# the dtypes exchange takes, by their code in its header
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int32, torch.int64, torch.uint8)
_HEADER = 8  # tag, count, dtype, ndim, shape (at most 4 axes)


def exchange(mine: Sequence[torch.Tensor], device, tag: str = ""
             ) -> List[List[torch.Tensor]]:
    """Every process of the group contributes ``mine`` (tensors of one
    shape and dtype across the group, any number, none allowed) and
    receives every process's, in process order: ``out[r]`` is process
    r's list (``out[rank]`` is ``mine``).  ``mine`` lies on ``device``,
    whose :func:`transport` moves it: CPU tensors by one gloo
    ``all_gather``; CUDA tensors within one node by ``parallel/ipc.py``,
    over several nodes by one NCCL ``all_gather`` on this process's NCCL
    card (never through the host); other devices, a tensor on another
    device than ``device``, CUDA tensors between nodes under gloo, and
    between nodes on another card than :func:`nccl_device` (NCCL would
    make a second communicator) raise ``ValueError``.  A header gathered
    first (by gloo) carries each process's count, shape and ``tag``: a
    process whose sequence of exchanges differs from its peers' raises
    ``RuntimeError``; a peer that does not come raises after the group's
    timeout."""
    import torch.distributed as dist

    device = mesh_lib._device(device)
    how = transport(device)
    for t in mine:
        if t.device != device:
            raise ValueError(f"exchange over {device} was handed a tensor "
                             f"on {t.device}: no silent staging; the "
                             "transport is chosen by the tensors' device")
    if how == "nccl" and device != nccl_device():
        raise ValueError(f"exchange between nodes runs on this process's "
                         f"NCCL card {nccl_device()}, got {device}")
    head = torch.full((_HEADER,), -1, dtype=torch.int64)
    head[0] = zlib.crc32(tag.encode())
    head[1] = len(mine)
    if mine:
        t = mine[0]
        if t.dim() > _HEADER - 4 or t.dtype not in _DTYPES:
            raise ValueError(f"exchange takes at most {_HEADER - 4} axes of "
                             f"{_DTYPES}, got {t.dtype} {tuple(t.shape)}")
        head[2] = _DTYPES.index(t.dtype)
        head[3] = t.dim()
        head[4:4 + t.dim()] = torch.tensor(t.shape)
    heads = [torch.empty_like(head) for _ in range(dist.get_world_size())]
    dist.all_gather(heads, head)
    rank = dist.get_rank()
    if len({int(h[0]) for h in heads}) != 1:
        raise RuntimeError(f"exchange {tag!r}: the processes are at "
                           "different exchanges (their sequences differ)")
    counts = [int(h[1]) for h in heads]
    kinds = {tuple(h[2:].tolist()) for h, c in zip(heads, counts) if c}
    if len(kinds) > 1:
        raise RuntimeError(f"exchange {tag!r}: the processes contribute "
                           f"different shapes or dtypes {sorted(kinds)}")
    out = [list(mine) if r == rank else [] for r in range(len(heads))]
    if not kinds:  # nothing to move
        return out
    kind = kinds.pop()
    dtype, shape = _DTYPES[kind[0]], tuple(kind[2:2 + kind[1]])
    if how == "ipc":
        from mpqe_tpu_torch.parallel import ipc

        got = ipc.channel(device).exchange(mine, counts, shape, dtype)
    else:
        got = _gather_exchange(mine, counts, shape, dtype, device)
    for r in range(len(heads)):
        if r != rank:
            out[r] = got[r]
    return out


def _gather_exchange(mine, counts, shape, dtype, device=torch.device("cpu")
                     ) -> List[List[torch.Tensor]]:
    """:func:`exchange`'s collective transport: one ``all_gather`` of
    every process's tensors on ``device``, padded to the largest count,
    as bytes; gloo's for CPU tensors, NCCL's for CUDA tensors (between
    nodes)."""
    import torch.distributed as dist

    for t in mine:
        if t.device != device:
            raise ValueError(
                f"the gloo transport takes CPU tensors, got {t.device}: "
                "CUDA tensors cross processes by parallel/ipc.py within a "
                "node and by NCCL between nodes, never through the host"
                if device.type == "cpu" else
                f"the NCCL transport on {device} was handed a tensor on "
                f"{t.device}")
    m = max(counts)
    buf = torch.zeros((m, *shape), dtype=dtype, device=device)
    if mine:
        buf[:len(mine)] = torch.stack(mine)
    raw = buf.reshape(-1).view(torch.uint8)
    bufs = [torch.empty_like(raw) for _ in counts]
    dist.all_gather(bufs, raw)
    return [list(b.view(dtype).view(m, *shape)[:c].unbind(0))
            for b, c in zip(bufs, counts)]


# its CPU case, by the name the gloo transport had
_gloo_exchange = _gather_exchange
