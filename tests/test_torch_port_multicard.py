"""The parallel layer with its parts on distinct cards, held on the CPU as
far as the CPU reaches: everything that needs no second card.

* ``multihost.global_mesh`` of two gloo processes that each list two
  ``cuda`` devices (as strings, nothing allocated): the layout, ``procs``,
  ``local_parts``, ``local_devices``, K8's run of parts; the refusal of
  unequal lists;
* ``mesh.cli_mesh``, ``tools/dryrun_multichip.py part_devices`` and
  ``tools/scaling_bench.py part_counts`` with ``torch.cuda.device_count``
  patched to 4;
* K8's copy plan (``ops/ring.py _copy_plan``, ``_readers``) over groups
  keyed by distinct cards, in one process and across processes;
* the refusals: peer access that ``can_device_access_peer`` denies
  (``parallel/ipc.py``), a driver without stream memory operations, two
  NCCL processes naming one card (two worker processes);
* a two-process gloo halo step (``tools/multihost_run.py``, ring and
  gather) whose crossings' exchanges, forward and backward, come in the
  same order in both processes: under ``mesh.ordered_crossings`` the
  backward runs them in the reverse of the forward's order.

This file is also the worker: ``python <this file> <mode> <port> <rank>
<out.json>``.
"""

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


# ---------------------------------------------------------------- worker
def _worker_mesh(rank, out):
    """Two gloo processes, each listing two cuda devices as strings."""
    from mpqe_tpu_torch.ops import ring
    from mpqe_tpu_torch.parallel import multihost

    mine = [f"cuda:{2 * rank}", f"cuda:{2 * rank + 1}"]
    res = {}
    for shape in ((4, 1), (2, 2)):
        m = multihost.global_mesh(shape, mine)
        data = m.axis_devices("data")
        res[str(shape)] = dict(
            devices=[str(d) for d in m.devices.flat],
            procs=m.procs.reshape(-1).tolist(),
            spans=m.spans_processes,
            local_devices=[str(d) for d in m.local_devices()],
            local_parts=[[p, str(d)] for p, d in m.local_parts("data")],
            data_procs=list(data.procs),
            k8_parts=(ring._local_parts(data) if shape == (4, 1) else None))
    try:  # unequal lists: every process raises
        multihost.global_mesh((5, 1), mine + ["cuda:4"] * rank)
        res["unequal"] = None
    except ValueError as e:
        res["unequal"] = str(e)
    with open(out, "w") as f:
        json.dump(res, f)


def _worker_tags(rank, out):
    """A two-process gloo halo step (ring, then gather): every exchange's
    tag, in the order it ran (a backward's tags end in ``.T``)."""
    from mpqe_tpu_torch.parallel import multihost
    from mpqe_tpu_torch.tools import multihost_run

    tags = []
    exchange = multihost.exchange

    def recorded(mine, device, tag=""):
        tags.append(tag)
        return exchange(mine, device, tag)

    multihost.exchange = recorded
    res = {}
    for kind in ("ring", "gather"):
        tags.clear()
        r = multihost_run.main([
            "--device", "cpu", "--parallel", f"halo_{kind}", "--mesh", "2,1",
            "--entities", "300", "--embed_dim", "16", "--num_bases", "4",
            "--batch_size", "32", "--steps", "2", "--out",
            os.path.join(os.path.dirname(out), kind)])
        res[kind] = dict(tags=list(tags), losses=r["losses"])
    with open(out, "w") as f:
        json.dump(res, f)


def _worker_nccl_one_card(rank, port, out):
    """Two processes naming NCCL on cuda:0 (the card's calls patched out:
    the refusal comes before any)."""
    from mpqe_tpu_torch.parallel import multihost

    torch.cuda.set_device = lambda d: None
    try:
        multihost.initialize(f"127.0.0.1:{port}", 2, rank, backend="nccl",
                             device="cuda:0", timeout_s=60)
        res = {"raised": None}
    except RuntimeError as e:
        res = {"raised": str(e)}
    with open(out, "w") as f:
        json.dump(res, f)


def _worker(argv):
    mode, port, rank, out = argv[0], argv[1], int(argv[2]), argv[3]
    sys.path.insert(0, REPO)
    if mode == "nccl":
        return _worker_nccl_one_card(rank, port, out)
    from mpqe_tpu_torch.parallel import multihost

    assert multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu",
                                timeout_s=120)
    (_worker_mesh if mode == "mesh" else _worker_tags)(rank, out)


# ----------------------------------------------------------------- tests
def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _pair(tmp_path, mode):
    """Run the two workers of ``mode``; their results, rank-ordered."""
    port = _free_port()
    outs = [str(tmp_path / f"{mode}{r}" / "out.json") for r in (0, 1)]
    for o in outs:
        os.makedirs(os.path.dirname(o))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, __file__, mode, str(port), str(r), outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for r in (0, 1)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        errs.append(err)
    for p, err in zip(procs, errs):
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
    res = []
    for o in outs:
        with open(o) as f:
            res.append(json.load(f))
    return res


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("multicard_mesh"), "mesh")


@pytest.fixture(scope="module")
def tag_runs(tmp_path_factory):
    return _pair(tmp_path_factory.mktemp("multicard_tags"), "tags")


@pytest.mark.parametrize("rank", [0, 1])
def test_global_mesh_of_two_cards_a_process(mesh_runs, rank):
    """(4, 1): the processes' lists in process order; each process holds
    its two parts, on its own two cards."""
    got = mesh_runs[rank]["(4, 1)"]
    assert got["devices"] == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert got["procs"] == [0, 0, 1, 1] and got["spans"]
    mine = [f"cuda:{2 * rank}", f"cuda:{2 * rank + 1}"]
    assert got["local_devices"] == mine
    assert got["local_parts"] == [[2 * rank, mine[0]],
                                  [2 * rank + 1, mine[1]]]
    assert got["data_procs"] == [0, 0, 1, 1]
    # K8 takes a process's run of parts on its two cards (was refused)
    assert got["k8_parts"] == [2 * rank, 2 * rank + 1]


@pytest.mark.parametrize("rank", [0, 1])
def test_global_mesh_2x2_rows_by_process(mesh_runs, rank):
    """(2, 2): row-major over the gathered list, so each model row is one
    process's two cards and the data axis spans the processes."""
    got = mesh_runs[rank]["(2, 2)"]
    assert got["devices"] == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert got["procs"] == [0, 0, 1, 1]
    assert got["local_devices"] == [f"cuda:{2 * rank}",
                                    f"cuda:{2 * rank + 1}"]
    assert got["data_procs"] == [0, 1]
    assert got["local_parts"] == [[rank, f"cuda:{2 * rank}"]]


def test_global_mesh_refuses_unequal_lists(mesh_runs):
    for r in mesh_runs:
        assert r["unequal"] is not None
        assert "[2, 3] devices" in r["unequal"]


@pytest.fixture
def four_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


def test_cli_mesh_takes_distinct_cards(four_cards):
    from mpqe_tpu_torch.parallel import mesh as mesh_lib

    m = mesh_lib.cli_mesh((1, 4), torch.device("cuda", 0), "--shards 4")
    assert [str(d) for d in m.devices.flat] == [f"cuda:{i}" for i in range(4)]
    m = mesh_lib.cli_mesh((2, 2), torch.device("cuda", 0), "--mesh 2,2")
    assert m.shape == {"data": 2, "model": 2}
    assert [str(d) for d in m.axis_devices("data")] == ["cuda:0", "cuda:2"]
    with pytest.raises(SystemExit, match="--shards 5 needs that many "
                                         "devices, have 4"):
        mesh_lib.cli_mesh((1, 5), torch.device("cuda", 0), "--shards 5")


@pytest.mark.parametrize("n,device,want", [
    (4, "cuda", [f"cuda:{i}" for i in range(4)]),
    (2, "cuda", ["cuda:0", "cuda:1"]),
    (8, "cuda:0", ["cuda:0"] * 8),
    (3, "cuda:2", ["cuda:2"] * 3),
    (6, "cpu", ["cpu"] * 6),
])
def test_dryrun_part_devices(four_cards, n, device, want):
    """The first n visible cards for a bare ``cuda``, as the reference
    takes ``jax.devices()[:n]``; n parts of a card that ``--device``
    names."""
    from mpqe_tpu_torch.tools.dryrun_multichip import part_devices

    assert [str(d) for d in part_devices(n, device)] == want


def test_dryrun_refuses_more_parts_than_cards(four_cards):
    from mpqe_tpu_torch.tools.dryrun_multichip import part_devices

    with pytest.raises(SystemExit, match="8 parts need that many cards, "
                                         "have 4"):
        part_devices(8, "cuda")


@pytest.mark.parametrize("device,want", [
    ("cuda", [1, 2, 4]), ("cuda:0", [1, 2, 4, 8]), ("cpu", [1, 2, 4, 8])])
def test_scaling_bench_part_counts(four_cards, device, want):
    from mpqe_tpu_torch.tools.scaling_bench import part_counts

    assert part_counts(torch.device(device)) == want


def _plan(parts_by_card, n_parts, held=None):
    """``_copy_plan`` and ``_readers`` over groups keyed by the cards of
    ``parts_by_card``; ``held``: the parts this process holds (all)."""
    from types import SimpleNamespace

    from mpqe_tpu_torch.ops import ring

    groups = {torch.device("cuda", c): SimpleNamespace(parts=parts)
              for c, parts in parts_by_card.items()}
    where = {p: (dev, i) for dev, g in groups.items()
             for i, p in enumerate(g.parts)}
    plan = ring._copy_plan(groups, where, n_parts)
    first = next(iter(groups))
    return plan, ring._readers(plan, first)


def _c(i):
    return torch.device("cuda", i)


def test_copy_plan_one_part_a_card():
    """Four parts on four cards: each card copies its block from the
    previous card, one peer copy a hop; each card's slots are read by
    the next card's copy stream."""
    plan, (readers, forwards) = _plan({i: [i] for i in range(4)}, 4)
    assert plan == {_c(i): [(_c((i - 1) % 4), 0, 0, 1)] for i in range(4)}
    assert readers == {_c(i): [_c((i + 1) % 4)] for i in range(4)}
    assert forwards == {_c(i): i == 1 for i in range(4)}


def test_copy_plan_two_parts_a_card():
    """Parts 0, 1 on card 0 and 2, 3 on card 1: one copy within each card
    and one across, runs kept as slices."""
    plan, (readers, _) = _plan({0: [0, 1], 1: [2, 3]}, 4)
    assert plan[_c(0)] == [(_c(1), 1, 0, 1), (_c(0), 0, 1, 1)]
    assert plan[_c(1)] == [(_c(0), 1, 0, 1), (_c(1), 0, 1, 1)]
    assert readers == {_c(0): [_c(1)], _c(1): [_c(0)]}


def test_copy_plan_across_processes_two_cards():
    """Process 0 of two holds parts 0 (card 0) and 1 (card 1) of four:
    part 0's block comes from the other process (no copy here), part 1's
    from card 0, and that copy forwards the first part's slot."""
    plan, (readers, forwards) = _plan({0: [0], 1: [1]}, 4)
    assert plan == {_c(0): [], _c(1): [(_c(0), 0, 0, 1)]}
    assert readers == {_c(0): [_c(1)], _c(1): []}
    assert forwards == {_c(0): False, _c(1): True}


def test_peer_access_refused(monkeypatch):
    """A pair of cards without peer access raises before any driver call:
    no copy between them is staged through the host; one card needs
    none."""
    from mpqe_tpu_torch.parallel import ipc

    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: False)
    monkeypatch.setattr(ipc, "_libcuda", lambda: pytest.fail(
        "the refusal must come before the driver"))
    ipc.peer_access(1, 1)
    with pytest.raises(RuntimeError, match="cuda:0 has no peer access to "
                                           "cuda:1"):
        ipc.peer_access(0, 1)
    with pytest.raises(RuntimeError, match="no peer access"):
        ipc._open(bytes(64), 2, 3)
    assert (0, 1) not in ipc._PEERS


def test_peer_access_needs_both_ways(monkeypatch):
    from mpqe_tpu_torch.parallel import ipc

    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: (a, b) == (2, 3))
    monkeypatch.setattr(ipc, "_libcuda", lambda: pytest.fail("driver"))
    with pytest.raises(RuntimeError, match="cuda:3 has no peer access to "
                                           "cuda:2"):
        ipc.peer_access(2, 3)


@pytest.mark.parametrize("v2,attr,ok", [(True, 0, True), (False, 1, True),
                                        (False, 0, False)])
def test_stream_mem_ops_check(monkeypatch, v2, attr, ok):
    """The counters' driver check: the v2 entry points (CUDA 12's, every
    device), else the v1 attribute; a driver with neither raises."""
    from mpqe_tpu_torch.parallel import ipc

    def get_attr(val, a, dev):  # val: ctypes.byref of a c_int
        assert a == ipc._MEM_OPS_V1
        val._obj.value = attr
        return 0

    fake = {"mem_ops_v2": v2, "cuDeviceGet": lambda d, i: 0,
            "cuDeviceGetAttribute": get_attr}
    monkeypatch.setattr(ipc, "_libcuda", lambda: fake)
    if ok:
        ipc.stream_mem_ops(0)
    else:
        with pytest.raises(RuntimeError, match="no stream memory "
                                               "operations"):
            ipc.stream_mem_ops(0)


def test_two_nccl_processes_on_one_card_raise(tmp_path):
    """Both processes name NCCL on cuda:0: each raises ``RuntimeError``
    naming the card before the group is made (NCCL would refuse the
    duplicate card at its first collective); no backend is switched."""
    for r in _pair(tmp_path, "nccl"):
        assert r["raised"] is not None
        assert "processes 0 and 1 both name cuda:0 under NCCL" in r["raised"]


@pytest.mark.parametrize("rank,env,want", [(1, None, 1), (5, None, 1),
                                           (3, "2", 2)])
def test_nccl_card(four_cards, monkeypatch, rank, env, want):
    """One card a process: the device's index, else ``LOCAL_RANK``, else
    the rank modulo the visible cards."""
    from mpqe_tpu_torch.parallel import multihost

    if env is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", env)
    assert multihost.nccl_card("cuda", rank) == want
    assert multihost.nccl_card("cuda:3", rank) == 3


@pytest.mark.parametrize("kind", ["ring", "gather"])
def test_crossings_exchange_in_one_order(tag_runs, kind):
    """Both processes run the same exchanges in the same order, forward
    and backward, and each step's backward runs the layers' crossings
    in the reverse of their forward order."""
    a, b = (r[kind] for r in tag_runs)
    assert a["tags"] == b["tags"] and a["losses"] == b["losses"]
    fwd = [t for t in a["tags"] if not t.endswith(".T")]
    bwd = [t for t in a["tags"] if t.endswith(".T")]
    assert len(fwd) >= 6 and len(bwd) >= 6  # several crossings a step
    steps = 2
    per = len(bwd) // steps
    one = bwd[:per]
    assert bwd == one * steps
    # the layers' crossings: the backward's transposes in reverse order
    layer = [t for t in fwd[:len(fwd) // steps]
             if t in ("ppermute", "all_gather", "psum")]
    back = [t[:-2] for t in one if t[:-2] in ("ppermute", "all_gather",
                                              "psum")]
    assert back == layer[::-1]


def test_ordered_crossings_ties_a_chain():
    """Within ``ordered_crossings`` a crossing's output gives the token
    that the next crossing's inputs are tied to: the backward of the
    first crossing's output waits for the second's (its graph reaches
    the token's node); outside, nothing is tied."""
    from mpqe_tpu_torch.parallel import mesh as mesh_lib

    x = torch.ones(3, requires_grad=True)
    with mesh_lib.ordered_crossings():
        y = mesh_lib._mark(x * 2)
        (z,) = mesh_lib._tie([y + 1])
        assert mesh_lib._ORDER["token"] is not None
    assert mesh_lib._ORDER == {"on": False, "token": None}
    assert type(z.grad_fn).__name__ == "_TieBackward"
    z.sum().backward()
    assert torch.equal(x.grad, torch.full((3,), 2.0))
    (w,) = mesh_lib._tie([x])
    assert w is x


if __name__ == "__main__":
    _worker(sys.argv[1:])
