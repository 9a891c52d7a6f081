"""The port's HTTP front end (``mpqe_tpu_torch/netserve.py`` and ``serve
--http``) against the JAX package's ``mpqe_tpu/netserve.py`` on the CPU.

The model is carried across from JAX parameters.  The JAX server's
encoder is routed through the Pallas K3 kernel in interpret mode (a
test-side patch, as in ``tests/test_torch_port_serve.py``; the JAX
package is unchanged) with the highest matmul precision, and the port's
server runs K3's plain version, so both return the same entities with
scores within 1e-4 (the serve tests' tight tolerance).  Every network
wait here has its own timeout (<= 30 s) and every server is shut down in
a ``finally``.
"""

import contextlib
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mpqe_tpu.models.mpqe as jm
from mpqe_tpu import netserve as jns
from mpqe_tpu.data import sampler as jsamp
from mpqe_tpu.ops import pallas_fused_fwd as jff
from mpqe_tpu.serve import QueryServer as JaxServer
from mpqe_tpu_torch import convert
from mpqe_tpu_torch import netserve as tns
from mpqe_tpu_torch import serve as tserve
from mpqe_tpu_torch.data import sampler as tsamp
from mpqe_tpu_torch.models import mpqe as tm
from mpqe_tpu_torch.queries import STRUCTURE_NAMES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KG = dict(n_entities=300, n_modes=4, n_base_rels=6, n_triples=2000, seed=0)
WAIT_S = 30  # every network wait and future here
SCORE_TOL = 1e-4  # tests/test_torch_port_serve.py's tight tolerance


@pytest.fixture(scope="module")
def kgs():
    return jsamp.make_random_kg(**KG), tsamp.make_random_kg(**KG)


@pytest.fixture(scope="module")
def models():
    kw = dict(n_entities=300, n_modes=4, n_rels=12, embed_dim=16,
              n_layers=3, num_bases=4)
    jcfg, tcfg = jm.MPQEConfig(**kw), tm.MPQEConfig(**kw)
    params = jm.init_mpqe(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    for lp in params["layers"]:
        lp["bias"] = jnp.asarray(
            0.1 * rng.normal(size=lp["bias"].shape).astype(np.float32))
    model = convert.model_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                                     "cpu")
    return jcfg, tcfg, params, model


@pytest.fixture(scope="module")
def port_server(kgs, models):
    _, tkg = kgs
    _, tcfg, _, model = models
    return tserve.QueryServer(model, tcfg, tkg.entity_mode, device="cpu")


@contextlib.contextmanager
def _jax_k3_highest():
    """The JAX servers' encoder through the interpret-mode Pallas K3, at
    the highest matmul precision (set globally: the JAX batcher thread
    does not see a thread's context manager)."""
    real = jm.encode_dense_multi_auto

    def auto(params, cfg, structure, ne, nm, er, en):
        return jff.fused_tgt_forward_multi(params, cfg, structure, ne, nm,
                                           er, en, block=8, interpret=True)

    prev = jax.config.jax_default_matmul_precision
    jm.encode_dense_multi_auto = auto
    jax.config.update("jax_default_matmul_precision", "highest")
    try:
        yield
    finally:
        jm.encode_dense_multi_auto = real
        jax.config.update("jax_default_matmul_precision", prev)


def _wire(q):
    return {"structure": q.formula.structure, "anchors": list(q.anchors),
            "rels": list(q.formula.rels)}


def _sampled(kg, seed, n_per=3):
    s = tsamp.QuerySampler(kg, seed=seed)
    out = []
    for st in STRUCTURE_NAMES:
        out += s.sample_queries(st, n_per, n_neg=1)
    order = np.random.default_rng(seed).permutation(len(out))
    return [out[i] for i in order]


# ------------------------------------------------------------ build_query
def _mismatch(kg, kind):
    """(structure, anchors, rels) breaking the schema as ``kind`` says."""
    rels = range(kg.n_rels)
    if kind == "domain":
        rel = 0
        bad = int(np.flatnonzero(kg.entity_mode != kg.rel_id_modes(rel)[0])
                  [0])
        return "1-chain", (bad,), (rel,)
    if kind == "chain":
        a, b = next((a, b) for a in rels for b in rels
                    if kg.rel_id_modes(a)[1] != kg.rel_id_modes(b)[0])
        anchor = int(np.flatnonzero(
            kg.entity_mode == kg.rel_id_modes(a)[0])[0])
        return "2-chain", (anchor,), (a, b)
    a, b = next((a, b) for a in rels for b in rels
                if kg.rel_id_modes(a)[1] != kg.rel_id_modes(b)[1])
    a0 = int(np.flatnonzero(kg.entity_mode == kg.rel_id_modes(a)[0])[0])
    a1 = int(np.flatnonzero(kg.entity_mode == kg.rel_id_modes(b)[0])[0])
    return "2-inter", (a0, a1), (a, b)


BUILD_CASES = {
    "valid_1-chain": lambda kg, q: ("1-chain", q["1-chain"]),
    "valid_2-chain": lambda kg, q: ("2-chain", q["2-chain"]),
    "valid_3-chain_inter": lambda kg, q: ("3-chain_inter",
                                          q["3-chain_inter"]),
    "valid_3-inter": lambda kg, q: ("3-inter", q["3-inter"]),
    "unknown_structure": lambda kg, q: ("bogus", q["2-chain"]),
    "anchor_count": lambda kg, q: ("2-chain", (q["2-chain"][0] + (0,),
                                               q["2-chain"][1])),
    "rel_count": lambda kg, q: ("2-chain", (q["2-chain"][0],
                                            q["2-chain"][1][:1])),
    "anchor_range": lambda kg, q: ("2-chain", ((kg.n_entities,),
                                               q["2-chain"][1])),
    "rel_range": lambda kg, q: ("2-chain", (q["2-chain"][0],
                                            (kg.n_rels,
                                             q["2-chain"][1][1]))),
    "domain_mismatch": lambda kg, q: ("1-chain", _mismatch(kg, "domain")[1:]),
    "chain_mismatch": lambda kg, q: ("2-chain", _mismatch(kg, "chain")[1:]),
    "inter_disagreement": lambda kg, q: ("2-inter",
                                         _mismatch(kg, "inter")[1:]),
}


@pytest.mark.parametrize("case", list(BUILD_CASES))
def test_build_query_matches_jax(case, kgs):
    """The same ``Query``, or the same error type and message."""
    jkg, tkg = kgs
    sampler = tsamp.QuerySampler(tkg, seed=1)
    wire = {}
    for s in ("1-chain", "2-chain", "3-chain_inter", "3-inter"):
        q = sampler.sample_query(s, n_neg=1)
        wire[s] = (tuple(q.anchors), tuple(q.formula.rels))
    structure, (anchors, rels) = BUILD_CASES[case](tkg, wire)
    outs = []
    for mod, kg in ((jns, jkg), (tns, tkg)):
        try:
            q = mod.build_query(kg, structure, anchors, rels)
            outs.append(("ok", q.formula.structure, q.formula.rels,
                         q.formula.node_modes, q.anchors, q.target,
                         q.neg_samples, q.hard_neg_samples))
        except mod.QueryValidationError as e:
            outs.append(("error", str(e)))
    assert outs[0] == outs[1]
    assert (outs[1][0] == "ok") == case.startswith("valid_"), outs[1]


# ----------------------------------------------------------- MicroBatcher
def test_microbatcher_coalesces_and_orders(kgs, port_server):
    _, tkg = kgs
    qs = tsamp.QuerySampler(tkg, seed=5).sample_queries("2-chain", 6,
                                                         n_neg=1)
    b = tns.MicroBatcher(port_server, max_batch=64, max_wait_ms=50)
    # submitted before the worker starts: deterministically one dispatch
    futs = [b.submit([q], k=5) for q in qs]
    fk = b.submit(qs[:2], k=3)  # another k in the same drain
    b.start()
    try:
        answers = [f.result(timeout=WAIT_S) for f in futs]
        ak = fk.result(timeout=WAIT_S)
    finally:
        b.stop()
    assert list(b.batch_sizes) == [8] and b.total_dispatches == 1
    assert b.total_queries == 8
    assert all(len(a) == 1 and a[0].entity_ids.shape == (5,)
               for a in answers)
    assert len(ak) == 2 and ak[0].entity_ids.shape == (3,)
    direct = port_server.answer(qs, k=5)
    for a, d in zip(answers, direct):  # each request's own answers, in order
        np.testing.assert_array_equal(a[0].entity_ids, d.entity_ids)
        np.testing.assert_array_equal(a[0].scores, d.scores)


def test_microbatcher_propagates_errors_and_keeps_serving(kgs, port_server):
    """A dispatch that raises fails every request of its group, and the
    batcher thread answers the next one."""
    _, tkg = kgs

    class Boom(Exception):
        pass

    class Flaky:
        calls = 0

        def answer(self, queries, k):
            Flaky.calls += 1
            if Flaky.calls == 1:
                raise Boom("device on fire")
            return port_server.answer(queries, k)

    q = tsamp.QuerySampler(tkg, seed=6).sample_query("1-chain", n_neg=1)
    b = tns.MicroBatcher(Flaky(), max_wait_ms=50)
    f1, f2 = b.submit([q], k=2), b.submit([q, q], k=2)
    b.start()
    try:
        for f in (f1, f2):
            with pytest.raises(Boom):
                f.result(timeout=WAIT_S)
        ok = b.submit([q], k=2).result(timeout=WAIT_S)
    finally:
        b.stop()
    assert ok[0].entity_ids.shape == (2,)


def test_microbatcher_stop_fails_orphans(kgs, port_server):
    _, tkg = kgs
    q = tsamp.QuerySampler(tkg, seed=9).sample_query("1-chain", n_neg=1)
    b = tns.MicroBatcher(port_server, max_wait_ms=1)
    fut = b.submit([q], k=2)  # never started
    b.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        fut.result(timeout=5)
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit([q], k=2).result(timeout=5)


def test_batcher_thread_answers_without_grad(kgs, port_server):
    """Grad and inference modes are thread-local: the batcher thread's
    dispatch sets its own, whatever the submitting thread's."""
    _, tkg = kgs
    qs = _sampled(tkg, seed=4, n_per=1)
    b = tns.MicroBatcher(port_server, max_wait_ms=1).start()
    try:
        with torch.enable_grad():
            got = b.submit(qs, k=4).result(timeout=WAIT_S)
    finally:
        b.stop()
    with torch.no_grad():
        want = port_server.answer(qs, k=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.entity_ids, w.entity_ids)
        np.testing.assert_array_equal(g.scores, w.scores)


# ---------------------------------------------------------- HTTP servers
def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=WAIT_S) as r:
        return r.status, json.loads(r.read())


def _post(url, payload):
    req = urllib.request.Request(
        url + "/v1/answer", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@contextlib.contextmanager
def _running(make, *args, **kw):
    srv = make(*args, **kw)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        srv.batcher.stop()
        t.join(timeout=WAIT_S)


@pytest.fixture(scope="module")
def both_http(kgs, models):
    jkg, tkg = kgs
    jcfg, tcfg, params, model = models
    with _jax_k3_highest():
        jserver = JaxServer(params, jcfg, jkg.entity_mode)
        tserver = tserve.QueryServer(model, tcfg, tkg.entity_mode,
                                     device="cpu")
        with _running(jns.make_http_server, jserver, jkg, "127.0.0.1", 0,
                      default_k=7, max_wait_ms=2.0) as (jsrv, jurl), \
                _running(tns.make_http_server, tserver, tkg, "127.0.0.1", 0,
                         default_k=7, max_wait_ms=2.0) as (tsrv, turl):
            yield jurl, turl, tsrv, tkg


def test_http_healthz_and_statz_match_jax(both_http):
    jurl, turl, _, _ = both_http
    for path in ("/healthz", "/statz"):
        (js, jb), (ts, tb) = _get(jurl, path), _get(turl, path)
        assert js == ts == 200 and set(jb) == set(tb), path
    assert _get(turl, "/healthz")[1] == _get(jurl, "/healthz")[1]


def test_http_answers_match_jax(both_http):
    """The same requests, sent concurrently to each server (so dispatches
    coalesce): the same entities, scores within SCORE_TOL, and with the
    default k."""
    jurl, turl, tsrv, tkg = both_http
    qs = _sampled(tkg, seed=7)
    reqs = [{"queries": [_wire(q) for q in qs[i:i + 4]], "k": 5}
            for i in range(0, len(qs), 4)]
    reqs.append({"queries": [_wire(q) for q in qs[:3]]})  # default k = 7
    got = {}
    for name, url in (("jax", jurl), ("port", turl)):
        out = [None] * len(reqs)

        def fire(i, url=url, out=out):
            out[i] = _post(url, reqs[i])

        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
        got[name] = out
    for r, a, b in zip(reqs, got["jax"], got["port"]):
        assert a[0] == b[0] == 200, (a, b)
        assert len(b[1]["answers"]) == len(r["queries"])
        for ja, ta in zip(a[1]["answers"], b[1]["answers"]):
            assert ta["entities"] == ja["entities"]
            np.testing.assert_allclose(ta["scores"], ja["scores"], rtol=0,
                                       atol=SCORE_TOL)
            assert len(ta["entities"]) == r.get("k", 7)
    _, statz = _get(turl, "/statz")
    assert statz["total_queries"] >= len(qs) + 3


BAD_BODIES = [
    {}, {"queries": []}, [], "x", {"queries": [5]},
    {"queries": [{"structure": "nope", "anchors": [0], "rels": [0]}]},
    {"queries": [{"structure": "1-chain", "anchors": [0], "rels": [0]}],
     "k": 0},
    {"queries": [{"structure": "1-chain", "anchors": [0, 1],
                  "rels": [0]}]},
    {"queries": [{"structure": "1-chain", "anchors": [0], "rels": [999]}]},
]


def test_http_bad_bodies_match_jax(both_http):
    """The same 400 and message from both servers, which stay up."""
    jurl, turl, _, _ = both_http
    for body in BAD_BODIES:
        a, b = _post(jurl, body), _post(turl, body)
        assert a[0] == b[0] == 400, (body, a, b)
        assert a[1] == b[1], body
    assert _get(turl, "/healthz")[0] == 200


# --------------------------------------------------------------------- CLI
def test_serve_cli_bad_http_exits_before_loading(tmp_path):
    """A malformed --http fails before the (here missing) run dir is read."""
    with pytest.raises(SystemExit, match="--http expects HOST:PORT"):
        tserve.main(["--device", "cpu", "--run_dir",
                     str(tmp_path / "missing"), "--http", "bad"])


def test_serve_cli_http_listens_answers_and_stops():
    """``serve --http 127.0.0.1:0``: the ``listening`` line, answers, and
    on SIGINT the batcher stopped and exit code 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpqe_tpu_torch.serve", "--device", "cpu",
         "--init_seed", "0", "--syn_entities", "200", "--syn_triples",
         "1500", "--http", "127.0.0.1:0", "--max_wait_ms", "1"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=REPO))
    try:
        line = {}
        t = threading.Thread(
            target=lambda: line.update(json.loads(proc.stdout.readline())))
        t.start()
        t.join(timeout=WAIT_S)
        assert line, proc.stderr.read() if proc.poll() is not None else ""
        assert line["max_wait_ms"] == 1.0 and line["endpoints"] == [
            "GET /healthz", "GET /statz", "POST /v1/answer"]
        url = f"http://{line['listening']}"
        kg = tsamp.make_random_kg(n_entities=200, n_modes=3, n_base_rels=6,
                                  n_triples=1500, seed=0)
        q = tsamp.QuerySampler(kg, seed=3).sample_query("2-chain", n_neg=1)
        status, body = _post(url, {"queries": [_wire(q)], "k": 4})
        assert status == 200 and len(body["answers"][0]["entities"]) == 4
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=WAIT_S) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=WAIT_S)
        proc.stdout.close()
        proc.stderr.close()
