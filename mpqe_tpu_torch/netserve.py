"""HTTP JSON serving: a network front end over :class:`serve.QueryServer`
with cross-request micro-batching (counterpart of
``mpqe_tpu/netserve.py``).

* One **batcher thread** owns the card: concurrent client requests are
  coalesced into one ``QueryServer.answer`` per distinct ``k`` (each
  eligible structure group of it one K3 launch per layer), so the card's
  throughput is set by the batched rank dispatch, not by per-request
  latency.  A request waits at most ``max_wait_ms`` for co-travellers.
  Handler threads only parse and serialize JSON; a dispatch that raises
  fails every request of its group (HTTP 500) and the batcher goes on.
* Requests are validated against the KG schema before they reach the
  card: structure name, template arity, entity and relation id ranges,
  and anchor modes against relation domains; variable-slot modes come
  from the relation schema (``data/loader.py derive_node_modes``,
  strict).
* The stdlib ``http.server`` (threaded), no framework.

Endpoints::

  GET  /healthz   -> {"ok": true, "n_entities": N, "n_rels": R,
                      "structures": [...]}
  GET  /statz     -> {"total_dispatches", "total_queries",
                      "mean_queries_per_dispatch", "recent_dispatch_sizes",
                      "max_batch", "max_wait_ms"}
  POST /v1/answer {"queries": [{"structure": "2-chain", "anchors": [3],
                                "rels": [4, 7]}, ...], "k": 10}
                  -> {"answers": [{"entities": [...], "scores": [...]}]}

``python -m mpqe_tpu_torch.serve --http HOST:PORT`` is the CLI entry.
"""

from __future__ import annotations

import collections
import json
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

from mpqe_tpu_torch.queries import STRUCTURES, Formula, Query
from mpqe_tpu_torch.serve import Answer, QueryServer


class QueryValidationError(ValueError):
    pass


def build_query(kg, structure: str, anchors: Sequence[int],
                rels: Sequence[int]) -> Query:
    """A wire-format query validated against the KG schema -> ``Query``.

    ``rels`` are directed relation ids in template-edge (anchor-to-
    target) order, the in-memory convention of the rest of the port."""
    if structure not in STRUCTURES:
        raise QueryValidationError(
            f"unknown structure {structure!r}; expected one of "
            f"{sorted(STRUCTURES)}")
    spec = STRUCTURES[structure]
    if len(anchors) != spec.n_anchors:
        raise QueryValidationError(
            f"{structure} takes {spec.n_anchors} anchors, got {len(anchors)}")
    if len(rels) != spec.n_edges:
        raise QueryValidationError(
            f"{structure} takes {spec.n_edges} relations, got {len(rels)}")
    anchors = [int(a) for a in anchors]
    rels = [int(r) for r in rels]
    for a in anchors:
        if not 0 <= a < kg.n_entities:
            raise QueryValidationError(f"anchor {a} out of range")
    for r in rels:
        if not 0 <= r < kg.n_rels:
            raise QueryValidationError(f"relation {r} out of range")
    from mpqe_tpu_torch.data.loader import derive_node_modes

    try:
        # strict: domain-vs-source consistency along each relation chain
        # and agreement of the edges meeting at an intersection slot
        node_modes = derive_node_modes(kg, spec, anchors, rels, strict=True)
    except ValueError as e:
        raise QueryValidationError(str(e)) from None
    return Query(Formula(structure, tuple(rels), node_modes),
                 tuple(anchors), 0, (), ())


# ----------------------------------------------------------------------
class MicroBatcher:
    """Coalesces concurrent requests into shared dispatches.

    :meth:`submit` enqueues one request and returns a ``Future``; the one
    worker thread drains the queue (up to ``max_batch`` queries, or
    ``max_wait_ms`` after the first item), groups by ``k`` and runs one
    ``server.answer`` per group.  ``batch_sizes`` keeps the most recent
    dispatch sizes (bounded); ``total_dispatches`` and ``total_queries``
    count over the batcher's life; ``stats_lock`` guards the three."""

    _STOP = object()

    def __init__(self, server: QueryServer, max_batch: int = 4096,
                 max_wait_ms: float = 5.0):
        self.server = server
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.batch_sizes: "collections.deque[int]" = collections.deque(
            maxlen=1024)
        self.total_dispatches = 0
        self.total_queries = 0
        # /statz reads these from handler threads while _loop appends
        self.stats_lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False

    def start(self) -> "MicroBatcher":
        if self._thread is None and not self._stopped:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the worker after its current dispatch, and fail every
        request still queued (orphans) instead of leaving its handler
        blocked until the request timeout."""
        self._stopped = True
        if self._thread is not None:
            self._q.put(self._STOP)
            self._thread.join(timeout=10)
            self._thread = None
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is self._STOP:
                continue
            _, _, fut = item
            if not fut.done():
                fut.set_exception(RuntimeError("batcher stopped"))

    def submit(self, queries: Sequence[Query], k: int) -> Future:
        """One request (any number of queries) -> ``Future[List[Answer]]``."""
        fut: Future = Future()
        if self._stopped:
            fut.set_exception(RuntimeError("batcher stopped"))
            return fut
        self._q.put((list(queries), int(k), fut))
        return fut

    # ------------------------------------------------------------------
    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is self._STOP:
                return
            batch = [item]
            n = len(item[0])
            deadline = time.monotonic() + self.max_wait_s
            while n < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is self._STOP:
                    self._drain(batch)
                    return
                batch.append(nxt)
                n += len(nxt[0])
            self._drain(batch)

    def _drain(self, batch) -> None:
        n = sum(len(qs) for qs, _, _ in batch)
        with self.stats_lock:
            self.batch_sizes.append(n)
            self.total_dispatches += 1
            self.total_queries += n
        by_k: Dict[int, List[Tuple[List[Query], Future]]] = {}
        for qs, k, fut in batch:
            by_k.setdefault(k, []).append((qs, fut))
        for k, group in by_k.items():
            flat: List[Query] = []
            spans: List[Tuple[Future, int, int]] = []
            for qs, fut in group:
                spans.append((fut, len(flat), len(flat) + len(qs)))
                flat.extend(qs)
            try:
                # QueryServer sets its own inference mode: grad and
                # inference modes are thread-local
                answers = self.server.answer(flat, k=k)
            except Exception as e:  # noqa: BLE001 — to every request
                for fut, _, _ in spans:
                    if not fut.cancelled():
                        fut.set_exception(e)
                continue
            for fut, lo, hi in spans:
                if not fut.cancelled():
                    fut.set_result(answers[lo:hi])


# ----------------------------------------------------------------------
def _answer_to_json(a: Answer) -> Dict:
    return {
        "entities": [int(e) for e in a.entity_ids],
        "scores": [float(s) for s in a.scores],
    }


class _Handler(BaseHTTPRequestHandler):
    # set on the server instance by make_http_server:
    #   server.kg, server.batcher, server.default_k, server.request_timeout_s

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, payload: Dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — stdlib API
        if self.path == "/healthz":
            kg = self.server.kg
            self._send(200, {
                "ok": True,
                "n_entities": int(kg.n_entities),
                "n_rels": int(kg.n_rels),
                "structures": sorted(STRUCTURES),
            })
            return
        if self.path == "/statz":
            b = self.server.batcher
            with b.stats_lock:
                sizes = list(b.batch_sizes)
                dispatches = b.total_dispatches
                queries = b.total_queries
            self._send(200, {
                "total_dispatches": dispatches,
                "total_queries": queries,
                "mean_queries_per_dispatch": (
                    queries / dispatches if dispatches else 0.0),
                "recent_dispatch_sizes": sizes[-32:],
                "max_batch": b.max_batch,
                "max_wait_ms": b.max_wait_s * 1e3,
            })
            return
        self._send(404, {"error": "not found"})

    def do_POST(self):  # noqa: N802 — stdlib API
        if self.path != "/v1/answer":
            self._send(404, {"error": "not found"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(req, dict):
                raise QueryValidationError("request body must be an object")
            raw = req.get("queries")
            if not isinstance(raw, list) or not raw:
                raise QueryValidationError(
                    "'queries' must be a non-empty list")
            k = int(req.get("k", self.server.default_k))
            if not 1 <= k <= self.server.kg.n_entities:
                raise QueryValidationError(f"k={k} out of range")
            queries = []
            for q in raw:
                if not isinstance(q, dict):
                    raise QueryValidationError(
                        "each query must be an object with "
                        "structure/anchors/rels")
                queries.append(
                    build_query(self.server.kg, q.get("structure", ""),
                                q.get("anchors", ()), q.get("rels", ())))
        except (QueryValidationError, ValueError, TypeError, KeyError) as e:
            self._send(400, {"error": str(e)})
            return
        fut = self.server.batcher.submit(queries, k)
        try:
            answers = fut.result(timeout=self.server.request_timeout_s)
        except Exception as e:  # noqa: BLE001 — report, keep serving
            self._send(500, {"error": f"{type(e).__name__}: {e}"})
            return
        self._send(200, {"answers": [_answer_to_json(a) for a in answers]})


def make_http_server(
    qserver: QueryServer,
    kg,
    host: str = "127.0.0.1",
    port: int = 0,
    *,
    default_k: int = 10,
    max_batch: int = 4096,
    max_wait_ms: float = 5.0,
    request_timeout_s: float = 600.0,
) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server, its batcher started.
    Call ``serve_forever()`` on the result (or run it in a thread); tear
    down with ``shutdown()``, ``server_close()`` and ``batcher.stop()``."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.kg = kg
    httpd.default_k = int(default_k)
    httpd.request_timeout_s = float(request_timeout_s)
    httpd.batcher = MicroBatcher(
        qserver, max_batch=max_batch, max_wait_ms=max_wait_ms).start()
    return httpd
