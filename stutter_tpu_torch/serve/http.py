"""HTTP frontend over the batching ``EmbeddingServer``, standard library only
(counterpart of ``stutter_tpu/serve/http.py``).

Each HTTP request blocks its own handler thread until the serving loop
answers it, so that concurrent requests share device batches as JSONL ones
do.

- ``POST /embed`` with a JSON body ``{"path": "/abs/clip.wav"}``: embed a
  file on the server's file system.
- ``POST /embed`` with raw audio bytes (any other content type): the body is
  spooled to a temporary file, embedded, and the file removed. The decoder
  finds the format from the content, not the file's suffix: WAV always, and
  FLAC, MP3, OGG and the rest where the host has libav (without it a
  compressed body gets the decode-failure answer).
- ``GET /stats``: the server's counters and latency percentiles (each
  request from its arrival in the serving loop's queue to its answer);
  ``GET /healthz``: liveness.

Under a plan the frontend binds on rank 0 only; the other ranks run
``EmbeddingServer.follow``. A spooled body stays on disk until rank 0 has
answered its request, which is after every rank has decoded it (rank 0
answers a batch once every rank's rows are gathered), but the followers
must see rank 0's temporary directory (``TMPDIR``) at the same path.

Answers are JSON: ``{"id", "ok": true, "embeddings": {column: [floats]}}``
(with ``prediction`` and ``probs`` where the server classifies); 422 with
``{"id", "ok": false, "error"}`` when decoding or the batch failed; 400 for
a malformed request (an oversized or empty body also closes the connection);
404 for an unknown path.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import queue
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterator

import numpy as np

from stutter_tpu_torch.serve.server import EmbeddingServer, Request, Response

logger = logging.getLogger("stutter_tpu_torch.serve.http")

_MAX_BODY_BYTES = 64 * 1024 * 1024  # 64 MB, ~35 min of 16 kHz 16-bit mono


class _Waiter:
    __slots__ = ("event", "response")

    def __init__(self):
        self.event = threading.Event()
        self.response: Response | None = None


class HttpEmbeddingFrontend:
    """Bridges HTTP handler threads to one ``EmbeddingServer`` loop: each
    handler enqueues its Request and waits on an event that the loop's emit
    sets. Port 0 binds a free port."""

    def __init__(self, server: EmbeddingServer, host: str = "127.0.0.1", port: int = 8000,
                 request_timeout_s: float = 120.0):
        if server.plan is not None and server.plan.rank != 0:
            raise ValueError("the HTTP frontend binds on rank 0 only; the other ranks "
                             "call server.follow()")
        self.server = server
        self.request_timeout_s = request_timeout_s
        self._queue: queue.Queue = queue.Queue()
        self._stop = object()
        self._waiters: dict[str, _Waiter] = {}
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self.httpd = ThreadingHTTPServer((host, port), _handler_class(self))
        self.host, self.port = self.httpd.server_address[0], self.httpd.server_address[1]
        self._serve_thread: threading.Thread | None = None
        self._http_thread: threading.Thread | None = None

    # -- serving-loop side -------------------------------------------------

    def _request_stream(self) -> Iterator[Request]:
        while True:
            r = self._queue.get()
            if r is self._stop:
                return
            yield r

    def _emit(self, resp: Response) -> None:
        with self._lock:
            waiter = self._waiters.pop(resp.req_id, None)
        if waiter is None:  # the handler gave up (timeout): drop the late answer
            logger.warning("dropping response for timed-out request %s", resp.req_id)
            return
        waiter.response = resp
        waiter.event.set()

    # -- handler side ------------------------------------------------------

    def submit(self, path: str) -> Response:
        """Enqueue one path and block until the serving loop answers."""
        req_id = f"h{next(self._ids)}"
        waiter = _Waiter()
        with self._lock:
            self._waiters[req_id] = waiter
        self._queue.put(Request(req_id, path))
        if not waiter.event.wait(self.request_timeout_s):
            with self._lock:
                self._waiters.pop(req_id, None)
            return Response(req_id, path, False, None,
                            f"timed out after {self.request_timeout_s:.0f}s")
        return waiter.response

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._serve_thread = threading.Thread(
            target=self.server.serve, args=(self._request_stream(), self._emit),
            daemon=True, name="embed-serving-loop")
        self._serve_thread.start()
        self._http_thread = threading.Thread(target=self.httpd.serve_forever, daemon=True,
                                             name="http-listener")
        self._http_thread.start()
        logger.info("HTTP embedding server listening on %s:%d", self.host, self.port)

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._queue.put(self._stop)
        if self._serve_thread is not None:
            # under a plan the loop must end its followers' rounds and stop
            # them before this process leaves the group
            self._serve_thread.join(timeout=5.0 if self.server.plan is None else None)

    def serve_forever(self) -> None:
        """The CLI's blocking entry; Ctrl-C shuts down cleanly."""
        self.start()
        try:
            while self._http_thread.is_alive():
                self._http_thread.join(timeout=0.5)
        except KeyboardInterrupt:
            logger.info("interrupt: shutting down")
        finally:
            self.shutdown()


def response_json(resp: Response) -> tuple[int, dict]:
    """(HTTP status, JSON body) of a serving response."""
    if not resp.ok:
        return 422, {"id": resp.req_id, "ok": False, "error": resp.error}
    obj = {"id": resp.req_id, "ok": True,
           "embeddings": {k: np.asarray(v, np.float32).tolist()
                          for k, v in resp.embeddings.items()}}
    if resp.prediction is not None:
        obj["prediction"] = resp.prediction
        if resp.probs is not None:
            obj["probs"] = resp.probs
    if resp.error:  # ok, but the classification failed
        obj["error"] = resp.error
    return 200, obj


def _handler_class(frontend: HttpEmbeddingFrontend):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, status: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler's API
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            elif self.path == "/stats":
                self._reply(200, frontend.server.stats())
            else:
                self._reply(404, {"ok": False, "error": f"no such path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/embed":
                self._reply(404, {"ok": False, "error": f"no such path {self.path}"})
                return
            length = int(self.headers.get("Content-Length") or 0)
            if length <= 0 or length > _MAX_BODY_BYTES:
                # the unread body would desynchronise a keep-alive connection:
                # close it after the reply instead of draining it
                self.close_connection = True
                self._reply(400, {"ok": False,
                                  "error": f"body required (<= {_MAX_BODY_BYTES} bytes)"})
                return
            body = self.rfile.read(length)
            ctype = (self.headers.get("Content-Type") or "").split(";")[0].strip()
            if ctype == "application/json":
                try:
                    path = json.loads(body)["path"]
                    if not isinstance(path, str):
                        raise TypeError(path)
                except (ValueError, KeyError, TypeError):
                    self._reply(400, {"ok": False, "error": 'JSON body must be {"path": ...}'})
                    return
                self._reply(*response_json(frontend.submit(path)))
                return
            # raw audio bytes: spool to a temporary file for the decoder, which
            # tells the format by its content, whatever the suffix
            fd, tmp = tempfile.mkstemp(suffix=".wav", prefix="serve_http_")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(body)
                self._reply(*response_json(frontend.submit(tmp)))
            finally:
                os.unlink(tmp)

        def log_message(self, fmt, *args):  # access logs to the module's logger
            logger.debug("%s - %s", self.address_string(), fmt % args)

    return Handler
