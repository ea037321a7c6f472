"""Zero-dependency JSON front end for the power-flow, N-1, VVC and
topology service and the jobs API (QSTS studies, topology sweeps).

Port of ``ServeServer`` from ``freedm_tpu/serve/http.py``: a stdlib
``ThreadingHTTPServer`` on a daemon thread, loopback bind by default,
ephemeral port when asked for 0.  One OS thread per in-flight request
is what the micro-batcher wants — concurrent waiters are what it
coalesces.

Routes:

- ``POST /v1/<workload>`` for each of ``WORKLOADS`` — ``/v1/pf`` with a
  JSON body matching
  :class:`~freedm_tpu_torch.serve.service.PowerFlowRequest`, ``/v1/n1``
  with one matching :class:`~freedm_tpu_torch.serve.service.N1Request`,
  ``/v1/vvc`` with one matching
  :class:`~freedm_tpu_torch.serve.service.VVCRequest`, ``/v1/topo`` with
  one matching :class:`~freedm_tpu_torch.serve.service.TopoRequest`; 200
  with the typed response dict on success;
- ``POST /v1/qsts`` — submit a QSTS study to the
  :class:`~freedm_tpu_torch.scenarios.jobs.JobManager` given as ``jobs``
  (202 with the job record), ``POST /v1/topo/sweep`` a topology sweep
  (202); ``GET /v1/jobs/<id>`` polls either and ``POST
  /v1/jobs/<id>/cancel`` cancels it; without ``jobs`` these answer the
  reference's typed 404 "QSTS jobs are not enabled on this server";
- ``GET /healthz`` — liveness + the workload/case table and ``"qsts"``
  (whether jobs are enabled);
- ``GET /stats`` — queue depth, buckets, per-shape dispatch counts and
  the serve metric snapshot, with the job table's counts under
  ``"qsts"``;
- ``GET /metrics`` — the registry in the Prometheus text format.

Every other route answers a typed 404 (snapshots are not ported yet).
Errors are typed: the body is
always ``{"error": {"type": <ServeError.code>, "detail": ...}}`` with
the matching HTTP status (400 invalid_request, 404 not_found, 429
overloaded, 503 shutting_down, 504 deadline_exceeded, 500 internal);
429/503 carry a ``Retry-After`` header.

Keep-alive discipline: handlers speak HTTP/1.1 persistent connections,
so the declared request body is read before any routing or validation
can fail, and a body the server refuses to read (oversized, bogus
``Content-Length``) answers with ``Connection: close``.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler
from urllib.parse import urlparse

from freedm_tpu_torch.core.metrics import REGISTRY, BackgroundHttpServer
from freedm_tpu_torch.serve.queue import InvalidRequest, NotFound, ServeError
from freedm_tpu_torch.serve.service import (BUS_CASES, FEEDER_CASES,
                                            WORKLOADS, Service)

#: Request bodies past this are refused unread.
MAX_BODY_BYTES = 4_000_000


def retry_after_header(seconds) -> str:
    """``Retry-After`` formatting: whole seconds, floor 1."""
    return str(int(max(1, round(float(seconds)))))


def read_request_body(handler, max_bytes: int = MAX_BODY_BYTES) -> bytes:
    """Read the declared request body, or refuse it with the connection
    marked for close — either way the socket is left positionally clean
    for (or closed against) the next pipelined request."""
    raw = handler.headers.get("Content-Length") or "0"
    try:
        length = int(raw)
    except ValueError:
        length = -1
    if length < 0 or length > max_bytes:
        handler.close_connection = True
        raise InvalidRequest(
            f"request body over {max_bytes} bytes or "
            f"Content-Length unparseable ({raw!r})"
        )
    return handler.rfile.read(length) if length else b""


class ServeServer(BackgroundHttpServer):
    """The JSON query endpoint of a :class:`Service`."""

    def __init__(self, service: Service, port: int = 0,
                 host: str = "127.0.0.1", jobs=None):
        # Loopback by default: the service has no auth; widening the
        # bind is an explicit caller decision.
        svc = service
        jm = jobs

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # load generators must not spam stderr
                pass

            def _reply(self, code: int, obj, retry_after_s=None) -> None:
                self._send(code, (json.dumps(obj) + "\n").encode(),
                           "application/json", retry_after_s)

            def _send(self, code: int, data: bytes, content_type: str,
                      retry_after_s=None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                if retry_after_s is not None:
                    self.send_header("Retry-After",
                                     retry_after_header(retry_after_s))
                if self.close_connection:
                    # An unread body is still on the socket: tell the
                    # client this connection is done.
                    self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(data)

            def _error(self, err: ServeError) -> None:
                self._reply(err.http_status,
                            {"error": {"type": err.code, "detail": str(err)}},
                            retry_after_s=err.retry_after_s)

            def _jobs(self):
                if jm is None:
                    raise NotFound("QSTS jobs are not enabled on this server")
                return jm

            def do_GET(self):
                path = urlparse(self.path).path
                try:
                    # GETs can legally carry a body: drain it like POST
                    # does, or the leftover bytes corrupt the next request.
                    read_request_body(self)
                    if path == "/healthz":
                        self._reply(200, {
                            "ok": True,
                            "device": str(svc.device),
                            "workloads": list(WORKLOADS),
                            "bus_cases": list(BUS_CASES),
                            "feeder_cases": list(FEEDER_CASES),
                            "qsts": jm is not None,
                        })
                    elif path == "/stats":
                        stats = svc.stats()
                        if jm is not None:
                            stats["qsts"] = jm.stats()
                        self._reply(200, stats)
                    elif path == "/metrics":
                        self._send(200, REGISTRY.render_prometheus().encode(),
                                   "text/plain; version=0.0.4; charset=utf-8")
                    elif path.startswith("/v1/jobs/"):
                        self._reply(200, self._jobs().get(
                            path[len("/v1/jobs/"):]))
                    else:
                        raise NotFound(f"no route GET {path}")
                except ServeError as e:
                    self._error(e)
                except Exception as e:  # noqa: BLE001 — always answer typed
                    self._reply(500, {"error": {"type": "internal",
                                                "detail": repr(e)}})

            def do_POST(self):
                path = urlparse(self.path).path
                try:
                    # Drain FIRST: everything after this point can fail
                    # without corrupting the persistent connection.
                    body = read_request_body(self)
                    if path.startswith("/v1/jobs/") and path.endswith("/cancel"):
                        job_id = path[len("/v1/jobs/"):-len("/cancel")]
                        self._reply(200, self._jobs().cancel(job_id))
                        return
                    workload = path[len("/v1/"):] if path.startswith("/v1/") else ""
                    if workload not in WORKLOADS and path not in (
                            "/v1/qsts", "/v1/topo/sweep"):
                        raise NotFound(f"no route POST {path}")
                    if not body:
                        raise InvalidRequest("missing JSON request body")
                    try:
                        payload = json.loads(body)
                    except ValueError as e:
                        raise InvalidRequest(f"malformed JSON: {e}") from None
                    if path == "/v1/qsts":
                        self._reply(202, self._jobs().submit(payload))
                        return
                    if path == "/v1/topo/sweep":
                        self._reply(202, self._jobs().submit_topo(payload))
                        return
                    response = svc.request(workload, payload)
                    self._reply(200, response.to_dict())
                except ServeError as e:
                    self._error(e)
                except Exception as e:  # noqa: BLE001 — always answer typed
                    self._reply(500, {"error": {"type": "internal",
                                                "detail": repr(e)}})

        super().__init__(Handler, port=port, host=host)
