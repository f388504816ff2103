"""Stdlib-HTTP `/metrics` + `/healthz` endpoint (the role of coreth's
Prometheus gatherer handler + the avalanchego health API, without any
third-party dependency); counterpart of coreth_tpu/metrics/http.py.

Hardening rules: GET only (405 otherwise), exact-path routing (404
otherwise), Content-Length always set, handler exceptions become plain
500s (never a traceback on the wire), access logging suppressed, and the
server binds loopback by default — exposure beyond localhost is an
explicit config decision (`metrics-http-host`).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from . import Registry, default_registry

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsHTTPServer:
    """Owns a daemon-threaded ThreadingHTTPServer serving:

    GET /metrics  -> Prometheus text exposition of the registry
    GET /healthz  -> JSON health verdict, 200 healthy / 503 not

    `health_fn` returns a JSON-able dict with a boolean "healthy" key
    (vm.api.health_check has exactly that shape); omitted, the endpoint
    reports healthy as long as the process serves requests.
    """

    def __init__(self, registry: Optional[Registry] = None,
                 health_fn: Optional[Callable[[], dict]] = None):
        self.registry = registry or default_registry
        self.health_fn = health_fn
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle --------------------------------------------------------

    def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Bind and serve in a daemon thread; returns the bound port
        (useful with port=0)."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # no access-log spam
                pass

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        body = server.registry.export_prometheus().encode()
                        self._send(200, body, PROMETHEUS_CONTENT_TYPE)
                    elif path == "/healthz":
                        verdict = (server.health_fn() if server.health_fn
                                   else {"healthy": True})
                        code = 200 if verdict.get("healthy") else 503
                        self._send(code, json.dumps(verdict).encode(),
                                   "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except BrokenPipeError:
                    pass  # client went away mid-response
                except Exception:
                    from . import count_drop

                    count_drop("metrics/http/handler_error")
                    try:
                        self._send(500, b"internal error\n", "text/plain")
                    except OSError:
                        pass  # socket already dead; the counter is enough

            def do_POST(self):
                self._send(405, b"method not allowed\n", "text/plain")

            do_PUT = do_DELETE = do_PATCH = do_POST

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-http", daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    @property
    def port(self) -> Optional[int]:
        return self._httpd.server_address[1] if self._httpd else None

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
