"""Prometheus scrape endpoint over ``MetricsRegistry.exposition()`` (the
port's copy of the reference's endpoint).

Pure stdlib (``http.server``) so serving stacks can expose ``/metrics``
without pulling in a web framework: each :class:`MetricsHTTPServer` owns a
``ThreadingHTTPServer`` on its own daemon thread, renders the registry's
text exposition per request (version 0.0.4 content type), and answers 404
anywhere else.  ``port=0`` binds an ephemeral port — read ``server.port``
after ``start()`` — which is what the tests and the per-server
``start_metrics_http`` helpers use to avoid collisions.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .metrics import MetricsRegistry

__all__ = ["MetricsHTTPServer", "EXPOSITION_CONTENT_TYPE"]

EXPOSITION_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsHTTPServer:
    """Serve ``GET /metrics`` for one registry; idempotent start/stop."""

    def __init__(self, registry: MetricsRegistry, host: str = "127.0.0.1",
                 port: int = 0):
        self.registry = registry
        self._host = host
        self._want_port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> Optional[int]:
        """Bound port once started (resolves ``port=0``), else None."""
        return None if self._httpd is None else self._httpd.server_address[1]

    @property
    def url(self) -> Optional[str]:
        p = self.port
        return None if p is None else f"http://{self._host}:{p}/metrics"

    def start(self) -> "MetricsHTTPServer":
        if self._httpd is not None:
            return self
        registry = self.registry

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (http.server API)
                if self.path.split("?", 1)[0] != "/metrics":
                    self.send_error(404, "only /metrics is served here")
                    return
                body = registry.exposition().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", EXPOSITION_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):   # scrapes must not spam stderr
                pass

        self._httpd = ThreadingHTTPServer((self._host, self._want_port),
                                          Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="metrics-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
        self._httpd = None
        self._thread = None
