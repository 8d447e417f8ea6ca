"""Live read-only introspection endpoint for the resident service.

The port's copy of ``tpu_radix_join/observability/statusz.py``.
``--serve --statusz PORT`` (and the one-shot join's ``--statusz``)
starts a stdlib ``http.server`` thread that answers JSON snapshots of what
the process is doing now: the current phase and open spans, the counter
registry, and, under ``--serve``, the session's SLO / breaker / queue
state, the lease board and the caches — so an operator or a supervisor can
ask a live worker what it is doing without attaching a debugger.

  * **read-only** — GET only; every handler renders a snapshot callable
    and nothing mutates the session;
  * **isolated** — a section provider that raises renders as
    ``{"error": ...}`` in place: a request never takes the serving path
    down;
  * **pull-priced** — nothing runs until someone asks: no sampling thread
    of its own.  Providers run on the server's thread, so they read host
    state and tensor metadata only (``nbytes``, shapes), never a tensor's
    values: a provider never reads the card back.

Routes: ``/statusz`` (all sections), ``/statusz/<section>`` (one),
``/healthz`` (readiness: ``{"ok": true}`` 200 while the plane can take a
query, ``{"ok": false, "reason": ...}`` 503 when it cannot — session
closed, breaker open, own lease stale).  Binds 127.0.0.1 only.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional


class StatuszServer:
    """Serve read-only JSON snapshots from registered section callables."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 sections: Optional[Dict[str, Callable[[], object]]] = None,
                 readiness: Optional[Callable[[], object]] = None):
        self._host = host
        self._port = int(port)
        self._sections: Dict[str, Callable[[], object]] = dict(
            sections or {})
        self._readiness = readiness
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.requests_served = 0

    # ------------------------------------------------------------- sections
    def add_section(self, name: str, provider: Callable[[], object]
                    ) -> None:
        self._sections[name] = provider

    def set_readiness(self, provider: Callable[[], object]) -> None:
        """Install the ``/healthz`` readiness callable.  It returns either
        a bool or a ``{"ok": bool, "reason": ...}`` dict; ``ok=False``
        answers 503.  Without one, ``/healthz`` stays a liveness ping
        (the process answering IS the health)."""
        self._readiness = provider

    def health(self) -> tuple:
        """(status_code, body) for ``/healthz`` — testable in-process.
        A readiness provider that *raises* reads as not-ready: a plane
        that cannot even describe its health must not take traffic."""
        body = {"ok": True, "t_epoch_s": time.time()}
        if self._readiness is not None:
            try:
                verdict = self._readiness()
            except Exception as e:     # noqa: BLE001 — render, never raise
                verdict = {"ok": False,
                           "reason": f"readiness error: "
                                     f"{type(e).__name__}: {e}"}
            if isinstance(verdict, dict):
                body.update(verdict)
            else:
                body["ok"] = bool(verdict)
        return (200 if body.get("ok") else 503), body

    def _render_section(self, name: str) -> object:
        provider = self._sections.get(name)
        if provider is None:
            return {"error": f"unknown section {name!r}",
                    "sections": sorted(self._sections)}
        try:
            return provider()
        except Exception as e:     # snapshot errors render, never raise
            return {"error": f"{type(e).__name__}: {e}"}

    def snapshot(self, section: Optional[str] = None) -> dict:
        """The same payload the HTTP plane serves (testable in-process)."""
        body = {"t_epoch_s": time.time()}
        if section:
            body[section] = self._render_section(section)
        else:
            for name in sorted(self._sections):
                body[name] = self._render_section(name)
        return body

    # ------------------------------------------------------------ lifecycle
    @property
    def port(self) -> int:
        """Bound port (resolves an ephemeral port=0 after start)."""
        return self._port

    def start(self) -> int:
        if self._httpd is not None:
            return self._port
        server = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (http.server API)
                path = self.path.split("?", 1)[0].rstrip("/")
                code = 200
                if path == "/healthz":
                    code, body = server.health()
                elif path == "/statusz":
                    body = server.snapshot()
                elif path.startswith("/statusz/"):
                    body = server.snapshot(path[len("/statusz/"):])
                else:
                    self.send_error(404, "try /statusz or /healthz")
                    return
                # default=str: snapshots may carry exotica (paths, enums)
                data = json.dumps(body, default=str).encode()
                server.requests_served += 1
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):  # quiet: stdout carries BENCH/JSON
                pass

        self._httpd = ThreadingHTTPServer((self._host, self._port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.2},
            name=f"statusz:{self._port}", daemon=True)
        self._thread.start()
        return self._port

    def stop(self) -> None:
        httpd, self._httpd = self._httpd, None
        if httpd is None:
            return
        httpd.shutdown()
        httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # context-manager sugar for tests
    def __enter__(self) -> "StatuszServer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def measurements_sections(measurements) -> Dict[str, Callable[[], object]]:
    """Standard sections derivable from a Measurements registry alone:
    current phase (open spans + ring context), and the counter/tag
    registry.  Service-level sections (service, leases, cache, batch)
    are added by the serve wiring, which owns those objects."""
    def phase() -> dict:
        rec = getattr(measurements, "flightrec", None)
        tracer = getattr(measurements, "tracer", None)
        open_spans = {}
        if tracer is not None:
            open_spans = {name: len(stack)
                          for name, stack in tracer._open.items() if stack}
        out = {"open_spans": open_spans}
        if rec is not None:
            out["context"] = dict(rec.context)
            out["idle_s"] = round(rec.idle_s(), 3)
        return out

    def counters() -> dict:
        times = getattr(measurements, "times_us", {}) or {}
        counts = getattr(measurements, "counters", {}) or {}
        return {
            "times_us": {k: round(float(v), 1)
                         for k, v in sorted(times.items())},
            "counters": {k: int(v) for k, v in sorted(counts.items())},
        }

    return {"phase": phase, "counters": counters}
