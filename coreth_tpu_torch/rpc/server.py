"""JSON-RPC 2.0 engine (semantics of go-ethereum rpc/{server,http,
subscription}.go); counterpart of coreth_tpu/rpc/server.py. The
WebSocket transport (rpc/websocket.py) is not ported (ROADMAP "Still to
port", item 10b); subscriptions register here and wait for it.

Method registry keyed `namespace_method`, single + batch dispatch,
standard error codes, and pub/sub subscriptions. Serves over HTTP via the
stdlib ThreadingHTTPServer (handlers.go equivalents); tests can dispatch
in-process through `handle_raw`.

Overload behavior: when built
with a `ServingPolicy` (vm/api.create_handlers wires one from config),
dispatch runs on bounded cheap/expensive worker lanes, sheds `-32005`
(HTTP 429 + Retry-After) when a lane saturates, enforces cooperative
per-request deadlines, routes expensive methods through a circuit
breaker, and `stop()` drains in-flight work up to `rpc-drain-timeout`
before reporting what it abandoned. A bare `RPCServer()` (no policy)
dispatches inline on the transport's thread.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional

from ..fault import failpoint, register
from ..metrics import default_registry, observe_slo
from ..metrics import spans as _spans
from ..metrics import tracectx
from ..utils.deadline import Deadline, DeadlineExceeded
from ..utils.deadline import scope as _deadline_scope
from .admission import (ABANDONED, LIMIT_EXCEEDED, TIMEOUT_ERROR,
                        ServingPolicy, Shed, is_expensive)

PARSE_ERROR = -32700
INVALID_REQUEST = -32600
METHOD_NOT_FOUND = -32601
INVALID_PARAMS = -32602
INTERNAL_ERROR = -32603

# Overload/slow-handler drills (tests, CORETH_TPU_FAILPOINTS): `hang`
# here parks a worker exactly like a wedged handler would.
register("rpc/before_dispatch",
         "before every RPC handler invocation (on the serving worker)")
register("rpc/before_dispatch_expensive",
         "before expensive-lane handlers only (eth_call/eth_getLogs/"
         "debug_trace*), after the generic before_dispatch point")


class RPCError(Exception):
    def __init__(self, code: int, message: str, data=None):
        super().__init__(message)
        self.code = code
        self.data = data


class Subscription:
    def __init__(self, sub_id: str, notify: Callable[[Any], None]):
        self.id = sub_id
        self.notify = notify
        self.active = True
        self.cleanup: Optional[Callable[[], None]] = None


class RPCServer:
    def __init__(self, policy: Optional[ServingPolicy] = None):
        self._methods: Dict[str, Callable] = {}
        self._subscriptions: Dict[str, Subscription] = {}
        self._sub_factories: Dict[str, Callable] = {}
        self.lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._ipc_stops: List[Callable[[], None]] = []
        self.policy = policy
        self._draining = False

    @property
    def draining(self) -> bool:
        """True once stop() has begun: /healthz flips to 503 so load
        balancers route away while in-flight work drains."""
        return self._draining

    # --- registration -----------------------------------------------------

    def register(self, namespace: str, name: str, fn: Callable) -> None:
        self._methods[f"{namespace}_{name}"] = fn

    def register_api(self, namespace: str, api: object) -> None:
        """Register every public method of [api] under [namespace]
        (rpc/service.go reflection registration)."""
        for attr in dir(api):
            if attr.startswith("_"):
                continue
            fn = getattr(api, attr)
            if callable(fn):
                self.register(namespace, attr, fn)

    def unregister(self, namespace: str, name: str) -> None:
        """Remove one method — API gating carve-outs (the reference's
        eth-apis list gates at sub-namespace granularity, vm.go:1140)."""
        self._methods.pop(f"{namespace}_{name}", None)

    def register_subscription(self, namespace: str, name: str,
                              factory: Callable) -> None:
        """factory(notify_fn, *params) -> cleanup_fn|None."""
        self._sub_factories[f"{namespace}_{name}"] = factory

    # --- dispatch ---------------------------------------------------------

    def handle_raw(self, raw: bytes, meta: Optional[dict] = None) -> bytes:
        """Dispatch one wire payload. [meta], when given, receives
        transport hints: `status` (429/503/413) + `retry_after` when the
        whole payload was shed, so HTTP can answer with the right code
        while IPC/WS just relay the JSON error object."""
        policy = self.policy
        if (policy is not None and policy.body_limit
                and len(raw) > policy.body_limit):
            default_registry.counter("rpc/body_oversize").inc()
            if meta is not None:
                meta["status"] = 413
            return self._encode_error(
                None, INVALID_REQUEST,
                f"request body too large "
                f"({len(raw)} > {policy.body_limit} bytes)")
        try:
            payload = json.loads(raw)
        except Exception:
            return self._encode_error(None, PARSE_ERROR, "parse error")
        if isinstance(payload, list):
            if not payload:
                return self._encode_error(None, INVALID_REQUEST, "empty batch")
            if (policy is not None and policy.batch_limit
                    and len(payload) > policy.batch_limit):
                default_registry.counter("rpc/batch_oversize").inc()
                return self._encode_error(
                    None, INVALID_REQUEST,
                    f"batch too large "
                    f"({len(payload)} > {policy.batch_limit} requests)")
            out = [self._handle_one(req, meta) for req in payload]
            self._finish_meta(meta, len(payload))
            return json.dumps([json.loads(o) for o in out if o]).encode()
        resp = self._handle_one(payload, meta)
        self._finish_meta(meta, 1)
        return resp

    @staticmethod
    def _finish_meta(meta: Optional[dict], total: int) -> None:
        """Fully-shed payloads surface as HTTP 429 (503 while draining —
        set at shed time); partial batch sheds stay 200 with per-item
        error objects, standard JSON-RPC batch semantics."""
        if meta is not None and meta.get("sheds", 0) >= total:
            meta.setdefault("status", 429)
            meta.setdefault("retry_after", 1)

    def _handle_one(self, req, meta: Optional[dict] = None) -> bytes:
        if not isinstance(req, dict):
            return self._encode_error(None, INVALID_REQUEST, "invalid request")
        req_id = req.get("id")
        method = req.get("method")
        if not isinstance(method, str):
            return self._encode_error(req_id, INVALID_REQUEST, "missing method")
        params = req.get("params", [])
        fn = self._methods.get(method)
        if fn is None:
            return self._encode_error(
                req_id, METHOD_NOT_FOUND, f"the method {method} does not exist"
            )
        # mint the request's trace context at admission: it rides the
        # lane handoff (WorkerPool.submit captures it), parents worker-side
        # spans, and stamps every shed/expiry/abandonment answer
        ctx = None
        if tracectx.enabled:
            parent_span_id = None
            if _spans.enabled:
                cur = _spans.tracer.current()
                if cur is not None:
                    parent_span_id = cur.span_id
            ctx = tracectx.begin("rpc", parent_span_id)
            ctx.meta["method"] = method
        t0 = time.monotonic()
        with tracectx.scope(ctx):
            resp = self._dispatch_one(req_id, method, fn, params, meta)
            elapsed = time.monotonic() - t0
            observe_slo("slo/rpc/" + method, elapsed,
                        ctx.trace_id if ctx is not None else None)
            if ctx is not None and "outcome" not in ctx.meta:
                policy = self.policy
                slo = policy.slo_budget if policy is not None else 0.0
                if 0 < slo < elapsed:
                    ctx.meta["over_slo_budget_s"] = slo
                    tracectx.capture(ctx, "slow")
        return resp

    def _dispatch_one(self, req_id, method, fn, params,
                      meta: Optional[dict]) -> bytes:
        policy = self.policy
        if policy is None:
            return self._run_handler(req_id, method, fn, params, None)[0]
        lane = policy.lane(method)
        deadline = None
        budget = policy.budget_for(method)
        if budget > 0:
            # the budget covers queue wait + execution: bounded latency,
            # not just bounded run time
            deadline = Deadline(budget)
            ctx = tracectx.current()
            if ctx is not None:
                ctx.meta["budget_s"] = budget
        if lane is None:
            return self._run_handler(req_id, method, fn, params, deadline)[0]
        return self._dispatch_pooled(req_id, method, fn, params, lane,
                                     deadline, meta)

    def _dispatch_pooled(self, req_id, method, fn, params, lane, deadline,
                         meta: Optional[dict]) -> bytes:
        policy = self.policy
        expensive = lane is policy.expensive_pool
        probe = False
        if expensive:
            verdict = policy.breaker.admit()
            if verdict == "shed":
                self._count_shed(method, "breaker", meta)
                return self._encode_error(
                    req_id, LIMIT_EXCEEDED,
                    "circuit breaker open: expensive methods are "
                    "timing out; retry later",
                    self._trace_capture("shed", reason="breaker",
                                        code=LIMIT_EXCEEDED))
            probe = verdict == "probe"
        try:
            fut = lane.submit(
                method,
                lambda: self._run_handler(req_id, method, fn, params,
                                          deadline))
        except Shed as s:
            self._count_shed(method, s.reason, meta)
            code = TIMEOUT_ERROR if s.reason == "draining" else LIMIT_EXCEEDED
            return self._encode_error(
                req_id, code, str(s),
                self._trace_capture("shed", reason=s.reason, code=code))
        # Cooperative handlers answer by their deadline; the wait backstop
        # only catches a handler that never reaches a checkpoint (its
        # worker stays lost until it returns — threads cannot be killed).
        wait_timeout = None
        if deadline is not None:
            wait_timeout = (deadline.remaining()
                            + max(1.0, 2.0 * deadline.budget))
        done, value = fut.wait(wait_timeout)
        if not done:
            default_registry.counter("rpc/timeout").inc()
            default_registry.counter("rpc/stuck_workers").inc()
            if expensive:
                policy.breaker.record(True, probe)
            return self._encode_error(
                req_id, TIMEOUT_ERROR,
                f"request exceeded its {deadline.budget:g}s budget "
                f"(handler missed every deadline checkpoint)",
                self._trace_capture("stuck", code=TIMEOUT_ERROR))
        if value is ABANDONED:
            return self._encode_error(
                req_id, TIMEOUT_ERROR,
                "server shut down before the request was served",
                self._trace_capture("abandoned", code=TIMEOUT_ERROR))
        resp, timed_out = value
        if expensive:
            policy.breaker.record(timed_out, probe)
        return resp

    def _run_handler(self, req_id, method, fn, params, deadline):
        """Invoke one handler (inline or on a lane worker).
        -> (response bytes, timed_out)."""
        try:
            failpoint("rpc/before_dispatch")
            if is_expensive(method):
                failpoint("rpc/before_dispatch_expensive")
            with _spans.span("rpc/" + method):
                with _deadline_scope(deadline):
                    if deadline is not None:
                        deadline.check()  # shed queue-expired work unrun
                    if isinstance(params, dict):
                        result = fn(**params)
                    else:
                        result = fn(*params)
        except DeadlineExceeded as e:
            default_registry.counter("rpc/timeout").inc()
            return self._encode_error(
                req_id, TIMEOUT_ERROR, str(e),
                self._trace_capture("deadline_expired",
                                    code=TIMEOUT_ERROR)), True
        except RPCError as e:
            return self._encode_error(req_id, e.code, str(e), e.data), False
        except TypeError as e:
            return self._encode_error(req_id, INVALID_PARAMS, str(e)), False
        except Exception as e:
            return self._encode_error(req_id, INTERNAL_ERROR, str(e)), False
        return json.dumps(
            {"jsonrpc": "2.0", "id": req_id, "result": result}
        ).encode(), False

    @staticmethod
    def _trace_capture(outcome: str, reason: Optional[str] = None,
                       code: Optional[int] = None) -> Optional[dict]:
        """Capture the calling thread's trace (if any) into the ring with
        [outcome], and return the error `data` payload carrying its id —
        None when tracing is off, so `_encode_error` stays clean."""
        ctx = tracectx.current()
        if ctx is None:
            return None
        ctx.meta["outcome"] = outcome
        if reason is not None:
            ctx.meta["shed_reason"] = reason
        if code is not None:
            ctx.meta["error_code"] = code
        tracectx.capture(ctx, outcome)
        return {"traceId": ctx.trace_id}

    @staticmethod
    def _count_shed(method: str, reason: str, meta: Optional[dict]) -> None:
        default_registry.counter("rpc/shed").inc()
        default_registry.counter(f"rpc/shed/{reason}").inc()
        if meta is not None:
            meta["sheds"] = meta.get("sheds", 0) + 1
            if reason == "draining":
                meta["status"] = 503
                meta["retry_after"] = 1

    @staticmethod
    def _encode_error(req_id, code: int, message: str, data=None) -> bytes:
        err = {"code": code, "message": message}
        if data is not None:
            err["data"] = data
        return json.dumps({"jsonrpc": "2.0", "id": req_id, "error": err}).encode()

    # --- subscriptions ----------------------------------------------------

    def subscribe(self, method: str, notify: Callable[[Any], None], *params) -> str:
        factory = self._sub_factories.get(method)
        if factory is None:
            raise RPCError(METHOD_NOT_FOUND, f"no subscription {method}")
        sub_id = "0x" + uuid.uuid4().hex
        sub = Subscription(sub_id, notify)
        with self.lock:
            self._subscriptions[sub_id] = sub
        try:
            cleanup = factory(lambda item: self._notify(sub_id, item), *params)
        except BaseException:
            with self.lock:
                self._subscriptions.pop(sub_id, None)
            raise
        with self.lock:
            if sub_id in self._subscriptions:
                sub.cleanup = cleanup
                return sub_id
        # unsubscribe raced registration: tear the feed down now
        if cleanup is not None:
            cleanup()
        return sub_id

    def _notify(self, sub_id: str, item) -> None:
        sub = self._subscriptions.get(sub_id)
        if sub is not None and sub.active:
            sub.notify(item)

    def unsubscribe(self, sub_id: str) -> bool:
        with self.lock:
            sub = self._subscriptions.pop(sub_id, None)
        if sub is not None:
            sub.active = False
            if sub.cleanup is not None:
                sub.cleanup()
            return True
        return False

    # --- HTTP transport ---------------------------------------------------

    def serve_http(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start the HTTP listener; returns the bound port."""
        server = self
        policy = self.policy
        conn_sem = (threading.BoundedSemaphore(policy.max_connections)
                    if policy is not None and policy.max_connections > 0
                    else None)

        class Handler(BaseHTTPRequestHandler):
            def _respond(self, status: int, resp: bytes,
                         retry_after=None, close=False):
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(resp)))
                if retry_after is not None:
                    self.send_header("Retry-After", str(retry_after))
                if close:
                    self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(resp)

            def do_POST(self):
                length = int(self.headers.get("Content-Length", 0) or 0)
                if (policy is not None and policy.body_limit
                        and length > policy.body_limit):
                    # reject on the declared length: never buffer a body
                    # the policy already rules out
                    default_registry.counter("rpc/body_oversize").inc()
                    self._respond(
                        413,
                        server._encode_error(
                            None, INVALID_REQUEST,
                            f"request body too large "
                            f"({length} > {policy.body_limit} bytes)"),
                        close=True)
                    return
                body = self.rfile.read(length)
                meta: dict = {}
                resp = server.handle_raw(body, meta)
                self._respond(meta.get("status", 200), resp,
                              meta.get("retry_after"))

            def log_message(self, *args):
                pass

        class _Srv(ThreadingHTTPServer):
            # hard cap on concurrent connections: past it the socket is
            # answered 429 inline instead of spawning a thread
            def process_request(self, request, client_address):
                if conn_sem is not None and not conn_sem.acquire(
                        blocking=False):
                    default_registry.counter("rpc/shed").inc()
                    default_registry.counter("rpc/shed/connections").inc()
                    try:
                        request.sendall(
                            b"HTTP/1.1 429 Too Many Requests\r\n"
                            b"Retry-After: 1\r\nContent-Length: 0\r\n"
                            b"Connection: close\r\n\r\n")
                    except OSError:
                        pass  # client gone: the 429 had no audience
                    self.shutdown_request(request)
                    return
                try:
                    super().process_request(request, client_address)
                except BaseException:
                    if conn_sem is not None:
                        conn_sem.release()
                    raise

            def process_request_thread(self, request, client_address):
                try:
                    super().process_request_thread(request, client_address)
                finally:
                    if conn_sem is not None:
                        conn_sem.release()

        self._httpd = _Srv((host, port), Handler)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="rpc-http", daemon=True)
        self._http_thread.start()
        return self._httpd.server_address[1]

    # --- IPC transport ----------------------------------------------------

    def serve_ipc(self, path: str):
        """Unix-domain-socket endpoint (rpc/ipc.go): newline-delimited
        JSON-RPC, one connection per client, served on daemon threads.
        Returns a stop() callable (also invoked by RPCServer.stop())."""
        import os
        import socketserver

        try:
            os.unlink(path)
        except OSError:
            pass
        server = self
        policy = self.policy
        body_limit = policy.body_limit if policy is not None else 0

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                while True:
                    # bounded readline: an endless unterminated line must
                    # not buffer past the body cap
                    line = self.rfile.readline(
                        body_limit + 2 if body_limit else -1)
                    if not line:
                        return
                    payload = line.rstrip(b"\r\n")
                    if body_limit and len(payload) > body_limit:
                        default_registry.counter("rpc/body_oversize").inc()
                        self.wfile.write(server._encode_error(
                            None, INVALID_REQUEST,
                            f"request body too large "
                            f"(> {body_limit} bytes)") + b"\n")
                        self.wfile.flush()
                        return  # the stream is mid-line: resync is a new conn
                    if not payload:
                        continue
                    resp = server.handle_raw(payload)
                    self.wfile.write(resp + b"\n")
                    self.wfile.flush()

        class _Srv(socketserver.ThreadingUnixStreamServer):
            daemon_threads = True

        srv = _Srv(path, Handler)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()

        def stop():
            srv.shutdown()
            srv.server_close()
            thread.join(timeout=5)
            try:
                os.unlink(path)
            except OSError:
                pass

        self._ipc_stops.append(stop)
        return stop

    # --- shutdown ---------------------------------------------------------

    def serving_status(self) -> dict:
        """Live admission/breaker/drain state (debug_rpcStatus)."""
        if self.policy is None:
            return {"pooled": False}
        return self.policy.status()

    def stop(self, drain_timeout: Optional[float] = None) -> dict:
        """Stop accepting (HTTP + every IPC endpoint), drain in-flight
        dispatches up to [drain_timeout] (default: the rpc-drain-timeout
        knob), then report what was abandoned:
        {"drained": bool, "abandoned": n, "abandoned_methods": [...]}."""
        self._draining = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
            self._http_thread.join(timeout=5)
            self._http_thread = None
        ipc_stops, self._ipc_stops = self._ipc_stops, []
        for stop_ipc in ipc_stops:
            stop_ipc()
        if self.policy is None:
            return {"drained": True, "abandoned": 0, "abandoned_methods": []}
        return self.policy.drain(drain_timeout)
