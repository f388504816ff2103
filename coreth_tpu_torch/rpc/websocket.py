"""WebSocket JSON-RPC transport with push subscriptions (semantics of
coreth rpc/websocket.go + subscription.go); counterpart of
coreth_tpu/rpc/websocket.py.

RFC 6455 over stdlib sockets — handshake (Sec-WebSocket-Accept), frame
codec (client->server masked, server->client unmasked), ping/pong/close.
Each text frame is a JSON-RPC request; `eth_subscribe`/`eth_unsubscribe`
are connection-scoped: notifications push as

    {"jsonrpc":"2.0","method":"eth_subscription",
     "params":{"subscription": id, "result": ...}}

and every subscription a connection holds is torn down when it closes
(websocket.go connection lifetime semantics). A per-connection token
bucket throttles message processing — the reference's WS CPU limiter
(plugin/evm/vm.go:1178-1186, ws-cpu-refill-rate / ws-cpu-max-stored).

Backpressure (ROBUSTNESS.md "Serving under overload"): when
`notify_queue_size` > 0, notifications go through a bounded per-client
queue drained by a dedicated writer thread; a client that stops reading
fills its queue and is *disconnected deterministically*
(`rpc/ws/slow_disconnects`) instead of blocking the producer — one
stalled subscriber can never wedge block acceptance. `max_payload`
bounds inbound frames (the websocket half of the rpc-body-limit cap).

`WSClient` is the in-repo test/tooling client (role of the reference's
rpc.DialWebsocket for its own tests).

Departure from the reference (ROADMAP Queue 3): `WSServer.stop()` joins
the accept thread and every connection's reader and notify writer, so a
stopped server leaves no thread; the reference closes the sockets and
joins nothing.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import queue
import socket
import struct
import threading
import time
from typing import Any, List, Optional, Tuple

from ..fault import failpoint, register
from ..metrics import count_drop, default_registry
from ..metrics import tracectx

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# `hang` here parks the notification writer — a deterministic stand-in
# for a client that stopped reading (no TCP buffer games needed).
register("ws/before_notify",
         "in the per-connection writer thread, before each subscription "
         "notification frame is written")

OP_TEXT = 0x1
OP_CLOSE = 0x8
OP_PING = 0x9
OP_PONG = 0xA


def _accept_key(key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((key + _GUID).encode()).digest()
    ).decode()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return buf


class FrameTooLarge(ConnectionError):
    """An inbound frame exceeded [max_payload] — raised *before* the
    oversized payload is buffered."""

    def __init__(self, size: int, limit: int):
        super().__init__(f"frame too large ({size} > {limit} bytes)")


def read_frame(sock: socket.socket,
               max_payload: int = 0) -> Tuple[int, bytes]:
    """-> (opcode, payload); handles fragmentation by concatenation.
    [max_payload] > 0 rejects oversized frames from the declared length
    (never buffering them) with FrameTooLarge."""
    payload = b""
    opcode = None
    while True:
        h = _recv_exact(sock, 2)
        fin = h[0] & 0x80
        op = h[0] & 0x0F
        masked = h[1] & 0x80
        ln = h[1] & 0x7F
        if ln == 126:
            ln = struct.unpack(">H", _recv_exact(sock, 2))[0]
        elif ln == 127:
            ln = struct.unpack(">Q", _recv_exact(sock, 8))[0]
        if max_payload and len(payload) + ln > max_payload:
            raise FrameTooLarge(len(payload) + ln, max_payload)
        mask = _recv_exact(sock, 4) if masked else None
        data = _recv_exact(sock, ln) if ln else b""
        if mask:
            data = bytes(b ^ mask[i % 4] for i, b in enumerate(data))
        if opcode is None:
            opcode = op
        payload += data
        if fin:
            return opcode, payload


def write_frame(sock: socket.socket, opcode: int, payload: bytes,
                mask: bool = False) -> None:
    b0 = 0x80 | opcode
    header = bytes([b0])
    ln = len(payload)
    mask_bit = 0x80 if mask else 0
    if ln < 126:
        header += bytes([mask_bit | ln])
    elif ln < (1 << 16):
        header += bytes([mask_bit | 126]) + struct.pack(">H", ln)
    else:
        header += bytes([mask_bit | 127]) + struct.pack(">Q", ln)
    if mask:
        mk = os.urandom(4)
        payload = bytes(b ^ mk[i % 4] for i, b in enumerate(payload))
        header += mk
    sock.sendall(header + payload)


class _TokenBucket:
    """ws-cpu-refill-rate / ws-cpu-max-stored: each message costs one
    token; an empty bucket sleeps the connection until refill. 0 rates
    disable throttling (config.go default)."""

    def __init__(self, refill_per_s: float, max_stored: float):
        self.rate = refill_per_s
        # a rate with cap<1 could never accumulate a whole token and
        # take() would hang forever; clamp so throttling stays sane
        self.cap = max(max_stored, 1.0) if refill_per_s > 0 else max_stored
        self.tokens = self.cap
        self.t = time.monotonic()

    def take(self) -> None:
        if self.rate <= 0:
            return
        while True:
            now = time.monotonic()
            self.tokens = min(self.cap, self.tokens + (now - self.t) * self.rate)
            self.t = now
            if self.tokens >= 1:
                self.tokens -= 1
                return
            time.sleep((1 - self.tokens) / self.rate)


class WSServer:
    """WebSocket front-end over an RPCServer's method registry."""

    def __init__(self, rpc_server, refill_rate: float = 0,
                 max_stored: float = 0, notify_queue_size: int = 0,
                 max_payload: int = 0):
        self.rpc = rpc_server
        self.refill_rate = refill_rate
        self.max_stored = max_stored
        # 0 = legacy unbuffered notification writes (no backpressure)
        self.notify_queue_size = notify_queue_size
        self.max_payload = max_payload
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        self._conns_lock = threading.Lock()
        self._conns: set = set()  # guarded-by: _conns_lock
        # readers and notify writers; guarded-by: _conns_lock
        self._threads: set = set()
        self._accept_thread: Optional[threading.Thread] = None

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="ws-accept")
        self._accept_thread.start()
        return self._sock.getsockname()[1]

    def stop(self, timeout: float = 5.0) -> None:
        """Close the listener and every connection, then join the accept
        thread and each connection's reader and writer (up to [timeout]
        in all: a writer parked in a failpoint is abandoned)."""
        self._stop.set()
        if self._sock is not None:
            try:  # wakes the accept thread (a bare close does not)
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        with self._conns_lock:
            live = list(self._conns)
        for conn in live:  # unblock readers parked in read_frame
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        deadline = time.monotonic() + timeout
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=timeout)
        while True:  # a reader may start its writer while we wait
            with self._conns_lock:
                pending = [t for t in self._threads if t.is_alive()
                           and t is not threading.current_thread()]
            if not pending or time.monotonic() >= deadline:
                return
            for t in pending:
                t.join(timeout=max(0.0, deadline - time.monotonic()))

    def _spawn(self, target, args, name) -> None:
        """Start a connection thread that stop() joins."""
        t = threading.Thread(target=target, args=args, daemon=True,
                             name=name)
        with self._conns_lock:
            self._threads = {x for x in self._threads if x.is_alive()}
            self._threads.add(t)
        t.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._conns_lock:
                if self._stop.is_set():  # stop() already took its list
                    conn.close()
                    return
                self._conns.add(conn)
            self._spawn(self._serve_conn, (conn,), "ws-conn")

    def _handshake(self, conn: socket.socket) -> bool:
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = conn.recv(4096)
            if not chunk:
                return False
            data += chunk
        headers = {}
        for line in data.split(b"\r\n")[1:]:
            if b":" in line:
                k, v = line.split(b":", 1)
                headers[k.strip().lower()] = v.strip()
        key = headers.get(b"sec-websocket-key")
        if key is None:
            return False
        resp = (
            "HTTP/1.1 101 Switching Protocols\r\n"
            "Upgrade: websocket\r\n"
            "Connection: Upgrade\r\n"
            f"Sec-WebSocket-Accept: {_accept_key(key.decode())}\r\n\r\n"
        )
        conn.sendall(resp.encode())
        return True

    def _serve_conn(self, conn: socket.socket) -> None:
        subs: List[str] = []
        wlock = threading.Lock()
        bucket = _TokenBucket(self.refill_rate, self.max_stored)
        closed = threading.Event()
        notify_q: "Optional[queue.Queue]" = (
            queue.Queue(maxsize=self.notify_queue_size)
            if self.notify_queue_size > 0 else None)

        def send_json(obj) -> None:
            data = json.dumps(obj).encode()
            with wlock:
                write_frame(conn, OP_TEXT, data)

        def drop_conn() -> None:
            # deterministic disconnect: close the socket so the reader
            # unwinds and tears every subscription down
            closed.set()
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

        def notify_writer() -> None:
            while True:
                item = notify_q.get()
                if item is None:
                    return
                ctx, obj = item
                try:
                    # the producer's trace context (captured at enqueue)
                    # rides across the writer-thread boundary, so a
                    # notify failure attributes back to the block insert
                    # or request that produced the event
                    with tracectx.scope(ctx):
                        failpoint("ws/before_notify")
                        send_json(obj)
                except Exception:
                    # a dead or erroring client ends *its* delivery only
                    count_drop("rpc/ws/notify_errors")
                    tracectx.capture(ctx, "ws_notify_error")
                    drop_conn()
                    return

        def send_notification(obj) -> None:
            """Producer-side entry (runs on block-acceptance threads):
            never blocks — a full queue means the client is too slow."""
            if notify_q is None:
                failpoint("ws/before_notify")
                send_json(obj)
                return
            if closed.is_set():
                default_registry.counter("rpc/ws/notify_drops").inc()
                return
            ctx = tracectx.current()
            try:
                notify_q.put_nowait((ctx, obj))
            except queue.Full:
                default_registry.counter("rpc/ws/notify_drops").inc()
                default_registry.counter("rpc/ws/slow_disconnects").inc()
                tracectx.capture(ctx, "ws_notify_dropped")
                drop_conn()

        if notify_q is not None:
            self._spawn(notify_writer, (), "ws-notify")
        try:
            if not self._handshake(conn):
                return
            while not self._stop.is_set():
                op, payload = read_frame(conn, self.max_payload)
                if op == OP_CLOSE:
                    with wlock:
                        write_frame(conn, OP_CLOSE, b"")
                    return
                if op == OP_PING:
                    with wlock:
                        write_frame(conn, OP_PONG, payload)
                    continue
                if op != OP_TEXT:
                    continue
                bucket.take()
                self._handle_message(payload, send_json, send_notification,
                                     subs)
        except FrameTooLarge as e:
            default_registry.counter("rpc/body_oversize").inc()
            try:
                send_json({"jsonrpc": "2.0", "id": None,
                           "error": {"code": -32600, "message": str(e)}})
            except OSError:
                pass  # too-slow-to-even-read clients skip the courtesy
        except (ConnectionError, OSError):
            pass
        finally:
            for sid in subs:
                self.rpc.unsubscribe(sid)
            if notify_q is not None:
                try:
                    notify_q.put_nowait(None)  # release the writer
                except queue.Full:
                    pass  # writer is wedged; drop_conn unwedges its write
            drop_conn()
            with self._conns_lock:
                self._conns.discard(conn)

    def _handle_message(self, payload: bytes, send_json, send_notification,
                        subs: List[str]):
        try:
            req = json.loads(payload)
        except Exception:
            send_json({"jsonrpc": "2.0", "id": None,
                       "error": {"code": -32700, "message": "parse error"}})
            return
        if isinstance(req, dict) and req.get("method") == "eth_subscribe":
            self._do_subscribe(req, send_json, send_notification, subs)
            return
        if isinstance(req, dict) and req.get("method") == "eth_unsubscribe":
            params = req.get("params") or []
            ok = bool(params) and self.rpc.unsubscribe(params[0])
            if ok and params[0] in subs:
                subs.remove(params[0])
            send_json({"jsonrpc": "2.0", "id": req.get("id"), "result": ok})
            return
        resp = self.rpc.handle_raw(payload)
        send_json(json.loads(resp))

    def _do_subscribe(self, req: dict, send_json, send_notification,
                      subs: List[str]) -> None:
        params = req.get("params") or []
        if not params:
            send_json({"jsonrpc": "2.0", "id": req.get("id"),
                       "error": {"code": -32602,
                                 "message": "subscription kind required"}})
            return
        kind = params[0]
        holder = [None]  # filled once the server assigns the id; events
        # that race registration are dropped (no id to address them to)

        def notify(item):
            if holder[0] is None:
                return
            send_notification({
                "jsonrpc": "2.0",
                "method": "eth_subscription",
                "params": {"subscription": holder[0], "result": item},
            })

        try:
            sub_id = self.rpc.subscribe(f"eth_{kind}", notify, *params[1:])
            holder[0] = sub_id
        except Exception as e:
            send_json({"jsonrpc": "2.0", "id": req.get("id"),
                       "error": {"code": -32602, "message": str(e)}})
            return
        subs.append(sub_id)
        send_json({"jsonrpc": "2.0", "id": req.get("id"), "result": sub_id})


class WSClient:
    """Blocking test/tooling client: request() correlates by id;
    notifications queue for next_notification()."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        req = (
            f"GET / HTTP/1.1\r\nHost: {host}:{port}\r\n"
            "Upgrade: websocket\r\nConnection: Upgrade\r\n"
            f"Sec-WebSocket-Key: {key}\r\nSec-WebSocket-Version: 13\r\n\r\n"
        )
        self.sock.sendall(req.encode())
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = self.sock.recv(4096)
            if not chunk:
                raise ConnectionError("handshake failed")
            data += chunk
        if b"101" not in data.split(b"\r\n", 1)[0]:
            raise ConnectionError(f"handshake rejected: {data[:120]!r}")
        want = _accept_key(key).encode()
        if want not in data:
            raise ConnectionError("bad Sec-WebSocket-Accept")
        self._id = 0
        self._notifications: List[dict] = []
        self._lock = threading.Lock()

    def _recv_json(self) -> dict:
        while True:
            op, payload = read_frame(self.sock)
            if op == OP_CLOSE:
                raise ConnectionError("server closed")
            if op == OP_PING:
                write_frame(self.sock, OP_PONG, payload, mask=True)
                continue
            if op == OP_TEXT:
                return json.loads(payload)

    def request(self, method: str, params: Optional[list] = None) -> Any:
        with self._lock:
            self._id += 1
            rid = self._id
        msg = {"jsonrpc": "2.0", "id": rid, "method": method,
               "params": params or []}
        write_frame(self.sock, OP_TEXT, json.dumps(msg).encode(), mask=True)
        while True:
            obj = self._recv_json()
            if obj.get("method") == "eth_subscription":
                self._notifications.append(obj)
                continue
            if obj.get("id") == rid:
                if "error" in obj:
                    raise RuntimeError(obj["error"])
                return obj["result"]
            # stale response (shouldn't happen on a serial client): drop

    def next_notification(self, timeout: float = 10.0) -> dict:
        if self._notifications:
            return self._notifications.pop(0)
        old = self.sock.gettimeout()
        self.sock.settimeout(timeout)
        try:
            while True:
                obj = self._recv_json()
                if obj.get("method") == "eth_subscription":
                    return obj
        finally:
            self.sock.settimeout(old)

    def close(self) -> None:
        try:
            write_frame(self.sock, OP_CLOSE, b"", mask=True)
            self.sock.close()
        except OSError:
            pass
