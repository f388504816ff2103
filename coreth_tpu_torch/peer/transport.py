"""TCP transport for peer.Network (the production counterpart of the
in-process wiring; role of the AvalancheGo AppRequest plumbing coreth
rides, peer/network.go over p2p); counterpart of
coreth_tpu/peer/transport.py, with the same frames.

Framing: length-prefixed messages with request-id correlation so one
persistent connection multiplexes concurrent requests:

    u32 BE total_len | u8 kind | u64 BE request_id | payload
    kind: 0 = request, 1 = response, 2 = gossip (request_id ignored)

`TransportServer` accepts connections and answers through the local
Network's inbound handler. `dial()` returns a callable matching the
Network transport contract `(sender_id, request) -> response`, so remote
peers plug into `Network.connect` exactly like in-process ones.

Where the port departs from the reference (ROADMAP Queue 3), as
rpc/websocket.py's WSServer.stop does: `TransportServer.stop()` shuts the
listener down (waking the thread parked in accept()), closes every live
connection and joins the accept thread, the connection readers and the
request workers it started; `RemotePeer.close()` joins its read loops.
The reference closes the sockets and joins nothing. A worker still inside
its handler when the join budget (STOP_JOIN_SECONDS) runs out is left
behind and reported by the return value of stop()."""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Dict, List, Optional

KIND_REQUEST = 0
KIND_RESPONSE = 1
KIND_GOSSIP = 2

_MAX_FRAME = 32 * 1024 * 1024

# seconds stop()/close() wait, in all, for the threads they started
STOP_JOIN_SECONDS = 5.0


def _drop(reason: str) -> None:
    """Inbound-path drop counter (coreth keeps per-handler gossip/request
    stats; a bare swallow would make a misbehaving peer invisible)."""
    from ..metrics import count_drop

    count_drop(f"peer/drops/{reason}")


class TransportError(Exception):
    pass


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise TransportError("connection closed")
        buf += chunk
    return buf


def _read_frame(sock):
    total = struct.unpack(">I", _read_exact(sock, 4))[0]
    if total > _MAX_FRAME or total < 9:
        raise TransportError(f"bad frame length {total}")
    body = _read_exact(sock, total)
    kind = body[0]
    req_id = struct.unpack(">Q", body[1:9])[0]
    return kind, req_id, body[9:]


def _write_frame(sock, lock, kind: int, req_id: int, payload: bytes):
    frame = struct.pack(">IBQ", 9 + len(payload), kind, req_id) + payload
    with lock:
        sock.sendall(frame)


class TransportServer:
    """Listens for peers; inbound requests go to handler(sender, bytes)
    -> bytes; inbound gossip goes to gossip_handler(sender, bytes)."""

    def __init__(self, handler: Callable[[bytes, bytes], bytes],
                 gossip_handler: Optional[Callable[[bytes, bytes], None]] = None):
        self.handler = handler
        self.gossip_handler = gossip_handler
        self._sock: Optional[socket.socket] = None
        self._stop = threading.Event()
        # every thread this server started and every live connection, so
        # stop() can wake and join them all
        self._threads_mu = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._live: List[socket.socket] = []

    def _spawn(self, target, args=(), name: str = "peer") -> None:
        t = threading.Thread(target=target, args=args, daemon=True,
                             name=name)
        with self._threads_mu:
            self._threads = [th for th in self._threads if th.is_alive()]
            self._threads.append(t)
        t.start()

    def serve(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(32)
        self._spawn(self._accept_loop, name="peer-accept")
        return self._sock.getsockname()[1]

    def stop(self) -> List[str]:
        """Stop serving and join every thread this server started.
        Returns the names of threads still alive after STOP_JOIN_SECONDS
        (a handler that does not return), empty when all ended."""
        import time

        self._stop.set()
        if self._sock is not None:
            try:
                # a bare close() does not wake a thread parked in accept()
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                self._sock.close()
            except OSError:
                pass
        with self._threads_mu:
            live = list(self._live)
        for conn in live:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        end = time.monotonic() + STOP_JOIN_SECONDS
        while True:
            with self._threads_mu:
                threads = [t for t in self._threads
                           if t is not threading.current_thread()]
            for t in threads:
                t.join(timeout=max(0.0, end - time.monotonic()))
            with self._threads_mu:
                # a worker may have spawned while we joined: go round
                # again until nothing new is alive or the budget is spent
                left = [t for t in self._threads
                        if t.is_alive() and t is not threading.current_thread()]
                self._threads = left
            if not left or time.monotonic() >= end:
                return [t.name for t in left]

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, addr = self._sock.accept()
            except OSError:
                return
            if self._stop.is_set():
                conn.close()
                return
            self._spawn(self._serve_conn, (conn, addr), name="peer-conn")

    def _serve_conn(self, conn, addr):
        sender = f"{addr[0]}:{addr[1]}".encode()
        wlock = threading.Lock()
        with self._threads_mu:
            self._live.append(conn)
        try:
            while not self._stop.is_set():
                kind, req_id, payload = _read_frame(conn)
                if kind == KIND_GOSSIP:
                    if self.gossip_handler is not None:
                        try:
                            self.gossip_handler(sender, payload)
                        except Exception:
                            _drop("gossip_handler_error")
                    continue
                if kind != KIND_REQUEST:
                    _drop("unknown_frame_kind")
                    continue

                def work(rid=req_id, data=payload):
                    try:
                        resp = self.handler(sender, data)
                    except Exception:
                        _drop("request_handler_error")
                        resp = b""
                    try:
                        _write_frame(conn, wlock, KIND_RESPONSE, rid, resp)
                    except OSError:
                        pass

                # answer concurrently: one slow request must not head-of-
                # line-block the connection (AppRequest concurrency)
                self._spawn(work, name="peer-work")
        except (TransportError, OSError):
            pass
        finally:
            with self._threads_mu:
                try:
                    self._live.remove(conn)
                except ValueError:
                    pass
            try:
                conn.close()
            except OSError:
                pass


class RemotePeer:
    """Client side of one connection; usable as a Network transport.

    A broken pipe no longer kills the peer for good: the dial target is
    retained, and the next request (or gossip) re-dials with capped
    exponential backoff + jitter (fault.Backoff), counted in
    `peer/reconnects`. Requests in flight when the connection died still
    fail — the wire offers no replay semantics — but the peer object
    stays usable, matching how AvalancheGo keeps the peer and re-dials
    under it. reconnect=False restores fail-forever."""

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 reconnect: bool = True, max_redials: int = 4):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.reconnect = reconnect
        self.max_redials = max_redials
        self._wlock = threading.Lock()
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._waiters: Dict[int, "threading.Event"] = {}
        self._responses: Dict[int, bytes] = {}
        # _conn_lock guards sock/_dead/_gen swaps; _gen invalidates stale
        # read loops (a late error from a replaced socket must not kill
        # the fresh connection)
        self._conn_lock = threading.Lock()
        self._gen = 0  # guarded-by: _conn_lock
        self._dead: Optional[Exception] = None  # guarded-by: _conn_lock
        self._closed = False  # guarded-by: _conn_lock
        self.sock: Optional[socket.socket] = None
        self._readers: List[threading.Thread] = []  # guarded-by: _conn_lock
        with self._conn_lock:
            self._connect_locked()

    def _connect_locked(self) -> None:  # guarded-by: _conn_lock
        self.sock = socket.create_connection(
            (self.host, self.port), timeout=self.timeout)
        self._dead = None
        self._gen += 1
        t = threading.Thread(target=self._read_loop,
                             args=(self.sock, self._gen), daemon=True,
                             name="peer-read")
        self._readers = [r for r in self._readers if r.is_alive()]
        self._readers.append(t)
        t.start()

    def _read_loop(self, sock, gen: int):
        try:
            while True:
                kind, req_id, payload = _read_frame(sock)
                if kind != KIND_RESPONSE:
                    continue
                ev = self._waiters.get(req_id)
                if ev is not None:
                    self._responses[req_id] = payload
                    ev.set()
        except (TransportError, OSError) as e:
            self._mark_dead(gen, e)

    def _mark_dead(self, gen: int, e: Exception) -> None:
        with self._conn_lock:
            if gen != self._gen:
                return  # stale loop of an already-replaced socket
            if self._dead is None:
                self._dead = e
        # wake every waiter: their request died with the connection
        for ev in list(self._waiters.values()):
            ev.set()

    def _ensure_connected(self) -> None:
        """Re-dial a dead connection with capped backoff + jitter; raises
        TransportError when closed, reconnect is off, or every redial
        attempt failed."""
        from ..fault import Backoff
        from ..metrics import default_registry

        with self._conn_lock:
            if self._closed:
                raise TransportError("peer closed")
            if self._dead is None:
                return
            if not self.reconnect:
                raise TransportError(
                    f"peer connection dead: {self._dead}")
            last = self._dead
            backoff = Backoff(base=0.05, cap=2.0)
            for _ in range(max(1, self.max_redials)):
                try:
                    self._connect_locked()
                except OSError as e:
                    last = e
                    backoff.sleep()
                    continue
                default_registry.counter("peer/reconnects").inc()
                return
            raise TransportError(
                f"reconnect to {self.host}:{self.port} failed after "
                f"{self.max_redials} attempts: {last}") from last

    def __call__(self, sender_id: bytes, request: bytes) -> bytes:
        """Network transport contract: blocking request/response."""
        self._ensure_connected()
        with self._id_lock:
            self._next_id += 1
            rid = self._next_id
        ev = threading.Event()
        self._waiters[rid] = ev
        try:
            with self._conn_lock:
                sock, gen = self.sock, self._gen
            try:
                _write_frame(sock, self._wlock, KIND_REQUEST, rid, request)
            except OSError as e:  # socket died between checks
                self._mark_dead(gen, e)
                # broken pipe surfaces HERE, not in the read loop:
                # re-dial once and replay this request on the fresh
                # connection (it never reached the wire)
                self._ensure_connected()
                with self._conn_lock:
                    sock, gen = self.sock, self._gen
                try:
                    _write_frame(sock, self._wlock, KIND_REQUEST, rid,
                                 request)
                except OSError as e2:
                    self._mark_dead(gen, e2)
                    raise TransportError(
                        f"peer connection dead: {e2}") from e2
            if not ev.wait(timeout=sock.gettimeout()):
                raise TransportError("request timed out")
            with self._conn_lock:
                dead = self._dead
            if dead is not None and rid not in self._responses:
                raise TransportError(f"peer connection dead: {dead}")
            return self._responses.pop(rid)
        finally:
            self._waiters.pop(rid, None)
            self._responses.pop(rid, None)

    def gossip(self, payload: bytes) -> None:
        self._ensure_connected()
        with self._conn_lock:
            sock, gen = self.sock, self._gen
        try:
            _write_frame(sock, self._wlock, KIND_GOSSIP, 0, payload)
        except OSError as e:
            self._mark_dead(gen, e)
            self._ensure_connected()
            with self._conn_lock:
                sock, gen = self.sock, self._gen
            try:
                _write_frame(sock, self._wlock, KIND_GOSSIP, 0, payload)
            except OSError as e2:
                self._mark_dead(gen, e2)
                raise TransportError(
                    f"peer connection dead: {e2}") from e2

    def close(self):
        """Close the connection and join the read loops (a shutdown wakes
        the one parked in recv())."""
        with self._conn_lock:
            self._closed = True
            self._gen += 1  # retire the read loop's death report
            sock = self.sock
            readers, self._readers = list(self._readers), []
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass
        for t in readers:
            if t is not threading.current_thread():
                t.join(timeout=STOP_JOIN_SECONDS)


def dial(host: str, port: int, timeout: float = 30.0,
         reconnect: bool = True) -> RemotePeer:
    return RemotePeer(host, port, timeout, reconnect=reconnect)
