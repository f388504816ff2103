"""Client-side WebSocket subscriptions (semantics of coreth's ethclient
Subscribe* surface — ethclient/ethclient.go SubscribeNewHead /
SubscribeFilterLogs over rpc/websocket; counterpart of
coreth_tpu/ethclient/ws.py): a background reader routes
eth_subscription pushes from rpc/websocket.py's WSServer into
per-subscription queues while plain requests stay available on the same
connection.

    from coreth_tpu_torch.ethclient.ws import WSEthClient
    c = WSEthClient("127.0.0.1", port)
    heads = c.subscribe_new_heads()
    h = heads.next(timeout=5)          # blocks for the next header
    heads.unsubscribe()
    c.close()
"""

from __future__ import annotations

import json
import queue
import threading
from typing import Any, Dict, List, Optional

from ..rpc.websocket import OP_CLOSE, OP_PING, OP_PONG, OP_TEXT, WSClient, \
    read_frame, write_frame


class WSSubscriptionError(Exception):
    pass


class Subscription:
    """One server-side subscription; pushes buffer in an own queue."""

    def __init__(self, client: "WSEthClient", sub_id: str):
        self.id = sub_id
        self._client = client
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False

    def next(self, timeout: Optional[float] = 10.0) -> Any:
        """Block for the next pushed item (a header dict for newHeads, a
        log dict for logs). Raises WSSubscriptionError on timeout or
        after the connection dies."""
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            raise WSSubscriptionError("timed out waiting for push")
        if isinstance(item, _ConnClosed):
            raise WSSubscriptionError(f"connection closed: {item.reason}")
        return item

    def unsubscribe(self) -> bool:
        if self._closed:
            return False
        self._closed = True
        return self._client._unsubscribe(self.id)


class _ConnClosed:
    def __init__(self, reason: str):
        self.reason = reason


class WSEthClient:
    """WebSocket RPC client with concurrent subscriptions: a reader
    thread demultiplexes responses (by id) and eth_subscription pushes
    (by subscription id). Requests from any thread; pushes never block
    requests."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        # reuse WSClient purely for its HTTP upgrade handshake
        self._sock = WSClient(host, port, timeout=timeout).sock
        self._sock.settimeout(None)
        self._wlock = threading.Lock()
        self._id = 0
        self._pending: Dict[int, "queue.Queue"] = {}
        self._subs: Dict[str, Subscription] = {}
        # pushes that beat subscribe()'s registration of the sub id (the
        # server can push between sending the eth_subscribe response and
        # the main thread recording the id); drained on registration
        self._orphans: Dict[str, List[Any]] = {}
        self._dead: Optional[str] = None  # reason, once the reader exits
        self._lock = threading.Lock()
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    # --- plumbing ---------------------------------------------------------

    def _read_loop(self) -> None:
        reason = "closed"
        try:
            while True:
                op, payload = read_frame(self._sock)
                if op == OP_CLOSE:
                    reason = "server close frame"
                    break
                if op == OP_PING:
                    with self._wlock:
                        write_frame(self._sock, OP_PONG, payload, mask=True)
                    continue
                if op != OP_TEXT:
                    continue
                obj = json.loads(payload)
                if obj.get("method") == "eth_subscription":
                    params = obj.get("params") or {}
                    sid = params.get("subscription")
                    with self._lock:
                        sub = self._subs.get(sid)
                        if sub is None and sid is not None and \
                                len(self._orphans) < 64:
                            lst = self._orphans.setdefault(sid, [])
                            # per-sid cap: a server that keeps pushing
                            # for a sid we never register (failed or
                            # raced unsubscribe) must not grow memory
                            # for the connection's lifetime
                            if len(lst) < 32:
                                lst.append(params.get("result"))
                    if sub is not None:
                        sub._q.put(params.get("result"))
                    continue
                with self._lock:
                    waiter = self._pending.pop(obj.get("id"), None)
                if waiter is not None:
                    waiter.put(obj)
        except (OSError, ValueError) as e:
            reason = str(e) or type(e).__name__
        finally:
            closed = _ConnClosed(reason)
            with self._lock:
                self._dead = reason  # set BEFORE draining: a request()
                # registering after this sees _dead and fails fast
                for sub in self._subs.values():
                    sub._q.put(closed)
                for waiter in self._pending.values():
                    waiter.put({"error": {"message": f"connection lost "
                                                     f"({reason})"}})
                self._pending.clear()

    def request(self, method: str, params: Optional[List] = None,
                timeout: float = 10.0) -> Any:
        waiter: "queue.Queue" = queue.Queue()
        with self._lock:
            if self._dead is not None:
                raise WSSubscriptionError(
                    f"connection closed: {self._dead}")
            self._id += 1
            rid = self._id
            self._pending[rid] = waiter
        msg = {"jsonrpc": "2.0", "id": rid, "method": method,
               "params": params or []}
        try:
            with self._wlock:
                write_frame(self._sock, OP_TEXT, json.dumps(msg).encode(),
                            mask=True)
        except OSError as e:
            with self._lock:
                self._pending.pop(rid, None)
            raise WSSubscriptionError(f"connection lost: {e}") from e
        try:
            resp = waiter.get(timeout=timeout)
        except queue.Empty:
            with self._lock:
                self._pending.pop(rid, None)
            raise WSSubscriptionError(f"{method} timed out")
        if "error" in resp:
            raise WSSubscriptionError(str(resp["error"]))
        return resp.get("result")

    # --- subscriptions (ethclient.go Subscribe*) --------------------------

    def subscribe(self, kind: str, *params) -> Subscription:
        sub_id = self.request("eth_subscribe", [kind, *params])
        sub = Subscription(self, sub_id)
        with self._lock:
            self._subs[sub_id] = sub
            for item in self._orphans.pop(sub_id, []):
                sub._q.put(item)  # pushes that raced registration
        return sub

    def subscribe_new_heads(self) -> Subscription:
        """SubscribeNewHead: accepted-head headers as they land."""
        return self.subscribe("newHeads")

    def subscribe_logs(self, criteria: Optional[dict] = None) -> Subscription:
        """SubscribeFilterLogs: matching logs from accepted blocks."""
        return self.subscribe("logs", criteria or {})

    def _unsubscribe(self, sub_id: str) -> bool:
        ok = bool(self.request("eth_unsubscribe", [sub_id]))
        with self._lock:
            self._subs.pop(sub_id, None)
        return ok

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            with self._wlock:
                write_frame(self._sock, OP_CLOSE, b"", mask=True)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
