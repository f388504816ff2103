"""Engine side of the process boundary: a proxy that drives a VM served
by plugin/server.py over its unix socket (the engine half of coreth's
rpcchainvm plugin transport, reached from plugin/main.go:33); counterpart
of coreth_tpu/plugin/client.py.

`RemoteVM.app_request` matches the peer.Network transport contract
`(sender, request) -> response`, so a local sync client can state-sync
from the remote process exactly as from an in-process peer — the
cross-process variant of the two-VM harness (syncervm_test.go:269
pattern).
"""

from __future__ import annotations

import socket
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..metrics import count_drop
from .protocol import b2h, h2b, recv_msg, send_msg


class RemoteVMError(Exception):
    pass


@dataclass
class RemoteBlock:
    """Serialized block handle (id + canonical RLP) from the remote VM."""

    id: bytes
    parent_id: bytes
    height: int
    bytes: bytes

    @classmethod
    def from_info(cls, info: dict) -> "RemoteBlock":
        return cls(id=h2b(info["id"]), parent_id=h2b(info["parentID"]),
                   height=int(info["height"]), bytes=h2b(info["bytes"]))


class RemoteVM:
    """Blocking JSON-frame client; one in-flight request at a time per
    connection (requests are serialized by a lock — the engine drives
    the lifecycle sequentially anyway, and sync requests are small)."""

    def __init__(self, sock_path: str, connect_timeout: float = 10.0):
        deadline = time.monotonic() + connect_timeout
        last_err: Optional[Exception] = None
        self._sock = None
        while time.monotonic() < deadline:
            try:
                s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                s.connect(sock_path)
                self._sock = s
                break
            except OSError as e:  # server still booting
                last_err = e
                time.sleep(0.05)
        if self._sock is None:
            raise RemoteVMError(f"cannot connect to {sock_path}: {last_err}")
        self._lock = threading.Lock()
        self._next_id = 0

    def request(self, method: str, **params) -> dict:
        with self._lock:
            self._next_id += 1
            rid = self._next_id
            send_msg(self._sock, {"id": rid, "method": method,
                                  "params": params})
            resp = recv_msg(self._sock)
        if resp.get("id") != rid:
            raise RemoteVMError(f"response id mismatch: {resp}")
        if "error" in resp:
            raise RemoteVMError(resp["error"])
        return resp.get("result") or {}

    # --- snowman ChainVM --------------------------------------------------

    def handshake(self) -> bytes:
        return h2b(self.request("handshake")["lastAcceptedID"])

    def build_block(self) -> RemoteBlock:
        return RemoteBlock.from_info(self.request("buildBlock"))

    def parse_block(self, blob: bytes) -> RemoteBlock:
        return RemoteBlock.from_info(
            self.request("parseBlock", bytes=b2h(blob)))

    def get_block(self, block_id: bytes) -> RemoteBlock:
        return RemoteBlock.from_info(
            self.request("getBlock", id=b2h(block_id)))

    def block_verify(self, block_id: bytes) -> None:
        self.request("blockVerify", id=b2h(block_id))

    def block_accept(self, block_id: bytes) -> None:
        self.request("blockAccept", id=b2h(block_id))

    def block_reject(self, block_id: bytes) -> None:
        self.request("blockReject", id=b2h(block_id))

    def set_preference(self, block_id: bytes) -> None:
        self.request("setPreference", id=b2h(block_id))

    def last_accepted(self) -> RemoteBlock:
        return RemoteBlock.from_info(self.request("lastAccepted"))

    def issue_tx(self, raw: bytes) -> None:
        self.request("issueTx", raw=b2h(raw))

    # --- state sync -------------------------------------------------------

    def app_request(self, sender: bytes, request: bytes) -> bytes:
        """peer.Network transport contract: plug into Network.connect."""
        return h2b(self.request("appRequest",
                                request=b2h(request))["response"])

    def get_last_state_summary(self):
        from ..sync.messages import SyncSummary

        blob = self.request("getLastStateSummary").get("summary")
        return SyncSummary.decode(h2b(blob)) if blob else None

    def get_state_summary(self, height: int):
        from ..sync.messages import SyncSummary

        blob = self.request("getStateSummary", height=height).get("summary")
        return SyncSummary.decode(h2b(blob)) if blob else None

    def health(self) -> bool:
        return bool(self.request("health").get("healthy"))

    def shutdown(self) -> None:
        try:
            self.request("shutdown")
        except Exception:  # noqa: BLE001 — server may die before replying
            count_drop("plugin/client/shutdown_rpc_error")
        self.close()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
