"""VM side of the process boundary: serve a VM's snowman interface over a
unix socket (semantics of coreth plugin/main.go:33
`rpcchainvm.Serve(ctx, &evm.VM{IsPlugin: true})`); counterpart of
coreth_tpu/plugin/server.py, with the same methods and answers.

The engine process drives the whole ChainVM lifecycle — buildBlock,
parseBlock, Verify/Accept/Reject by block id, setPreference — plus the
state-sync server surface (appRequest forwards to vm.sync_handler, the
summaries come from vm/syncervm.py's StateSyncServer), all across
serialized frames. Every block crossing the boundary travels as its
canonical RLP bytes.

Where the port departs from the reference (ROADMAP Queue 3), as
peer/transport.py's TransportServer.stop does: serve_forever() shuts
every live connection down and joins the connection threads it started
before it returns; the reference leaves them as daemon threads that
nothing joins. A connection thread still inside its request after
STOP_JOIN_SECONDS is left behind and named in `threads_left`.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from typing import List

from .protocol import ProtocolError, b2h, h2b, recv_msg, send_msg

STOP_JOIN_SECONDS = 5.0


class VMServer:
    """Serve [vm] on a unix socket until shutdown is requested."""

    def __init__(self, vm, sock_path: str):
        self.vm = vm
        self.sock_path = sock_path
        self._blocks: dict = {}  # id -> VMBlock (parsed/built, pre-decision)
        # RLock: lifecycle ops are engine-ordered, but parseBlock/getBlock
        # may arrive on other connections concurrently and _block_info
        # mutates _blocks (lifecycle paths re-enter it while holding)
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._sync_server = None
        self._listener = None
        self._conns_mu = threading.Lock()
        self._conns: dict = {}  # connection thread -> its socket
        self.threads_left: List[str] = []

    # --- snowman surface --------------------------------------------------

    def _block_info(self, vmb) -> dict:
        bid = vmb.id()
        with self._lock:
            self._blocks.pop(bid, None)  # refresh insertion order
            self._blocks[bid] = vmb
            # bound retention: undecided blocks the engine abandoned must
            # not pin memory forever; decided/canonical blocks re-resolve
            # through vm.get_block, so eviction only drops in-flight
            # handles
            while len(self._blocks) > 512:
                self._blocks.pop(next(iter(self._blocks)))
        return {
            "id": b2h(vmb.id()),
            "parentID": b2h(vmb.parent_id()),
            "height": vmb.height(),
            "bytes": b2h(vmb.bytes()),
        }

    def _get(self, params) -> "object":
        bid = h2b(params["id"])
        vmb = self._blocks.get(bid)
        if vmb is None:
            vmb = self.vm.get_block(bid)
        if vmb is None:
            raise ProtocolError(f"unknown block {params['id']}")
        return vmb

    def _sync(self):
        if self._sync_server is None:
            from ..vm.syncervm import StateSyncServer

            # syncable heights must land on committed roots, so the
            # serving interval rides the chain's commit interval
            self._sync_server = StateSyncServer(
                self.vm.blockchain,
                syncable_interval=self.vm.config.commit_interval,
            )
        return self._sync_server

    def dispatch(self, method: str, params: dict) -> dict:
        vm = self.vm
        if method == "handshake":
            return {"ok": True,
                    "lastAcceptedID": b2h(vm.last_accepted().id())}
        if method == "buildBlock":
            with self._lock:
                return self._block_info(vm.build_block())
        if method == "parseBlock":
            return self._block_info(vm.parse_block(h2b(params["bytes"])))
        if method == "getBlock":
            return self._block_info(self._get(params))
        if method == "blockVerify":
            with self._lock:
                self._get(params).verify()
            return {}
        if method == "blockAccept":
            with self._lock:
                vmb = self._get(params)
                vmb.accept()
                vm.blockchain.drain_acceptor_queue()
                self._blocks.pop(vmb.id(), None)
            return {}
        if method == "blockReject":
            with self._lock:
                vmb = self._get(params)
                vmb.reject()
                self._blocks.pop(vmb.id(), None)
            return {}
        if method == "setPreference":
            with self._lock:
                vm.set_preference(h2b(params["id"]))
            return {}
        if method == "lastAccepted":
            return self._block_info(vm.last_accepted())
        if method == "issueTx":
            from ..core.types import Transaction

            vm.issue_tx(Transaction.decode(h2b(params["raw"])))
            return {}
        if method == "appRequest":
            # the sync-server path (leafs/blocks/code w/ range proofs)
            resp = vm.sync_handler.handle(b"engine", h2b(params["request"]))
            return {"response": b2h(resp)}
        if method == "getLastStateSummary":
            s = self._sync().get_last_state_summary()
            return {"summary": b2h(s.encode()) if s else None}
        if method == "getStateSummary":
            s = self._sync().get_state_summary(int(params["height"]))
            return {"summary": b2h(s.encode()) if s else None}
        if method == "health":
            return {"healthy": True}
        if method == "shutdown":
            self._stop.set()
            return {}
        raise ProtocolError(f"unknown method {method!r}")

    # --- socket plumbing --------------------------------------------------

    def _serve_conn(self, conn):
        try:
            while not self._stop.is_set():
                msg = recv_msg(conn)
                out = {"id": msg.get("id")}
                try:
                    out["result"] = self.dispatch(
                        msg.get("method", ""), msg.get("params") or {})
                except Exception as e:  # noqa: BLE001 — cross the boundary
                    out["error"] = f"{type(e).__name__}: {e}"
                send_msg(conn, out)
        except (ProtocolError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._conns_mu:
                self._conns.pop(threading.current_thread(), None)

    def _join_connections(self) -> None:
        """Wake every connection thread parked in recv() and join it.
        SHUT_RD ends the recv but lets a reply in flight (the shutdown
        request's own) reach its engine."""
        with self._conns_mu:
            live = list(self._conns.items())
        for _t, conn in live:
            try:
                conn.shutdown(socket.SHUT_RD)
            except OSError:
                pass
        end = time.monotonic() + STOP_JOIN_SECONDS
        for t, _conn in live:
            t.join(timeout=max(0.0, end - time.monotonic()))
        self.threads_left = [t.name for t, _c in live if t.is_alive()]

    def serve_forever(self) -> None:
        try:
            os.unlink(self.sock_path)
        except FileNotFoundError:
            pass
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.sock_path)
        self._listener.listen(8)
        self._listener.settimeout(0.5)
        n = 0
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            n += 1
            t = threading.Thread(target=self._serve_conn, args=(conn,),
                                 name=f"plugin-conn-{n}", daemon=True)
            with self._conns_mu:
                self._conns[t] = conn
            t.start()
        try:
            self._listener.close()
        except OSError:
            pass
        self._join_connections()
        try:
            os.unlink(self.sock_path)
        except FileNotFoundError:
            pass


def serve(vm, sock_path: str) -> None:
    """Block serving [vm] on [sock_path] until a shutdown request
    arrives, then shut the VM down (plugin/main.go's lifetime)."""
    srv = VMServer(vm, sock_path)
    try:
        srv.serve_forever()
    finally:
        vm.shutdown()
