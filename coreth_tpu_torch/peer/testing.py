"""Scripted fault injection for the peer layer (role of coreth's
sync/client/mock_network.go:31-99 + mock_client.go intercept hooks);
counterpart of coreth_tpu/peer/testing.py.

`FaultyTransport` wraps a working transport with a per-call script so
tests (and chaos drills) can drive the retry/rotation/deadline machinery
deterministically:

    FaultyTransport(inner, script=["drop", "delay:0.2", "corrupt", "ok"])

Script verbs:
    ok            pass through
    drop          raise (transport failure -> AppRequestFailed path)
    delay:<s>     sleep s seconds, then pass through (deadline tests)
    corrupt       pass through but flip bytes in the response (the
                  client's proof validation must reject it)
    empty         return b"" (undecodable response)

The script consumes one verb per call; after the script is exhausted,
every later call is "ok" (so a sync eventually completes — loop scripts
by passing `cycle=True`).

`DisruptiveServer` is the TCP-level counterpart: a TransportServer that
tracks its live connections so a test can sever them all mid-flight and
exercise RemotePeer's reconnect-on-broken-pipe path."""

from __future__ import annotations

import socket
import threading
import time
from typing import Callable, List

from .transport import TransportServer


class TransportFault(Exception):
    pass


class FaultyTransport:
    def __init__(self, inner: Callable[[bytes, bytes], bytes],
                 script: List[str], cycle: bool = False):
        self.inner = inner
        self.script = list(script)
        self.cycle = cycle
        self.calls = 0
        self.faults_injected = 0
        self._lock = threading.Lock()

    def _next_verb(self) -> str:
        with self._lock:
            i = self.calls
            self.calls += 1
            if not self.script:
                return "ok"
            if i < len(self.script):
                return self.script[i]
            if self.cycle:
                return self.script[i % len(self.script)]
            return "ok"

    def __call__(self, sender: bytes, request: bytes) -> bytes:
        verb = self._next_verb()
        if verb == "ok":
            return self.inner(sender, request)
        self.faults_injected += 1
        if verb == "drop":
            raise TransportFault("scripted drop")
        if verb.startswith("delay:"):
            time.sleep(float(verb.split(":", 1)[1]))
            return self.inner(sender, request)
        if verb == "corrupt":
            resp = self.inner(sender, request)
            if not resp:
                return resp
            # flip bits mid-payload: keeps length, breaks proofs/digests
            mid = len(resp) // 2
            return resp[:mid] + bytes([resp[mid] ^ 0xFF]) + resp[mid + 1:]
        if verb == "empty":
            return b""
        raise ValueError(f"unknown fault verb {verb!r}")


class AdversarialPeer:
    """Byzantine peer simulator for the sync bootstrap drills: wraps an
    honest request handler with one MODE of sustained misbehavior, so a
    peer set can be assembled where liars outnumber honest nodes and the
    client must still converge bit-exactly.

    Modes (each maps to a ladder failure class the client should assign):

        honest            pass through (control peer)
        lying_leafs       flip a byte in a leaf value — range-proof
                          validation must reject it (proof weight)
        bad_proof         corrupt a proof node (proof weight)
        truncated_stream  the INVISIBLE truncation: rewrite the request
                          to fetch fewer leaves, answer honestly for the
                          smaller range (proofs verify!), then claim
                          more=False. Per-batch validation cannot catch
                          this on end-bounded segments — the
                          drain-confirmation cross-exam and the terminal
                          rebuild root check must
        stall             sleep past the request deadline, then answer
                          (deadline weight)
        flap              fail every call at the transport level — the
                          connect/refuse flapping reconnector
                          (transport weight)
        empty             answer the don't-have wire shape for leafs and
                          empty responses otherwise (stale/pruned peer;
                          also the lying-empty attack)
        garbage           undecodable bytes (decode weight)

    Tampering is deterministic (fixed byte positions, no RNG) so seeded
    drills replay exactly."""

    def __init__(self, inner: Callable[[bytes, bytes], bytes], mode: str,
                 stall_seconds: float = 1.0):
        if mode not in ("honest", "lying_leafs", "bad_proof",
                        "truncated_stream", "stall", "flap", "empty",
                        "garbage"):
            raise ValueError(f"unknown adversarial mode {mode!r}")
        self.inner = inner
        self.mode = mode
        self.stall_seconds = stall_seconds
        self.calls = 0
        self.tampered = 0
        self._lock = threading.Lock()

    def __call__(self, sender: bytes, request: bytes) -> bytes:
        from ..sync.messages import (
            BlockRequest,
            BlockResponse,
            CodeRequest,
            CodeResponse,
            LeafsRequest,
            LeafsResponse,
            decode_message,
        )

        with self._lock:
            self.calls += 1
        mode = self.mode
        if mode == "honest":
            return self.inner(sender, request)
        if mode == "flap":
            with self._lock:
                self.tampered += 1
            raise TransportFault("flapping peer: connection refused")
        if mode == "garbage":
            with self._lock:
                self.tampered += 1
            return b"\x63" + b"garbage"  # unknown type tag
        if mode == "stall":
            with self._lock:
                self.tampered += 1
            time.sleep(self.stall_seconds)
            return self.inner(sender, request)
        if mode == "empty":
            with self._lock:
                self.tampered += 1
            req = decode_message(request)
            if isinstance(req, LeafsRequest):
                return LeafsResponse().encode()  # the don't-have shape
            if isinstance(req, BlockRequest):
                return BlockResponse().encode()
            if isinstance(req, CodeRequest):
                return CodeResponse().encode()
            return self.inner(sender, request)
        # leafs-tampering modes: non-leafs traffic passes through
        req = decode_message(request)
        if not isinstance(req, LeafsRequest):
            return self.inner(sender, request)
        if mode == "truncated_stream":
            limit = req.limit or 1024
            req.limit = max(1, limit // 4)
            resp = decode_message(self.inner(sender, req.encode()))
            if resp.more:
                with self._lock:
                    self.tampered += 1
                resp.more = False  # "that's all there is", honestly proofed
            return resp.encode()
        resp = decode_message(self.inner(sender, request))
        if mode == "lying_leafs" and resp.vals:
            v = resp.vals[len(resp.vals) // 2]
            if v:
                with self._lock:
                    self.tampered += 1
                resp.vals[len(resp.vals) // 2] = (
                    v[:-1] + bytes([v[-1] ^ 0xFF]))
        elif mode == "bad_proof" and resp.proof_vals:
            p = resp.proof_vals[0]
            with self._lock:
                self.tampered += 1
            resp.proof_vals[0] = p[:-1] + bytes([p[-1] ^ 0xFF]) if p else b"\x01"
        return resp.encode()


class DisruptiveServer(TransportServer):
    """TransportServer that can hard-close every live connection on
    demand — the wire-level analogue of a peer crash / NAT rebind.
    Drives RemotePeer's backoff re-dial path in chaos tests."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._conns: List[socket.socket] = []
        self._conns_lock = threading.Lock()
        self.severed = 0

    def _serve_conn(self, conn, addr):
        with self._conns_lock:
            self._conns.append(conn)
        try:
            super()._serve_conn(conn, addr)
        finally:
            with self._conns_lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass

    def sever_all(self) -> int:
        """Abort every live connection (RST-ish: shutdown both ways then
        close). Returns how many were severed."""
        with self._conns_lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass
        self.severed += len(conns)
        return len(conns)
