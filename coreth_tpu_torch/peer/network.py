"""App-level request/response networking (role of coreth peer/
network.go + client.go + peer_tracker.go); counterpart of
coreth_tpu/peer/network.py.

The reference rides AvalancheGo's AppRequest/AppResponse/AppGossip with
request-id correlation, deadlines, and bandwidth-aware peer selection.
Here the transport is pluggable: production would bind a socket transport;
tests wire VMs back-to-back in-process exactly like the reference's
syncervm tests (syncervm_test.go:269 createSyncServerAndClientVMs).

Peer selection runs a scoring ladder with the same shape as the device
degradation ladder (ops/device.py) and the RPC breaker (rpc/server.py):
HEALTHY -> SUSPECT -> QUARANTINED, fed by typed failure classes where
proof/validation failures weigh hardest (a lying peer is worse than a
slow one). Quarantine is time-boxed with escalating strikes; re-admission
is probe-based — a quarantined peer must answer consecutive probes
correctly before rejoining the healthy rotation.

Where the port departs from the reference (ROADMAP Queue 3): `close()`
shuts the request executor down and joins its workers, so no thread of a
Network outlives its owner; the reference has no close and leaves them.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


def _count(name: str) -> None:
    from ..metrics import count_drop

    count_drop(name)


# Typed failure classes for the peer ladder. Proof rejections weigh
# hardest: a peer that serves data failing cryptographic validation is
# actively lying, while transport faults may just be congestion.
FAIL_TRANSPORT = "transport"
FAIL_DEADLINE = "deadline"
FAIL_DECODE = "decode"
FAIL_PROOF = "proof"

FAILURE_WEIGHTS: Dict[str, float] = {
    FAIL_TRANSPORT: 1.0,
    FAIL_DEADLINE: 2.0,
    FAIL_DECODE: 3.0,
    FAIL_PROOF: 4.0,
}

# Ladder states (mirrors ops/device.py DeviceLadder naming).
PEER_HEALTHY = "healthy"
PEER_SUSPECT = "suspect"
PEER_QUARANTINED = "quarantined"


class NetworkError(Exception):
    """Transport-level failure. ``kind`` is the peer-ladder failure class
    (FAIL_TRANSPORT or FAIL_DEADLINE); validation layers raise their own
    errors and score the peer with FAIL_DECODE/FAIL_PROOF."""

    def __init__(self, message: str, kind: str = FAIL_TRANSPORT):
        super().__init__(message)
        self.kind = kind


@dataclass
class PeerStats:
    """peer_tracker.go bandwidth tracking + ladder state."""

    requests: int = 0
    failures: int = 0
    total_bytes: int = 0
    total_seconds: float = 0.0
    state: str = PEER_HEALTHY
    score: float = 0.0
    strikes: int = 0
    probe_passes: int = 0
    quarantine_until: float = 0.0
    fail_kinds: Dict[str, int] = field(default_factory=dict)

    @property
    def bandwidth(self) -> float:
        if self.requests == 0:
            return float("inf")  # untested peers rank first (exploration)
        if self.total_seconds == 0:
            return 0.0  # tested but never a successful transfer
        return self.total_bytes / self.total_seconds

    @property
    def failure_rate(self) -> float:
        if self.requests == 0:
            return 0.0
        return self.failures / self.requests

    def rank(self) -> float:
        """Selection key: bandwidth discounted by failure rate and the
        live ladder score, so a fast lying peer stops winning rotation."""
        bw = self.bandwidth
        if bw == float("inf"):
            return bw
        return bw * (1.0 - self.failure_rate) / (1.0 + self.score)


class PeerTracker:
    """Bandwidth-aware peer selection (peer_tracker.go:70-198) with a
    healthy/suspect/quarantined scoring ladder."""

    def __init__(self):
        self.peers: Dict[bytes, PeerStats] = {}
        self.lock = threading.Lock()
        # Ladder tuning (overridden by PeerTracker.configure from the
        # validated sync-* config knobs).
        self.suspect_score = 4.0
        self.quarantine_score = 8.0
        self.quarantine_seconds = 30.0
        self.readmit_probes = 2
        self.success_decay = 0.5

    def configure(self, *, suspect_score: Optional[float] = None,
                  quarantine_score: Optional[float] = None,
                  quarantine_seconds: Optional[float] = None,
                  readmit_probes: Optional[int] = None,
                  success_decay: Optional[float] = None) -> None:
        with self.lock:
            if suspect_score is not None:
                self.suspect_score = suspect_score
            if quarantine_score is not None:
                self.quarantine_score = quarantine_score
            if quarantine_seconds is not None:
                self.quarantine_seconds = quarantine_seconds
            if readmit_probes is not None:
                self.readmit_probes = readmit_probes
            if success_decay is not None:
                self.success_decay = success_decay

    def connected(self, node_id: bytes) -> None:
        with self.lock:
            self.peers.setdefault(node_id, PeerStats())

    def disconnected(self, node_id: bytes) -> None:
        with self.lock:
            self.peers.pop(node_id, None)

    # --- ladder -----------------------------------------------------------

    def record_success(self, node_id: bytes, size: int, seconds: float) -> None:
        with self.lock:
            st = self.peers.setdefault(node_id, PeerStats())
            st.requests += 1
            st.total_bytes += size
            st.total_seconds += max(seconds, 1e-6)
            if st.state == PEER_QUARANTINED:
                # A quarantined peer only ever sees traffic as a probe
                # (probe window or last-resort fallback); consecutive
                # correct answers earn re-admission.
                st.probe_passes += 1
                if st.probe_passes >= self.readmit_probes:
                    st.state = PEER_SUSPECT
                    st.score = self.suspect_score / 2.0
                    st.quarantine_until = 0.0
                    st.probe_passes = 0
                    _count("peer/ladder/readmissions")
                return
            st.score = max(0.0, st.score * self.success_decay)
            if st.state == PEER_SUSPECT and st.score < self.suspect_score:
                st.state = PEER_HEALTHY

    def record_failure(self, node_id: bytes, kind: str = FAIL_TRANSPORT) -> None:
        weight = FAILURE_WEIGHTS.get(kind, 1.0)
        with self.lock:
            st = self.peers.setdefault(node_id, PeerStats())
            st.requests += 1
            st.failures += 1
            st.fail_kinds[kind] = st.fail_kinds.get(kind, 0) + 1
            st.score += weight
            now = time.monotonic()
            if st.state == PEER_QUARANTINED:
                st.probe_passes = 0
                if now >= st.quarantine_until:
                    # failed its probe: escalate the quarantine window
                    st.strikes += 1
                    st.quarantine_until = now + self._quarantine_span(st)
                    _count("peer/ladder/probe_failures")
                return
            if st.score >= self.quarantine_score:
                st.state = PEER_QUARANTINED
                st.quarantine_until = now + self._quarantine_span(st)
                st.strikes += 1
                st.probe_passes = 0
                _count("peer/ladder/quarantines")
            elif st.score >= self.suspect_score and st.state == PEER_HEALTHY:
                st.state = PEER_SUSPECT
                _count("peer/ladder/suspects")
        _count("peer/failures/%s" % kind)

    def _quarantine_span(self, st: PeerStats) -> float:
        return self.quarantine_seconds * (2.0 ** min(st.strikes, 6))

    def track_request(self, node_id: bytes, size: int, seconds: float,
                      ok: bool) -> None:
        """Compatibility shim for pre-ladder callers: failures route
        through the ladder as transport faults."""
        if ok:
            self.record_success(node_id, size, seconds)
        else:
            self.record_failure(node_id, FAIL_TRANSPORT)

    # --- selection --------------------------------------------------------

    def best_peer(self, exclude: Optional[set] = None) -> Optional[bytes]:
        now = time.monotonic()
        with self.lock:
            tiers: Dict[int, List[Tuple[float, int, bytes]]] = {}
            for order, (nid, st) in enumerate(self.peers.items()):
                if exclude and nid in exclude:
                    continue
                if st.state == PEER_QUARANTINED:
                    # expired quarantine = probe window; active quarantine
                    # is kept as a LAST resort so an all-quarantined peer
                    # set degrades to probing instead of deadlocking.
                    tier = 3 if now >= st.quarantine_until else 4
                elif st.requests == 0:
                    tier = 0
                elif st.state == PEER_HEALTHY:
                    tier = 1
                else:
                    tier = 2
                tiers.setdefault(tier, []).append((st.rank(), -order, nid))
        for tier in sorted(tiers):
            best = max(tiers[tier])
            return best[2]
        return None

    def status(self) -> Dict[str, dict]:
        """Ladder snapshot for debug_syncStatus."""
        now = time.monotonic()
        out: Dict[str, dict] = {}
        with self.lock:
            for nid, st in self.peers.items():
                bw = st.bandwidth
                out[nid.hex()] = {
                    "state": st.state,
                    "score": round(st.score, 3),
                    "strikes": st.strikes,
                    "requests": st.requests,
                    "failures": st.failures,
                    "failKinds": dict(st.fail_kinds),
                    "bandwidth": None if bw == float("inf") else round(bw, 1),
                    "quarantineRemaining": round(
                        max(0.0, st.quarantine_until - now), 3)
                    if st.state == PEER_QUARANTINED else 0.0,
                }
        return out


class Network:
    """SendAppRequest/Gossip surface (network.go:40,128-483). A Transport
    delivers (node_id, request_bytes) -> response_bytes."""

    def __init__(self, self_id: bytes = b"self"):
        self.self_id = self_id
        self.tracker = PeerTracker()
        self._transports: Dict[bytes, Callable[[bytes, bytes], bytes]] = {}
        self._gossip_handlers: List[Callable[[bytes, bytes], None]] = []
        self._request_handler: Optional[Callable[[bytes, bytes], bytes]] = None
        self._failed_handlers: List[Callable[[bytes, bytes], None]] = []
        self._cross_chain: Dict[bytes, Callable[[bytes], bytes]] = {}
        self._req_id = 0
        self.lock = threading.Lock()
        self._pool = None  # lazy executor for deadlines + async requests
        self.gossip_deadline = 2.0

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            # bounded: 16 workers caps concurrent in-flight transport
            # calls; excess callers queue
            self._pool = ThreadPoolExecutor(
                max_workers=16, thread_name_prefix="peer-net")
        return self._pool

    def close(self) -> None:
        """Shut the request executor down and join its workers. A call
        still parked in a transport is waited for, so close a transport
        (RemotePeer.close, TransportServer.stop) first. Safe to call
        again; a later request re-creates the executor."""
        with self.lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # --- wiring -----------------------------------------------------------

    def connect(self, node_id: bytes, transport: Callable[[bytes, bytes], bytes]) -> None:
        """Register a peer; transport(sender_id, request) -> response."""
        self._transports[node_id] = transport
        self.tracker.connected(node_id)

    def disconnect(self, node_id: bytes) -> None:
        self._transports.pop(node_id, None)
        self.tracker.disconnected(node_id)

    def set_request_handler(self, handler: Callable[[bytes, bytes], bytes]) -> None:
        """Inbound AppRequest handler: (sender, bytes) -> response bytes."""
        self._request_handler = handler

    def subscribe_gossip(self, handler: Callable[[bytes, bytes], None]) -> None:
        self._gossip_handlers.append(handler)

    def subscribe_request_failed(self,
                                 handler: Callable[[bytes, bytes], None]) -> None:
        """AppRequestFailed observer (network.go:398): handler(node_id,
        request) fires on transport fault OR deadline expiry."""
        self._failed_handlers.append(handler)

    def _fire_failed(self, node_id: bytes, request: bytes) -> None:
        for h in self._failed_handlers:
            try:
                h(node_id, request)
            except Exception:
                _count("peer/drops/failed_handler_error")

    # --- cross-chain (network.go:199-328) ---------------------------------

    def register_cross_chain_handler(self, chain_id: bytes,
                                     handler: Callable[[bytes], bytes]) -> None:
        """Serve inbound cross-chain requests addressed to [chain_id]."""
        self._cross_chain[chain_id] = handler

    def send_cross_chain_request(self, chain_id: bytes, request: bytes,
                                 deadline: float = 10.0) -> bytes:
        """SendCrossChainRequest: request another chain's VM (in-process
        registry here; the reference routes via the node's chain router)."""
        handler = self._cross_chain.get(chain_id)
        if handler is None:
            raise NetworkError(f"unknown chain {chain_id!r}")
        fut = self._executor().submit(handler, request)
        from concurrent.futures import TimeoutError as _FTimeout

        try:
            return fut.result(timeout=deadline)
        except _FTimeout:
            raise NetworkError("cross-chain request deadline exceeded",
                               kind=FAIL_DEADLINE)
        except Exception as e:
            raise NetworkError(f"cross-chain request failed: {e}") from e

    # --- outbound ---------------------------------------------------------

    def send_request_any(self, request: bytes, deadline: float = 10.0,
                         exclude: Optional[set] = None) -> Tuple[bytes, bytes]:
        """SendAppRequestAny: pick the best peer; returns (node_id, response)."""
        node_id = self.tracker.best_peer(exclude)
        if node_id is None:
            raise NetworkError("no peers available")
        return node_id, self.send_request(node_id, request, deadline)

    def send_request(self, node_id: bytes, request: bytes,
                     deadline: float = 10.0) -> bytes:
        """Blocking request with a REAL deadline: the caller unblocks at
        the deadline even if the peer never answers (the reference's
        AppRequest deadline + AppRequestFailed, network.go:167-197,398)."""
        transport = self._transports.get(node_id)
        if transport is None:
            raise NetworkError(f"unknown peer {node_id!r}")
        start = time.monotonic()
        fut = self._executor().submit(transport, self.self_id, request)
        from concurrent.futures import TimeoutError as _FTimeout

        try:
            response = fut.result(timeout=deadline)
        except _FTimeout:
            self.tracker.record_failure(node_id, FAIL_DEADLINE)
            self._fire_failed(node_id, request)
            raise NetworkError("request deadline exceeded", kind=FAIL_DEADLINE)
        except Exception as e:
            self.tracker.record_failure(node_id, FAIL_TRANSPORT)
            self._fire_failed(node_id, request)
            raise NetworkError(f"request to {node_id!r} failed: {e}") from e
        elapsed = time.monotonic() - start
        self.tracker.record_success(node_id, len(response), elapsed)
        return response

    def send_request_async(self, node_id: bytes, request: bytes,
                           on_response: Callable[[bytes, bytes], None],
                           on_failed: Optional[Callable[[bytes], None]] = None,
                           deadline: float = 10.0):
        """SendAppRequest's handler-registry shape (network.go:128-167):
        returns immediately; on_response(node_id, response) or
        on_failed(node_id) fires when the request resolves."""

        def run():
            try:
                resp = self.send_request(node_id, request, deadline)
            except NetworkError:
                if on_failed is not None:
                    try:
                        on_failed(node_id)
                    except Exception:
                        _count("peer/drops/failed_callback_error")
                return
            try:
                on_response(node_id, resp)
            except Exception:
                _count("peer/drops/response_callback_error")

        return self._executor().submit(run)

    def gossip(self, payload: bytes) -> None:
        """Fan out without letting one wedged transport stall the loop:
        every send runs on the executor and the whole fan-out shares one
        bounded deadline; a peer that hasn't answered by then is counted
        under peer/gossip_timeouts and abandoned (gossip is fire-and-
        forget, so the payload is not retried)."""
        from concurrent.futures import TimeoutError as _FTimeout

        futs = [
            (node_id, self._executor().submit(transport, self.self_id,
                                              b"\xff" + payload))
            for node_id, transport in list(self._transports.items())
        ]
        end = time.monotonic() + self.gossip_deadline
        for node_id, fut in futs:
            try:
                fut.result(timeout=max(0.0, end - time.monotonic()))
            except _FTimeout:
                _count("peer/gossip_timeouts")
            except Exception:
                _count("peer/drops/gossip_send_failure")

    # --- inbound ----------------------------------------------------------

    def app_request(self, sender: bytes, request: bytes) -> bytes:
        """Entry point peers call (wire this as their transport)."""
        if request[:1] == b"\xff":
            for h in self._gossip_handlers:
                try:
                    h(sender, request[1:])
                except Exception:
                    # one bad handler must not starve the rest, but the
                    # drop is counted, never silent
                    _count("peer/drops/gossip_handler_error")
            return b""
        if self._request_handler is None:
            raise NetworkError("no request handler registered")
        return self._request_handler(sender, request)
