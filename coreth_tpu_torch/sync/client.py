"""Sync client (role of coreth sync/client/client.go); counterpart of
coreth_tpu/sync/client.py.

GetLeafs/GetBlocks/GetCode with response validation (range proofs checked
via trie.verify_range_proof — client.go:180), per-attempt peer rotation,
and bounded retries (client.go:293-361; up to 32 attempts).

Retries are DISCIPLINED (unlike the reference's immediate re-send):

  * `fault.Backoff` spaces attempts so a struggling peer set is not
    hammered; the schedule resets per logical request
  * every request class (leafs / blocks / code) has its own deadline,
    capped by any ambient `utils.deadline` budget on the thread
  * failures are TYPED and fed to the peer scoring ladder — transport
    and deadline faults from the network layer, decode failures for
    garbage bytes, proof-weight failures for responses that fail
    cryptographic or structural validation
  * the critical leafs path can HEDGE: if the primary peer has not
    answered within `hedge_delay`, a duplicate request goes to the
    next-best peer and the first answer wins (tail-latency insurance;
    the loser is abandoned to its own deadline)
  * peers that answer "don't have" (empty response for a non-empty
    root) are tallied per root; once enough DISTINCT peers agree, the
    root is presumed stale and `RootUnavailableError` tells the
    orchestrator to pivot to a newer summary instead of burning retries
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple

from ..fault import Backoff, failpoint
from ..fault import register as _register_failpoint
from ..metrics import default_registry
from ..native import keccak256
from ..peer.network import (
    FAIL_DECODE,
    FAIL_PROOF,
    Network,
    NetworkError,
)
from ..trie.node import EMPTY_ROOT
from ..trie.proof_range import ProofError, verify_range_proof
from ..utils import deadline as _deadline
from .messages import (
    BlockRequest,
    BlockResponse,
    CodeRequest,
    CodeResponse,
    LeafsRequest,
    LeafsResponse,
    decode_message,
)

MAX_RETRY_ATTEMPTS = 32

# Deadline per request class (seconds); overridable via sync-* knobs.
DEFAULT_DEADLINES = {"leafs": 10.0, "blocks": 10.0, "code": 10.0}

FP_BEFORE_REQUEST = _register_failpoint(
    "sync/before_request",
    "before every outbound sync request (leafs/blocks/code) is sent")


class ClientError(Exception):
    pass


class RootUnavailableError(ClientError):
    """Enough distinct peers answered "don't have" for this root that it
    is presumed stale/unavailable: the sync orchestrator should pivot to
    a newer state summary rather than keep retrying."""

    def __init__(self, root: bytes, peers: Set[bytes]):
        super().__init__(
            f"root {root.hex()[:12]} unavailable: {len(peers)} distinct "
            "peers answered don't-have")
        self.root = root
        self.peers = set(peers)


class _DontHave(Exception):
    """Internal: one peer answered the don't-have wire shape."""


class SyncClient:
    def __init__(self, network: Network, max_attempts: int = MAX_RETRY_ATTEMPTS,
                 deadlines: Optional[Dict[str, float]] = None,
                 backoff_base: float = 0.02, backoff_cap: float = 1.0,
                 hedge_enabled: bool = False, hedge_delay: float = 0.25,
                 stale_root_votes: int = 3):
        self.network = network
        self.max_attempts = max_attempts
        self.deadlines = dict(DEFAULT_DEADLINES)
        if deadlines:
            self.deadlines.update(deadlines)
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.hedge_enabled = hedge_enabled
        self.hedge_delay = hedge_delay
        self.stale_root_votes = stale_root_votes
        self._hedge_pool = None
        self._lock = threading.Lock()
        # root -> distinct peers that answered don't-have for it
        self._dont_have: Dict[bytes, Set[bytes]] = {}

    @classmethod
    def from_config(cls, network: Network, config) -> "SyncClient":
        """Build from validated vm/config sync-* knobs and configure the
        peer ladder from the same source."""
        network.tracker.configure(
            suspect_score=config.sync_suspect_score,
            quarantine_score=config.sync_quarantine_score,
            quarantine_seconds=config.sync_quarantine_seconds,
            readmit_probes=config.sync_readmit_probes,
        )
        return cls(
            network,
            max_attempts=config.sync_max_attempts,
            deadlines={
                "leafs": config.sync_leafs_deadline,
                "blocks": config.sync_blocks_deadline,
                "code": config.sync_code_deadline,
            },
            backoff_base=config.sync_backoff_base,
            backoff_cap=config.sync_backoff_cap,
            hedge_enabled=config.sync_hedge_requests,
            hedge_delay=config.sync_hedge_delay,
            stale_root_votes=config.sync_stale_root_votes,
        )

    def close(self) -> None:
        with self._lock:
            pool, self._hedge_pool = self._hedge_pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    # --- peer scoring hooks ------------------------------------------------

    def report_peer(self, node_id: Optional[bytes], kind: str) -> None:
        """Score a peer for a failure discovered AFTER its response was
        accepted (e.g. a drained-segment claim contradicted by another
        peer's proof-backed leaves)."""
        if node_id is None:
            return
        self.network.tracker.record_failure(node_id, kind)
        default_registry.counter(f"sync/reported/{kind}").inc()

    def peer_count(self) -> int:
        with self.network.tracker.lock:
            return len(self.network.tracker.peers)

    def _note_dont_have(self, root: bytes, node_id: bytes) -> None:
        default_registry.counter("sync/root_unavailable_votes").inc()
        with self._lock:
            votes = self._dont_have.setdefault(root, set())
            votes.add(node_id)
            count = len(votes)
        # single-peer networks pivot on the first vote; larger sets need
        # a quorum so one lying "empty" peer cannot force a pivot
        needed = min(self.stale_root_votes, max(1, self.peer_count()))
        if count >= needed:
            with self._lock:
                peers = self._dont_have.pop(root, set())
            raise RootUnavailableError(root, peers)

    def _clear_dont_have(self, root: bytes) -> None:
        with self._lock:
            self._dont_have.pop(root, None)

    # --- transport with optional hedging -----------------------------------

    def _hedger(self):
        with self._lock:
            if self._hedge_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                # bounded: at most 8 in-flight hedge pairs; sized apart
                # from Network's pool so a hedge can never deadlock
                # waiting on the worker its own primary occupies
                self._hedge_pool = ThreadPoolExecutor(max_workers=8)
            return self._hedge_pool

    def _send(self, node_id: bytes, payload: bytes, deadline: float,
              hedge: bool, exclude: Set[bytes]) -> Tuple[bytes, bytes]:
        """One wire exchange; returns (answering_peer, raw_response).
        With hedging, a slow primary races a duplicate on the next-best
        peer; the loser keeps running to its own deadline and only its
        tracker bookkeeping lands late."""
        if not hedge:
            return node_id, self.network.send_request(node_id, payload,
                                                      deadline)
        from concurrent.futures import FIRST_COMPLETED
        from concurrent.futures import TimeoutError as _FTimeout
        from concurrent.futures import wait as _wait

        pool = self._hedger()
        primary = pool.submit(self.network.send_request, node_id, payload,
                              deadline)
        try:
            return node_id, primary.result(timeout=self.hedge_delay)
        except _FTimeout:
            pass  # primary is slow: hedge
        second = self.network.tracker.best_peer(exclude=exclude | {node_id})
        if second is None:
            return node_id, primary.result(timeout=deadline)
        default_registry.counter("sync/hedges").inc()
        backup = pool.submit(self.network.send_request, second, payload,
                             deadline)
        pending = {primary: node_id, backup: second}
        last_err: Optional[Exception] = None
        while pending:
            done, _ = _wait(list(pending), timeout=deadline + 1.0,
                            return_when=FIRST_COMPLETED)
            if not done:
                break
            for fut in done:
                nid = pending.pop(fut)
                try:
                    raw = fut.result()
                except Exception as e:  # scored inside send_request
                    last_err = e
                    continue
                if nid == second:
                    default_registry.counter("sync/hedge_wins").inc()
                return nid, raw
        raise last_err or NetworkError("hedged request failed")

    # --- retry loop ---------------------------------------------------------

    def _request(self, payload: bytes, validate=None, klass: str = "leafs",
                 hedge: bool = False, exclude: Optional[Set[bytes]] = None):
        """One logical request: rotate peers on ANY failure — transport
        faults, undecodable responses, or validation rejections
        (client.go:293-361 retry-with-rotation) — with Backoff between
        attempts and the request-class deadline capped by any ambient
        thread deadline."""
        tried: set = set(exclude) if exclude else set()
        pinned: set = set(tried)  # caller exclusions survive rotation resets
        last_err: Optional[Exception] = None
        backoff = Backoff(base=self.backoff_base, cap=self.backoff_cap)
        timer = default_registry.timer(f"sync/request/{klass}")
        for attempt in range(self.max_attempts):
            _deadline.check()
            if attempt:
                default_registry.counter("sync/retries").inc()
                backoff.sleep()
            node_id = self.network.tracker.best_peer(exclude=tried)
            if node_id is None:
                tried = set(pinned)  # rotation exhausted: start over
                node_id = self.network.tracker.best_peer(exclude=tried or None)
                if node_id is None:
                    raise ClientError("no peers available")
            budget = _deadline.remaining(self.deadlines.get(klass, 10.0))
            failpoint("sync/before_request")
            try:
                with timer.time():
                    peer, raw = self._send(node_id, payload, budget,
                                           hedge, tried)
            except NetworkError as e:
                # send_request already scored transport/deadline faults
                last_err = e
                tried.add(node_id)
                continue
            try:
                msg = decode_message(raw)
            except Exception as e:
                self.network.tracker.record_failure(peer, FAIL_DECODE)
                default_registry.counter("sync/failures/decode").inc()
                last_err = e
                tried.add(peer)
                continue
            try:
                if validate is not None:
                    validate(msg, peer)
            except RootUnavailableError:
                raise  # quorum reached: the orchestrator must pivot
            except _DontHave:
                # not a lie per se (the peer may just be pruned), but it
                # yielded nothing: weight-1 score + rotate away
                self.network.tracker.record_failure(peer, FAIL_DECODE)
                last_err = ClientError("peer answered don't-have")
                tried.add(peer)
                continue
            except (ClientError, ProofError, ValueError) as e:
                # validation rejections are the lying-peer signal: weigh
                # hardest so a fast liar exits the rotation quickly
                self.network.tracker.record_failure(peer, FAIL_PROOF)
                default_registry.counter("sync/failures/validation").inc()
                last_err = e
                tried.add(peer)
                continue
            msg.peer = peer  # attribution for after-the-fact scoring
            return msg
        raise ClientError(f"exhausted retries: {last_err}")

    # --- request classes ----------------------------------------------------

    def get_leafs(self, root: bytes, start: bytes = b"", end: bytes = b"",
                  limit: int = 1024, account: bytes = b"",
                  exclude: Optional[Set[bytes]] = None) -> LeafsResponse:
        """GetLeafs (client.go:114): fetch + verify a range-proofed batch.
        [exclude] pins peers out of the rotation (drain confirmation asks
        a DIFFERENT peer than the one whose claim it checks)."""
        req = LeafsRequest(root, account, start, end, limit)

        def validate(resp, peer):
            if not isinstance(resp, LeafsResponse):
                raise ClientError("wrong response type")
            if (not resp.keys and not resp.proof_vals
                    and req.root != EMPTY_ROOT):
                # the handlers' "don't have" wire shape: no keys AND no
                # proofs for a non-empty root (an honest drained range
                # always carries edge proofs). Tally the vote; enough
                # distinct voters raises RootUnavailableError.
                self._note_dont_have(req.root, peer)
                raise _DontHave()
            self._verify_leafs(req, resp)
            self._clear_dont_have(req.root)

        return self._request(req.encode(), validate, klass="leafs",
                             hedge=self.hedge_enabled and self.peer_count() > 1,
                             exclude=exclude)

    def _verify_leafs(self, req: LeafsRequest, resp: LeafsResponse) -> None:
        """client.go:180 region: responses must carry a valid range proof."""
        if not resp.proof_vals:
            # whole-trie response: only valid with no start key and no more
            if req.start or resp.more:
                raise ProofError("missing proof for partial response")
            has_more = verify_range_proof(
                req.root,
                resp.keys[0] if resp.keys else b"",
                resp.keys[-1] if resp.keys else b"",
                resp.keys, resp.vals, None,
            )
            if has_more:
                raise ProofError("unexpected more-elements")
            return
        proof_db = {keccak256(b): b for b in resp.proof_vals}
        first = req.start if req.start else (resp.keys[0] if resp.keys else b"\x00" * 32)
        if req.end and not resp.keys:
            # end-bounded segment drained: the zero-key edge proof can only
            # express "no keys AT OR AFTER first" over the whole trie —
            # keys legitimately exist past the segment's end, so that check
            # would always fail here. Truncation inside the segment cannot
            # hide: the segmented syncer re-derives the FULL-keyspace root
            # from the buffered leaves and rejects any gap.
            return
        last = resp.keys[-1] if resp.keys else first
        has_more = verify_range_proof(
            req.root, first, last, resp.keys, resp.vals, proof_db
        )
        if req.end:
            # beyond-`last` elements may lie outside the requested segment;
            # the proof cannot distinguish them, so keep the server's flag
            # (same gap-catch as above: the rebuild root check is terminal,
            # and the drain-confirmation pass in statesync cross-examines
            # a second peer before any segment is marked done)
            return
        # Trust the proof, never the peer: overwrite the server-supplied flag
        # with the proof-derived one (parseLeafsResponse in the reference sets
        # More = hasRightElement). A malicious more=False would otherwise
        # silently truncate the leaf stream.
        resp.more = has_more

    def get_blocks(self, block_hash: bytes, height: int, parents: int) -> List[bytes]:
        """GetBlocks: verified parent-hash-linked block bytes, newest first.
        An empty response is NEVER success, and a short response is only
        accepted when it bottoms out at genesis — anything else is a
        scored peer failure (the old vacuous-loop bug accepted both)."""
        from ..core.types import Block

        def validate(resp, peer):
            if not isinstance(resp, BlockResponse):
                raise ClientError("wrong response type")
            if not resp.blocks:
                raise ClientError("empty block response")
            expected = block_hash
            blk = None
            for blob in resp.blocks:
                blk = Block.decode(blob)
                if blk.hash() != expected:
                    raise ClientError("block hash chain mismatch")
                expected = blk.parent_hash
            if len(resp.blocks) < parents and blk is not None and blk.number != 0:
                raise ClientError(
                    f"short block response: {len(resp.blocks)}/{parents} "
                    f"without reaching genesis")

        resp = self._request(
            BlockRequest(block_hash, height, parents).encode(), validate,
            klass="blocks",
        )
        return list(resp.blocks)

    def get_code(self, hashes: List[bytes]) -> List[bytes]:
        """GetCode: keccak-verified code blobs."""

        def validate(resp, peer):
            if not isinstance(resp, CodeResponse):
                raise ClientError("wrong response type")
            if len(resp.data) != len(hashes):
                raise ClientError("wrong code count")
            for h, code in zip(hashes, resp.data):
                if keccak256(code) != h:
                    raise ClientError(f"code hash mismatch for {h.hex()[:12]}")

        resp = self._request(CodeRequest(list(hashes)).encode(), validate,
                             klass="code")
        return list(resp.data)
