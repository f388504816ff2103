"""Log filters & subscriptions (semantics of coreth eth/filters/ —
filter_system.go, filter.go; bloom-gated log search, polling filters, and
coreth's accepted-event feeds); counterpart of coreth_tpu/eth/filters.py.

The feeds fire on the chain's acceptor thread (accepted blocks and their
logs) and on the caller of TxPool.add (pending txs); each accepted block
reaches every filter once."""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from ..core.types import bloom_lookup
from ..metrics import count_drop
from ..utils.deadline import check as deadline_check
from .cache import BoundedCache

FILTER_TIMEOUT = 300.0  # 5 min deactivation like filter_system.go
CANDIDATES_CACHE_SIZE = 64

# deadline checkpoint cadence inside a block scan: often enough that a
# budget overrun is caught within one batch, rare enough to stay free
DEADLINE_CHECK_EVERY = 32


def _match_topics(log, topics: List) -> bool:
    """Topic filter semantics: position-wise, None = wildcard, list = OR."""
    if not topics:
        return True
    if len(topics) > len(log.topics):
        return False
    for want, have in zip(topics, log.topics):
        if want is None:
            continue
        options = want if isinstance(want, list) else [want]
        if not any(o == have for o in options):
            return False
    return True


def _match_address(log, addresses: List[bytes]) -> bool:
    return not addresses or log.address in addresses


class _Filter:
    def __init__(self, typ: str, crit: Optional[dict] = None):
        self.typ = typ  # "logs" | "blocks" | "pendingTxs"
        self.crit = crit or {}
        self.items: list = []
        self.last_poll = time.monotonic()


class FilterSystem:
    """Installable polling filters + direct getLogs (filters.FilterSystem)."""

    def __init__(self, backend, candidates_cache_size: int = CANDIDATES_CACHE_SIZE):
        self.b = backend
        self.lock = threading.Lock()
        # bloom-bit candidate offsets per (section, criteria): candidates
        # are only consulted for FULLY-indexed sections, whose rows never
        # change once committed — the key is complete forever, so no
        # invalidation hook is needed (logs-cache-size knob)
        self._candidates_cache = BoundedCache("logs", candidates_cache_size)
        self.filters: Dict[str, _Filter] = {}
        # push subscribers: id -> (typ, crit, notify) — the WS
        # eth_subscribe feeds (filter_system.go subscription channels)
        self._subscribers: Dict[int, tuple] = {}
        self._next_sub = 0
        # accepted-chain events drive filters (coreth semantics)
        backend.chain.subscribe_chain_accepted_event(self._on_accepted)
        if getattr(backend, "txpool", None) is not None:
            backend.txpool.subscribe_new_txs(self._on_new_txs)

    # --- event fan-in -----------------------------------------------------

    def _on_accepted(self, block, logs) -> None:
        with self.lock:
            self._expire_stale()  # abandoned filters must not grow forever
            for f in self.filters.values():
                if f.typ == "blocks":
                    f.items.append(block.hash())
                elif f.typ == "logs":
                    # honor the filter's block range, not just addr/topics
                    lo, hi = f.crit.get("from"), f.crit.get("to")
                    if lo is not None and block.number < lo:
                        continue
                    if hi is not None and block.number > hi:
                        continue
                    f.items.extend(self._filter_logs(logs, f.crit))
            subscribers = list(self._subscribers.items())
        # notify OUTSIDE the lock: subscriber callbacks write sockets. A
        # dead client must never poison block acceptance — failures drop
        # the subscriber.
        for sid, (typ, crit, notify) in subscribers:
            try:
                if typ == "newHeads":
                    notify(block)
                elif typ == "logs":
                    for l in self._filter_logs(logs, crit):
                        notify(l)
            except Exception:
                # a throwing sink is unsubscribed, not retried — count the
                # eviction so a flapping websocket shows up in metrics
                count_drop("eth/filters/subscriber_evicted")
                with self.lock:
                    self._subscribers.pop(sid, None)

    def _on_new_txs(self, txs) -> None:
        with self.lock:
            for f in self.filters.values():
                if f.typ == "pendingTxs":
                    f.items.extend(t.hash() for t in txs)
            subscribers = list(self._subscribers.items())
        for sid, (typ, _crit, notify) in subscribers:
            if typ != "newPendingTransactions":
                continue
            try:
                for t in txs:
                    notify(t.hash())
            except Exception:
                count_drop("eth/filters/subscriber_evicted")
                with self.lock:
                    self._subscribers.pop(sid, None)

    # --- push subscriptions (WS eth_subscribe) ----------------------------

    def subscribe_push(self, typ: str, crit: Optional[dict],
                       notify: Callable) -> Callable[[], None]:
        """Register a push subscriber; returns its unsubscribe fn.
        typ: newHeads | logs | newPendingTransactions."""
        if typ not in ("newHeads", "logs", "newPendingTransactions"):
            raise ValueError(f"unknown subscription kind {typ!r}")
        parsed = self._parse_criteria(crit or {}) if typ == "logs" else {}
        with self.lock:
            sid = self._next_sub
            self._next_sub += 1
            self._subscribers[sid] = (typ, parsed, notify)

        def cancel():
            with self.lock:
                self._subscribers.pop(sid, None)

        return cancel

    # --- filter management ------------------------------------------------

    def _install(self, f: _Filter) -> str:
        fid = "0x" + uuid.uuid4().hex
        with self.lock:
            self._expire_stale()
            self.filters[fid] = f
        return fid

    def _expire_stale(self) -> None:  # guarded-by: lock
        now = time.monotonic()
        for fid in [fid for fid, f in self.filters.items()
                    if now - f.last_poll > FILTER_TIMEOUT]:
            del self.filters[fid]

    def new_log_filter(self, crit: dict) -> str:
        return self._install(_Filter("logs", self._parse_criteria(crit)))

    def new_block_filter(self) -> str:
        return self._install(_Filter("blocks"))

    def new_pending_tx_filter(self) -> str:
        return self._install(_Filter("pendingTxs"))

    def uninstall(self, fid: str) -> bool:
        with self.lock:
            return self.filters.pop(fid, None) is not None

    def get_changes(self, fid: str) -> list:
        with self.lock:
            f = self.filters.get(fid)
            if f is None:
                raise ValueError("filter not found")
            f.last_poll = time.monotonic()
            items, f.items = f.items, []
            return items

    # --- log search -------------------------------------------------------

    def _parse_criteria(self, crit: dict) -> dict:
        from .api import parse_bytes, parse_hex

        out = {"addresses": [], "topics": [], "from": None, "to": None,
               "block_hash": None}
        addrs = crit.get("address")
        if addrs:
            if isinstance(addrs, str):
                addrs = [addrs]
            out["addresses"] = [parse_bytes(a) for a in addrs]
        for t in crit.get("topics", []):
            if t is None:
                out["topics"].append(None)
            elif isinstance(t, list):
                out["topics"].append([parse_bytes(x) for x in t])
            else:
                out["topics"].append(parse_bytes(t))
        if crit.get("blockHash"):
            out["block_hash"] = parse_bytes(crit["blockHash"])
        else:
            def tag_to_number(tag):
                if tag in (None, "latest", "accepted", "pending"):
                    return None
                if tag == "earliest":
                    return 0
                return parse_hex(tag)

            out["from"] = tag_to_number(crit.get("fromBlock"))
            out["to"] = tag_to_number(crit.get("toBlock"))
        return out

    def _filter_logs(self, logs, crit: dict) -> list:
        return [
            l for l in logs
            if _match_address(l, crit["addresses"]) and _match_topics(l, crit["topics"])
        ]

    def get_logs(self, raw_crit: dict) -> list:
        """eth_getLogs: indexed sections resolve candidate blocks through
        the transposed bloom-bit index (core/bloombits analog — a handful
        of row reads + vectorized ANDs instead of a header walk);
        unindexed stretches fall back to per-block header blooms."""
        crit = self._parse_criteria(raw_crit)
        chain = self.b.chain
        head = self.b.last_accepted_block().number
        if crit["block_hash"] is not None:
            blk = chain.get_block(crit["block_hash"])
            return self._scan_blocks([blk] if blk else [], crit)
        lo = crit["from"] if crit["from"] is not None else head
        hi = crit["to"] if crit["to"] is not None else head
        hi = min(hi, head)
        max_blocks = getattr(self.b, "api_max_blocks", 0)
        if max_blocks and hi - lo + 1 > max_blocks:
            from ..rpc.server import RPCError
            from ..rpc.admission import LIMIT_EXCEEDED
            raise RPCError(
                LIMIT_EXCEEDED,
                f"eth_getLogs range too large ({hi - lo + 1} > "
                f"{max_blocks} blocks); narrow fromBlock/toBlock")

        from ..core.bloom_index import filter_groups

        indexer = getattr(chain, "bloom_indexer", None)
        groups = filter_groups(crit)
        out = []
        n = lo
        while n <= hi:
            deadline_check()  # cooperative: frees the worker on expiry
            size = indexer.section_size if indexer else 0
            section = n // size if size else 0
            sec_lo, sec_hi = section * size, (section + 1) * size - 1
            use_index = (
                indexer is not None and groups
                and n == sec_lo and sec_hi <= hi
                and indexer.has_section(section)
            )
            if use_index:
                cache_key = (section, tuple(tuple(g) for g in groups))
                offsets = self._candidates_cache.get(cache_key)
                if offsets is None:
                    offsets = indexer.candidates(section, groups)
                    if offsets is not None:
                        self._candidates_cache.put(cache_key, offsets)
                blocks = [
                    chain.get_block_by_number(sec_lo + int(off))
                    for off in (offsets if offsets is not None else [])
                ]
                if offsets is None:  # raced / partial index: scan instead
                    blocks = [chain.get_block_by_number(i)
                              for i in range(sec_lo, sec_hi + 1)]
                out.extend(self._scan_blocks(blocks, crit))
                n = sec_hi + 1
            else:
                stop = min(hi, sec_hi if size else hi)
                blocks = [chain.get_block_by_number(i)
                          for i in range(n, stop + 1)]
                out.extend(self._scan_blocks(blocks, crit))
                n = stop + 1
        return out

    def _scan_blocks(self, blocks, crit: dict) -> list:
        chain = self.b.chain
        out = []
        for i, blk in enumerate(blocks):
            if i % DEADLINE_CHECK_EVERY == 0:
                deadline_check()
            if blk is None:
                continue
            # bloom pre-filter: skip blocks that cannot contain a match
            if crit["addresses"] and not any(
                bloom_lookup(blk.header.bloom, a) for a in crit["addresses"]
            ):
                continue
            receipts = chain.get_receipts(blk.hash()) or []
            for r in receipts:
                out.extend(self._filter_logs(r.logs, crit))
        return out
