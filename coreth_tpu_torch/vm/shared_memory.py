"""In-process shared memory between chains (semantics of avalanchego's
atomic.Memory as coreth's plugin/evm uses it: the X/P<->C UTXO bridge);
counterpart of coreth_tpu/vm/shared_memory.py.

Each (requesting chain, peer chain) pair shares one namespace of
key→value elements with traits (indexes). Apply() commits a batch of
puts/removes atomically together with the VM's own database batch, the
same contract as avalanchego's SharedMemory.Apply (plugin/evm/block.go:
164-168 commit batch pattern).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class Element:
    key: bytes
    value: bytes
    traits: List[bytes] = field(default_factory=list)


@dataclass
class Requests:
    remove_requests: List[bytes] = field(default_factory=list)
    put_requests: List[Element] = field(default_factory=list)


class SharedMemory:
    """One chain's view onto the shared atomic memory."""

    def __init__(self, memory: "Memory", chain_id: bytes):
        self._memory = memory
        self._chain_id = chain_id

    def get(self, peer_chain_id: bytes, keys: List[bytes]) -> List[bytes]:
        ns = self._memory._namespace(self._chain_id, peer_chain_id)
        out = []
        for k in keys:
            v = ns.get(k)
            if v is None:
                raise KeyError(f"key {k.hex()} not found in shared memory")
            out.append(v.value)
        return out

    def indexed(self, peer_chain_id: bytes, traits: List[bytes],
                start_trait: bytes = b"", start_key: bytes = b"",
                limit: int = 100) -> Tuple[List[bytes], bytes, bytes]:
        """Fetch values whose traits intersect [traits] (UTXO lookup)."""
        ns = self._memory._namespace(self._chain_id, peer_chain_id)
        hits = []
        for el in ns.values():
            if any(t in el.traits for t in traits):
                hits.append(el)
        hits.sort(key=lambda e: e.key)
        if start_key:
            hits = [e for e in hits if e.key > start_key]
        vals = [e.value for e in hits[:limit]]
        last_key = hits[min(limit, len(hits)) - 1].key if hits else b""
        return vals, b"", last_key

    def apply(self, requests: Dict[bytes, Requests], batch=None) -> None:
        """Atomically apply removes/puts across peer chains, then write the
        caller's db batch — all under one lock."""
        with self._memory._lock:
            # validate first: removes must exist
            for peer, req in requests.items():
                ns = self._memory._namespace(peer, self._chain_id)
                my_ns = self._memory._namespace(self._chain_id, peer)
                for k in req.remove_requests:
                    if k not in my_ns:
                        raise KeyError(f"cannot remove missing key {k.hex()}")
            for peer, req in requests.items():
                # removes target OUR inbound namespace (consuming imports);
                # puts go to the PEER's inbound namespace (exports to them)
                my_ns = self._memory._namespace(self._chain_id, peer)
                peer_ns = self._memory._namespace(peer, self._chain_id)
                for k in req.remove_requests:
                    del my_ns[k]
                for el in req.put_requests:
                    peer_ns[el.key] = el
            if batch is not None:
                batch.write()


class Memory:
    """The hub shared by all chains in one process (test fixture +
    production single-process topology)."""

    def __init__(self):
        self._lock = threading.RLock()
        # (owner chain, peer chain) -> {key: Element}: elements readable by
        # [owner] that were produced by [peer]
        self._spaces: Dict[Tuple[bytes, bytes], Dict[bytes, Element]] = {}

    def new_shared_memory(self, chain_id: bytes) -> SharedMemory:
        return SharedMemory(self, chain_id)

    def _namespace(self, owner: bytes, peer: bytes) -> Dict[bytes, Element]:
        return self._spaces.setdefault((owner, peer), {})
