"""Server-side sync handlers (role of coreth sync/handlers/
{leafs_request,block_request,code_request}.go); counterpart of
coreth_tpu/sync/handlers.py.

LeafsRequestHandler serves range-proofed leaf batches (≤1024 leaves,
leafs_request.go:34,76): iterate the requested trie from `start`, attach
edge proofs so the client can run VerifyRangeProof. BlockRequestHandler
walks parent hashes; CodeRequestHandler reads code blobs.
"""

from __future__ import annotations

from typing import List, Optional

from ..core import rawdb
from ..metrics import count_drop
from ..metrics.spans import span
from ..native import keccak256
from ..trie.proof import prove
from .messages import (
    MAX_CODE_HASHES_PER_REQUEST,
    MAX_LEAVES_LIMIT,
    BlockRequest,
    BlockResponse,
    CodeRequest,
    CodeResponse,
    LeafsRequest,
    LeafsResponse,
    decode_message,
)


class LeafsRequestHandler:
    """Range-proofed leaf batches. When a snapshot tree is attached, leaf
    VALUES come from the flat snapshot (leafs_request.go:38,246 fast
    path) inside a 75%-of-deadline budget, locally verified against the
    requested trie root before responding — a stale snapshot silently
    falls back to direct trie iteration."""

    SNAPSHOT_BUDGET = 0.75  # leafs_request.go: leave 25% for proof build

    def __init__(self, triedb, diskdb=None, snaps=None):
        self.triedb = triedb
        self.snaps = snaps

    def on_leafs_request(self, req: LeafsRequest,
                         deadline: Optional[float] = None) -> LeafsResponse:
        """OnLeafsRequest (leafs_request.go:76): collect up to limit leaves
        in [start, end] plus range proofs. deadline: absolute
        time.monotonic() budget for the whole request."""
        limit = min(req.limit or MAX_LEAVES_LIMIT, MAX_LEAVES_LIMIT)
        try:
            trie = self.triedb.open_trie(req.root)
        except Exception:
            # empty response = "dont-have" on the wire; the peer retries
            # elsewhere, but WE should know we're serving misses
            count_drop("sync/handlers/leafs_open_error")
            return LeafsResponse()

        resp = self._try_snapshot(req, trie, limit, deadline)
        if resp is not None:
            return resp

        from ..trie.iterator import iterate_leaves

        import time as _time

        keys: List[bytes] = []
        vals: List[bytes] = []
        more = False
        try:
            for k, v in iterate_leaves(trie, req.start or None):
                if req.end and k > req.end:
                    break
                if len(keys) >= limit:
                    more = True
                    break
                if deadline is not None and _time.monotonic() > deadline:
                    more = True  # out of time: serve what we have
                    break
                keys.append(k)
                vals.append(v)
        except Exception:
            count_drop("sync/handlers/leafs_iterate_error")
            return LeafsResponse()

        return self._respond(req, trie, keys, vals, more)

    # --- snapshot fast path -----------------------------------------------

    def _try_snapshot(self, req, trie, limit: int,
                      deadline: Optional[float]) -> Optional[LeafsResponse]:
        if self.snaps is None:
            return None
        import time as _time

        from ..state.snapshot import (SNAPSHOT_ACCOUNT_PREFIX,
                                      SNAPSHOT_STORAGE_PREFIX, SnapshotError)
        from ..state.statedb import _slim_to_account

        disk = self.snaps.disk_layer
        budget_end = None
        if deadline is not None:
            now = _time.monotonic()
            budget_end = now + (deadline - now) * self.SNAPSHOT_BUDGET
        keys: List[bytes] = []
        vals: List[bytes] = []
        more = False
        try:
            disk._check()
            if req.account:
                pfx = SNAPSHOT_STORAGE_PREFIX + req.account
                it = ((k[len(pfx):], v)
                      for k, v in disk.diskdb.iterate(pfx, req.start))
                convert = lambda v: v
            else:
                pfx = SNAPSHOT_ACCOUNT_PREFIX
                it = ((k[len(pfx):], v)
                      for k, v in disk.diskdb.iterate(pfx, req.start))
                # snapshot stores slim account RLP; the trie stores full
                convert = lambda v: _slim_to_account(v).encode()
            for k, v in it:
                if req.end and k > req.end:
                    break
                if len(keys) >= limit:
                    more = True
                    break
                if budget_end is not None and _time.monotonic() > budget_end:
                    more = True  # truncated: client continues from last key
                    break
                keys.append(k)
                vals.append(convert(v))
        except SnapshotError:
            return None  # generating / stale: the trie is the truth
        except Exception:
            # unexpected snapshot fault (not a lifecycle miss): the trie
            # fallback hides it, the counter does not
            count_drop("sync/handlers/snapshot_read_error")
            return None
        if more and not keys:
            # budget died before anything was collected: let the trie
            # path produce whatever it can inside the remaining time
            return None

        resp = self._respond(req, trie, keys, vals, more)
        # verify before trusting the flat data: the snapshot may lag the
        # requested root (leafs_request.go double-check + fallback)
        try:
            from ..trie.proof_range import verify_range_proof

            proof_db = {keccak256(b): b for b in resp.proof_vals} or None
            # same edge-key rule as the client (sync/client.py): an empty
            # start anchors at the first key (or the zero key)
            first = req.start if req.start else (
                keys[0] if keys else b"\x00" * 32)
            if proof_db is not None:
                verify_range_proof(req.root, first,
                                   keys[-1] if keys else first,
                                   keys, vals, proof_db)
            else:
                # whole-trie response: root must simply match
                from ..trie.stacktrie import StackTrie

                st = StackTrie()
                for k, v in zip(keys, vals):
                    st.update(k, v)
                if st.hash() != req.root:
                    return None
        except Exception:
            count_drop("sync/handlers/snapshot_proof_error")
            return None
        return resp

    # --- shared response/proof build ---------------------------------------

    def _respond(self, req, trie, keys, vals, more) -> LeafsResponse:
        # proofs: start edge (or first key) and last key. A whole-trie
        # response (no start, not truncated) needs no proof.
        proof_vals: List[bytes] = []
        if req.start or more:
            proof_db = {}
            first = req.start if req.start else (keys[0] if keys else b"\x00" * 32)
            for blob in prove(trie, first):
                proof_db[keccak256(blob)] = blob
            if keys:
                for blob in prove(trie, keys[-1]):
                    proof_db[keccak256(blob)] = blob
            proof_vals = list(proof_db.values())
        return LeafsResponse(keys, vals, more, proof_vals)


class BlockRequestHandler:
    def __init__(self, chain):
        self.chain = chain

    def on_block_request(self, req: BlockRequest) -> BlockResponse:
        blocks: List[bytes] = []
        h = req.hash
        for _ in range(min(req.parents, 256)):
            blk = self.chain.get_block(h)
            if blk is None:
                break
            blocks.append(blk.encode())
            if blk.number == 0:
                break
            h = blk.parent_hash
        return BlockResponse(blocks)


class CodeRequestHandler:
    def __init__(self, diskdb):
        self.diskdb = diskdb

    def on_code_request(self, req: CodeRequest) -> CodeResponse:
        data: List[bytes] = []
        for ch in req.hashes[:MAX_CODE_HASHES_PER_REQUEST]:
            code = rawdb.read_code(self.diskdb, ch)
            data.append(code or b"")
        return CodeResponse(data)


class SyncHandler:
    """Router for all inbound sync requests (plugin/evm message router)."""

    def __init__(self, chain, triedb, diskdb, snaps=None):
        if snaps is None:
            snaps = getattr(chain, "snaps", None)
        self.leafs = LeafsRequestHandler(triedb, snaps=snaps)
        self.blocks = BlockRequestHandler(chain)
        self.code = CodeRequestHandler(diskdb)

    def handle(self, sender: bytes, request: bytes) -> bytes:
        msg = decode_message(request)
        if isinstance(msg, LeafsRequest):
            with span("sync/leafs", limit=msg.limit or 0):
                return self.leafs.on_leafs_request(msg).encode()
        if isinstance(msg, BlockRequest):
            with span("sync/blocks", parents=msg.parents):
                return self.blocks.on_block_request(msg).encode()
        if isinstance(msg, CodeRequest):
            with span("sync/code", hashes=len(msg.hashes)):
                return self.code.on_code_request(msg).encode()
        raise ValueError(f"unhandled request {type(msg)}")
