"""EthBackend: the facade wiring chain + txpool + miner for the APIs
(semantics of coreth eth/backend.go Ethereum + eth/api_backend.go
EthAPIBackend); counterpart of coreth_tpu/eth/backend.py.

Coreth semantics: "latest" == last *accepted* block unless the node opts
into allow-unfinalized queries (api_backend.go).
"""

from __future__ import annotations

from typing import Optional, Tuple

from .. import params
from ..core.state_transition import GasPool, Message, apply_message
from ..core.types import Block, Transaction
from ..evm.evm import EVM, Config, TxContext
from ..rpc.server import RPCError
from .api import parse_addr, parse_bytes, parse_hex
from .filters import FilterSystem
from .gasprice import Oracle


def require_keystore(keystore):
    """Shared guard for every keystore-backed RPC (eth/personal/avax)."""
    if keystore is None:
        raise RPCError(
            -32000, "keystore not configured (set keystore-directory)")
    return keystore


class EthBackend:
    def __init__(self, chain, txpool, allow_unfinalized_queries: bool = False,
                 keystore=None, external_signer=None, api_max_blocks: int = 0,
                 gasprice_cache_size: int = 8, logs_cache_size: int = 64):
        self.chain = chain
        self.txpool = txpool
        self.chain_config = chain.config
        self.allow_unfinalized_queries = allow_unfinalized_queries
        self.keystore = keystore  # accounts.KeyStore | None (node/ role)
        # accounts/external.ExternalSigner | None (clef daemon): its
        # accounts list into eth_accounts; signing for them routes over
        # the daemon's IPC (keystore-external-signer config knob)
        self.external_signer = external_signer
        # eth_getLogs block-span cap (api-max-blocks-per-request); 0 = off
        self.api_max_blocks = api_max_blocks
        self.filters = FilterSystem(self, candidates_cache_size=logs_cache_size)
        self.gpo = Oracle(self, cache_size=gasprice_cache_size)

    # --- heads ------------------------------------------------------------
    # every accessor resolves against the chain's atomically published
    # ReadView — no chainmu, no coupling to the write path (SA010)

    def last_accepted_block(self) -> Block:
        return self.chain.read_view().accepted

    def current_block(self) -> Block:
        return self.chain.read_view().preferred

    def _block_in_view(self, view, tag: str) -> Optional[Block]:
        """Tag resolution against ONE view, so a caller that also needs
        state sees block and head from the same publication."""
        if tag in ("latest", "accepted"):
            return view.accepted
        if tag == "pending":
            # coreth has no pending block concept at the API: preference tip
            return view.preferred
        if tag == "earliest":
            return self.chain.genesis_block
        number = parse_hex(tag)
        head = view.accepted.number
        if number > head and not self.allow_unfinalized_queries:
            raise RPCError(
                -32000,
                f"cannot query unfinalized data (requested {number} > accepted {head})",
            )
        return self.chain.get_block_by_number(number)

    def block_by_tag(self, tag: str) -> Optional[Block]:
        return self._block_in_view(self.chain.read_view(), tag)

    def state_at_tag(self, tag: str):
        view = self.chain.read_view()
        blk = self._block_in_view(view, tag)
        if blk is None:
            raise RPCError(-32000, "block not found")
        return self.chain.state_at_view(view, blk.root)

    def state_at_root(self, root: bytes):
        """View-pinned state at an already-resolved root (callers that
        hold a block from block_by_tag/do_call)."""
        return self.chain.state_at_view(self.chain.read_view(), root)

    # --- txs --------------------------------------------------------------

    def send_tx(self, tx: Transaction) -> None:
        self.txpool.add_local(tx)

    def tx_by_hash(self, tx_hash: bytes) -> Optional[Tuple[Transaction, Optional[Block], int]]:
        from ..core import rawdb

        number = rawdb.read_tx_lookup(self.chain.diskdb, tx_hash)
        if number is not None:
            blk = self.chain.get_block_by_number(number)
            if blk is not None:
                for i, tx in enumerate(blk.transactions):
                    if tx.hash() == tx_hash:
                        return tx, blk, i
        pending = self.txpool.get(tx_hash)
        if pending is not None:
            return pending, None, 0
        return None

    # --- fees -------------------------------------------------------------

    def suggest_gas_price(self) -> int:
        return self.gpo.suggest_price()

    def suggest_gas_tip_cap(self) -> int:
        return self.gpo.suggest_tip_cap()

    def fee_history(self, count, newest_tag, percentiles):
        return self.gpo.fee_history(count, newest_tag, percentiles)

    # --- call / estimate --------------------------------------------------

    def _call_msg(self, call_obj: dict, gas_default: int) -> Message:
        from_ = parse_addr(call_obj["from"]) if call_obj.get("from") else b"\x00" * 20
        to = parse_addr(call_obj["to"]) if call_obj.get("to") else None
        gas = parse_hex(call_obj["gas"]) if call_obj.get("gas") else gas_default
        gas_price = parse_hex(call_obj["gasPrice"]) if call_obj.get("gasPrice") else 0
        value = parse_hex(call_obj["value"]) if call_obj.get("value") else 0
        data = parse_bytes(call_obj.get("data") or call_obj.get("input") or "0x")
        return Message(
            from_=from_, to=to, gas_limit=gas, gas_price=gas_price,
            value=value, data=data, skip_account_checks=True,
        )

    def do_call(self, call_obj: dict, tag: str, wrap_state=None):
        """eth_call semantics. wrap_state: optional StateDB decorator
        (e.g. an access recorder) applied before execution — the ONE
        call-execution recipe shared by eth_call, callDetailed, and
        createAccessList."""
        view = self.chain.read_view()
        blk = self._block_in_view(view, tag)
        if blk is None:
            raise RPCError(-32000, "block not found")
        state = self.chain.state_at_view(view, blk.root)
        if wrap_state is not None:
            state = wrap_state(state)
        msg = self._call_msg(call_obj, blk.gas_limit)
        from ..core.state_processor import new_block_context

        evm = EVM(
            new_block_context(blk.header, self.chain),
            TxContext(origin=msg.from_, gas_price=msg.gas_price),
            state, self.chain_config, Config(no_base_fee=True),
        )
        return apply_message(evm, msg, GasPool(2**63)), msg, blk

    # --- keystore-backed signing (internal/ethapi/api.go:276-460) --------

    def require_keystore(self):
        return require_keystore(self.keystore)

    def fill_tx(self, obj: dict) -> Transaction:
        """setDefaults (internal/ethapi/transaction_args.go): nonce from
        the pool, fees from the oracle, gas from estimation."""
        if not obj.get("from"):
            raise RPCError(-32602, "missing 'from' address")
        from_ = parse_addr(obj["from"])
        to = parse_addr(obj["to"]) if obj.get("to") else None
        value = parse_hex(obj["value"]) if obj.get("value") else 0
        data = parse_bytes(obj.get("data") or obj.get("input") or "0x")
        nonce = (parse_hex(obj["nonce"]) if obj.get("nonce")
                 else self.txpool.nonce(from_))
        if obj.get("maxFeePerGas") or obj.get("maxPriorityFeePerGas"):
            tip = (parse_hex(obj["maxPriorityFeePerGas"])
                   if obj.get("maxPriorityFeePerGas")
                   else self.suggest_gas_tip_cap())
            if obj.get("maxFeePerGas"):
                max_fee = parse_hex(obj["maxFeePerGas"])
            else:
                # geth setDefaults: feeCap = 2*baseFee + tip, so the tx
                # survives base-fee growth and always covers the tip
                base = self.last_accepted_block().base_fee or 0
                max_fee = 2 * base + tip
            if max_fee < tip:
                raise RPCError(
                    -32602,
                    f"maxFeePerGas ({max_fee}) < maxPriorityFeePerGas "
                    f"({tip})")
            tx = Transaction(
                type=2, chain_id=self.chain_config.chain_id, nonce=nonce,
                max_fee=max_fee, max_priority_fee=tip, gas_price=max_fee,
                to=to, value=value, data=data,
            )
        else:
            gas_price = (parse_hex(obj["gasPrice"]) if obj.get("gasPrice")
                         else self.suggest_gas_price())
            tx = Transaction(
                type=0, chain_id=self.chain_config.chain_id, nonce=nonce,
                gas_price=gas_price, to=to, value=value, data=data,
            )
        if obj.get("gas"):
            tx.gas = parse_hex(obj["gas"])
        else:
            est = dict(obj)
            est.pop("nonce", None)  # estimation state is the latest block
            tx.gas = self.estimate_gas(est, "latest")
        return tx

    def sign_tx_with_keystore(self, obj: dict) -> Transaction:
        from ..accounts.keystore import KeyStoreError

        addr = parse_addr(obj["from"])
        # external-signer accounts route over the daemon's IPC; local
        # keystore accounts take precedence (both-known is operator
        # error and the local key is the cheaper, auditable path)
        ext = self.external_signer
        local = (self.keystore is not None
                 and any(a.address == addr
                         for a in self.keystore.accounts()))
        if ext is not None and not local:
            from ..accounts.external import ExternalSignerError

            try:
                if ext.contains(addr):
                    return ext.sign_tx(addr, self.fill_tx(obj),
                                       self.chain_config.chain_id)
            except ExternalSignerError as e:
                raise RPCError(-32000, f"external signer: {e}")
        ks = self.require_keystore()
        tx = self.fill_tx(obj)
        try:
            return ks.sign_tx(addr, tx, self.chain_config.chain_id)
        except KeyStoreError as e:
            raise RPCError(-32000, str(e))

    # --- merkle proofs (internal/ethapi/api.go:669 GetProof) -------------

    def walkable_state_trie(self, root: bytes):
        """A state trie at [root] with real Python nodes to walk
        (proofs, dumps, leaf iteration). Resident roots have none, so
        flush the changed account nodes to disk first (O(delta) export)
        and open the hashdb image like any historical root."""
        state_trie = self.chain.state_database.open_trie(root)
        if not getattr(state_trie, "resident", False):
            return state_trie
        from ..trie.resident_mirror import MirrorError

        mirror = self.chain.state_database.mirror
        try:
            key = mirror.key_for_root(root)
            if key is None:  # pruned between open_trie and here
                raise MirrorError("root left the resident window")
            # children-first like ResidentTrieWriter._export: flush
            # storage-trie nodes BEFORE the account batch that makes
            # has_state(root) true, else a crash right after this
            # call boots a root with missing storage subtrees (the
            # exact ordering _export's comment forbids)
            triedb = self.chain.state_database.triedb
            mirror.export_to(self.chain.diskdb, at_block=key,
                             pre_write=lambda: triedb.cap(0))
        except MirrorError as e:
            raise RPCError(-32000, f"state unavailable: {e}")
        return self.chain.state_database.triedb.open_state_trie(root)

    def get_proof(self, addr: bytes, storage_keys, tag: str) -> dict:
        from ..native import keccak256
        from ..state.account import Account
        from ..trie.proof import prove

        blk = self.block_by_tag(tag)
        if blk is None:
            raise RPCError(-32000, "block not found")
        state_trie = self.walkable_state_trie(blk.root)
        account_proof = prove(state_trie.trie, keccak256(addr))
        blob = state_trie.get(addr)
        acct = Account.decode(blob) if blob else Account()
        storage_proof = []
        if storage_keys:
            storage_trie = self.chain.state_database.open_storage_trie(
                keccak256(addr), acct.root)
            from .. import rlp

            for key in storage_keys:
                proof = prove(storage_trie.trie, keccak256(key))
                enc = storage_trie.get(key)
                val = rlp.decode(enc) if enc else b""
                storage_proof.append((key, val, proof))
        return {
            "account": acct,
            "account_proof": account_proof,
            "storage_proof": storage_proof,
        }

    def estimate_gas(self, call_obj: dict, tag: str) -> int:
        """Binary search over gas (internal/ethapi estimateGas)."""
        blk = self.block_by_tag(tag)
        if blk is None:
            raise RPCError(-32000, "block not found")
        hi = parse_hex(call_obj["gas"]) if call_obj.get("gas") else blk.gas_limit
        lo = params.TX_GAS - 1

        def executable(gas: int) -> bool:
            obj = dict(call_obj)
            obj["gas"] = hex(gas)
            try:
                res, _, _ = self.do_call(obj, tag)
            except RPCError:
                return False
            return res.err is None

        if not executable(hi):
            raise RPCError(-32000, "gas required exceeds allowance or always failing tx")
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if executable(mid):
                hi = mid
            else:
                lo = mid
        return hi
