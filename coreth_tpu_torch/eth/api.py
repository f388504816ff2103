"""The eth_* JSON-RPC namespace (semantics of coreth internal/ethapi/
api.go — BlockChainAPI/TransactionAPI — plus coreth's accepted-head
semantics and GetAssetBalance, api.go:643); counterpart of
coreth_tpu/eth/api.py. Keystore-backed methods answer the reference's
"keystore not configured" error on a node without a keystore.

All quantities are 0x-hex per the JSON-RPC spec; block tags accept
"latest"/"accepted"/"pending"/"earliest" or hex numbers.
"""

from __future__ import annotations

from typing import Optional

from .. import vmerrs
from ..core.types import Block, Signer, Transaction
from ..rpc.server import RPCError


def hx(v: int) -> str:
    return hex(v)


def hb(b: bytes) -> str:
    return "0x" + b.hex()


def parse_hex(v: str) -> int:
    return int(v, 16)


def parse_bytes(v: str) -> bytes:
    if v.startswith("0x"):
        v = v[2:]
    return bytes.fromhex(v)


def parse_addr(v: str) -> bytes:
    b = parse_bytes(v)
    if len(b) != 20:
        raise RPCError(-32602, f"invalid address length {len(b)}")
    return b


class EthAPI:
    """eth namespace. [backend] is the EthBackend facade."""

    def __init__(self, backend):
        self.b = backend

    # --- chain meta -------------------------------------------------------

    def chainId(self) -> str:
        return hx(self.b.chain_config.chain_id)

    def blockNumber(self) -> str:
        # coreth: the accepted (finalized) tip is the API head
        return hx(self.b.last_accepted_block().number)

    def syncing(self):
        return False

    def gasPrice(self) -> str:
        return hx(self.b.suggest_gas_price())

    def maxPriorityFeePerGas(self) -> str:
        return hx(self.b.suggest_gas_tip_cap())

    def feeHistory(self, block_count, newest_block="latest", reward_percentiles=None):
        count = block_count if isinstance(block_count, int) else parse_hex(block_count)
        return self.b.fee_history(count, newest_block, reward_percentiles or [])

    # --- state reads ------------------------------------------------------

    def getBalance(self, address: str, block: str = "latest") -> str:
        state = self.b.state_at_tag(block)
        return hx(state.get_balance(parse_addr(address)))

    def getAssetBalance(self, address: str, block: str, asset_id: str) -> str:
        """coreth-only (api.go:643): multicoin balance."""
        state = self.b.state_at_tag(block)
        return hx(
            state.get_balance_multicoin(parse_addr(address), parse_bytes(asset_id))
        )

    def getTransactionCount(self, address: str, block: str = "latest") -> str:
        if block == "pending":
            return hx(self.b.txpool.nonce(parse_addr(address)))
        state = self.b.state_at_tag(block)
        return hx(state.get_nonce(parse_addr(address)))

    def getCode(self, address: str, block: str = "latest") -> str:
        state = self.b.state_at_tag(block)
        return hb(state.get_code(parse_addr(address)))

    def getStorageAt(self, address: str, slot: str, block: str = "latest") -> str:
        state = self.b.state_at_tag(block)
        key = parse_hex(slot).to_bytes(32, "big")
        return hb(state.get_state(parse_addr(address), key))

    # --- blocks -----------------------------------------------------------

    def getBlockByNumber(self, block: str, full_txs: bool = False):
        blk = self.b.block_by_tag(block)
        return None if blk is None else self._marshal_block(blk, full_txs)

    def getBlockByHash(self, block_hash: str, full_txs: bool = False):
        blk = self.b.chain.get_block(parse_bytes(block_hash))
        return None if blk is None else self._marshal_block(blk, full_txs)

    def getBlockTransactionCountByNumber(self, block: str):
        blk = self.b.block_by_tag(block)
        return None if blk is None else hx(len(blk.transactions))

    def getBlockTransactionCountByHash(self, block_hash: str):
        blk = self.b.chain.get_block(parse_bytes(block_hash))
        return None if blk is None else hx(len(blk.transactions))

    def getHeaderByNumber(self, block: str):
        """eth_getHeaderByNumber (api.go GetHeaderByNumber): the block
        marshaling minus the tx list."""
        blk = self.b.block_by_tag(block)
        if blk is None:
            return None
        out = self._marshal_block(blk, False)
        out.pop("transactions", None)
        return out

    def getHeaderByHash(self, block_hash: str):
        blk = self.b.chain.get_block(parse_bytes(block_hash))
        if blk is None:
            return None
        out = self._marshal_block(blk, False)
        out.pop("transactions", None)
        return out

    def coinbase(self):
        """eth_coinbase (eth/api.go Coinbase/Etherbase): the address
        blocks credit fees to — the blackhole under Avalanche's fee
        burn."""
        from ..miner.worker import BLACKHOLE_ADDR

        return hb(BLACKHOLE_ADDR)

    def etherbase(self):
        return self.coinbase()

    def baseFee(self):
        """eth_baseFee (coreth-only, api.go BaseFee): the last accepted
        block's base fee."""
        fee = self.b.last_accepted_block().base_fee
        return hx(fee) if fee is not None else None

    # --- uncles: Avalanche consensus has none (api.go returns empty) -----

    def getUncleCountByBlockNumber(self, block: str):
        blk = self.b.block_by_tag(block)
        return None if blk is None else hx(0)

    def getUncleCountByBlockHash(self, block_hash: str):
        blk = self.b.chain.get_block(parse_bytes(block_hash))
        return None if blk is None else hx(0)

    def getUncleByBlockNumberAndIndex(self, block: str, index: str):
        return None

    def getUncleByBlockHashAndIndex(self, block_hash: str, index: str):
        return None

    def _marshal_block(self, blk: Block, full_txs: bool) -> dict:
        h = blk.header
        out = {
            "number": hx(h.number),
            "hash": hb(blk.hash()),
            "parentHash": hb(h.parent_hash),
            "nonce": hb(h.nonce),
            "sha3Uncles": hb(h.uncle_hash),
            "logsBloom": hb(h.bloom),
            "transactionsRoot": hb(h.tx_hash),
            "stateRoot": hb(h.root),
            "receiptsRoot": hb(h.receipt_hash),
            "miner": hb(h.coinbase),
            "difficulty": hx(h.difficulty),
            "extraData": hb(h.extra),
            "size": hx(len(blk.encode())),
            "gasLimit": hx(h.gas_limit),
            "gasUsed": hx(h.gas_used),
            "timestamp": hx(h.time),
            "mixHash": hb(h.mix_digest),
            "extDataHash": hb(h.ext_data_hash),
            "uncles": [],
        }
        if h.base_fee is not None:
            out["baseFeePerGas"] = hx(h.base_fee)
        if h.ext_data_gas_used is not None:
            out["extDataGasUsed"] = hx(h.ext_data_gas_used)
        if h.block_gas_cost is not None:
            out["blockGasCost"] = hx(h.block_gas_cost)
        if full_txs:
            out["transactions"] = [
                self._marshal_tx(t, blk, i) for i, t in enumerate(blk.transactions)
            ]
        else:
            out["transactions"] = [hb(t.hash()) for t in blk.transactions]
        return out

    # --- transactions -----------------------------------------------------

    def sendRawTransaction(self, raw: str) -> str:
        tx = Transaction.decode(parse_bytes(raw))
        self.b.send_tx(tx)
        return hb(tx.hash())

    def getTransactionByHash(self, tx_hash: str):
        found = self.b.tx_by_hash(parse_bytes(tx_hash))
        if found is None:
            return None
        tx, blk, index = found
        return self._marshal_tx(tx, blk, index)

    @staticmethod
    def _tx_in_block(blk, index: str):
        """Bounds-safe tx lookup: None for a missing block OR any
        out-of-range index (incl. negative — Python indexing must not
        leak through; geth returns null)."""
        if blk is None:
            return None, 0
        i = parse_hex(index)
        if not 0 <= i < len(blk.transactions):
            return None, 0
        return blk.transactions[i], i

    def _tx_at(self, blk, index: str):
        tx, i = self._tx_in_block(blk, index)
        return None if tx is None else self._marshal_tx(tx, blk, i)

    def getTransactionByBlockNumberAndIndex(self, block: str, index: str):
        return self._tx_at(self.b.block_by_tag(block), index)

    def getTransactionByBlockHashAndIndex(self, block_hash: str,
                                          index: str):
        return self._tx_at(self.b.chain.get_block(parse_bytes(block_hash)),
                           index)

    # --- raw (RLP) transaction access (api.go GetRawTransaction*) --------

    def getRawTransactionByHash(self, tx_hash: str):
        found = self.b.tx_by_hash(parse_bytes(tx_hash))
        return None if found is None else hb(found[0].encode())

    def getRawTransactionByBlockNumberAndIndex(self, block: str,
                                               index: str):
        tx, _ = self._tx_in_block(self.b.block_by_tag(block), index)
        return None if tx is None else hb(tx.encode())

    def getRawTransactionByBlockHashAndIndex(self, block_hash: str,
                                             index: str):
        tx, _ = self._tx_in_block(
            self.b.chain.get_block(parse_bytes(block_hash)), index)
        return None if tx is None else hb(tx.encode())

    def getTransactionReceipt(self, tx_hash: str):
        found = self.b.tx_by_hash(parse_bytes(tx_hash))
        if found is None or found[1] is None:
            return None
        tx, blk, index = found
        receipts = self.b.chain.get_receipts(blk.hash()) or []
        if index >= len(receipts):
            return None
        r = receipts[index]
        sender = Signer(self.b.chain_config.chain_id).sender(tx)
        out = {
            "transactionHash": hb(tx.hash()),
            "transactionIndex": hx(index),
            "blockHash": hb(blk.hash()),
            "blockNumber": hx(blk.number),
            "from": hb(sender),
            "to": hb(tx.to) if tx.to else None,
            "cumulativeGasUsed": hx(r.cumulative_gas_used),
            "gasUsed": hx(r.gas_used),
            "effectiveGasPrice": hx(tx.effective_gas_price(blk.base_fee)),
            "contractAddress": hb(r.contract_address) if r.contract_address else None,
            "logs": [self._marshal_log(l, i) for i, l in enumerate(r.logs)],
            "logsBloom": hb(r.bloom),
            "status": hx(r.status),
            "type": hx(tx.type),
        }
        return out

    def _marshal_tx(self, tx: Transaction, blk: Optional[Block], index: int) -> dict:
        sender = Signer(self.b.chain_config.chain_id).sender(tx)
        out = {
            "hash": hb(tx.hash()),
            "nonce": hx(tx.nonce),
            "from": hb(sender),
            "to": hb(tx.to) if tx.to else None,
            "value": hx(tx.value),
            "gas": hx(tx.gas),
            "gasPrice": hx(tx.effective_gas_price(blk.base_fee if blk else None)),
            "input": hb(tx.data),
            "type": hx(tx.type),
            "v": hx(tx.v),
            "r": hx(tx.r),
            "s": hx(tx.s),
        }
        if tx.type == 2:
            out["maxFeePerGas"] = hx(tx.max_fee)
            out["maxPriorityFeePerGas"] = hx(tx.max_priority_fee)
        if blk is not None:
            out["blockHash"] = hb(blk.hash())
            out["blockNumber"] = hx(blk.number)
            out["transactionIndex"] = hx(index)
        return out

    def _marshal_log(self, l, i: int) -> dict:
        return {
            "address": hb(l.address),
            "topics": [hb(t) for t in l.topics],
            "data": hb(l.data),
            "blockNumber": hx(l.block_number),
            "transactionHash": hb(l.tx_hash),
            "transactionIndex": hx(l.tx_index),
            "blockHash": hb(l.block_hash),
            "logIndex": hx(getattr(l, "index", i)),
            "removed": False,
        }

    # --- execution --------------------------------------------------------

    def call(self, call_obj: dict, block: str = "latest") -> str:
        result, _, _ = self.b.do_call(call_obj, block)
        if result.err is not None:
            if vmerrs.is_revert(result.err):
                raise RPCError(3, "execution reverted", hb(result.return_data))
            raise RPCError(-32000, f"execution failed: {result.err}")
        return hb(result.return_data)

    def estimateGas(self, call_obj: dict, block: str = "latest") -> str:
        return hx(self.b.estimate_gas(call_obj, block))

    def callDetailed(self, call_obj: dict, block: str = "latest") -> dict:
        """eth_callDetailed (coreth-only, api.go:1112 CallDetailed):
        like call but returns gas used and the error message instead of
        failing the RPC."""
        result, _, _ = self.b.do_call(call_obj, block)
        out = {"returnData": hb(result.return_data),
               "usedGas": hx(result.used_gas)}
        if result.err is not None:
            out["errorMessage"] = str(result.err)
        return out

    def createAccessList(self, call_obj: dict,
                         block: str = "latest") -> dict:
        """eth_createAccessList (api.go CreateAccessList): execute the
        call recording every touched (account, slot) outside the
        sender/recipient/precompiles and return it as an EIP-2930
        access list plus the plain call's gas. Single recording pass
        (the reference iterates to a fixpoint because using the list
        changes warm/cold gas; the touched-set is a valid list either
        way)."""
        from .tracers import PrestateTracer

        recorder = PrestateTracer()
        result, msg, blk = self.b.do_call(call_obj, block,
                                          wrap_state=recorder.wrap)
        # sender, recipient (or the derived CREATE address), the
        # active precompile set, and the COINBASE (touched by the fee
        # payout, not by the call) never belong in the list (geth's
        # AccessListTracer exclusion)
        to = msg.to
        if to is None:
            from ..core.types import create_address

            to = create_address(
                msg.from_,
                self.b.state_at_root(blk.root).get_nonce(msg.from_))
        exclude = {msg.from_, to, blk.header.coinbase}
        from ..evm.precompiles import active_precompiles

        rules = self.b.chain_config.rules(blk.header.number,
                                          blk.header.time)
        exclude |= set(active_precompiles(rules).keys())
        access = []
        for addr, acct in recorder.accounts.items():
            if addr in exclude:
                continue
            access.append({
                "address": hb(addr),
                "storageKeys": [hb(k.rjust(32, b"\x00"))
                                for k in acct["storage"]],
            })
        out = {"accessList": access, "gasUsed": hx(result.used_gas)}
        if result.err is not None:
            out["error"] = str(result.err)
        return out

    def fillTransaction(self, tx_obj: dict) -> dict:
        """eth_fillTransaction (api.go FillTransaction): apply
        setDefaults (nonce/fees/gas) and return the UNSIGNED tx
        (marshaled by hand — _marshal_tx recovers a sender the
        unsigned payload does not have)."""
        tx = self.b.fill_tx(tx_obj)
        out = {
            "type": hx(tx.type),
            "nonce": hx(tx.nonce),
            "gas": hx(tx.gas),
            "to": hb(tx.to) if tx.to else None,
            "value": hx(tx.value),
            "input": hb(tx.data or b""),
            "chainId": hx(tx.chain_id),
        }
        if tx.type in (0, 1):
            out["gasPrice"] = hx(tx.gas_price)
        else:
            out["maxFeePerGas"] = hx(tx.max_fee)
            out["maxPriorityFeePerGas"] = hx(tx.max_priority_fee)
        return {"raw": hb(tx.encode()), "tx": out}

    def pendingTransactions(self) -> list:
        """eth_pendingTransactions (api.go PendingTransactions): pool
        txs whose sender the node can sign for."""
        mine = {a.address for a in (self.b.keystore.accounts()
                                    if self.b.keystore else [])}
        ext = getattr(self.b, "external_signer", None)
        if ext is not None:
            try:
                mine |= set(ext.accounts())
            except Exception:
                # daemon down: the keystore set still filters, but the
                # degradation is countable (same signal as the manager)
                from ..metrics import count_drop

                count_drop("accounts/external/list_error")
        out = []
        for addr, txs in self.b.txpool.pending_txs().items():
            if addr in mine:
                out.extend(self._marshal_tx(t, None, 0) for t in txs)
        return out

    def resend(self, tx_obj: dict, gas_price: str = None,
               gas_limit: str = None) -> str:
        """eth_resend (api.go Resend): re-sign the (from, nonce) pending
        tx with new fees and replace it in the pool."""
        if not tx_obj.get("nonce"):
            raise RPCError(-32602, "nonce required for resend")
        from_ = parse_addr(tx_obj["from"]) if tx_obj.get("from") else None
        nonce = parse_hex(tx_obj["nonce"])
        pending = self.b.txpool.pending_txs().get(from_, [])
        if not any(t.nonce == nonce for t in pending):
            # the reference's Resend errors for a tx that is not in the
            # pool (already mined / never sent) instead of minting a
            # brand-new transaction the caller never intended
            raise RPCError(-32000,
                           f"transaction (nonce {nonce}) not found in "
                           "the pool")
        obj = dict(tx_obj)
        if gas_price:
            obj["gasPrice"] = gas_price
            obj.pop("maxFeePerGas", None)
            obj.pop("maxPriorityFeePerGas", None)
        if gas_limit:
            obj["gas"] = gas_limit
        tx = self.b.sign_tx_with_keystore(obj)
        self.b.send_tx(tx)  # same (from, nonce): pool price-bump replace
        return hb(tx.hash())

    def getLogs(self, filter_obj: dict) -> list:
        logs = self.b.filters.get_logs(filter_obj)
        return [self._marshal_log(l, i) for i, l in enumerate(logs)]

    # --- keystore-backed accounts (internal/ethapi/api.go:276-460) -------

    def accounts(self) -> list:
        """eth_accounts: addresses the node can sign for — the local
        keystore plus the external signer daemon's list (clef role)."""
        out = []
        ext = getattr(self.b, "external_signer", None)
        if ext is not None:
            try:
                out = [hb(a) for a in ext.accounts()]
            except Exception:
                # daemon down: keystore accounts still serve (same
                # countable signal as pendingTransactions)
                from ..metrics import count_drop

                count_drop("accounts/external/list_error")
                out = []
        if self.b.keystore is None:
            return out
        seen = set(out)
        return out + [hb(a.address) for a in self.b.keystore.accounts()
                      if hb(a.address) not in seen]

    def sign(self, address: str, data: str) -> str:
        """eth_sign: personal-message signature by an UNLOCKED account
        (api.go:444: the \\x19Ethereum Signed Message prefix guards
        against signing raw txs)."""
        from ..accounts.keystore import KeyStoreError

        ks = self.b.require_keystore()
        msg = parse_bytes(data)
        try:
            sig = ks.sign_hash(parse_addr(address), _personal_hash(msg))
        except KeyStoreError as e:
            raise RPCError(-32000, str(e))
        return hb(sig[:64] + bytes([sig[64] + 27]))

    def signTransaction(self, tx_obj: dict) -> dict:
        """eth_signTransaction: fill defaults, sign with the unlocked
        keystore account, return the raw RLP without submitting."""
        tx = self.b.sign_tx_with_keystore(tx_obj)
        return {"raw": hb(tx.encode()), "tx": self._marshal_tx(tx, None, 0)}

    def sendTransaction(self, tx_obj: dict) -> str:
        """eth_sendTransaction: sign with the unlocked keystore account
        and submit to the pool (api.go:276 SendTransaction)."""
        tx = self.b.sign_tx_with_keystore(tx_obj)
        self.b.send_tx(tx)
        return hb(tx.hash())

    def getProof(self, address: str, storage_keys: list,
                 block: str = "latest") -> dict:
        """eth_getProof (api.go:669): merkle proofs of an account and a
        set of its storage slots against the block's state root."""
        addr = parse_addr(address)
        keys = [parse_hex(k).to_bytes(32, "big") for k in storage_keys or []]
        res = self.b.get_proof(addr, keys, block)
        acct = res["account"]
        return {
            "address": hb(addr),
            "accountProof": [hb(n) for n in res["account_proof"]],
            "balance": hx(acct.balance),
            "codeHash": hb(acct.code_hash),
            "nonce": hx(acct.nonce),
            "storageHash": hb(acct.root),
            "storageProof": [
                {
                    "key": hb(key),
                    "value": hx(int.from_bytes(val, "big") if val else 0),
                    "proof": [hb(n) for n in proof],
                }
                for key, val, proof in res["storage_proof"]
            ],
        }


def _personal_hash(msg: bytes) -> bytes:
    """accounts.TextHash: keccak over the EIP-191 personal-message
    envelope."""
    from ..native import keccak256

    return keccak256(
        b"\x19Ethereum Signed Message:\n" + str(len(msg)).encode() + msg)


class PersonalAPI:
    """personal_* namespace (internal/ethapi/api.go:210-520): keystore
    lifecycle + passphrase-scoped signing."""

    def __init__(self, backend):
        self.b = backend

    def listAccounts(self) -> list:
        return EthAPI(self.b).accounts()

    def newAccount(self, password: str) -> str:
        ks = self.b.require_keystore()
        return hb(ks.new_account(password).address)

    def importRawKey(self, priv_hex: str, password: str) -> str:
        ks = self.b.require_keystore()
        priv = parse_bytes(priv_hex)
        if len(priv) != 32:
            raise RPCError(-32602, "private key must be 32 bytes")
        return hb(ks.import_key(priv, password).address)

    def unlockAccount(self, address: str, password: str,
                      duration=None) -> bool:
        """geth semantics (api.go UnlockAccount): duration omitted ->
        300 s auto-relock; explicit 0 -> unlocked until lockAccount."""
        from ..accounts.keystore import KeyStoreError

        if duration is None:
            timeout = 300.0
        elif duration == 0:
            timeout = None
        else:
            timeout = float(duration)
        ks = self.b.require_keystore()
        try:
            ks.unlock(parse_addr(address), password, timeout=timeout)
        except KeyStoreError as e:
            raise RPCError(-32000, str(e))
        return True

    def lockAccount(self, address: str) -> bool:
        self.b.require_keystore().lock_account(parse_addr(address))
        return True

    def sign(self, data: str, address: str, password: str) -> str:
        from ..accounts.keystore import KeyStoreError

        ks = self.b.require_keystore()
        try:
            sig = ks.sign_hash_with_passphrase(
                parse_addr(address), password, _personal_hash(parse_bytes(data)))
        except KeyStoreError as e:
            raise RPCError(-32000, str(e))
        return hb(sig[:64] + bytes([sig[64] + 27]))

    def ecRecover(self, data: str, sig_hex: str) -> str:
        from ..crypto.secp256k1 import recover_address

        sig = parse_bytes(sig_hex)
        if len(sig) != 65:
            raise RPCError(-32602, "signature must be 65 bytes")
        v = sig[64]
        if v >= 27:
            v -= 27
        addr = recover_address(
            _personal_hash(parse_bytes(data)), v,
            int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:64], "big"))
        if addr is None:
            raise RPCError(-32000, "invalid signature")
        return hb(addr)

    def sendTransaction(self, tx_obj: dict, password: str) -> str:
        """personal_sendTransaction: sign with the passphrase (no prior
        unlock needed) and submit."""
        from ..accounts.keystore import KeyStoreError
        from ..core.types import Signer

        ks = self.b.require_keystore()
        tx = self.b.fill_tx(tx_obj)
        addr = parse_addr(tx_obj["from"])
        try:
            priv = ks.export_key(addr, password)
        except KeyStoreError as e:
            raise RPCError(-32000, str(e))
        tx = Signer(self.b.chain_config.chain_id).sign(tx, priv)
        self.b.send_tx(tx)
        return hb(tx.hash())
