"""Atomic transactions: the UTXO ↔ EVM-account bridge (semantics of
coreth plugin/evm/{tx,import_tx,export_tx,codec}.go); counterpart of
coreth_tpu/vm/atomic_tx.py.

ImportTx consumes UTXOs from a peer chain's shared memory and credits EVM
accounts; ExportTx debits EVM accounts (nonce-checked EVMInputs) and
produces UTXOs for the peer chain. Fees follow coreth's dynamic
model: gasUsed = bytes + per-signature cost (+10k fixed post-AP5), burned
AVAX (nAVAX, 9 decimals) must cover gasUsed*baseFee/1e9 (tx.go:150-259).

Serialization is a versioned RLP envelope (this framework's linear codec);
credentials are 65-byte recoverable secp256k1 signatures over the keccak
of the unsigned bytes, recovered to addresses like secp256k1fx. Recovery
runs on the native secp256k1 (native/secp.py), whose failed build raises;
the reference recovers in pure Python (crypto.secp256k1.recover_address,
the port's oracle). Signing stays the pure-Python signer, as there.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .. import params, rlp
from ..crypto.secp256k1 import sign
from ..native import keccak256, secp
from .shared_memory import Element, Requests

CODEC_VERSION = 0
TX_BYTES_GAS = 1
# EVMOutput: 20B addr + 8B amount + 32B assetID; EVMInput adds 8B nonce + sig
EVM_OUTPUT_GAS = (20 + 8 + 32) * TX_BYTES_GAS
EVM_INPUT_GAS = (20 + 8 + 32 + 8) * TX_BYTES_GAS + 1000  # + per-sig cost
X2C_RATE = 10**9  # nAVAX (9 decimals) -> wei (18 decimals)

TYPE_IMPORT = 0
TYPE_EXPORT = 1


class AtomicTxError(Exception):
    pass


# params.AvalancheAtomicTxFee: the AP2 fixed atomic tx fee (1 milliAVAX)
AVALANCHE_ATOMIC_TX_FEE = 1_000_000  # nAVAX


def _flow_check(consumed: Dict[bytes, int], produced: Dict[bytes, int]) -> None:
    """avax.FlowChecker: every asset must consume >= produce (incl. fee)."""
    for asset, amount in produced.items():
        if consumed.get(asset, 0) < amount:
            raise AtomicTxError(
                f"flow check failed: asset {asset.hex()[:8]} consumes "
                f"{consumed.get(asset, 0)} < produces {amount}"
            )


def _required_fee(rules, tx: "Tx", base_fee: Optional[int]) -> int:
    """Per-fork atomic fee (import_tx.go:192-210): dynamic from AP3,
    fixed 1 mAVAX from AP2, free before."""
    if rules.is_apricot_phase3:
        if base_fee is None:
            raise AtomicTxError("base fee required post-AP3")
        return calculate_dynamic_fee(tx.gas_used(rules.is_apricot_phase5), base_fee)
    if rules.is_apricot_phase2:
        return AVALANCHE_ATOMIC_TX_FEE
    return 0


@dataclass
class UTXO:
    tx_id: bytes          # 32B source tx
    output_index: int
    asset_id: bytes       # 32B
    amount: int           # nAVAX
    address: bytes        # 20B owner (single-sig secp owner)
    locktime: int = 0
    threshold: int = 1

    def utxo_id(self) -> bytes:
        return keccak256(self.tx_id + self.output_index.to_bytes(4, "big"))

    def encode(self) -> bytes:
        return rlp.encode([
            self.tx_id, self.output_index, self.asset_id, self.amount,
            self.address, self.locktime, self.threshold,
        ])

    @classmethod
    def decode(cls, blob: bytes) -> "UTXO":
        i = rlp.decode(blob)
        return cls(i[0], _u(i[1]), i[2], _u(i[3]), i[4], _u(i[5]), _u(i[6]))


def _u(b) -> int:
    return int.from_bytes(b, "big") if isinstance(b, bytes) else b


@dataclass
class EVMInput:
    """Debit from an EVM account (export source) — nonce-checked."""

    address: bytes
    amount: int          # nAVAX
    asset_id: bytes
    nonce: int

    def items(self):
        return [self.address, self.amount, self.asset_id, self.nonce]


@dataclass
class EVMOutput:
    """Credit to an EVM account (import destination)."""

    address: bytes
    amount: int          # nAVAX
    asset_id: bytes

    def items(self):
        return [self.address, self.amount, self.asset_id]


@dataclass
class ImportTx:
    network_id: int
    blockchain_id: bytes
    source_chain: bytes
    imported_inputs: List[UTXO] = field(default_factory=list)
    outs: List[EVMOutput] = field(default_factory=list)

    type_id = TYPE_IMPORT

    def unsigned_items(self):
        return [
            TYPE_IMPORT, self.network_id, self.blockchain_id, self.source_chain,
            [u.encode() for u in self.imported_inputs],
            [o.items() for o in self.outs],
        ]

    def input_utxos(self) -> List[bytes]:
        return [u.utxo_id() for u in self.imported_inputs]

    def burned(self, asset_id: bytes) -> int:
        consumed = sum(u.amount for u in self.imported_inputs if u.asset_id == asset_id)
        produced = sum(o.amount for o in self.outs if o.asset_id == asset_id)
        return consumed - produced

    def gas_used(self, fixed_fee: bool, byte_len: int, n_sigs: int) -> int:
        gas = byte_len * TX_BYTES_GAS + n_sigs * 1000
        if fixed_fee:
            gas += params.ATOMIC_TX_BASE_COST
        return gas

    # --- verify + state transfer (import_tx.go:181-460) -------------------

    def verify(self, vm) -> None:
        if self.network_id != vm.network_id:
            raise AtomicTxError(
                f"wrong network id {self.network_id} != {vm.network_id}"
            )
        if self.blockchain_id != vm.chain_id_bytes:
            raise AtomicTxError("wrong blockchain id")
        if self.source_chain == vm.chain_id_bytes:
            raise AtomicTxError("cannot import from self")
        if not self.imported_inputs:
            raise AtomicTxError("import has no inputs")
        if any(o.amount == 0 for o in self.outs):
            raise AtomicTxError("zero-value output")
        ids = [u.utxo_id() for u in self.imported_inputs]
        if len(set(ids)) != len(ids):
            raise AtomicTxError("duplicate UTXO consumed")

    def semantic_verify(self, vm, tx: "Tx", base_fee: Optional[int]) -> None:
        self.verify(vm)
        # flow check on every fork (import_tx.go:192-220): consumed must
        # cover produced + the per-fork fee — otherwise imports mint value
        rules = vm.current_rules()
        consumed: Dict[bytes, int] = {}
        produced: Dict[bytes, int] = {}
        for u in self.imported_inputs:
            consumed[u.asset_id] = consumed.get(u.asset_id, 0) + u.amount
        for o in self.outs:
            produced[o.asset_id] = produced.get(o.asset_id, 0) + o.amount
        produced[vm.avax_asset_id] = (
            produced.get(vm.avax_asset_id, 0) + _required_fee(rules, tx, base_fee)
        )
        _flow_check(consumed, produced)
        # UTXOs must exist in shared memory with matching owners + sigs
        utxo_bytes = vm.shared_memory.get(self.source_chain, self.input_utxos())
        for i, (u, stored) in enumerate(zip(self.imported_inputs, utxo_bytes)):
            stored_utxo = UTXO.decode(stored)
            if stored_utxo.amount != u.amount or stored_utxo.asset_id != u.asset_id:
                raise AtomicTxError("UTXO mismatch vs shared memory")
            signer = tx.credential_address(i)
            if signer != stored_utxo.address:
                raise AtomicTxError("invalid UTXO signature")

    def evm_state_transfer(self, vm, state) -> None:
        """Credit outputs (import_tx.go:434): AVAX in wei, others multicoin."""
        for out in self.outs:
            if out.asset_id == vm.avax_asset_id:
                state.add_balance(out.address, out.amount * X2C_RATE)
            else:
                state.add_balance_multicoin(out.address, out.asset_id, out.amount)

    def atomic_ops(self) -> Tuple[bytes, Requests]:
        """Consume the imported UTXOs from [source_chain]'s namespace."""
        return self.source_chain, Requests(remove_requests=self.input_utxos())


@dataclass
class ExportTx:
    network_id: int
    blockchain_id: bytes
    destination_chain: bytes
    ins: List[EVMInput] = field(default_factory=list)
    exported_outputs: List[UTXO] = field(default_factory=list)

    type_id = TYPE_EXPORT

    def unsigned_items(self):
        return [
            TYPE_EXPORT, self.network_id, self.blockchain_id, self.destination_chain,
            [i.items() for i in self.ins],
            [u.encode() for u in self.exported_outputs],
        ]

    def input_utxos(self) -> List[bytes]:
        return []

    def burned(self, asset_id: bytes) -> int:
        consumed = sum(i.amount for i in self.ins if i.asset_id == asset_id)
        produced = sum(
            u.amount for u in self.exported_outputs if u.asset_id == asset_id
        )
        return consumed - produced

    def gas_used(self, fixed_fee: bool, byte_len: int, n_sigs: int) -> int:
        gas = byte_len * TX_BYTES_GAS + n_sigs * 1000
        if fixed_fee:
            gas += params.ATOMIC_TX_BASE_COST
        return gas

    def verify(self, vm) -> None:
        if self.network_id != vm.network_id:
            raise AtomicTxError(
                f"wrong network id {self.network_id} != {vm.network_id}"
            )
        if self.blockchain_id != vm.chain_id_bytes:
            raise AtomicTxError("wrong blockchain id")
        if self.destination_chain == vm.chain_id_bytes:
            raise AtomicTxError("cannot export to self")
        if not self.ins:
            raise AtomicTxError("export has no inputs")
        if any(u.amount == 0 for u in self.exported_outputs):
            raise AtomicTxError("zero-value exported output")

    def semantic_verify(self, vm, tx: "Tx", base_fee: Optional[int]) -> None:
        self.verify(vm)
        # flow check on every fork (export_tx.go SemanticVerify)
        rules = vm.current_rules()
        consumed: Dict[bytes, int] = {}
        produced: Dict[bytes, int] = {}
        for i in self.ins:
            consumed[i.asset_id] = consumed.get(i.asset_id, 0) + i.amount
        for u in self.exported_outputs:
            produced[u.asset_id] = produced.get(u.asset_id, 0) + u.amount
        produced[vm.avax_asset_id] = (
            produced.get(vm.avax_asset_id, 0) + _required_fee(rules, tx, base_fee)
        )
        _flow_check(consumed, produced)
        # each input must be signed by its account holder
        for i, inp in enumerate(self.ins):
            if tx.credential_address(i) != inp.address:
                raise AtomicTxError("export input signature mismatch")

    def evm_state_transfer(self, vm, state) -> None:
        """Debit inputs with nonce check (export_tx.go:372-401). Multiple
        inputs from one address carry the SAME nonce (e.g. asset + AVAX
        fee); the nonce bumps once per address after all checks, exactly
        as coreth's addrs map does (export_tx.go:393-400)."""
        addr_nonce: Dict[bytes, int] = {}
        for inp in self.ins:
            if inp.asset_id == vm.avax_asset_id:
                amount_wei = inp.amount * X2C_RATE
                if state.get_balance(inp.address) < amount_wei:
                    raise AtomicTxError("insufficient balance for export")
                state.sub_balance(inp.address, amount_wei)
            else:
                if state.get_balance_multicoin(inp.address, inp.asset_id) < inp.amount:
                    raise AtomicTxError("insufficient multicoin balance for export")
                state.sub_balance_multicoin(inp.address, inp.asset_id, inp.amount)
            if state.get_nonce(inp.address) != inp.nonce:
                raise AtomicTxError(
                    f"invalid export nonce: state {state.get_nonce(inp.address)} != tx {inp.nonce}"
                )
            addr_nonce[inp.address] = inp.nonce
        for addr, nonce in addr_nonce.items():
            state.set_nonce(addr, nonce + 1)

    def atomic_ops(self) -> Tuple[bytes, Requests]:
        """Produce UTXOs into [destination_chain]'s namespace."""
        puts = [
            Element(
                key=u.utxo_id(),
                value=u.encode(),
                traits=[u.address],
            )
            for u in self.exported_outputs
        ]
        return self.destination_chain, Requests(put_requests=puts)


class Tx:
    """Signed atomic tx envelope (tx.go Tx: UnsignedAtomicTx + Creds)."""

    def __init__(self, unsigned, creds: Optional[List[bytes]] = None):
        self.unsigned = unsigned
        self.creds: List[bytes] = creds or []  # 65-byte r||s||v signatures
        self._unsigned_bytes: Optional[bytes] = None
        self._signed_bytes: Optional[bytes] = None

    def unsigned_bytes(self) -> bytes:
        if self._unsigned_bytes is None:
            self._unsigned_bytes = rlp.encode(
                [CODEC_VERSION] + self.unsigned.unsigned_items()
            )
        return self._unsigned_bytes

    def encode(self) -> bytes:
        if self._signed_bytes is None:
            self._signed_bytes = rlp.encode(
                [CODEC_VERSION] + self.unsigned.unsigned_items() + [list(self.creds)]
            )
        return self._signed_bytes

    def id(self) -> bytes:
        return keccak256(self.encode())

    def sign(self, keys: List[bytes]) -> None:
        """One recoverable signature per input, over keccak(unsigned)."""
        h = keccak256(self.unsigned_bytes())
        self.creds = []
        for key in keys:
            v, r, s = sign(h, key)
            self.creds.append(r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v]))
        self._signed_bytes = None

    def credential_address(self, i: int) -> Optional[bytes]:
        if i >= len(self.creds):
            raise AtomicTxError("missing credential")
        sig = self.creds[i]
        h = keccak256(self.unsigned_bytes())
        return secp.recover_one(
            h, sig[64], int.from_bytes(sig[:32], "big"), int.from_bytes(sig[32:64], "big")
        )

    def gas_used(self, fixed_fee: bool) -> int:
        return self.unsigned.gas_used(
            fixed_fee, len(self.encode()), len(self.creds)
        )

    def burned(self, asset_id: bytes) -> int:
        return self.unsigned.burned(asset_id)

    def block_fee_contribution(self, fixed_fee: bool, avax_asset_id: bytes,
                               base_fee: int) -> Tuple[int, int]:
        """(contribution in wei, gasUsed) — tx.go:185-215."""
        if base_fee is None or base_fee <= 0:
            raise AtomicTxError(f"invalid base fee {base_fee}")
        gas = self.gas_used(fixed_fee)
        fee = calculate_dynamic_fee(gas, base_fee)
        burned = self.burned(avax_asset_id)
        if fee > burned:
            raise AtomicTxError(f"insufficient AVAX burned ({burned}) to cover fee ({fee})")
        return (burned - fee) * X2C_RATE, gas

    def semantic_verify(self, vm, base_fee) -> None:
        self.unsigned.semantic_verify(vm, self, base_fee)

    def evm_state_transfer(self, vm, state) -> None:
        self.unsigned.evm_state_transfer(vm, state)

    def atomic_ops(self) -> Tuple[bytes, Requests]:
        return self.unsigned.atomic_ops()

    def input_utxos(self) -> List[bytes]:
        return self.unsigned.input_utxos()


def calculate_dynamic_fee(gas: int, base_fee: int) -> int:
    """CalculateDynamicFee (tx.go:243-257): wei fee → nAVAX, rounded up."""
    return (gas * base_fee + X2C_RATE - 1) // X2C_RATE


# --- codec ----------------------------------------------------------------


def decode_tx(blob: bytes) -> Tx:
    items = rlp.decode(blob)
    version = _u(items[0])
    if version != CODEC_VERSION:
        raise AtomicTxError(f"unknown codec version {version}")
    type_id = _u(items[1])
    if type_id == TYPE_IMPORT:
        unsigned = ImportTx(
            network_id=_u(items[2]),
            blockchain_id=items[3],
            source_chain=items[4],
            imported_inputs=[UTXO.decode(u) for u in items[5]],
            outs=[EVMOutput(o[0], _u(o[1]), o[2]) for o in items[6]],
        )
    elif type_id == TYPE_EXPORT:
        unsigned = ExportTx(
            network_id=_u(items[2]),
            blockchain_id=items[3],
            destination_chain=items[4],
            ins=[EVMInput(i[0], _u(i[1]), i[2], _u(i[3])) for i in items[5]],
            exported_outputs=[UTXO.decode(u) for u in items[6]],
        )
    else:
        raise AtomicTxError(f"unknown atomic tx type {type_id}")
    creds = [bytes(c) for c in items[7]] if len(items) > 7 else []
    return Tx(unsigned, creds)


def extract_atomic_txs(ext_data: bytes, batch: bool, codec=None) -> List[Tx]:
    """ExtractAtomicTxs (plugin/evm/tx.go): pre-AP5 blocks carry ONE atomic
    tx in ExtData; AP5+ carries an RLP list of them."""
    if not ext_data:
        return []
    if batch:
        return [decode_tx(rlp.encode(i) if isinstance(i, list) else i)
                for i in rlp.decode(ext_data)]
    return [decode_tx(ext_data)]


def encode_atomic_txs(txs: List[Tx], batch: bool) -> bytes:
    if not txs:
        return b""
    if batch:
        return rlp.encode([t.encode() for t in txs])
    assert len(txs) == 1
    return txs[0].encode()
