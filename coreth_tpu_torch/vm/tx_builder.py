"""Wallet-side atomic tx construction: UTXO selection + fee-aware
building of import/export txs (roles of newImportTx/newExportTx and the
spendable-funds selectors, coreth plugin/evm/vm.go:1419-1626);
counterpart of coreth_tpu/vm/tx_builder.py.

The fee depends on the signed tx's byte length, which depends on how many
inputs the fee forces in — the reference resolves this by building once
with every available UTXO (imports consume everything addressed to the
keys) and iterating the fee for exports. Here both builders converge the
fee by fixed-point iteration on the fully signed size (2-3 rounds: size
is monotone in the fee only through int division, so it settles fast).
"""

from __future__ import annotations

from typing import List, Optional

from ..crypto.secp256k1 import priv_to_address
from .atomic_tx import (
    UTXO,
    AtomicTxError,
    EVMInput,
    EVMOutput,
    ExportTx,
    ImportTx,
    Tx,
    calculate_dynamic_fee,
)


def spendable_utxos(vm, source_chain: bytes,
                    addresses: List[bytes]) -> List[UTXO]:
    """All shared-memory UTXOs addressed to [addresses] from
    [source_chain], paged until exhaustion (GetAtomicUTXOs,
    vm.go:1419-1455)."""
    blobs: List[bytes] = []
    start_key = b""
    while True:
        page, _, last_key = vm.shared_memory.indexed(
            source_chain, addresses, start_key=start_key, limit=1024)
        blobs.extend(page)
        if len(page) < 1024 or not last_key or last_key == start_key:
            break
        start_key = last_key
    utxos = [UTXO.decode(b) for b in blobs]
    # skip locked outputs and foreign thresholds (secp fx single-sig only)
    now = vm.blockchain.current_block.header.time
    return [u for u in utxos
            if u.locktime <= now and u.threshold == 1
            and u.address in addresses]


def _fee_fixed_point(build_and_sign, base_fee: int, fixed_fee: bool,
                     max_iters: int = 4) -> Tx:
    """Iterate fee -> size -> fee until stable; returns the signed tx."""
    fee = 0
    tx = None
    for _ in range(max_iters):
        tx = build_and_sign(fee)
        new_fee = calculate_dynamic_fee(tx.gas_used(fixed_fee), base_fee)
        if new_fee <= fee:
            return tx
        fee = new_fee
    return build_and_sign(fee)


def new_import_tx(vm, to_address: bytes, source_chain: bytes,
                  keys: List[bytes],
                  base_fee: Optional[int] = None) -> Tx:
    """Consume every spendable UTXO owned by [keys] on [source_chain] and
    credit the balances (minus the AVAX fee) to [to_address]
    (newImportTx, vm.go:1419-1517)."""
    if source_chain == vm.chain_id_bytes:
        raise AtomicTxError("cannot import from self")
    addr_key = {priv_to_address(k): k for k in keys}
    utxos = spendable_utxos(vm, source_chain, list(addr_key))
    if not utxos:
        raise AtomicTxError("no spendable UTXOs for the provided keys")
    if base_fee is None:
        base_fee = vm._next_base_fee() or 1
    rules = vm.current_rules()
    fixed_fee = rules.is_apricot_phase5

    totals = {}
    for u in utxos:
        totals[u.asset_id] = totals.get(u.asset_id, 0) + u.amount
    sign_keys = [addr_key[u.address] for u in utxos]

    def build_and_sign(fee: int) -> Tx:
        outs = []
        avax_total = totals.get(vm.avax_asset_id, 0)
        if avax_total > fee:
            outs.append(EVMOutput(address=to_address,
                                  amount=avax_total - fee,
                                  asset_id=vm.avax_asset_id))
        for asset, amount in totals.items():
            if asset != vm.avax_asset_id:
                outs.append(EVMOutput(address=to_address, amount=amount,
                                      asset_id=asset))
        if not outs:
            raise AtomicTxError(
                f"imported AVAX ({avax_total}) does not cover the fee "
                f"({fee})")
        tx = Tx(ImportTx(
            network_id=vm.network_id,
            blockchain_id=vm.chain_id_bytes,
            source_chain=source_chain,
            imported_inputs=utxos,
            outs=outs,
        ))
        tx.sign(sign_keys)
        return tx

    if not rules.is_apricot_phase3:
        # fixed (AP2) or zero fee: a single build at the flat fee suffices
        from .atomic_tx import AVALANCHE_ATOMIC_TX_FEE

        flat = AVALANCHE_ATOMIC_TX_FEE if rules.is_apricot_phase2 else 0
        return build_and_sign(flat)
    return _fee_fixed_point(build_and_sign, base_fee, fixed_fee)


def new_export_tx(vm, amount: int, asset_id: bytes,
                  destination_chain: bytes, to_address: bytes,
                  keys: List[bytes],
                  base_fee: Optional[int] = None) -> Tx:
    """Debit [amount] of [asset_id] (plus the AVAX fee) from the first
    key's EVM account and export a UTXO owned by [to_address] to
    [destination_chain] (newExportTx, vm.go:1519-1626)."""
    if destination_chain == vm.chain_id_bytes:
        raise AtomicTxError("cannot export to self")
    if amount == 0:
        raise AtomicTxError("export amount must be positive")
    if not keys:
        raise AtomicTxError("no keys to sign the export")
    if base_fee is None:
        base_fee = vm._next_base_fee() or 1
    rules = vm.current_rules()
    fixed_fee = rules.is_apricot_phase5
    from_key = keys[0]
    from_addr = priv_to_address(from_key)
    state = vm.blockchain.state()
    nonce = state.get_nonce(from_addr)
    avax = vm.avax_asset_id

    def build_and_sign(fee: int) -> Tx:
        if asset_id == avax:
            ins = [EVMInput(address=from_addr, amount=amount + fee,
                            asset_id=avax, nonce=nonce)]
        else:
            ins = [EVMInput(address=from_addr, amount=amount,
                            asset_id=asset_id, nonce=nonce)]
            if fee:
                # AVAX fee rides a second input against the same nonce
                # (the reference spends fee and asset from one account
                # state transition)
                ins.append(EVMInput(address=from_addr, amount=fee,
                                    asset_id=avax, nonce=nonce))
        tx = Tx(ExportTx(
            network_id=vm.network_id,
            blockchain_id=vm.chain_id_bytes,
            destination_chain=destination_chain,
            ins=ins,
            exported_outputs=[UTXO(
                tx_id=b"\x00" * 32, output_index=0, asset_id=asset_id,
                amount=amount, address=to_address,
            )],
        ))
        tx.sign([from_key] * len(ins))
        return tx

    if not rules.is_apricot_phase3:
        from .atomic_tx import AVALANCHE_ATOMIC_TX_FEE

        flat = AVALANCHE_ATOMIC_TX_FEE if rules.is_apricot_phase2 else 0
        tx = build_and_sign(flat)
    else:
        tx = _fee_fixed_point(build_and_sign, base_fee, fixed_fee)
    # pre-flight balance check: semantic verify would reject later anyway,
    # but the builder should fail with a clear error (vm.go:1560-1580)
    need_avax = sum(i.amount for i in tx.unsigned.ins if i.asset_id == avax)
    from .atomic_tx import X2C_RATE

    if state.get_balance(from_addr) < need_avax * X2C_RATE:
        raise AtomicTxError(
            f"insufficient AVAX balance: need {need_avax} nAVAX")
    if asset_id != avax:
        have = state.get_balance_multicoin(from_addr, asset_id)
        if have < amount:
            raise AtomicTxError(
                f"insufficient multicoin balance: need {amount}, have {have}")
    return tx
