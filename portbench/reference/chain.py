"""The VM mix's state transition, plain: what an archive C-Chain node's
state must hold after each block of the `blocks` mix, with nothing of
the port.

Each block's base fee, every transaction's gas and status, and the state
after the block: nonces, balances, the fees paid to the coinbase, each
contract call's storage writes. Roots come from mpt.py's batched trie:
every changed contract's storage trie after each block in one forest,
then the account trie over all blocks as versions of the genesis key set.

What it follows (coreth v0.12.5, all forks through Cortina and the D
upgrade active, as in the local chain preset):
- dynamic fees (consensus/dummy/dynamic_fees.go CalcBaseFee), the
  Apricot Phase 5 rules: a 10-slot rolling gas window, target 15M gas,
  change denominator 36, floor 25 gwei, 225 gwei at the first block; no
  block gas cost in the window;
- the state transition (core/state_transition.go): intrinsic gas 21,000
  plus 16 a non-zero and 4 a zero calldata byte; the sender pays gas
  used times min(fee cap, base fee + tip) and the coinbase receives it
  (the black-hole address: Avalanche burns fees there); no gas refund
  (none since Apricot Phase 1);
- coreth's storage keys (core/state/state_object.go NormalizeStateKey):
  bit 0 of a key's first byte is cleared before the key is read or
  written, the multicoin balances' half of the key space kept apart;
- the EVM's gas for the opcodes the mix's contract code uses (the
  yellow paper's tiers; EIP-2929 cold and warm access; EIP-2200 net
  metered SSTORE with the 2,300 sentry; LOG 375 + 375 a topic + 8 a
  byte; memory 3 a word + words^2 / 512).

Departures: only the opcodes of the mix's code run here (any other raises
UnsupportedOpcode), and only the Apricot Phase 5 fee rules; a call that
runs out of gas reverts its writes and uses its whole gas limit, as in
the EVM, but no other failure is modelled. Logs are not kept (the
comparison reads states, receipts' status and gas).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from . import mpt, rlp
from .keccak import keccak256, keccak256_list

EMPTY_ROOT = mpt.EMPTY_ROOT
EMPTY_CODE_HASH = bytes.fromhex(
    "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
# coreth params/avalanche_params.go
INITIAL_BASE_FEE = 225 * 10**9     # ApricotPhase3InitialBaseFee
MIN_BASE_FEE = 25 * 10**9          # ApricotPhase4MinBaseFee
TARGET_GAS = 15_000_000            # ApricotPhase5TargetGas
FEE_DENOMINATOR = 36               # ApricotPhase5BaseFeeChangeDenominator
ROLLUP_WINDOW = 10                 # RollupWindow
TX_GAS = 21_000
CALLDATA_NONZERO = 16
CALLDATA_ZERO = 4
COLD_SLOAD = 2_100
WARM_READ = 100
SSTORE_SET = 20_000
SSTORE_RESET = 5_000
SSTORE_SENTRY = 2_300
LOG_GAS, LOG_TOPIC, LOG_DATA = 375, 375, 8
MEM_WORD = 3
COPY_WORD = 3
WORD = 1 << 256


class UnsupportedOpcode(ValueError):
    """The reference meets an opcode outside the mix's code."""


class InvalidTransaction(ValueError):
    """A transaction the state transition would refuse (a harness fault:
    the mix never makes one)."""


class _OutOfGas(Exception):
    pass


def intrinsic_gas(data: bytes) -> int:
    zeros = data.count(0)
    return TX_GAS + CALLDATA_ZERO * zeros + CALLDATA_NONZERO * (
        len(data) - zeros)


def normalize_key(key: bytes) -> bytes:
    """coreth's NormalizeStateKey: bit 0 of the first byte cleared."""
    return bytes([key[0] & 0xFE]) + key[1:]


def _mem_cost(words: int) -> int:
    return MEM_WORD * words + words * words // 512


def _jumpdests(code: bytes) -> set:
    out, pc = set(), 0
    while pc < len(code):
        op = code[pc]
        if op == 0x5B:
            out.add(pc)
        pc += 1 + (op - 0x5F if 0x60 <= op <= 0x7F else 0)
    return out


def run_code(code: bytes, data: bytes, caller: bytes, storage: dict,
             gas: int):
    """Execute `code` on `storage` ({32-byte key: 32-byte value}, the
    contract's state at the transaction's start) with `gas` after the
    intrinsic cost. Returns (gas left, writes {key: value}); raises
    _OutOfGas, which reverts every write."""
    dests = _jumpdests(code)
    stack: List[int] = []
    mem = bytearray()
    writes: Dict[bytes, bytes] = {}
    warm = set()
    pc = 0

    def use(n):
        nonlocal gas
        if n > gas:
            raise _OutOfGas
        gas -= n

    def expand(offset, size):
        if size == 0:
            return
        words = (offset + size + 31) // 32
        have = len(mem) // 32
        if words > have:
            use(_mem_cost(words) - _mem_cost(have))
            mem.extend(bytes(32 * words - len(mem)))

    def cd_load(off):
        return int.from_bytes(data[off:off + 32].ljust(32, b"\x00"), "big")

    while pc < len(code):
        op = code[pc]
        if op == 0x00:      # STOP
            break
        if 0x60 <= op <= 0x7F:  # PUSHn
            use(3)
            n = op - 0x5F
            stack.append(int.from_bytes(
                code[pc + 1:pc + 1 + n].ljust(n, b"\x00"), "big"))
            pc += 1 + n
            continue
        if op == 0x01:      # ADD
            use(3)
            a, b = stack.pop(), stack.pop()
            stack.append((a + b) % WORD)
        elif op == 0x11:    # GT
            use(3)
            a, b = stack.pop(), stack.pop()
            stack.append(1 if a > b else 0)
        elif op == 0x15:    # ISZERO
            use(3)
            stack.append(1 if stack.pop() == 0 else 0)
        elif op == 0x33:    # CALLER
            use(2)
            stack.append(int.from_bytes(caller, "big"))
        elif op == 0x35:    # CALLDATALOAD
            use(3)
            stack.append(cd_load(stack.pop()))
        elif op == 0x36:    # CALLDATASIZE
            use(2)
            stack.append(len(data))
        elif op == 0x37:    # CALLDATACOPY
            dst, off, size = stack.pop(), stack.pop(), stack.pop()
            use(3 + COPY_WORD * ((size + 31) // 32))
            expand(dst, size)
            mem[dst:dst + size] = data[off:off + size].ljust(size, b"\x00")
        elif op == 0x55:    # SSTORE
            if gas <= SSTORE_SENTRY:
                raise _OutOfGas
            key = normalize_key(stack.pop().to_bytes(32, "big"))
            value = stack.pop().to_bytes(32, "big")
            cost = 0
            if key not in warm:
                warm.add(key)
                cost += COLD_SLOAD
            original = storage.get(key, bytes(32))
            current = writes.get(key, original)
            if value == current:
                cost += WARM_READ
            elif original == current:
                cost += (SSTORE_SET if original == bytes(32)
                         else SSTORE_RESET - COLD_SLOAD)
            else:
                cost += WARM_READ
            use(cost)
            writes[key] = value
        elif op == 0x56:    # JUMP
            use(8)
            dest = stack.pop()
            if dest not in dests:
                raise _OutOfGas  # an invalid jump consumes all gas
            pc = dest
            continue
        elif op == 0x57:    # JUMPI
            use(10)
            dest, cond = stack.pop(), stack.pop()
            if cond:
                if dest not in dests:
                    raise _OutOfGas
                pc = dest
                continue
        elif op == 0x5B:    # JUMPDEST
            use(1)
        elif op == 0x80:    # DUP1
            use(3)
            stack.append(stack[-1])
        elif op == 0x81:    # DUP2
            use(3)
            stack.append(stack[-2])
        elif op == 0xA1:    # LOG1
            off, size, _topic = stack.pop(), stack.pop(), stack.pop()
            use(LOG_GAS + LOG_TOPIC + LOG_DATA * size)
            expand(off, size)
        else:
            raise UnsupportedOpcode(f"opcode 0x{op:02x} at {pc}")
        pc += 1
    return gas, writes


class PlainTx:
    """One type-2 transaction as the mix made it: account indices, not
    addresses, for sender and recipient."""

    __slots__ = ("sender", "nonce", "to", "value", "gas", "max_fee", "tip",
                 "data", "hash", "raw")

    def __init__(self, sender, nonce, to, value, gas, max_fee, tip, data,
                 hash=b"", raw=b""):
        self.sender, self.nonce, self.to, self.value = sender, nonce, to, value
        self.gas, self.max_fee, self.tip, self.data = gas, max_fee, tip, data
        self.hash, self.raw = hash, raw


def account_rlp(nonce: int, balance: int, root: bytes, code_hash: bytes
                ) -> bytes:
    """coreth's StateAccount: [nonce, balance, root, code hash,
    is-multicoin (false)]."""
    return rlp.encode([nonce, balance, root, code_hash, b""])


def slot_rlp(value: bytes) -> bytes:
    return rlp.encode(value.lstrip(b"\x00"))


class ChainReference:
    """The state from a genesis alloc, block after block.

    addrs[i], nonce[i], balance[i]: the genesis accounts; code {i: bytes};
    storage {i: {32-byte key: 32-byte value}}; coinbase: the index of the
    fee recipient; each block `block_gap` seconds after its parent, from
    a genesis at time 0. apply_block() runs one block; roots() then gives
    every root and fills each block's reads (what its state holds for the
    accounts it touched and the slots it wrote). strict=False takes each
    transaction's nonce as given (the control, whose lost transactions
    leave gaps)."""

    def __init__(self, addrs: Sequence[bytes], nonce, balance, code: dict,
                 storage: dict, coinbase: int, gas_limit: int,
                 block_gap: int, device="cpu", strict: bool = True):
        self.strict = strict
        self.addrs = list(addrs)
        self.nonce = [int(x) for x in nonce]
        self.balance = [int(x) for x in balance]
        storage = {c: {normalize_key(k): v for k, v in s.items()
                       if v != bytes(32)} for c, s in storage.items()}
        self.genesis = (list(self.nonce), list(self.balance),
                        {c: dict(s) for c, s in storage.items()})
        self.code = dict(code)
        self.storage = {c: dict(s) for c, s in storage.items()}
        self.coinbase = coinbase
        self.gas_limit = gas_limit
        self.gap = block_gap
        self.device = device
        self.code_hash = dict(zip(sorted(code), keccak256_list(
            [code[i] for i in sorted(code)], device)))
        # the parent header's fields the base fee reads
        self.number, self.time, self.base_fee = 0, 0, None
        self.window = [0] * ROLLUP_WINDOW
        self.gas_used = 0
        # per block: "accounts" {index: (nonce, balance)} and "storage"
        # {contract: its whole storage} after it, "written" {contract:
        # keys written}, "receipts", "base_fee"
        self.blocks: List[dict] = []

    def next_base_fee(self, timestamp: int):
        """(base fee, rolled window) of a child of the current head at
        `timestamp` (CalcBaseFee, Apricot Phase 5 rules)."""
        if self.number == 0:
            return INITIAL_BASE_FEE, [0] * ROLLUP_WINDOW
        roll = timestamp - self.time
        if roll < 0:
            raise InvalidTransaction("a block before its parent")
        window = [0] * ROLLUP_WINDOW
        if roll < ROLLUP_WINDOW:
            window[:ROLLUP_WINDOW - roll] = self.window[roll:]
            window[ROLLUP_WINDOW - 1 - roll] += self.gas_used
        total = sum(window)
        fee = self.base_fee
        if total > TARGET_GAS:
            fee += max(fee * (total - TARGET_GAS) // TARGET_GAS
                       // FEE_DENOMINATOR, 1)
        elif total < TARGET_GAS:
            delta = max(fee * (TARGET_GAS - total) // TARGET_GAS
                        // FEE_DENOMINATOR, 1)
            if roll > ROLLUP_WINDOW:
                delta *= roll // ROLLUP_WINDOW
            fee -= delta
        return max(fee, MIN_BASE_FEE), window

    def apply_block(self, txs: Sequence[PlainTx], drop_last: bool = False
                    ) -> List[tuple]:
        """Run one block of `txs` (all of them, or all but the last: the
        control) at the next timestamp. Returns [(tx hash, status, gas
        used)] in order."""
        timestamp = self.time + self.gap
        base_fee, window = self.next_base_fee(timestamp)
        receipts, touched, written = [], set(), {}
        used = 0
        for tx in (txs[:-1] if drop_last else txs):
            status, gas = self._apply_tx(tx, base_fee, touched, written)
            used += gas
            receipts.append((tx.hash, status, gas))
        if used > self.gas_limit:
            raise InvalidTransaction(f"block uses {used} gas")
        self.number += 1
        self.time, self.base_fee = timestamp, base_fee
        self.window, self.gas_used = window, used
        self.blocks.append({
            "accounts": {i: (self.nonce[i], self.balance[i])
                         for i in sorted(touched)},
            "storage": {c: dict(self.storage[c]) for c in sorted(written)},
            "written": written, "receipts": receipts,
            "base_fee": base_fee})
        return receipts

    def _apply_tx(self, tx: PlainTx, base_fee: int, touched: set,
                  written: dict):
        s = tx.sender
        if tx.nonce != self.nonce[s] and self.strict:
            raise InvalidTransaction(
                f"nonce {tx.nonce}, account at {self.nonce[s]}")
        if tx.max_fee < base_fee:
            raise InvalidTransaction("fee cap below the base fee")
        if self.balance[s] < tx.gas * tx.max_fee + tx.value:
            raise InvalidTransaction("balance below gas * fee cap + value")
        intrinsic = intrinsic_gas(tx.data)
        if intrinsic > tx.gas:
            raise InvalidTransaction("gas below the intrinsic gas")
        price = min(tx.max_fee, base_fee + tx.tip)
        self.nonce[s] = tx.nonce + 1
        status, left, writes = 1, tx.gas - intrinsic, {}
        code = self.code.get(tx.to)
        if code:
            try:
                left, writes = run_code(code, tx.data, self.addrs[s],
                                        self.storage.get(tx.to, {}), left)
            except _OutOfGas:
                status, left, writes = 0, 0, {}
        gas = tx.gas - left
        if status:
            self.balance[s] -= tx.value
            self.balance[tx.to] += tx.value
            if writes:
                st = self.storage.setdefault(tx.to, {})
                for k, v in writes.items():
                    if v == bytes(32):
                        st.pop(k, None)
                    else:
                        st[k] = v
                written.setdefault(tx.to, set()).update(writes)
        fee = gas * price
        self.balance[s] -= fee
        self.balance[self.coinbase] += fee
        touched.update((s, tx.to, self.coinbase))
        return status, gas

    # ---------------------------------------------------------------- roots

    def _forest_roots(self, groups: List[dict]) -> List[bytes]:
        """The storage root of each {key: value} in `groups`."""
        out = [EMPTY_ROOT] * len(groups)
        keys, vals, gid = [], [], []
        for g, st in enumerate(groups):
            for k, v in st.items():
                keys.append(k)
                vals.append(slot_rlp(v))
                gid.append(g)
        if not keys:
            return out
        dev = self.device
        rows, lens = _pack(vals)
        st = mpt.Structure(_hash_rows(keys, dev), torch.tensor(
            gid, dtype=torch.int64, device=dev))
        got = mpt.roots(st, rows.to(dev), lens.to(dev))[0].cpu().numpy()
        for j, g in enumerate(sorted(set(gid))):
            out[g] = got[j].tobytes()
        return out

    def roots(self) -> List[bytes]:
        """Roots of the genesis and of every block applied, in order. Also
        gives each block its "account_rlp" {index: leaf value} and
        "storage_roots" {contract: root} after it."""
        dev = self.device
        g_nonce, g_balance, g_storage = self.genesis
        cur = {}  # contract -> its storage root as of the block at hand
        gen = sorted(g_storage)
        cur.update(zip(gen, self._forest_roots([g_storage[c] for c in gen])))
        pairs = [(k, c) for k, b in enumerate(self.blocks)
                 for c in b["storage"]]
        got = self._forest_roots([self.blocks[k]["storage"][c]
                                  for k, c in pairs])
        for b in self.blocks:
            b["storage_roots"] = {}
        for (k, c), r in zip(pairs, got):
            self.blocks[k]["storage_roots"][c] = r

        def leaf(i, nonce, balance):
            return account_rlp(nonce, balance, cur.get(i, EMPTY_ROOT),
                               self.code_hash.get(i, EMPTY_CODE_HASH))

        base = [leaf(i, g_nonce[i], g_balance[i])
                for i in range(len(self.addrs))]
        ups = []
        for b in self.blocks:
            cur.update(b["storage_roots"])
            acc = {i: leaf(i, nc, bal) for i, (nc, bal) in
                   b["accounts"].items()}
            b["account_rlp"] = acc
            idx = sorted(acc)
            rows, lens = _pack([acc[i] for i in idx])
            ups.append((torch.tensor(idx, dtype=torch.int64, device=dev),
                        rows.to(dev), lens.to(dev)))
        st = mpt.Structure(_hash_rows(self.addrs, dev))
        rows, lens = _pack(base)
        out = mpt.roots(st, rows.to(dev), lens.to(dev), ups)[:, 0]
        out = out.cpu().numpy()
        return [out[k].tobytes() for k in range(out.shape[0])]

    def reads(self, k: int):
        """What block k's state (k from 1) holds where the block touched
        it, after roots(): ([(address, account leaf value)], [(storage
        root, [(slot key, slot leaf value)])]) with the raw address and
        slot keys (the trie's keys are their Keccak-256)."""
        b = self.blocks[k - 1]
        accounts = [(self.addrs[i], v) for i, v in
                    sorted(b["account_rlp"].items())]
        slots = [(b["storage_roots"][c],
                  [(key, slot_rlp(b["storage"][c][key]))
                   for key in sorted(keys) if key in b["storage"][c]])
                 for c, keys in sorted(b["written"].items())]
        return accounts, slots


def _pack(values: List[bytes]):
    """uint8 [n, W] rows and int64 [n] lengths of byte strings."""
    w = max(1, max((len(v) for v in values), default=1))
    buf = np.zeros((len(values), w), np.uint8)
    for i, v in enumerate(values):
        buf[i, :len(v)] = np.frombuffer(v, np.uint8)
    return (torch.from_numpy(buf),
            torch.tensor([len(v) for v in values], dtype=torch.int64))


def _hash_rows(msgs: List[bytes], device) -> torch.Tensor:
    """uint8 [n, 32] Keccak-256 of each message, on `device`."""
    rows, lens = _pack(msgs)
    return keccak256(rows.to(device), lens.to(device))
