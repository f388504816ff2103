"""The blocks mix's generator: an archive node's genesis world, and full
blocks of signed type-2 transactions over it, as plain data (nothing of
the port: the harness makes them before the port is imported).

Everything comes from the seed: the world from stream (seed, 0), block k
from its own stream (seed, 1, k), so the first k blocks do not depend on
how many are made. A block is `calls_per_block` calls to distinct
contracts, each writing `writes_per_call` slots (half of them existing,
half new) through the contract code the traffic file gives and logging
once, spread evenly among `transfers_per_block` transfers of seeded
values to seeded plain accounts (slot keys made as coreth keeps them,
bit 0 of the first byte clear). The keyed senders sign in turn, each at
its next nonce, every transaction with tip 0 and one fee cap.

Config keys read: accounts (the genesis alloc, the coinbase among them),
contracts, slots_per_contract, keyed_senders, chain_id. Traffic keys
read: calls_per_block, transfers_per_block, writes_per_call, call_gas,
transfer_gas, max_fee_wei, value_max_wei, contract_code (hex).
"""

from __future__ import annotations

from typing import List

import numpy as np

from portbench.reference import rlp
from portbench.reference.chain import PlainTx, normalize_key
from portbench.reference.keccak import keccak256_list

from . import signer

# the fee recipient of every block the VM builds: coreth's
# constants.BlackholeAddr (fees are burned there)
BLACKHOLE = b"\x01" + bytes(19)
# each keyed sender starts with at least this much more (1,000 units)
KEYED_FUNDS = 10**21


class World:
    """The genesis accounts: contracts first (the traffic's code and
    `slots_per_contract` seeded slots each), then the keyed senders (the
    addresses of seeded private keys), then plain accounts, the coinbase
    last. addrs, nonce, balance are lists; code {index: bytes}; storage
    {index: {32-byte key: 32-byte value}}; keys [(index, private key)]."""

    def __init__(self, config: dict, traffic: dict, seed: int):
        n = int(config["accounts"])
        c = int(config["contracts"])
        slots = int(config["slots_per_contract"])
        k = int(config["keyed_senders"])
        if c + k + 2 > n:
            raise ValueError("contracts and keyed senders leave no plain "
                             "account to receive transfers")
        rng = np.random.default_rng([seed, 0])
        raw = rng.bytes(20 * n)
        self.addrs = [raw[20 * i:20 * i + 20] for i in range(n)]
        self.nonce = rng.integers(0, 1 << 16, n).tolist()
        bal = rng.bytes(10 * n)
        self.balance = [int.from_bytes(bal[10 * i:10 * i + 10], "big")
                        % 10**24 for i in range(n)]
        code = bytes.fromhex(traffic["contract_code"])
        self.code = {i: code for i in range(c)}
        self.storage = {}
        for i in range(c):
            keys, vals = rng.bytes(32 * slots), rng.bytes(32 * slots)
            self.storage[i] = {normalize_key(keys[32 * s:32 * s + 32]):
                               b"\x01" + vals[32 * s + 1:32 * s + 32]
                               for s in range(slots)}
        self.keys = [(i, b"\x01" + rng.bytes(31)) for i in range(c, c + k)]
        pubs = [signer.public_key(key) for _, key in self.keys]
        for (i, _), h in zip(self.keys, keccak256_list(pubs)):
            self.addrs[i] = h[12:]
            self.balance[i] += KEYED_FUNDS
        self.coinbase = n - 1
        self.addrs[self.coinbase] = BLACKHOLE
        if len(set(self.addrs)) != n:
            raise ValueError("two genesis accounts share an address")
        self.receivers = np.arange(c + k, n - 1)
        self.chain_id = int(config["chain_id"])


class Blocks:
    """The mix's blocks in order (next_block), unsigned; sign() signs a
    list of them."""

    def __init__(self, world: World, traffic: dict, seed: int):
        self.world = world
        self.seed = seed
        self.calls = int(traffic["calls_per_block"])
        self.transfers = int(traffic["transfers_per_block"])
        self.writes = int(traffic["writes_per_call"])
        self.call_gas = int(traffic["call_gas"])
        self.transfer_gas = int(traffic["transfer_gas"])
        self.max_fee = int(traffic["max_fee_wei"])
        self.value_max = int(traffic["value_max_wei"])
        if self.calls > len(world.storage):
            raise ValueError("more calls a block than contracts")
        self.nonce = {i: world.nonce[i] for i, _ in world.keys}
        # each contract's keys in the order they were made, and as a set
        self.slot_keys = {c: list(s) for c, s in world.storage.items()}
        self.slot_set = {c: set(s) for c, s in world.storage.items()}
        self.made = 0
        self.sent = 0  # transactions made: the next sender in turn

    def next_block(self) -> List[PlainTx]:
        w = self.world
        r = np.random.default_rng([self.seed, 1, self.made])
        self.made += 1
        total = self.calls + self.transfers
        contracts = r.choice(len(w.storage), self.calls, replace=False)
        call_at = {round(j * total / self.calls): int(c)
                   for j, c in enumerate(contracts)}
        txs = []
        for pos in range(total):
            i, _ = w.keys[self.sent % len(w.keys)]
            self.sent += 1
            if pos in call_at:
                to = call_at[pos]
                data = self._call_data(to, r)
                tx = PlainTx(i, self.nonce[i], to, 0, self.call_gas,
                             self.max_fee, 0, data)
            else:
                to = int(r.choice(w.receivers))
                tx = PlainTx(i, self.nonce[i], to,
                             int(r.integers(1, self.value_max)),
                             self.transfer_gas, self.max_fee, 0, b"")
            self.nonce[i] += 1
            txs.append(tx)
        return txs

    def _call_data(self, c: int, r) -> bytes:
        """(key, value) pairs for the contract's code: half to existing
        slots (new values), half to new keys."""
        keys = self.slot_keys[c]
        old = [keys[int(j)] for j in r.choice(
            len(keys), min(self.writes // 2, len(keys)), replace=False)]
        pairs = [(k, b"\x04" + r.bytes(31)) for k in old]
        while len(pairs) < self.writes:
            k = normalize_key(r.bytes(32))
            if k not in self.slot_set[c]:
                self.slot_set[c].add(k)
                keys.append(k)
                pairs.append((k, b"\x05" + r.bytes(31)))
        return b"".join(k + v for k, v in pairs)

    def sign(self, blocks: List[List[PlainTx]]) -> None:
        """Sign every transaction of `blocks` in place: its `raw` is the
        typed envelope 0x02 || RLP(fields, y parity, r, s) and its `hash`
        the envelope's Keccak-256."""
        w = self.world
        keys = dict(w.keys)
        txs = [tx for b in blocks for tx in b]
        fields = [[w.chain_id, tx.nonce, tx.tip, tx.max_fee, tx.gas,
                   w.addrs[tx.to], tx.value, tx.data, []] for tx in txs]
        digests = keccak256_list([b"\x02" + rlp.encode(f) for f in fields])
        for tx, f, d in zip(txs, fields, digests):
            parity, sr, ss = signer.sign(keys[tx.sender], d)
            tx.raw = b"\x02" + rlp.encode(f + [parity, sr, ss])
        for tx, h in zip(txs, keccak256_list([tx.raw for tx in txs])):
            tx.hash = h
