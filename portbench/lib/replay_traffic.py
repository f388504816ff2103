"""The replay mix's generator: a state of plain accounts and the
account-trie change sets of full blocks of plain transfers over it.

Everything comes from the seed: block k from its own stream (seed, 1,
k), so the first k blocks do not depend on how many are made. Keys are
32 uniform bytes, as hashed addresses are.

Config keys read: accounts, contracts. Traffic keys read:
transfers_per_block, gas_per_transfer, gas_price_wei, value_max_wei.
"""

from __future__ import annotations

import numpy as np

from . import accounts


class ReplayTraffic:
    def __init__(self, config: dict, traffic: dict, seed: int):
        n = int(config["accounts"])
        c = int(config["contracts"])
        rng = np.random.default_rng([seed, 0])
        self.seed = seed
        self.n = n
        self.keys = np.frombuffer(rng.bytes(32 * n), np.uint8).reshape(
            n, 32).copy()
        self.nonce = rng.integers(0, 1 << 16, n).astype(np.uint64)
        # at least 2**64 wei (about 18.4 units): no transfer overdraws
        self.hi = rng.integers(1, 1 << 16, n).astype(np.uint64)
        self.lo = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        self.root = np.broadcast_to(
            np.frombuffer(accounts.EMPTY_ROOT, np.uint8), (n, 32)).copy()
        self.code = np.broadcast_to(
            np.frombuffer(accounts.EMPTY_CODE_HASH, np.uint8), (n, 32)).copy()
        # the contracts: code and a storage root of their own
        self.root[:c] = np.frombuffer(rng.bytes(32 * c), np.uint8).reshape(
            c, 32)
        self.code[:c] = np.frombuffer(rng.bytes(32 * c), np.uint8).reshape(
            c, 32)
        self.coinbase = int(rng.integers(0, n))
        self.transfers = int(traffic["transfers_per_block"])
        self.fee = np.uint64(int(traffic["gas_per_transfer"])
                             * int(traffic["gas_price_wei"]))
        self.value_max = int(traffic["value_max_wei"])
        self.made = 0

    def genesis(self):
        """(keys uint8 [n, 32], rows uint8 [n, W], lengths int64 [n])."""
        rows, lens = accounts.encode(self.nonce, self.hi, self.lo, self.root,
                                     self.code)
        return self.keys, rows, lens

    def next_block(self):
        """The next block's changes: (account indices, rows, lengths,
        block hash). Senders and receivers are distinct accounts, drawn
        uniformly, none the coinbase; the coinbase's leaf comes last."""
        k = self.made
        self.made += 1
        t = self.transfers
        r = np.random.default_rng([self.seed, 1, k])
        pick = r.choice(self.n - 1, 2 * t, replace=False)
        pick = pick + (pick >= self.coinbase)
        snd, rcv = pick[:t], pick[t:]
        value = r.integers(1, self.value_max, t).astype(np.uint64)
        self.nonce[snd] += np.uint64(1)
        self._move(snd, value + self.fee, -1)
        self._move(rcv, value, +1)
        cb = np.array([self.coinbase])
        self._move(cb, np.array([self.fee * np.uint64(t)]), +1)
        idx = np.concatenate((snd, rcv, cb))
        rows, lens = accounts.encode(self.nonce[idx], self.hi[idx],
                                     self.lo[idx], self.root[idx],
                                     self.code[idx])
        return idx, rows, lens, r.bytes(32)

    def _move(self, idx, amount, sign: int) -> None:
        lo = self.lo[idx]
        if sign > 0:
            new = lo + amount
            self.hi[idx] += (new < lo).astype(np.uint64)
        else:
            new = lo - amount
            self.hi[idx] -= (new > lo).astype(np.uint64)
        self.lo[idx] = new
