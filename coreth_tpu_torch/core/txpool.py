"""Transaction pool (semantics of coreth core/txpool/txpool.go +
list.go/noncer.go — pending/queued partition, per-account nonce lists,
price-bounded admission, head-event reset); counterpart of
coreth_tpu/core/txpool.py.

coreth runs a goroutine event loop (txpool.go:379); here the chain calls
reset() on head events directly through its chain feed
(BlockChain.subscribe_chain_event), and all operations take the pool
lock. reset() opens the new head's state with chain.state_at, which on a
resident chain reads through the mirror and the snapshot tree as an
insert does.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..metrics import count_drop
from .state_transition import intrinsic_gas
from .types import Signer, Transaction

TX_SLOT_SIZE = 32 * 1024
MAX_TX_SIZE = 4 * TX_SLOT_SIZE


class TxPoolError(Exception):
    pass


ErrAlreadyKnown = "already known"
ErrInvalidSender = "invalid sender"
ErrUnderpriced = "transaction underpriced"
ErrReplaceUnderpriced = "replacement transaction underpriced"
ErrAccountLimitExceeded = "account holds more than allowed"
ErrGasLimit = "exceeds block gas limit"
ErrNegativeValue = "negative value"
ErrOversizedData = "oversized data"
ErrFutureTx = "future transaction"
ErrNonceTooLow = "nonce too low"
ErrInsufficientFunds = "insufficient funds"
ErrIntrinsicGas = "intrinsic gas too low"
ErrTipAboveFeeCap = "tip above fee cap"


@dataclass
class TxPoolConfig:
    """txpool.go DefaultConfig."""

    price_limit: int = 1
    price_bump: int = 10          # % price bump to replace a pending tx
    account_slots: int = 16
    global_slots: int = 4096
    account_queue: int = 64
    global_queue: int = 1024
    journal: str = ""             # local-tx journal path ("" disables)
    locals: Tuple[bytes, ...] = ()  # addresses always treated as local


class _PricedList:
    """Min-heap over remote txs by fee cap (txpool.go pricedList): pop
    the cheapest victim when the pool overflows. Entries go stale when
    their tx leaves the pool; stale heads are skipped lazily."""

    def __init__(self):
        import heapq as _hq

        self._hq = _hq
        self._heap: list = []   # (gas_fee_cap, seq, hash)
        self._seq = 0

    def push(self, tx: Transaction) -> None:
        self._hq.heappush(self._heap, (tx.gas_fee_cap, self._seq, tx.hash()))
        self._seq += 1

    def cheapest(self, alive) -> Optional[Transaction]:
        """Peek the cheapest live remote tx (alive: hash -> tx | None)."""
        while self._heap:
            _, _, h = self._heap[0]
            tx = alive(h)
            if tx is None:
                self._hq.heappop(self._heap)
                continue
            return tx
        return None


class TxJournal:
    """Disk journal of local transactions (txpool journal.go): appended
    on admission, replayed on boot, rewritten compact on rotate()."""

    def __init__(self, path: str):
        self.path = path

    def load(self, add_fn) -> int:
        import os

        from .. import rlp

        if not self.path or not os.path.exists(self.path):
            return 0
        loaded = 0
        with open(self.path, "rb") as f:
            blob = f.read()
        pos = 0
        while pos < len(blob):
            try:
                item, pos = rlp._decode_at(blob, pos)
                tx = Transaction.decode(bytes(item))
            except Exception:
                # truncated tail (crash mid-append): keep the rest
                count_drop("txpool/journal/truncated")
                break
            try:
                add_fn(tx)
                loaded += 1
            except Exception:
                # stale journal entries (already mined) are fine, but a
                # journal full of rejects should show up in the counters
                count_drop("txpool/journal/stale_entry")
        return loaded

    def insert(self, tx: Transaction) -> None:
        if not self.path:
            return
        from .. import rlp

        with open(self.path, "ab") as f:
            f.write(rlp.encode(tx.encode()))

    def rotate(self, all_local: List[Transaction]) -> None:
        if not self.path:
            return
        import os

        from .. import rlp

        tmp = self.path + ".new"
        with open(tmp, "wb") as f:
            for tx in all_local:
                f.write(rlp.encode(tx.encode()))
        os.replace(tmp, self.path)


class _TxList:
    """Per-account nonce-sorted list (txpool list.go)."""

    def __init__(self):
        self.items: Dict[int, Transaction] = {}

    def get(self, nonce: int) -> Optional[Transaction]:
        return self.items.get(nonce)

    def add(self, tx: Transaction, price_bump: int) -> Tuple[bool, Optional[Transaction]]:
        old = self.items.get(tx.nonce)
        if old is not None:
            # replacement needs a price_bump% higher tip AND fee cap
            bump = 100 + price_bump
            if (
                tx.gas_fee_cap * 100 < old.gas_fee_cap * bump
                or tx.gas_tip_cap * 100 < old.gas_tip_cap * bump
            ):
                return False, None
        self.items[tx.nonce] = tx
        return True, old

    def forward(self, threshold: int) -> List[Transaction]:
        """Drop txs with nonce < threshold."""
        dropped = [t for n, t in self.items.items() if n < threshold]
        for t in dropped:
            del self.items[t.nonce]
        return dropped

    def filter_cost(self, balance: int, gas_limit: int) -> List[Transaction]:
        dropped = [
            t for t in self.items.values()
            if t.cost() > balance or t.gas > gas_limit
        ]
        for t in dropped:
            del self.items[t.nonce]
        return dropped

    def ready(self, start: int) -> List[Transaction]:
        """Sequential txs beginning at start."""
        out = []
        n = start
        while n in self.items:
            out.append(self.items[n])
            n += 1
        return out

    def cap(self, limit: int) -> List[Transaction]:
        if len(self.items) <= limit:
            return []
        nonces = sorted(self.items)
        dropped = [self.items.pop(n) for n in nonces[limit:]]
        return dropped

    def __len__(self):
        return len(self.items)

    def empty(self) -> bool:
        return not self.items


class TxPool:
    def __init__(self, config: TxPoolConfig, chain_config, chain):
        self.config = config
        self.chain_config = chain_config
        self.chain = chain
        self.signer = Signer(chain_config.chain_id)
        self.mu = threading.RLock()

        self.pending: Dict[bytes, _TxList] = {}
        self.queue: Dict[bytes, _TxList] = {}
        self.all: Dict[bytes, Transaction] = {}  # hash -> tx
        self.pending_nonces: Dict[bytes, int] = {}
        # O(1) capacity counters, kept in sync with pending/queue sizes
        self._pending_count = 0
        self._queued_count = 0

        head = chain.current_block
        self.current_head = head.header
        self.statedb = chain.state_at(head.root)
        self.gas_limit = head.gas_limit
        self.min_fee: Optional[int] = None

        # new-tx event subscribers (gossip wiring)
        self._tx_feed: list = []

        # locals + journal (txpool.go accountSet + journal.go): local
        # senders bypass caps, never get price-evicted, and their txs
        # survive restarts through the journal
        self.locals: set = set(config.locals)
        self.priced_pending = _PricedList()
        self.priced_queued = _PricedList()
        self.journal = TxJournal(config.journal) if config.journal else None
        if self.journal is not None:
            self.journal.load(lambda tx: self.add(tx, local=True, journal=False))
            self._rotate_journal()

        chain.subscribe_chain_event(lambda blk, logs: self.reset(blk.header))

    # ------------------------------------------------------------ locals

    def _is_local(self, sender: bytes) -> bool:
        return sender in self.locals

    def _local_txs(self) -> List[Transaction]:
        out = []
        for part in (self.pending, self.queue):
            for sender, lst in part.items():
                if sender in self.locals:
                    out.extend(lst.items[n] for n in sorted(lst.items))
        return out

    def _rotate_journal(self) -> None:
        if self.journal is not None:
            self.journal.rotate(self._local_txs())

    # ------------------------------------------------------------ eviction

    def _evict_for(self, tx: Transaction, partition: Dict[bytes, "_TxList"],
                   heap: "_PricedList") -> bool:  # guarded-by: mu
        """Partition overflow: drop that partition's cheapest REMOTE tx if
        [tx] outbids it (txpool.go pricedList.Discard). Each partition has
        its own heap (txs re-push when they move partitions), so occupancy
        can never exceed its cap. False = tx itself is the loser."""

        def alive_in_partition(h):
            t = self.all.get(h)
            if t is None:
                return None
            sender = self.signer.sender(t)
            if self._is_local(sender):
                return None
            lst = partition.get(sender)
            if lst is None or lst.get(t.nonce) is not t:
                return None
            return t

        victim = heap.cheapest(alive_in_partition)
        if victim is None or victim.gas_fee_cap >= tx.gas_fee_cap:
            return False
        self._remove(victim.hash())
        return True

    def _remove(self, tx_hash: bytes) -> None:  # guarded-by: mu
        """Drop one tx from whichever partition holds it; demote later
        pending nonces of the same sender back to the queue."""
        tx = self.all.pop(tx_hash, None)
        if tx is None:
            return
        sender = self.signer.sender(tx)
        plist = self.pending.get(sender)
        if plist is not None and plist.get(tx.nonce) is tx:
            del plist.items[tx.nonce]
            self._pending_count -= 1
            # nonce gap: everything after it is no longer executable
            laters = [plist.items[n] for n in sorted(plist.items)
                      if n > tx.nonce]
            for later in laters:
                del plist.items[later.nonce]
                self._pending_count -= 1
                qlist = self.queue.setdefault(sender, _TxList())
                if qlist.get(later.nonce) is None:
                    self._queued_count += 1
                qlist.items[later.nonce] = later
                if not self._is_local(sender):
                    self.priced_queued.push(later)
            self.pending_nonces[sender] = tx.nonce
            if plist.empty():
                self.pending.pop(sender, None)
            return
        qlist = self.queue.get(sender)
        if qlist is not None and qlist.get(tx.nonce) is tx:
            del qlist.items[tx.nonce]
            self._queued_count -= 1
            if qlist.empty():
                self.queue.pop(sender, None)

    # ------------------------------------------------------------ admission

    def _validate(self, tx: Transaction, local: bool) -> bytes:
        if len(tx.encode()) > MAX_TX_SIZE:
            raise TxPoolError(ErrOversizedData)
        if tx.value < 0:
            raise TxPoolError(ErrNegativeValue)
        if tx.gas > self.gas_limit:
            raise TxPoolError(ErrGasLimit)
        if tx.gas_fee_cap < tx.gas_tip_cap:
            raise TxPoolError(ErrTipAboveFeeCap)
        try:
            sender = self.signer.sender(tx)
        except Exception as e:
            raise TxPoolError(ErrInvalidSender) from e
        if not local and tx.gas_tip_cap < self.config.price_limit:
            raise TxPoolError(ErrUnderpriced)
        # post-AP3 minimum fee: fee cap must cover the current minimum
        if self.min_fee is not None and tx.gas_fee_cap < self.min_fee:
            raise TxPoolError(f"{ErrUnderpriced}: fee cap below minimum {self.min_fee}")
        if self.statedb.get_nonce(sender) > tx.nonce:
            raise TxPoolError(ErrNonceTooLow)
        if self.statedb.get_balance(sender) < tx.cost():
            raise TxPoolError(ErrInsufficientFunds)
        rules = self.chain_config.rules(
            self.current_head.number + 1, self.current_head.time
        )
        gas = intrinsic_gas(
            tx.data, tx.access_list, tx.to is None,
            rules.is_homestead, rules.is_istanbul, rules.is_d_upgrade,
        )
        if tx.gas < gas:
            raise TxPoolError(ErrIntrinsicGas)
        return sender

    def add_remote(self, tx: Transaction) -> None:
        self.add(tx, local=False)

    def add_local(self, tx: Transaction) -> None:
        self.add(tx, local=True)

    def add(self, tx: Transaction, local: bool = False,
            journal: bool = True) -> None:
        with self.mu:
            h = tx.hash()
            if h in self.all:
                raise TxPoolError(ErrAlreadyKnown)
            sender = self._validate(tx, local)
            local = local or self._is_local(sender)
            if local:
                self.locals.add(sender)

            # executable now?
            state_nonce = self.statedb.get_nonce(sender)
            pending_nonce = self.pending_nonces.get(sender, state_nonce)

            # global capacity checks (txpool.go DefaultConfig slots): a
            # replacement never grows the pool, so only new slots count;
            # local txs bypass the caps; a remote overflow evicts the
            # cheapest remote when the newcomer outbids it (pricedList)
            if tx.nonce <= pending_nonce:
                plist = self.pending.setdefault(sender, _TxList())
                is_replacement = plist.get(tx.nonce) is not None
                if (not is_replacement and not local
                        and self._pending_count >= self.config.global_slots
                        and not self._evict_for(tx, self.pending,
                                                self.priced_pending)):
                    raise TxPoolError(ErrUnderpriced + ": pool full")
                inserted, old = plist.add(tx, self.config.price_bump)
                if not inserted:
                    raise TxPoolError(ErrReplaceUnderpriced)
                if not is_replacement:
                    self._pending_count += 1
                if old is not None:
                    self.all.pop(old.hash(), None)
                self.all[h] = tx
                self.pending_nonces[sender] = max(pending_nonce, tx.nonce + 1)
                self._promote(sender)
            else:
                qlist = self.queue.setdefault(sender, _TxList())
                if len(qlist) >= self.config.account_queue:
                    raise TxPoolError(ErrAccountLimitExceeded)
                is_replacement = qlist.get(tx.nonce) is not None
                if (not is_replacement and not local
                        and self._queued_count >= self.config.global_queue
                        and not self._evict_for(tx, self.queue,
                                                self.priced_queued)):
                    raise TxPoolError(ErrAccountLimitExceeded + ": queue full")
                inserted, old = qlist.add(tx, self.config.price_bump)
                if not inserted:
                    raise TxPoolError(ErrReplaceUnderpriced)
                if not is_replacement:
                    self._queued_count += 1
                if old is not None:
                    self.all.pop(old.hash(), None)
                self.all[h] = tx
            if not local:
                heap = (self.priced_pending
                        if tx.nonce <= pending_nonce else self.priced_queued)
                heap.push(tx)
            elif journal and self.journal is not None:
                self.journal.insert(tx)
            for fn in self._tx_feed:
                fn([tx])

    def _promote(self, sender: bytes) -> None:  # guarded-by: mu
        """Move now-sequential queued txs into pending."""
        qlist = self.queue.get(sender)
        if qlist is None:
            return
        next_nonce = self.pending_nonces.get(
            sender, self.statedb.get_nonce(sender)
        )
        for tx in qlist.ready(next_nonce):
            plist = self.pending.setdefault(sender, _TxList())
            was_new = plist.get(tx.nonce) is None
            plist.add(tx, self.config.price_bump)
            if not self._is_local(sender):
                self.priced_pending.push(tx)
            del qlist.items[tx.nonce]
            self._queued_count -= 1
            if was_new:
                self._pending_count += 1
            self.pending_nonces[sender] = tx.nonce + 1
        if qlist.empty():
            self.queue.pop(sender, None)

    # -------------------------------------------------------------- queries

    def get(self, tx_hash: bytes) -> Optional[Transaction]:
        return self.all.get(tx_hash)

    def has(self, tx_hash: bytes) -> bool:
        return tx_hash in self.all

    # fork-scheduled floors (gasprice_update.go gasPriceSetter):
    # SetGasPrice -> the admission tip floor; SetMinFee -> the fee-cap
    # floor (head events re-derive min_fee from the base fee thereafter)

    def set_price_floor(self, price: int) -> None:
        with self.mu:
            self.config.price_limit = price

    def set_min_fee_floor(self, fee: Optional[int]) -> None:
        with self.mu:
            self.min_fee = fee

    def nonce(self, addr: bytes) -> int:
        with self.mu:
            return self.pending_nonces.get(addr, self.statedb.get_nonce(addr))

    def pending_txs(self) -> Dict[bytes, List[Transaction]]:
        """Pending (txpool.go:599): executable txs per account, nonce order."""
        with self.mu:
            out = {}
            for addr, plist in self.pending.items():
                start = self.statedb.get_nonce(addr)
                txs = plist.ready(start)
                if txs:
                    out[addr] = txs
            return out

    def stats(self) -> Tuple[int, int]:
        with self.mu:
            return (
                sum(len(l) for l in self.pending.values()),
                sum(len(l) for l in self.queue.values()),
            )

    def subscribe_new_txs(self, fn) -> None:
        self._tx_feed.append(fn)

    # ---------------------------------------------------------------- reset

    def reset(self, new_head) -> None:
        """Head changed: drop included/stale txs, revalidate balances
        (txpool.go reset path)."""
        with self.mu:
            self.current_head = new_head
            self.statedb = self.chain.state_at(new_head.root)
            self.gas_limit = new_head.gas_limit
            if self.chain_config.is_apricot_phase3(new_head.time):
                from ..consensus.dummy import estimate_next_base_fee

                try:
                    _, self.min_fee = estimate_next_base_fee(
                        self.chain_config, new_head, new_head.time
                    )
                except Exception:
                    count_drop("txpool/reset/base_fee_estimate_error")
                    self.min_fee = None
            for addr in list(self.pending):
                plist = self.pending[addr]
                state_nonce = self.statedb.get_nonce(addr)
                for tx in plist.forward(state_nonce):
                    self.all.pop(tx.hash(), None)
                for tx in plist.filter_cost(
                    self.statedb.get_balance(addr), self.gas_limit
                ):
                    self.all.pop(tx.hash(), None)
                if plist.empty():
                    del self.pending[addr]
                    self.pending_nonces.pop(addr, None)
                else:
                    self.pending_nonces[addr] = max(plist.items) + 1
            for addr in list(self.queue):
                qlist = self.queue[addr]
                for tx in qlist.forward(self.statedb.get_nonce(addr)):
                    self.all.pop(tx.hash(), None)
                if qlist.empty():
                    del self.queue[addr]
            # bulk filtering above bypassed the counters: resync, then
            # promote (which keeps them incremental again)
            self._pending_count = sum(len(l) for l in self.pending.values())
            self._queued_count = sum(len(l) for l in self.queue.values())
            for addr in list(self.queue):
                self._promote(addr)
            # compact the local-tx journal to the survivors (the reference
            # rotates on its reset loop; append-only would grow unbounded)
            self._rotate_journal()
