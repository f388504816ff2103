"""Transaction gossip (semantics of coreth plugin/evm/gossiper.go);
counterpart of coreth_tpu/vm/gossiper.py, with the same payload bytes.

Gossips new eth/atomic txs to peers and handles inbound gossip into the
pools; a regossip loop re-broadcasts the highest-tip pending txs on a
ticker (gossiper.go:223-241,423-523). The knobs are the node config's
regossip-frequency and regossip-max-txs.

Where the port departs from the reference (ROADMAP Queue 3), as
peer/transport.py's TransportServer.stop does: stop() sets the ticker's
event and joins the regossip thread; the reference sets the event and
joins nothing.
"""

from __future__ import annotations

import threading
from typing import List, Optional

from .. import rlp
from ..core.types import Transaction
from ..metrics import count_drop
from .atomic_tx import decode_tx

GOSSIP_ETH_TXS = 0
GOSSIP_ATOMIC_TX = 1

REGOSSIP_INTERVAL = 60.0     # gossiper.go regossipFrequency
MAX_TXS_PER_GOSSIP = 16
STOP_JOIN_SECONDS = 5.0      # stop()'s budget for the regossip thread


def encode_tx_gossip(txs: List[Transaction]) -> bytes:
    return bytes([GOSSIP_ETH_TXS]) + rlp.encode([t.encode() for t in txs])


def encode_atomic_gossip(tx) -> bytes:
    return bytes([GOSSIP_ATOMIC_TX]) + tx.encode()


class Gossiper:
    def __init__(self, vm, network):
        self.vm = vm
        self.network = network
        # regossip knobs from the node config (config.go regossip-*)
        full = getattr(vm, "full_config", None)
        self.regossip_interval = getattr(
            full, "regossip_frequency", REGOSSIP_INTERVAL)
        self.regossip_max_txs = getattr(
            full, "regossip_max_txs", MAX_TXS_PER_GOSSIP)
        self._recently_gossiped: set = set()
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._regossip_thread: Optional[threading.Thread] = None

        network.subscribe_gossip(self.handle_gossip)
        vm.txpool.subscribe_new_txs(self.gossip_new_txs)

    # --- outbound ---------------------------------------------------------

    def gossip_new_txs(self, txs: List[Transaction]) -> None:
        """GossipEthTxs (gossiper.go:479): fan out fresh pool entries."""
        fresh = []
        with self._lock:
            for t in txs:
                h = t.hash()
                if h not in self._recently_gossiped:
                    self._recently_gossiped.add(h)
                    fresh.append(t)
            if len(self._recently_gossiped) > 4096:
                self._recently_gossiped = set(
                    list(self._recently_gossiped)[-2048:])
        for i in range(0, len(fresh), MAX_TXS_PER_GOSSIP):
            self.network.gossip(
                encode_tx_gossip(fresh[i:i + MAX_TXS_PER_GOSSIP]))

    def gossip_atomic_tx(self, tx) -> None:
        self.network.gossip(encode_atomic_gossip(tx))

    def start_regossip(self) -> None:
        """Regossip ticker (gossiper.go:223-241)."""

        def loop():
            while not self._stop.wait(self.regossip_interval):
                self.regossip()

        self._regossip_thread = threading.Thread(
            target=loop, name="gossip-regossip", daemon=True)
        self._regossip_thread.start()

    def regossip(self) -> None:
        pending = self.vm.txpool.pending_txs()
        best: List[Transaction] = []
        for txs in pending.values():
            if txs:
                best.append(txs[0])  # lowest-nonce executable per account
        best.sort(key=lambda t: -t.gas_tip_cap)
        if best:
            self.network.gossip(
                encode_tx_gossip(best[:self.regossip_max_txs]))

    def stop(self) -> None:
        """Stop the ticker and join its thread (a regossip in flight ends
        within the network's gossip deadline)."""
        self._stop.set()
        t, self._regossip_thread = self._regossip_thread, None
        if t is not None and t is not threading.current_thread():
            t.join(timeout=STOP_JOIN_SECONDS)

    # --- inbound ----------------------------------------------------------

    def handle_gossip(self, sender: bytes, payload: bytes) -> None:
        """GossipHandler.HandleEthTxs/HandleAtomicTx (gossiper.go:423-479).

        Drops are never fatal but always counted: gossip/drops/<reason>
        meters make a peer spraying malformed or unacceptable txs
        visible."""

        def drop(reason: str):
            count_drop(f"gossip/drops/{reason}")

        if not payload:
            drop("empty")
            return
        kind, body = payload[0], payload[1:]
        try:
            if kind == GOSSIP_ETH_TXS:
                for blob in rlp.decode(body):
                    tx = Transaction.decode(
                        bytes(blob) if not isinstance(blob, list)
                        else rlp.encode(blob))
                    try:
                        self.vm.txpool.add_remote(tx)
                    except Exception:
                        drop("eth_tx_rejected")
            elif kind == GOSSIP_ATOMIC_TX:
                tx = decode_tx(body)
                try:
                    tx.semantic_verify(self.vm, self.vm._next_base_fee())
                    self.vm.mempool.add(tx)
                except Exception:
                    drop("atomic_tx_rejected")
            else:
                drop("unknown_kind")
        except Exception:
            drop("malformed")
