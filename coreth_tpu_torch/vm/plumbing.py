"""Small VM plumbing: fork-scheduled gas-price floors (semantics of coreth
plugin/evm/gasprice_update.go); counterpart of coreth_tpu/vm/plumbing.py.

Not ported: the static genesis-builder service, the ext-data-hash repair
table and the VM factory (StaticService, load_ext_data_hashes,
repaired_ext_data_hash, factory_new), which belong to the plugin (ROADMAP
"Still to port", item 10).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Tuple

from .. import params


class GasPriceUpdater:
    """gasprice_update.go: set the tx pool's gas-price floor to the
    launch minimum, then step it at each fork activation — immediately
    for forks already active, via a timer for future ones. stop() cancels
    pending timers (the shutdownChan analog)."""

    def __init__(self, txpool, chain_config, clock: Callable[[], float] = time.time):
        self.txpool = txpool
        self.config = chain_config
        self.clock = clock
        self._timers: List[threading.Timer] = []

    def start(self) -> None:
        self.txpool.set_price_floor(params.LAUNCH_MIN_GAS_PRICE)
        steps: List[Tuple[Optional[int], str, int]] = [
            (self.config.apricot_phase1_time, "price",
             params.APRICOT_PHASE1_MIN_GAS_PRICE),
            (self.config.apricot_phase3_time, "price", 0),
            (self.config.apricot_phase3_time, "min_fee",
             params.APRICOT_PHASE3_MIN_BASE_FEE),
            (self.config.apricot_phase4_time, "min_fee",
             params.APRICOT_PHASE4_MIN_BASE_FEE),
        ]
        for ts, kind, value in steps:
            if ts is None:
                return  # later forks can't be scheduled either (gpu.start)
            self._schedule(ts, kind, value)

    def _apply(self, kind: str, value: int) -> None:
        if kind == "price":
            self.txpool.set_price_floor(value)
        else:
            self.txpool.set_min_fee_floor(value)

    def _schedule(self, ts: int, kind: str, value: int) -> None:
        delay = ts - self.clock()
        if delay <= 0:
            self._apply(kind, value)
            return
        t = threading.Timer(delay, lambda: self._apply(kind, value))
        t.daemon = True
        self._timers.append(t)
        t.start()

    def stop(self) -> None:
        for t in self._timers:
            t.cancel()
        self._timers.clear()
