"""Small VM plumbing: fork-scheduled gas-price floors, the static
genesis-builder service, the ext-data-hash repair table and the VM
factory (semantics of coreth plugin/evm/{gasprice_update,static_service,
ext_data_hashes,factory}.go); counterpart of coreth_tpu/vm/plumbing.py.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

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


class StaticService:
    """static_service.go: BuildGenesis — marshal a genesis spec to the
    hex blob Initialize takes, with no chain running."""

    def buildGenesis(self, genesis_obj: dict) -> dict:
        blob = json.dumps(genesis_obj, sort_keys=True).encode()
        return {"bytes": "0x" + blob.hex(), "encoding": "hex"}


# ext_data_hashes.go: on fuji/mainnet some historical blocks carry an
# ExtDataHash that must map to a REPAIRED hash (bonus-block cleanup).
# The reference embeds network-specific JSON; networks without a list
# (test/local) ban nothing.
_ext_data_hashes: Dict[int, Dict[bytes, bytes]] = {}


def load_ext_data_hashes(network_id: int, raw_json: bytes) -> None:
    """Install a network's {extDataHash: repairedHash} map (the go:embed
    fuji/mainnet JSON analog; hex-keyed)."""
    table = {
        bytes.fromhex(k.removeprefix("0x")): bytes.fromhex(
            v.removeprefix("0x"))
        for k, v in json.loads(raw_json).items()
    }
    _ext_data_hashes[network_id] = table


def repaired_ext_data_hash(network_id: int, h: bytes) -> Optional[bytes]:
    """The repaired hash for [h] on [network_id], or None if unmapped."""
    return _ext_data_hashes.get(network_id, {}).get(h)


def factory_new(**initialize_kwargs):
    """factory.go Factory.New: construct an uninitialized VM (the node
    calls Initialize separately); kwargs pre-bind Initialize args for
    test harnesses."""
    from .vm import VM

    vm = VM()
    if initialize_kwargs:
        vm.initialize(**initialize_kwargs)
    return vm
