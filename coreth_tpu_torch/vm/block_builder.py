"""Block-build throttling (semantics of coreth plugin/evm/
block_builder.go:40-155); counterpart of coreth_tpu/vm/block_builder.py.

The engine must be notified exactly once per outstanding build: after a
PendingTxs notification goes out, further tx arrivals stay silent until
the engine actually calls BuildBlock (`build_sent` gate). After a build,
a retry timer re-notifies once the minimum delay passes IF the
pools still hold work — so an engine that drops a notification, or a
mempool that refills immediately, never wedges and never spins."""

from __future__ import annotations

import threading
from typing import Optional

# minBlockBuildingRetryDelay (block_builder.go): floor between notifying
# the engine twice over the same mempool contents
MIN_BLOCK_BUILDING_RETRY_DELAY = 0.5


class BlockBuilder:
    def __init__(self, vm,
                 retry_delay: float = MIN_BLOCK_BUILDING_RETRY_DELAY):
        self.vm = vm
        self.retry_delay = retry_delay
        self.lock = threading.Lock()
        self.build_sent = False
        self._timer: Optional[threading.Timer] = None
        self._shutdown = False
        # observability for tests/metrics
        self.notifications_sent = 0

    # --- inputs -----------------------------------------------------------

    def signal_txs_ready(self) -> None:
        """New work arrived (tx pool feed / gossip / atomic mempool)."""
        with self.lock:
            self._mark_building()

    def handle_generate_block(self) -> None:
        """Called by the VM right after BuildBlock (block_builder.go:90):
        reopen the gate and arm the retry timer."""
        with self.lock:
            self.build_sent = False
            self._set_timer()

    def shutdown(self) -> None:
        with self.lock:
            self._shutdown = True
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None

    # --- internals --------------------------------------------------------

    def need_to_build(self) -> bool:
        """Outstanding work in either pool (block_builder.go:104-108)."""
        vm = self.vm
        pending = 0
        if getattr(vm, "txpool", None) is not None:
            pending = vm.txpool.stats()[0]
        mempool = len(vm.mempool) if getattr(vm, "mempool", None) is not None else 0
        return pending > 0 or mempool > 0

    def _mark_building(self) -> None:  # guarded-by: lock
        if self.build_sent or self._shutdown:
            return  # engine already has an un-consumed notification
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        notify = getattr(self.vm, "to_engine", None)  # live lookup: tests
        # and the node may swap the engine channel after initialize
        if notify is not None:
            try:
                notify()
            except Exception:
                # engine channel full: the retry timer recovers, and the
                # backpressure is countable
                from ..metrics import count_drop

                count_drop("vm/builder/engine_notify_error")
                return
        self.build_sent = True
        self.notifications_sent += 1
        from ..metrics import default_registry

        default_registry.counter("vm/builder/notifications").inc()

    def _set_timer(self) -> None:  # guarded-by: lock
        if self._timer is not None:
            self._timer.cancel()
        if self._shutdown:
            return

        def fire():
            with self.lock:
                self._timer = None
                if self.need_to_build():
                    self._mark_building()

        self._timer = threading.Timer(self.retry_delay, fire)
        self._timer.daemon = True
        self._timer.start()
