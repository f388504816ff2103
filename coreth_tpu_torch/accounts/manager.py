"""Event-driven wallet registry (semantics of coreth accounts/manager.go
+ keystore's watch.go directory watcher); counterpart of
coreth_tpu/accounts/manager.py.

The Manager aggregates backends (today: KeyStore), serves wallet/account
lookup, and pushes WalletEvent notifications (arrived/dropped) to
subscribers. The keystore directory is watched by polling mtimes —
inotify isn't in the stdlib, and the reference itself falls back to
polling where fsnotify is unavailable."""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from .keystore import Account, KeyStore

WALLET_ARRIVED = "arrived"
WALLET_DROPPED = "dropped"


@dataclass
class WalletEvent:
    kind: str          # WALLET_ARRIVED | WALLET_DROPPED
    account: Account


class Manager:
    """accounts.Manager: backends + subscription fan-out."""

    def __init__(self, keystore: Optional[KeyStore] = None,
                 poll_interval: float = 1.0, external=None):
        self.keystore = keystore
        # optional remote-signer backend (accounts/external.py
        # ExternalBackend — the clef shape): its accounts merge into
        # listing/lookup; signing goes through the daemon, never here
        self.external = external
        self.poll_interval = poll_interval
        self._subs: List[Callable[[WalletEvent], None]] = []
        self._known: Dict[bytes, Account] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if keystore is not None:
            for acct in keystore.accounts():
                self._known[acct.address] = acct

    # --- queries ----------------------------------------------------------

    def accounts(self) -> List[Account]:
        with self._lock:
            out = dict(self._known)
        if self.external is not None:
            try:
                for acct in self.external.accounts():
                    out.setdefault(acct.address, acct)
            except Exception:
                # daemon down: keystore accounts still serve, but the
                # silent degradation must be countable (clef operators
                # otherwise discover it from missing accounts)
                from ..metrics import count_drop

                count_drop("accounts/external/list_error")
        return sorted(out.values(), key=lambda a: a.address)

    def find(self, address: bytes) -> Optional[Account]:
        with self._lock:
            acct = self._known.get(address)
        if acct is None and self.external is not None:
            try:
                acct = self.external.find(address)
            except Exception:
                # daemon down: same countable degradation as list()
                from ..metrics import count_drop

                count_drop("accounts/external/find_error")
                acct = None
        return acct

    # --- events -----------------------------------------------------------

    def subscribe(self, fn: Callable[[WalletEvent], None]) -> Callable[[], None]:
        """Register an event sink; returns the unsubscribe fn."""
        with self._lock:
            self._subs.append(fn)

        def cancel():
            with self._lock:
                if fn in self._subs:
                    self._subs.remove(fn)

        return cancel

    def _emit(self, ev: WalletEvent) -> None:
        with self._lock:
            subs = list(self._subs)
        for fn in subs:
            try:
                fn(ev)
            except Exception:
                # one bad subscriber must not starve the rest — but a
                # permanently throwing sink is an operator bug to surface
                from ..metrics import count_drop

                count_drop("accounts/subscriber_error")

    # --- directory watch --------------------------------------------------

    def start_watching(self) -> "Manager":
        if self.keystore is None or self._thread is not None:
            return self
        self._thread = threading.Thread(target=self._watch_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def refresh(self) -> None:
        """One reconcile pass: diff the keystore dir against known
        accounts, emitting arrived/dropped events."""
        try:
            current = {a.address: a for a in self.keystore.accounts()}
        except OSError:
            return
        with self._lock:
            known = dict(self._known)
            self._known = current
        for addr, acct in current.items():
            if addr not in known:
                self._emit(WalletEvent(WALLET_ARRIVED, acct))
        for addr, acct in known.items():
            if addr not in current:
                self._emit(WalletEvent(WALLET_DROPPED, acct))

    def _watch_loop(self) -> None:
        last_sig = None
        while not self._stop.wait(self.poll_interval):
            sig = self._dir_signature()
            if sig != last_sig:
                last_sig = sig
                self.refresh()

    def _dir_signature(self):
        try:
            entries = sorted(os.listdir(self.keystore.keydir))
            return tuple(
                (e, os.path.getmtime(os.path.join(self.keystore.keydir, e)))
                for e in entries
            )
        except OSError:
            return None
