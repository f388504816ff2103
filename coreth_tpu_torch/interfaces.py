"""Public client-facing interfaces (semantics of coreth interfaces/
interfaces.go — the typed contracts go-ethereum callers program against,
trimmed to coreth's accepted-head semantics); counterpart of
coreth_tpu/interfaces.py.

Python rendering: `typing.Protocol` (structural), so any object with the
right methods satisfies them — `ethclient.Client` and `accounts.bind`'s
BoundContract are checked against these in tests without inheriting."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Protocol, runtime_checkable


@runtime_checkable
class ChainReader(Protocol):
    """interfaces.ChainReader: canonical block access (accepted head)."""

    def block_by_number(self, number: Optional[int] = None,
                        full: bool = False) -> Optional[dict]: ...

    def block_number(self) -> int: ...


@runtime_checkable
class ChainStateReader(Protocol):
    """interfaces.ChainStateReader: account state at a block tag."""

    def balance_at(self, address: bytes, block: str = "latest") -> int: ...

    def nonce_at(self, address: bytes, block: str = "latest") -> int: ...

    def code_at(self, address: bytes, block: str = "latest") -> bytes: ...

    def storage_at(self, address: bytes, slot: int,
                   block: str = "latest") -> bytes: ...


@runtime_checkable
class TransactionSender(Protocol):
    """interfaces.TransactionSender."""

    def send_transaction(self, tx) -> bytes: ...


@runtime_checkable
class ContractCaller(Protocol):
    """interfaces.ContractCaller: constant execution."""

    def call_contract(self, call_obj: Dict[str, Any],
                      block: str = "latest") -> bytes: ...


@runtime_checkable
class GasEstimator(Protocol):
    """interfaces.GasEstimator + GasPricer."""

    def estimate_gas(self, call_obj: Dict[str, Any]) -> int: ...

    def suggest_gas_price(self) -> int: ...


@runtime_checkable
class LogFilterer(Protocol):
    """interfaces.LogFilterer (poll form; push lives on the WS client)."""

    def get_logs(self, criteria: Dict[str, Any]) -> List[dict]: ...


@runtime_checkable
class TransactionReader(Protocol):
    """interfaces.TransactionReader."""

    def transaction_receipt(self, tx_hash: bytes) -> Optional[dict]: ...
