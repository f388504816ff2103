"""RPC client (semantics of coreth ethclient/ + corethclient —
accepted-head semantics); counterpart of coreth_tpu/ethclient/__init__.py.
Speaks JSON-RPC over HTTP or directly against an in-process RPCServer:
raw calls, raw batches and the typed surface of ethclient.go. The
WebSocket client with push subscriptions is ethclient/ws.py."""

from __future__ import annotations

import json
import urllib.request
from typing import Any, List, Optional

from ..core.types import Transaction


class ClientError(Exception):
    def __init__(self, code, message, data=None):
        super().__init__(message)
        self.code = code
        self.data = data


class Client:
    def __init__(self, url: str = "", server=None):
        """Either an HTTP url or an in-process RPCServer."""
        self.url = url
        self.server = server
        self._id = 0

    def _post(self, payload: bytes) -> Any:
        if self.server is not None:
            return json.loads(self.server.handle_raw(payload))
        req = urllib.request.Request(
            self.url, data=payload,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read())

    def _request(self, method: str, params) -> dict:
        self._id += 1
        return {"jsonrpc": "2.0", "id": self._id, "method": method,
                "params": list(params)}

    @staticmethod
    def _result(out: dict) -> Any:
        if "error" in out:
            e = out["error"]
            raise ClientError(e.get("code"), e.get("message"), e.get("data"))
        return out["result"]

    def call_raw(self, method: str, *params) -> Any:
        return self._result(self._post(json.dumps(
            self._request(method, params)).encode()))

    def batch_raw(self, calls) -> List[Any]:
        """One JSON-RPC batch of (method, params) pairs; the results in
        the calls' order. Any error object raises ClientError."""
        reqs = [self._request(m, p) for m, p in calls]
        out = self._post(json.dumps(reqs).encode())
        if isinstance(out, dict):  # the whole batch refused
            self._result(out)
        by_id = {r.get("id"): r for r in out}
        return [self._result(by_id[r["id"]]) for r in reqs]

    # --- typed surface (ethclient.go) -------------------------------------

    def chain_id(self) -> int:
        return int(self.call_raw("eth_chainId"), 16)

    def block_number(self) -> int:
        return int(self.call_raw("eth_blockNumber"), 16)

    def balance_at(self, address: bytes, block: str = "latest") -> int:
        return int(self.call_raw("eth_getBalance", "0x" + address.hex(), block), 16)

    def asset_balance_at(self, address: bytes, asset_id: bytes,
                         block: str = "latest") -> int:
        return int(self.call_raw(
            "eth_getAssetBalance", "0x" + address.hex(), block,
            "0x" + asset_id.hex(),
        ), 16)

    def nonce_at(self, address: bytes, block: str = "latest") -> int:
        return int(self.call_raw(
            "eth_getTransactionCount", "0x" + address.hex(), block), 16)

    def code_at(self, address: bytes, block: str = "latest") -> bytes:
        return bytes.fromhex(self.call_raw(
            "eth_getCode", "0x" + address.hex(), block)[2:])

    def storage_at(self, address: bytes, slot: int, block: str = "latest") -> bytes:
        return bytes.fromhex(self.call_raw(
            "eth_getStorageAt", "0x" + address.hex(), hex(slot), block)[2:])

    def send_transaction(self, tx: Transaction) -> bytes:
        out = self.call_raw("eth_sendRawTransaction", "0x" + tx.encode().hex())
        return bytes.fromhex(out[2:])

    def transaction_receipt(self, tx_hash: bytes) -> Optional[dict]:
        return self.call_raw("eth_getTransactionReceipt", "0x" + tx_hash.hex())

    def block_by_number(self, number: Optional[int] = None, full: bool = False) -> Optional[dict]:
        tag = "latest" if number is None else hex(number)
        return self.call_raw("eth_getBlockByNumber", tag, full)

    def call_contract(self, call_obj: dict, block: str = "latest") -> bytes:
        out = self.call_raw("eth_call", call_obj, block)
        return bytes.fromhex(out[2:])

    def estimate_gas(self, call_obj: dict) -> int:
        return int(self.call_raw("eth_estimateGas", call_obj), 16)

    def suggest_gas_price(self) -> int:
        return int(self.call_raw("eth_gasPrice"), 16)

    def get_logs(self, criteria: dict) -> List[dict]:
        return self.call_raw("eth_getLogs", criteria)


def ws_connect(host: str, port: int, timeout: float = 10.0):
    """Open a WebSocket client with subscription support
    (ethclient.go Dial + Subscribe*): returns ethclient.ws.WSEthClient,
    whose subscribe_new_heads()/subscribe_logs() consume the server's
    push stream while plain request() calls share the connection."""
    from .ws import WSEthClient

    return WSEthClient(host, port, timeout=timeout)
