"""RPC client (semantics of coreth ethclient/ + corethclient —
accepted-head semantics); counterpart of coreth_tpu/ethclient/__init__.py.
Speaks JSON-RPC over HTTP: raw calls, raw batches and block_number. The
reference's typed methods and its in-process mode come when a caller
needs them (the chaos workload, ROADMAP item 8b); the WebSocket client
(ethclient/ws.py) is not ported (item 10b)."""

from __future__ import annotations

import json
import urllib.request
from typing import Any, List


class ClientError(Exception):
    def __init__(self, code, message, data=None):
        super().__init__(message)
        self.code = code
        self.data = data


class Client:
    def __init__(self, url: str):
        self.url = url
        self._id = 0

    def _post(self, payload: bytes) -> Any:
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

    def block_number(self) -> int:
        return int(self.call_raw("eth_blockNumber"), 16)


def ws_connect(host: str, port: int, timeout: float = 10.0):
    """A WebSocket client with subscription support (ethclient.go Dial +
    Subscribe*). Not ported: ethclient/ws.py comes with ROADMAP "Still to
    port", item 10b."""
    raise NotImplementedError(
        "ws_connect is not ported (ROADMAP 'Still to port', item 10b: "
        "ethclient/ws.py)")
