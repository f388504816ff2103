"""External signer backend (semantics of coreth accounts/external/
backend.go — the clef remote signer; counterpart of
coreth_tpu/accounts/external.py): private keys live in a SEPARATE signer
daemon; the node forwards account listing and signing requests
over the daemon's JSON-RPC IPC endpoint and never touches key material.

Protocol: the signer's `account_*` JSON-RPC namespace over a unix
socket, newline-delimited JSON (the repo's IPC codec, rpc/server.py
serve_ipc — the same wire shape clef's IPC speaks):

    account_version            -> "x.y.z"
    account_list               -> ["0x<addr>", ...]
    account_signData(mime, addr, "0x<data>")       -> "0x<65B sig>"
    account_signTransaction({tx json, chainId})    -> "0x<signed rlp>"

The returned signed transaction is DECODED and its sender recovered
locally, so a compromised or buggy signer cannot substitute another
account's signature undetected (the reference performs the same
sanity decode on clef's response).

tests/test_torch_accounts.py drives this against the mock signer daemon
of tests/test_external_signer.py (an in-process RPCServer over serve_ipc
backed by a KeyStore): the protocol surface and the trust boundary are
the capability; no clef binary is needed.
"""

from __future__ import annotations

import json
import socket
from typing import List, Optional

from ..core.types import Transaction


class ExternalSignerError(Exception):
    pass


def _hx(b: bytes) -> str:
    return "0x" + b.hex()


def _unhex(s: str) -> bytes:
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


class ExternalSigner:
    """Client for one signer daemon endpoint (a unix socket path)."""

    def __init__(self, endpoint: str, timeout: float = 10.0,
                 cache_ttl: float = 2.0):
        self.endpoint = endpoint
        self.timeout = timeout
        self.cache_ttl = cache_ttl  # account-list cache (the reference
        # backend keeps a cached set too); membership probes must not
        # cost one full-list IPC round trip each
        self._id = 0
        self._acct_cache: Optional[List[bytes]] = None
        self._acct_cache_at = 0.0

    # --- transport (newline-delimited JSON-RPC over a unix socket) -------

    def _call(self, method: str, *params):
        self._id += 1
        payload = json.dumps({"jsonrpc": "2.0", "id": self._id,
                              "method": method,
                              "params": list(params)}).encode() + b"\n"
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.settimeout(self.timeout)
                s.connect(self.endpoint)
                s.sendall(payload)
                buf = b""
                while not buf.endswith(b"\n"):
                    chunk = s.recv(65536)
                    if not chunk:
                        break
                    buf += chunk
        except OSError as e:
            raise ExternalSignerError(
                f"signer daemon unreachable at {self.endpoint}: {e}") from e
        try:
            resp = json.loads(buf)
        except ValueError as e:
            raise ExternalSignerError(f"bad signer response: {e}") from e
        if "error" in resp:
            err = resp["error"]
            msg = err.get("message") if isinstance(err, dict) else err
            raise ExternalSignerError(f"signer rejected {method}: {msg}")
        return resp.get("result")

    # --- backend surface (external/backend.go) ----------------------------

    def version(self) -> str:
        return str(self._call("account_version"))

    def accounts(self) -> List[bytes]:
        """account_list: the addresses the daemon is willing to serve
        (cached for cache_ttl seconds)."""
        import time

        now = time.monotonic()
        if (self._acct_cache is None
                or now - self._acct_cache_at > self.cache_ttl):
            self._acct_cache = [
                _unhex(a) for a in self._call("account_list") or []]
            self._acct_cache_at = now
        return list(self._acct_cache)

    def contains(self, address: bytes) -> bool:
        return address in self.accounts()

    def sign_data(self, address: bytes, data: bytes,
                  mime: str = "text/plain") -> bytes:
        """account_signData: 65-byte [R||S||V] signature over the
        daemon's canonical hash of [data] (clef applies the EIP-191
        prefix for text/plain itself — the node never pre-hashes)."""
        sig = _unhex(self._call("account_signData", mime, _hx(address),
                                _hx(data)))
        if len(sig) != 65:
            raise ExternalSignerError(
                f"signer returned a {len(sig)}-byte signature, want 65")
        return sig

    def sign_tx(self, address: bytes, tx: Transaction,
                chain_id: int) -> Transaction:
        """account_signTransaction: ship the unsigned tx, get the signed
        RLP back, decode and recover the sender locally — a wrong-key
        signature is rejected HERE, not trusted."""
        obj = {
            "from": _hx(address),
            "to": _hx(tx.to) if tx.to else None,
            "gas": hex(tx.gas),
            "nonce": hex(tx.nonce),
            "value": hex(tx.value),
            "input": _hx(tx.data or b""),
            "chainId": hex(chain_id),
            "type": hex(tx.type),
        }
        if tx.type in (0, 1):  # legacy AND EIP-2930 price via gasPrice
            obj["gasPrice"] = hex(tx.gas_price)
        else:
            obj["maxFeePerGas"] = hex(tx.max_fee)
            obj["maxPriorityFeePerGas"] = hex(tx.max_priority_fee)
        if tx.type in (1, 2) and tx.access_list:
            # the access list is part of the signed payload: dropping it
            # would make the daemon sign a DIFFERENT transaction that
            # still recovers the right sender — ship it and let the
            # decode round-trip prove it survived
            obj["accessList"] = [
                {"address": _hx(addr),
                 "storageKeys": [_hx(k) for k in keys]}
                for addr, keys in tx.access_list
            ]
        from ..core.types import Signer

        raw = _unhex(self._call("account_signTransaction", obj))
        signed = Transaction.decode(raw)
        sender = Signer(chain_id).sender(signed)
        if sender != address:
            raise ExternalSignerError(
                f"signer returned a transaction from {_hx(sender)}, "
                f"requested {_hx(address)}")
        # sender recovery alone cannot catch a daemon that signed a
        # DIFFERENT payload with the right key — diff the core fields
        def core(t):
            fees = ((t.gas_price,) if t.type in (0, 1)
                    else (t.max_fee, t.max_priority_fee))
            return (t.type, t.nonce, t.gas, t.to, t.value, t.data or b"",
                    list(t.access_list), fees)

        if core(signed) != core(tx):
            raise ExternalSignerError(
                "signer altered the transaction payload")
        return signed


class ExternalBackend:
    """accounts.Backend shape over one ExternalSigner (the piece
    accounts/manager.py aggregates alongside the keystore)."""

    def __init__(self, signer: ExternalSigner):
        self.signer = signer

    def accounts(self) -> List["object"]:
        from .keystore import Account

        return [Account(a, url=f"extapi://{self.signer.endpoint}")
                for a in self.signer.accounts()]

    def find(self, address: bytes) -> Optional["object"]:
        from .keystore import Account

        if self.signer.contains(address):
            return Account(address, url=f"extapi://{self.signer.endpoint}")
        return None
