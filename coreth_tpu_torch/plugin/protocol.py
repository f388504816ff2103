"""Wire protocol for the out-of-process VM boundary (the role of coreth's
rpcchainvm plugin transport, plugin/main.go:33 rpcchainvm.Serve);
counterpart of coreth_tpu/plugin/protocol.py, with the same bytes.

The consensus engine and the VM live in different processes and speak
the snowman interface over a unix socket. The framing is minimal —
length-prefixed JSON with binary fields hex-encoded — because the point
of the boundary is process isolation and interface serialization, not
RPC framework parity.

Frame:  u32 BE payload_len | payload (UTF-8 JSON object)
Request:  {"id": n, "method": str, "params": {...}}
Response: {"id": n, "result": {...}} | {"id": n, "error": str}
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Optional

_MAX_FRAME = 64 * 1024 * 1024


class ProtocolError(Exception):
    pass


def b2h(b: Optional[bytes]) -> Optional[str]:
    return None if b is None else "0x" + b.hex()


def h2b(s: Optional[str]) -> Optional[bytes]:
    if s is None:
        return None
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


def send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    if len(data) > _MAX_FRAME:
        raise ProtocolError(f"frame too large ({len(data)} bytes)")
    sock.sendall(struct.pack(">I", len(data)) + data)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ProtocolError("connection closed")
        buf += chunk
    return buf


def recv_msg(sock: socket.socket) -> dict:
    (n,) = struct.unpack(">I", _read_exact(sock, 4))
    if n > _MAX_FRAME:
        raise ProtocolError(f"frame too large ({n} bytes)")
    return json.loads(_read_exact(sock, n).decode())
