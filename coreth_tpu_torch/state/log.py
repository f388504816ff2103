"""`Log`, an EVM log record; counterpart of coreth_tpu/state/log.py."""

from __future__ import annotations

from typing import List


class Log:
    __slots__ = (
        "address", "topics", "data", "block_number", "tx_hash", "tx_index",
        "block_hash", "index",
    )

    def __init__(self, address: bytes, topics: List[bytes], data: bytes):
        self.address = address
        self.topics = topics
        self.data = data
        self.block_number = 0
        self.tx_hash = b"\x00" * 32
        self.tx_index = 0
        self.block_hash = b"\x00" * 32
        self.index = 0
