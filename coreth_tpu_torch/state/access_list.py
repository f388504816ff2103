"""EIP-2930 access list (semantics of coreth core/state/access_list.go);
counterpart of coreth_tpu/state/access_list.py."""

from __future__ import annotations

from typing import Dict, Set, Tuple


class AccessList:
    def __init__(self):
        self.addresses: Dict[bytes, int] = {}  # addr -> slot-set index or -1
        self.slots: list[Set[bytes]] = []

    def contains_address(self, addr: bytes) -> bool:
        return addr in self.addresses

    def contains(self, addr: bytes, slot: bytes) -> Tuple[bool, bool]:
        idx = self.addresses.get(addr)
        if idx is None:
            return False, False
        if idx == -1:
            return True, False
        return True, slot in self.slots[idx]

    def add_address(self, addr: bytes) -> bool:
        if addr in self.addresses:
            return False
        self.addresses[addr] = -1
        return True

    def add_slot(self, addr: bytes, slot: bytes) -> Tuple[bool, bool]:
        idx = self.addresses.get(addr)
        if idx is None:
            self.addresses[addr] = len(self.slots)
            self.slots.append({slot})
            return True, True
        if idx == -1:
            self.addresses[addr] = len(self.slots)
            self.slots.append({slot})
            return False, True
        if slot in self.slots[idx]:
            return False, False
        self.slots[idx].add(slot)
        return False, True

    def delete_address(self, addr: bytes) -> None:
        self.addresses.pop(addr, None)

    def delete_slot(self, addr: bytes, slot: bytes) -> None:
        idx = self.addresses.get(addr)
        if idx is not None and idx != -1:
            self.slots[idx].discard(slot)

    def copy(self) -> "AccessList":
        a = AccessList()
        a.addresses = dict(self.addresses)
        a.slots = [set(s) for s in self.slots]
        return a
