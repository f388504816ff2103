"""Sectioned bloom-bit index for historical log search (semantics of
coreth core/bloombits/ + core/bloom_indexer.go); counterpart of
coreth_tpu/core/bloom_index.py.

The reference builds, per 4096-block section, a transposed bitmap: for
each of the 2048 bloom bits, one 4096-bit row saying which blocks in the
section set that bit. A log filter then ANDs three rows per probed value
(a bloom match needs all 3 of its bits) and ORs across alternatives —
turning a per-block header walk into a handful of 512-byte row reads and
vectorized bit ops.

That transpose-then-AND shape is exactly a batched bit-matrix problem, so
the build and query here are numpy u64 ops end to end (rows pack into
uint64[64] vectors) — one `packbits` transpose per section instead of the
reference's per-bit generator loop (bloombits/generator.go).

Storage schema (core/rawdb/schema.go bloomBitsPrefix analog):
    b"B" + section(u32 BE) + bit(u16 BE) -> 512-byte row
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from .types import bloom_bits

SECTION_SIZE = 4096  # bloom_indexer.go BloomBitsBlocks
BLOOM_BITS = 2048

BLOOM_BITS_PREFIX = b"B"


def _row_key(section: int, bit: int) -> bytes:
    return BLOOM_BITS_PREFIX + section.to_bytes(4, "big") + bit.to_bytes(2, "big")


class BloomIndexer:
    """Accumulates accepted-header blooms; at each section boundary the
    2048x4096 transpose lands in the database (bloom_indexer.go Process/
    Commit). Query serves candidate block offsets for a parsed filter."""

    def __init__(self, diskdb, section_size: int = SECTION_SIZE):
        if section_size <= 0 or section_size % 8:
            raise ValueError(
                f"bloom section size {section_size} is not a positive "
                "multiple of 8")
        self.diskdb = diskdb
        self.section_size = section_size
        self._row_bytes = section_size // 8
        self._section: Optional[int] = None
        # [section_size, 256] uint8 — raw bloom bytes per block in section
        self._blooms = np.zeros((section_size, 256), np.uint8)
        self._filled = np.zeros(section_size, bool)

    # --- build --------------------------------------------------------------

    def add_block(self, number: int, bloom: bytes) -> None:
        """Feed an accepted header (in order); commits a finished section."""
        section, offset = divmod(number, self.section_size)
        if self._section is None:
            self._section = section
        if section != self._section:
            self._section = section
            self._blooms[:] = 0
            self._filled[:] = False
        self._blooms[offset] = np.frombuffer(bloom, np.uint8)
        self._filled[offset] = True
        if offset == self.section_size - 1 and self._filled.all():
            self.commit_section(section, self._blooms)

    def commit_section(self, section: int, blooms: np.ndarray) -> None:
        """One vectorized transpose: uint8[section, 256] -> 2048 rows of
        section/8 bytes, written in one batch."""
        # bits[block, bit] — bloom bit b of a 256-byte bloom is bit
        # (7 - b%8) of byte b//8... unpackbits yields MSB-first, which IS
        # ethereum's bloom bit order (types.bloom_bits indexes from the
        # byte's high bit), so a straight unpack lines up
        bits = np.unpackbits(blooms, axis=1)          # [4096, 2048]
        rows = np.packbits(bits.T, axis=1)            # [2048, 512]
        batch = self.diskdb.new_batch()
        for bit in range(BLOOM_BITS):
            batch.put(_row_key(section, bit), rows[bit].tobytes())
        batch.write()

    def has_section(self, section: int) -> bool:
        return self.diskdb.get(_row_key(section, 0)) is not None

    # --- query ----------------------------------------------------------------

    def _row(self, section: int, bit: int) -> Optional[np.ndarray]:
        blob = self.diskdb.get(_row_key(section, bit))
        if blob is None:
            return None
        return np.frombuffer(blob, np.uint8)

    def candidates(self, section: int,
                   groups: Sequence[Sequence[bytes]]) -> Optional[np.ndarray]:
        """groups: conjunction of alternatives — [[addr1, addr2], [topicA]]
        means (addr1 OR addr2) AND topicA, matching filter semantics.
        Returns block offsets within the section that MAY match, or None
        if the section is not indexed."""
        acc = np.full(self._row_bytes, 0xFF, np.uint8)
        for group in groups:
            if not group:
                continue
            group_acc = np.zeros(self._row_bytes, np.uint8)
            for value in group:
                val_acc = np.full(self._row_bytes, 0xFF, np.uint8)
                for bit in bloom_bits(value):
                    # types.bloom_bits returns the geth bit index within
                    # the 2048-bit filter (counted from the LOW end)
                    row = self._row(section, BLOOM_BITS - 1 - bit)
                    if row is None:
                        return None
                    val_acc &= row
                group_acc |= val_acc
            acc &= group_acc
        return np.nonzero(np.unpackbits(acc))[0]


def filter_groups(crit: dict) -> List[List[bytes]]:
    """Parsed filter criteria -> conjunction groups for candidates()."""
    groups: List[List[bytes]] = []
    if crit.get("addresses"):
        groups.append(list(crit["addresses"]))
    for t in crit.get("topics", []):
        if t is None:
            continue
        groups.append(list(t) if isinstance(t, list) else [t])
    return groups
