"""Snowman consensus Block wrapper (semantics of coreth plugin/evm/
block.go); counterpart of coreth_tpu/vm/block.py.

Wraps a chain Block with the consensus lifecycle: Verify inserts into the
BlockChain without marking canonical-final (block.go:229-253), Accept
finalizes through the acceptor queue + atomic shared-memory commit
(:136-169), Reject drops trie refs and re-queues atomic txs (:173-191).
"""

from __future__ import annotations

from enum import Enum


class BlockStatus(Enum):
    PROCESSING = 0
    ACCEPTED = 1
    REJECTED = 2


class VMBlock:
    def __init__(self, vm, eth_block):
        self.vm = vm
        self.eth_block = eth_block
        self.status = BlockStatus.PROCESSING
        self.atomic_txs = []
        if eth_block.ext_data:
            from .atomic_tx import extract_atomic_txs

            self.atomic_txs = extract_atomic_txs(
                eth_block.ext_data,
                batch=vm.chain_config.is_apricot_phase5(eth_block.time),
                codec=vm.atomic_codec,
            )

    # --- identity ---------------------------------------------------------

    def id(self) -> bytes:
        return self.eth_block.hash()

    def parent_id(self) -> bytes:
        return self.eth_block.parent_hash

    def height(self) -> int:
        return self.eth_block.number

    def timestamp(self) -> int:
        return self.eth_block.time

    def bytes(self) -> bytes:
        return self.eth_block.encode()

    # --- lifecycle --------------------------------------------------------

    def verify(self, writes: bool = True) -> None:
        """Verify (block.go:229-253): syntactic checks + InsertBlockManual
        + pinning the block's pending atomic state (atomic_backend.go)."""
        self.syntactic_verify()
        for atx in self.atomic_txs:
            atx.semantic_verify(self.vm, self.eth_block.base_fee)
        if writes:
            # conflict-check against pending ancestors BEFORE the chain
            # insert so a double-spending fork never lands in the chain
            self.vm.atomic_backend.insert_block(self)
        try:
            self.vm.blockchain.insert_block_manual(self.eth_block, writes)
        except Exception:
            if writes:
                self.vm.atomic_backend.reject(self)
            raise
        if writes:
            self.vm.add_verified_block(self)

    def syntactic_verify(self) -> None:
        from .block_verification import syntactic_verify

        syntactic_verify(self.vm, self)

    def accept(self) -> None:
        """Accept (block.go:136-169): chain accept + the block's pending
        atomic state applied in one repository/shared-memory batch."""
        vm = self.vm
        vm.blockchain.accept(self.eth_block)
        self.status = BlockStatus.ACCEPTED
        vm.set_last_accepted(self)
        vm.atomic_backend.accept(self)
        vm.forget_verified_block(self.id())

    def reject(self) -> None:
        """Reject (block.go:173-191): losing fork; re-issue atomic txs."""
        vm = self.vm
        vm.atomic_backend.reject(self)
        for atx in self.atomic_txs:
            try:
                vm.mempool.add(atx, force=True)
            except Exception:
                # re-issue is best-effort (block.go Reject logs and moves
                # on); the chain-level reject must still run
                from ..metrics import count_drop

                count_drop("vm/block/reject_reissue_error")
        vm.blockchain.reject(self.eth_block)
        self.status = BlockStatus.REJECTED
        vm.forget_verified_block(self.id())
