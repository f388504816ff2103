"""Gas price oracle (semantics of coreth eth/gasprice/{gasprice,
feehistory}.go + fee_info_provider.go's accepted-header cache);
counterpart of coreth_tpu/eth/gasprice.py.

Suggests tips from the percentile of effective tips over recent accepted
blocks; feeHistory reports base fees / gas ratios / reward percentiles.
"""

from __future__ import annotations

from typing import List

from .. import params
from ..consensus.dummy import estimate_next_base_fee
from ..metrics import count_drop
from .cache import BoundedCache

CHECK_BLOCKS = 20
PERCENTILE = 60
MAX_LOOKBACK = 2048
CACHE_SIZE = 8


class Oracle:
    def __init__(self, backend, check_blocks: int = CHECK_BLOCKS,
                 percentile: int = PERCENTILE, cache_size: int = CACHE_SIZE):
        self.b = backend
        self.check_blocks = check_blocks
        self.percentile = percentile
        # tips are a pure function of the accepted head (the walk only
        # touches accepted ancestors, which never change under a hash),
        # so the head hash is a complete cache key; a reorg of the
        # preference tip cannot stale it (gasprice-cache-size knob)
        self._tips_cache = BoundedCache("gasprice", cache_size)

    def _recent_tips(self) -> List[int]:
        chain = self.b.chain
        head = self.b.last_accepted_block()
        cached = self._tips_cache.get(head.hash())
        if cached is not None:
            return cached
        tips: List[int] = []
        blk = head
        for _ in range(self.check_blocks):
            if blk is None or blk.number == 0:
                break
            base_fee = blk.base_fee
            for tx in blk.transactions:
                tip = tx.effective_gas_tip(base_fee)
                if tip >= 0:
                    tips.append(tip)
            blk = chain.get_block(blk.parent_hash)
        tips.sort()
        self._tips_cache.put(head.hash(), tips)
        return tips

    def suggest_tip_cap(self) -> int:
        tips = self._recent_tips()
        if not tips:
            return 0
        return tips[min(len(tips) - 1, len(tips) * self.percentile // 100)]

    def suggest_price(self) -> int:
        """Tip + the estimated next base fee (post-AP3)."""
        head = self.b.last_accepted_block().header
        tip = self.suggest_tip_cap()
        if self.b.chain_config.is_apricot_phase3(head.time):
            try:
                _, next_base = estimate_next_base_fee(
                    self.b.chain_config, head, head.time
                )
            except Exception:
                # estimator fault: serving the stale base fee keeps the
                # endpoint up, but persistent fallback = stale quotes
                count_drop("eth/gasprice/estimate_fallback")
                next_base = head.base_fee or 0
            return tip + next_base
        return max(tip, params.LAUNCH_MIN_GAS_PRICE)

    def fee_history(self, count: int, newest_tag: str, percentiles: List[float]) -> dict:
        count = min(count, MAX_LOOKBACK)
        newest = self.b.block_by_tag(newest_tag)
        if newest is None or count == 0:
            return {"oldestBlock": "0x0", "baseFeePerGas": [], "gasUsedRatio": []}
        chain = self.b.chain
        blocks = []
        blk = newest
        for _ in range(count):
            if blk is None:
                break
            blocks.append(blk)
            if blk.number == 0:
                break
            blk = chain.get_block(blk.parent_hash)
        blocks.reverse()
        base_fees = [b.base_fee or 0 for b in blocks]
        # next base fee after the newest block
        try:
            _, nxt = estimate_next_base_fee(
                self.b.chain_config, newest.header, newest.time
            )
            base_fees.append(nxt)
        except Exception:
            count_drop("eth/gasprice/fee_history_estimate_fallback")
            base_fees.append(base_fees[-1] if base_fees else 0)
        out = {
            "oldestBlock": hex(blocks[0].number) if blocks else "0x0",
            "baseFeePerGas": [hex(f) for f in base_fees],
            "gasUsedRatio": [
                (b.gas_used / b.gas_limit) if b.gas_limit else 0.0 for b in blocks
            ],
        }
        if percentiles:
            rewards = []
            for b in blocks:
                tips = sorted(
                    tx.effective_gas_tip(b.base_fee) for tx in b.transactions
                )
                if not tips:
                    rewards.append([hex(0)] * len(percentiles))
                    continue
                rewards.append([
                    hex(tips[min(len(tips) - 1, int(len(tips) * p / 100))])
                    for p in percentiles
                ])
            out["reward"] = rewards
        return out
