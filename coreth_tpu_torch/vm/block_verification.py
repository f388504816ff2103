"""Syntactic block verification per fork ruleset (semantics of coreth
plugin/evm/block_verification.go); counterpart of
coreth_tpu/vm/block_verification.py.

These are the Avalanche-specific shape checks that run before the chain's
own header verification: ExtDataHash binding, version, uncle emptiness,
atomic gas limits. Gas/fee field checks live in consensus.dummy.
"""

from __future__ import annotations

from .. import params
from ..native import keccak256

ZERO_HASH = b"\x00" * 32
EMPTY_UNCLE_HASH = bytes.fromhex(
    "1dcc4de8dec75d7aab85b567b6ccd41ad312451b948a7413f0a142fd40d49347"
)


class BlockVerificationError(Exception):
    pass


def syntactic_verify(vm, vmblock) -> None:
    b = vmblock.eth_block
    header = b.header
    config = vm.chain_config
    timestamp = b.time
    rules = config.rules(b.number, timestamp)

    # ExtDataHash must bind the ext data (block_verification.go:61-70)
    if not b.ext_data:
        if header.ext_data_hash != ZERO_HASH:
            raise BlockVerificationError(
                "extra data hash set with empty extra data"
            )
    else:
        if header.ext_data_hash != keccak256(b.ext_data):
            raise BlockVerificationError("extra data hash mismatch")

    if header.uncle_hash != EMPTY_UNCLE_HASH or b.uncles:
        raise BlockVerificationError("uncles not allowed")

    # version is always 0 (block_verification.go versions check)
    if b.version != 0:
        raise BlockVerificationError(f"invalid version {b.version}")

    if header.nonce != b"\x00" * 8 or header.mix_digest != ZERO_HASH:
        raise BlockVerificationError("nonce/mixDigest must be zero")

    if rules.is_apricot_phase1 and b.ext_data and len(b.ext_data) > 64 * 1024:
        raise BlockVerificationError("extra data too large")

    # atomic gas limit (AP5): sum of atomic tx gas bounded
    if rules.is_apricot_phase5:
        total = sum(t.gas_used(True) for t in vmblock.atomic_txs)
        if total > params.ATOMIC_GAS_LIMIT:
            raise BlockVerificationError(
                f"atomic gas used {total} exceeds limit {params.ATOMIC_GAS_LIMIT}"
            )
    elif len(vmblock.atomic_txs) > 1:
        raise BlockVerificationError("only one atomic tx allowed pre-AP5")
