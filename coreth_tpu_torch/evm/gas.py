"""EVM gas schedule (semantics of coreth core/vm/gas_table.go,
params/protocol_params.go, core/vm/operations_acl.go).

Post-AP1 note: Avalanche removed SSTORE/SELFDESTRUCT refunds entirely
(core/vm/eips.go:164-171 gasSStoreAP1/gasSelfdestructAP1); the EIP-2200/3529
refund paths here only run for pre-AP1 rules.

Counterpart of coreth_tpu/evm/gas.py.
"""

from __future__ import annotations

# constant-gas tiers
GAS_QUICK = 2
GAS_FASTEST = 3
GAS_FAST = 5
GAS_MID = 8
GAS_SLOW = 10
GAS_EXT = 20

KECCAK256_GAS = 30
KECCAK256_WORD_GAS = 6

SLOAD_GAS_EIP2200 = 800
SSTORE_SET_GAS = 20000
SSTORE_RESET_GAS = 5000
SSTORE_CLEARS_SCHEDULE = 15000
SSTORE_SENTRY_EIP2200 = 2300

COLD_ACCOUNT_ACCESS_COST = 2600
COLD_SLOAD_COST = 2100
WARM_STORAGE_READ_COST = 100

CALL_VALUE_TRANSFER_GAS = 9000
CALL_NEW_ACCOUNT_GAS = 25000
CALL_STIPEND = 2300

SELFDESTRUCT_GAS_EIP150 = 5000
SELFDESTRUCT_REFUND = 24000
CREATE_BY_SELFDESTRUCT_GAS = 25000

EXP_BYTE_GAS_EIP158 = 50
COPY_GAS = 3
MEMORY_GAS = 3
QUAD_COEFF_DIV = 512

LOG_GAS = 375
LOG_TOPIC_GAS = 375
LOG_DATA_GAS = 8

CREATE_GAS = 32000
CREATE_DATA_GAS = 200
INIT_CODE_WORD_GAS = 2

BALANCE_GAS_EIP1884 = 700
EXTCODE_SIZE_GAS_EIP150 = 700
EXTCODE_COPY_BASE_EIP150 = 700
EXTCODE_HASH_GAS_EIP1884 = 700
SLOAD_GAS_EIP1884 = 800
CALL_GAS_EIP150 = 700

BLOCKHASH_GAS = 20

MAX_CALL_DEPTH = 1024
STACK_LIMIT = 1024

# single source of truth for the consensus code-size caps lives in params
from ..params import MAX_CODE_SIZE, MAX_INIT_CODE_SIZE  # noqa: E402,F401

# coreth native-asset precompile costs (params/protocol_params.go AssetCall*)
ASSET_BALANCE_APRICOT = 2474
ASSET_CALL_APRICOT = 30275


def memory_gas_cost(mem_size_words_before: int, new_size_bytes: int) -> int:
    """Gas to expand memory to new_size_bytes (quadratic schedule).

    Caller tracks the highest charged size; pass the previous charged words.
    """
    if new_size_bytes == 0:
        return 0
    new_words = (new_size_bytes + 31) // 32
    if new_words <= mem_size_words_before:
        return 0

    def total(words: int) -> int:
        return MEMORY_GAS * words + words * words // QUAD_COEFF_DIV

    return total(new_words) - total(mem_size_words_before)


def to_word_size(size: int) -> int:
    return (size + 31) // 32


def call_gas_eip150(available: int, base: int, requested: int) -> int:
    """EIP-150 63/64 rule: cap the gas forwarded to a child call."""
    avail = available - base
    cap = avail - avail // 64
    return min(requested, cap)
