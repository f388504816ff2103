"""The `tpu_keccak` stateful precompile (BASELINE config 5); counterpart
of coreth_tpu/precompile/tpu_keccak.py.

Contracts submit a batch of byte strings and get their Keccak-256 digests
back in one call, priced per message at the EVM's SHA3 schedule
(evm/gas.py KECCAK256_GAS / KECCAK256_WORD_GAS) plus a flat batch base.
Gas is charged from the ABI lengths BEFORE any message bytes are copied,
so overlapping offsets buy no cheap memory amplification.

Where the digests are computed is not consensus-relevant (they are
bit-identical everywhere), so it never appears in the chain config. The
port takes the device from the state being executed, not from the
process: a batch of DEVICE_THRESHOLD messages or more goes through the
batch keccak seam of the executing StateDB's TrieDatabase (its
`batch_keccak`: the planned or batched marker of get_batch_keccak, kernel
K2 on CUDA under the process DeviceLadder, the host's native batch keccak
while a caller has the ladder demoted). Where the state has no seam
(device-hasher "off", or a shard worker's view, which never touches the
device) and below the threshold, the threaded native keccak hashes, as in
the reference. Unlike the reference's _Hasher, nothing falls back: an
error of the device call propagates out of the EVM as a non-VMError, so
the block's insert or build fails instead of a transaction failing with
its gas burned (ROADMAP Queue 3).

ABI (solidity):
    function keccak256Batch(bytes[] calldata msgs)
        external view returns (bytes32[] memory digests);
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Sequence, Tuple

from .. import vmerrs
from ..crypto import keccak256_batch
from ..evm.gas import KECCAK256_GAS, KECCAK256_WORD_GAS

TPU_KECCAK_ADDR = bytes.fromhex("0100000000000000000000000000000000000010")

# flat cost of entering the precompile (dispatch + ABI walk); per-message
# costs then follow the SHA3 opcode schedule: 30 + 6*ceil(len/32)
BATCH_BASE_GAS = 2000

# messages per call cap: bounds ABI-decode work and the device batch
MAX_BATCH_MESSAGES = 65536

# the device seam takes batches of at least this many messages; below it
# the threaded C++ keccak hashes (trie/hasher.BATCH_THRESHOLD's rule)
DEVICE_THRESHOLD = 64

_WORD = 32


def _u256(data: bytes, off: int) -> int:
    if off + _WORD > len(data):
        raise vmerrs.ErrPrecompileFailure
    return int.from_bytes(data[off:off + _WORD], "big")


def scan_bytes_array(args: bytes) -> List[Tuple[int, int]]:
    """Walk the ABI `bytes[]` layout, returning (start, len) anchors
    WITHOUT copying message bytes: the gas base for charge-before-copy."""
    head = _u256(args, 0)
    count = _u256(args, head)
    if count > MAX_BATCH_MESSAGES:
        raise vmerrs.ErrPrecompileFailure
    base = head + _WORD
    anchors = []
    for i in range(count):
        rel = _u256(args, base + i * _WORD)
        mlen = _u256(args, base + rel)
        start = base + rel + _WORD
        if start + mlen > len(args):
            raise vmerrs.ErrPrecompileFailure
        anchors.append((start, mlen))
    return anchors


def decode_bytes_array(args: bytes) -> List[bytes]:
    """ABI-decode `bytes[]` (selector already stripped)."""
    return [args[s:s + n] for s, n in scan_bytes_array(args)]


def encode_bytes32_array(vals: Sequence[bytes]) -> bytes:
    """ABI-encode `bytes32[]` return data."""
    out = bytearray()
    out += _WORD.to_bytes(_WORD, "big")        # offset to the array
    out += len(vals).to_bytes(_WORD, "big")    # length
    for v in vals:
        out += v
    return bytes(out)


def _per_msg_gas(length: int) -> int:
    return KECCAK256_GAS + KECCAK256_WORD_GAS * ((length + 31) // 32)


def batch_gas(msgs: Sequence[bytes]) -> int:
    return BATCH_BASE_GAS + sum(_per_msg_gas(len(m)) for m in msgs)


def hash_batch(msgs: List[bytes], seam=None) -> List[bytes]:
    """Digests of `msgs`: through `seam` (a batch keccak, msgs -> digests)
    from DEVICE_THRESHOLD messages on, else on the threaded native keccak.
    An error of the seam reaches the caller."""
    if seam is not None and len(msgs) >= DEVICE_THRESHOLD:
        return list(seam(msgs))
    return keccak256_batch(msgs, threads=0 if len(msgs) < 256 else 8)


def _run_batch(evm, caller, addr, args, gas, read_only):
    try:
        anchors = scan_bytes_array(args)
    except vmerrs.VMError:
        raise
    except Exception:
        raise vmerrs.ErrPrecompileFailure
    cost = BATCH_BASE_GAS + sum(_per_msg_gas(n) for _, n in anchors)
    gas = charge_gas(gas, cost)
    msgs = [args[s:s + n] for s, n in anchors]
    seam = getattr(evm.statedb, "batch_keccak", None)
    return encode_bytes32_array(hash_batch(msgs, seam)), gas


@functools.cache
def keccak_batch_contract():
    """The process's one SelectorDispatchContract for keccak256Batch. It
    holds no state (the seam comes from the executing state), so the
    config stays a plain picklable value for the shard workers."""
    return SelectorDispatchContract([PrecompileFunction(
        function_selector("keccak256Batch(bytes[])"), _run_batch)])


# the package defines these before it imports this module
from . import (PrecompileConfig, PrecompileFunction,  # noqa: E402
               SelectorDispatchContract, charge_gas, function_selector)


@dataclass(frozen=True)
class TpuKeccakConfig(PrecompileConfig):
    """Activation config: the framework's semantics; this class picks the
    address default and builds the contract."""

    address: bytes = TPU_KECCAK_ADDR

    def contract(self):
        return keccak_batch_contract()
