"""Precompiled contracts (semantics of coreth core/vm/contracts.go and
contracts_stateful.go).

Stateless Ethereum precompiles 0x01-0x09 (Istanbul pricing, EIP-2565 modexp)
plus the Avalanche stateful precompiles at
0x0100000000000000000000000000000000000001/02 (NativeAssetBalance /
NativeAssetCall — contracts_stateful.go:23-25) with the per-fork
activation/deprecation schedule of contracts.go:70-159.

Every precompile is `run(evm, caller, addr, input, gas, read_only) ->
(ret, remaining_gas)` raising vmerrs on failure — the stateful signature;
stateless ones are wrapped (contracts_stateful.go:30-41).

Counterpart of coreth_tpu/evm/precompiles.py.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, Optional, Tuple

from .. import vmerrs
from ..native import keccak256
from . import bn256

Addr = bytes

ECRECOVER_ADDR = (b"\x00" * 19) + b"\x01"
SHA256_ADDR = (b"\x00" * 19) + b"\x02"
RIPEMD160_ADDR = (b"\x00" * 19) + b"\x03"
IDENTITY_ADDR = (b"\x00" * 19) + b"\x04"
MODEXP_ADDR = (b"\x00" * 19) + b"\x05"
BN256_ADD_ADDR = (b"\x00" * 19) + b"\x06"
BN256_MUL_ADDR = (b"\x00" * 19) + b"\x07"
BN256_PAIRING_ADDR = (b"\x00" * 19) + b"\x08"
BLAKE2F_ADDR = (b"\x00" * 19) + b"\x09"

# Avalanche-range addresses (contracts_stateful.go:22-25)
GENESIS_CONTRACT_ADDR = bytes.fromhex("0100000000000000000000000000000000000000")
NATIVE_ASSET_BALANCE_ADDR = bytes.fromhex("0100000000000000000000000000000000000001")
NATIVE_ASSET_CALL_ADDR = bytes.fromhex("0100000000000000000000000000000000000002")

# gas (params/protocol_params.go)
ECRECOVER_GAS = 3000
SHA256_BASE_GAS = 60
SHA256_PER_WORD_GAS = 12
RIPEMD160_BASE_GAS = 600
RIPEMD160_PER_WORD_GAS = 120
IDENTITY_BASE_GAS = 15
IDENTITY_PER_WORD_GAS = 3
BN256_ADD_GAS_ISTANBUL = 150
BN256_SCALAR_MUL_GAS_ISTANBUL = 6000
BN256_PAIRING_BASE_GAS_ISTANBUL = 45000
BN256_PAIRING_PER_POINT_GAS_ISTANBUL = 34000
BLAKE2F_INPUT_LEN = 213

ASSET_BALANCE_APRICOT = 2474
ASSET_CALL_APRICOT = 30275

SECP256K1_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141


def _words(n: int) -> int:
    return (n + 31) // 32


def _pad(data: bytes, size: int) -> bytes:
    if len(data) >= size:
        return data[:size]
    return data + b"\x00" * (size - len(data))


# --- stateless implementations --------------------------------------------


def _run_ecrecover(input_: bytes) -> bytes:
    from ..crypto.secp256k1 import ecrecover

    input_ = _pad(input_, 128)
    h = input_[:32]
    v = int.from_bytes(input_[32:64], "big")
    r = int.from_bytes(input_[64:96], "big")
    s = int.from_bytes(input_[96:128], "big")
    # tighter sig verification (contracts.go ecrecover.Run)
    if v < 27 or v > 28:
        return b""
    if not (0 < r < SECP256K1_N and 0 < s < SECP256K1_N):
        return b""
    pub = ecrecover(h, v - 27, r, s)
    if pub is None:
        return b""
    return _pad(b"", 12) + keccak256(pub)[12:]


def _run_sha256(input_: bytes) -> bytes:
    return hashlib.sha256(input_).digest()


def _run_ripemd160(input_: bytes) -> bytes:
    h = hashlib.new("ripemd160")
    h.update(input_)
    return _pad(b"", 12) + h.digest()


def _modexp_gas(input_: bytes) -> int:
    """EIP-2565 pricing (contracts.go bigModExp.RequiredGas, eip2565=true)."""
    input_ = _pad(input_, 96)
    base_len = int.from_bytes(input_[0:32], "big")
    exp_len = int.from_bytes(input_[32:64], "big")
    mod_len = int.from_bytes(input_[64:96], "big")
    if base_len > 1 << 32 or exp_len > 1 << 32 or mod_len > 1 << 32:
        raise_oog()
    body = input_[96:]
    # leading 32 bytes of the exponent
    exp_head = int.from_bytes(_pad(body[base_len : base_len + min(exp_len, 32)], min(exp_len, 32)), "big")
    msb = exp_head.bit_length() - 1 if exp_head > 0 else 0
    adj_exp_len = 0
    if exp_len > 32:
        adj_exp_len = 8 * (exp_len - 32)
    adj_exp_len += msb
    # EIP-2565: words^2 multiplication complexity
    words = _words(max(base_len, mod_len))
    mult_complexity = words * words
    gas = mult_complexity * max(adj_exp_len, 1) // 3
    return max(200, gas)


def _run_modexp(input_: bytes) -> bytes:
    header = _pad(input_, 96)
    base_len = int.from_bytes(header[0:32], "big")
    exp_len = int.from_bytes(header[32:64], "big")
    mod_len = int.from_bytes(header[64:96], "big")
    if base_len == 0 and mod_len == 0:
        return b""
    body = input_[96:] if len(input_) > 96 else b""
    base = int.from_bytes(_pad(body[:base_len], base_len), "big")
    exp = int.from_bytes(_pad(body[base_len : base_len + exp_len], exp_len), "big")
    mod = int.from_bytes(_pad(body[base_len + exp_len : base_len + exp_len + mod_len], mod_len), "big")
    if mod == 0:
        return b"\x00" * mod_len
    return pow(base, exp, mod).to_bytes(mod_len, "big")


def _run_bn256_add(input_: bytes) -> bytes:
    input_ = _pad(input_, 128)
    a = bn256.g1_unmarshal(input_[0:64])
    b = bn256.g1_unmarshal(input_[64:128])
    return bn256.g1_marshal(bn256.g1_add(a, b))


def _run_bn256_mul(input_: bytes) -> bytes:
    input_ = _pad(input_, 96)
    a = bn256.g1_unmarshal(input_[0:64])
    k = int.from_bytes(input_[64:96], "big")
    return bn256.g1_marshal(bn256.g1_mul(a, k))


def _run_bn256_pairing(input_: bytes) -> bytes:
    if len(input_) % 192 != 0:
        # errBadPairingInput (contracts.go:620) — plain error, burns all gas
        raise vmerrs.ErrPrecompileFailure
    pairs = []
    for off in range(0, len(input_), 192):
        p = bn256.g1_unmarshal(input_[off : off + 64])
        q = bn256.g2_unmarshal(input_[off + 64 : off + 192])
        pairs.append((p, q))
    ok = bn256.pairing_check(pairs)
    return (1 if ok else 0).to_bytes(32, "big")


# --- blake2f (EIP-152) -----------------------------------------------------

_BLAKE2B_IV = [
    0x6A09E667F3BCC908, 0xBB67AE8584CAA73B, 0x3C6EF372FE94F82B, 0xA54FF53A5F1D36F1,
    0x510E527FADE682D1, 0x9B05688C2B3E6C1F, 0x1F83D9ABFB41BD6B, 0x5BE0CD19137E2179,
]
_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]
_M64 = (1 << 64) - 1


def _rotr64(x: int, n: int) -> int:
    return ((x >> n) | (x << (64 - n))) & _M64


def blake2f_compress(rounds: int, h: list, m: list, t0: int, t1: int, final: bool) -> list:
    """The F compression function of BLAKE2b (EIP-152)."""
    v = h[:] + _BLAKE2B_IV[:]
    v[12] ^= t0
    v[13] ^= t1
    if final:
        v[14] ^= _M64

    def g(a, b, c, d, x, y):
        v[a] = (v[a] + v[b] + x) & _M64
        v[d] = _rotr64(v[d] ^ v[a], 32)
        v[c] = (v[c] + v[d]) & _M64
        v[b] = _rotr64(v[b] ^ v[c], 24)
        v[a] = (v[a] + v[b] + y) & _M64
        v[d] = _rotr64(v[d] ^ v[a], 16)
        v[c] = (v[c] + v[d]) & _M64
        v[b] = _rotr64(v[b] ^ v[c], 63)

    for r in range(rounds):
        s = _SIGMA[r % 10]
        g(0, 4, 8, 12, m[s[0]], m[s[1]])
        g(1, 5, 9, 13, m[s[2]], m[s[3]])
        g(2, 6, 10, 14, m[s[4]], m[s[5]])
        g(3, 7, 11, 15, m[s[6]], m[s[7]])
        g(0, 5, 10, 15, m[s[8]], m[s[9]])
        g(1, 6, 11, 12, m[s[10]], m[s[11]])
        g(2, 7, 8, 13, m[s[12]], m[s[13]])
        g(3, 4, 9, 14, m[s[14]], m[s[15]])

    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def _run_blake2f(input_: bytes) -> bytes:
    rounds = int.from_bytes(input_[0:4], "big")
    h = [int.from_bytes(input_[4 + 8 * i : 12 + 8 * i], "little") for i in range(8)]
    m = [int.from_bytes(input_[68 + 8 * i : 76 + 8 * i], "little") for i in range(16)]
    t0 = int.from_bytes(input_[196:204], "little")
    t1 = int.from_bytes(input_[204:212], "little")
    f = input_[212]
    out = blake2f_compress(rounds, h, m, t0, t1, f == 1)
    return b"".join(x.to_bytes(8, "little") for x in out)


def raise_oog():
    raise vmerrs.ErrOutOfGas


# --- the stateful wrapper layer -------------------------------------------


class Precompile:
    """run(evm, caller, addr, input, gas, read_only) -> (ret, remaining)."""

    def run(self, evm, caller, addr, input_, gas, read_only):
        raise NotImplementedError


class _Wrapped(Precompile):
    """Stateless contract + gas fn (contracts_stateful.go:30-41)."""

    def __init__(self, gas_fn: Callable[[bytes], int], run_fn: Callable[[bytes], bytes]):
        self._gas = gas_fn
        self._run = run_fn

    def run(self, evm, caller, addr, input_, gas, read_only):
        cost = self._gas(input_)
        if gas < cost:
            raise vmerrs.ErrOutOfGas
        gas -= cost
        try:
            out = self._run(input_)
        except vmerrs.VMError:
            raise
        except Exception:
            # Malformed input → plain (non-revert) error so evm.Call burns all
            # remaining gas, matching RunPrecompiledContract + Call semantics.
            raise vmerrs.ErrPrecompileFailure
        return out, gas


class DeprecatedContract(Precompile):
    """Reverts unconditionally, refunding gas (contracts_stateful.go:129-133)."""

    def run(self, evm, caller, addr, input_, gas, read_only):
        raise vmerrs.ErrExecutionReverted


class NativeAssetBalance(Precompile):
    """GetBalanceMultiCoin(address, assetID) (contracts_stateful.go:48-93)."""

    def __init__(self, gas_cost: int = ASSET_BALANCE_APRICOT):
        self.gas_cost = gas_cost

    def run(self, evm, caller, addr, input_, gas, read_only):
        if gas < self.gas_cost:
            raise vmerrs.ErrOutOfGas
        gas -= self.gas_cost
        if len(input_) != 52:
            raise vmerrs.ErrExecutionReverted
        address, asset_id = input_[:20], input_[20:52]
        bal = evm.statedb.get_balance_multicoin(address, asset_id)
        if bal >= 1 << 256:
            raise vmerrs.ErrExecutionReverted
        return bal.to_bytes(32, "big"), gas


class NativeAssetCall(Precompile):
    """Atomic multicoin transfer + call (contracts_stateful.go:95-127,
    dispatched into EVM.native_asset_call per evm.go:688-740)."""

    def __init__(self, gas_cost: int = ASSET_CALL_APRICOT):
        self.gas_cost = gas_cost

    def run(self, evm, caller, addr, input_, gas, read_only):
        return evm.native_asset_call(caller, input_, gas, self.gas_cost, read_only)


def _blake2f_gas(input_: bytes) -> int:
    if len(input_) != BLAKE2F_INPUT_LEN:
        return 0  # length error surfaces in run
    return int.from_bytes(input_[0:4], "big")


def _check_blake2f(input_: bytes) -> bytes:
    if len(input_) != BLAKE2F_INPUT_LEN or input_[212] not in (0, 1):
        # errBlake2FInvalid* (contracts.go:690-700) — plain error, burns all gas
        raise vmerrs.ErrPrecompileFailure
    return _run_blake2f(input_)


def _stateless_set() -> Dict[Addr, Precompile]:
    return {
        ECRECOVER_ADDR: _Wrapped(lambda i: ECRECOVER_GAS, _run_ecrecover),
        SHA256_ADDR: _Wrapped(lambda i: SHA256_BASE_GAS + SHA256_PER_WORD_GAS * _words(len(i)), _run_sha256),
        RIPEMD160_ADDR: _Wrapped(lambda i: RIPEMD160_BASE_GAS + RIPEMD160_PER_WORD_GAS * _words(len(i)), _run_ripemd160),
        IDENTITY_ADDR: _Wrapped(lambda i: IDENTITY_BASE_GAS + IDENTITY_PER_WORD_GAS * _words(len(i)), lambda i: i),
        MODEXP_ADDR: _Wrapped(_modexp_gas, _run_modexp),
        BN256_ADD_ADDR: _Wrapped(lambda i: BN256_ADD_GAS_ISTANBUL, _run_bn256_add),
        BN256_MUL_ADDR: _Wrapped(lambda i: BN256_SCALAR_MUL_GAS_ISTANBUL, _run_bn256_mul),
        BN256_PAIRING_ADDR: _Wrapped(
            lambda i: BN256_PAIRING_BASE_GAS_ISTANBUL
            + BN256_PAIRING_PER_POINT_GAS_ISTANBUL * (len(i) // 192),
            _run_bn256_pairing,
        ),
        BLAKE2F_ADDR: _Wrapped(_blake2f_gas, _check_blake2f),
    }


def active_precompiles(rules) -> Dict[Addr, Precompile]:
    """Per-fork precompile sets (contracts.go:70-159 and evm.go
    activePrecompiles): the native-asset pair is live [AP2, Pre6) and
    [Phase6, Banff), deprecated otherwise once AP2 has passed."""
    contracts = _stateless_set()
    if rules.is_apricot_phase2:
        contracts[GENESIS_CONTRACT_ADDR] = DeprecatedContract()
        native_live = (
            not rules.is_apricot_phase_pre6 or (rules.is_apricot_phase6 and not rules.is_banff)
        )
        if native_live:
            contracts[NATIVE_ASSET_BALANCE_ADDR] = NativeAssetBalance()
            contracts[NATIVE_ASSET_CALL_ADDR] = NativeAssetCall()
        else:
            contracts[NATIVE_ASSET_BALANCE_ADDR] = DeprecatedContract()
            contracts[NATIVE_ASSET_CALL_ADDR] = DeprecatedContract()
    # stateful precompile framework registrations (precompile/ package)
    for addr, contract in getattr(rules, "active_precompiles", {}).items():
        contracts[addr] = contract
    return contracts
