"""Canonical EVM error values (semantics of coreth vmerrs/vmerrs.go).

Errors are singleton exception instances compared by identity, mirroring the
reference's sentinel `errors.New` values. `ErrExecutionReverted` is special:
it refunds remaining gas to the caller; every other VM error consumes it.

Counterpart of coreth_tpu/vmerrs.py.
"""

from __future__ import annotations


class VMError(Exception):
    """Base for consensus-level EVM errors (not Python bugs)."""


def _mk(msg: str) -> VMError:
    return VMError(msg)


ErrOutOfGas = _mk("out of gas")
ErrCodeStoreOutOfGas = _mk("contract creation code storage out of gas")
ErrDepth = _mk("max call depth exceeded")
ErrInsufficientBalance = _mk("insufficient balance for transfer")
ErrContractAddressCollision = _mk("contract address collision")
ErrExecutionReverted = _mk("execution reverted")
ErrMaxCodeSizeExceeded = _mk("max code size exceeded")
ErrMaxInitCodeSizeExceeded = _mk("max initcode size exceeded")
ErrInvalidJump = _mk("invalid jump destination")
ErrWriteProtection = _mk("write protection")
ErrReturnDataOutOfBounds = _mk("return data out of bounds")
ErrGasUintOverflow = _mk("gas uint64 overflow")
ErrInvalidCode = _mk("invalid code: must not begin with 0xef")
ErrNonceUintOverflow = _mk("nonce uint64 overflow")
ErrAddrProhibited = _mk("prohibited address cannot be sender or created contract address")
ErrInvalidCoinID = _mk("invalid coin id")
ErrStackUnderflow = _mk("stack underflow")
ErrStackOverflow = _mk("stack limit reached")
ErrInvalidOpcode = _mk("invalid opcode")
ErrInsufficientBalanceMC = _mk("insufficient multicoin balance for transfer")
ErrToAddrProhibited = _mk("prohibited address cannot be called")
# Precompile input/execution failure. NOT a revert: the reference's
# RunPrecompiledContract returns a plain error and evm.Call then consumes all
# remaining gas (contracts.go / evm.go Call error handling).
ErrPrecompileFailure = _mk("precompile execution failure")


class RevertError(VMError):
    """Revert carrying reason bytes (REVERT opcode / solidity require)."""

    def __init__(self, data: bytes):
        super().__init__("execution reverted")
        self.revert_data = data


def is_revert(err) -> bool:
    """True for both the plain sentinel and data-carrying reverts."""
    return err is ErrExecutionReverted or isinstance(err, RevertError)


def revert_data(err) -> bytes:
    return getattr(err, "revert_data", b"")
