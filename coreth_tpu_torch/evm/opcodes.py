"""EVM opcode constants (semantics of coreth core/vm/opcodes.go).

Counterpart of coreth_tpu/evm/opcodes.py.
"""

# 0x0 arithmetic
STOP = 0x00
ADD = 0x01
MUL = 0x02
SUB = 0x03
DIV = 0x04
SDIV = 0x05
MOD = 0x06
SMOD = 0x07
ADDMOD = 0x08
MULMOD = 0x09
EXP = 0x0A
SIGNEXTEND = 0x0B

# 0x10 comparison / bitwise
LT = 0x10
GT = 0x11
SLT = 0x12
SGT = 0x13
EQ = 0x14
ISZERO = 0x15
AND = 0x16
OR = 0x17
XOR = 0x18
NOT = 0x19
BYTE = 0x1A
SHL = 0x1B
SHR = 0x1C
SAR = 0x1D

# 0x20
KECCAK256 = 0x20

# 0x30 environment
ADDRESS = 0x30
BALANCE = 0x31
ORIGIN = 0x32
CALLER = 0x33
CALLVALUE = 0x34
CALLDATALOAD = 0x35
CALLDATASIZE = 0x36
CALLDATACOPY = 0x37
CODESIZE = 0x38
CODECOPY = 0x39
GASPRICE = 0x3A
EXTCODESIZE = 0x3B
EXTCODECOPY = 0x3C
RETURNDATASIZE = 0x3D
RETURNDATACOPY = 0x3E
EXTCODEHASH = 0x3F

# 0x40 block
BLOCKHASH = 0x40
COINBASE = 0x41
TIMESTAMP = 0x42
NUMBER = 0x43
DIFFICULTY = 0x44  # PREVRANDAO post-merge
GASLIMIT = 0x45
CHAINID = 0x46
SELFBALANCE = 0x47
BASEFEE = 0x48

# 0x50 stack/memory/storage/flow
POP = 0x50
MLOAD = 0x51
MSTORE = 0x52
MSTORE8 = 0x53
SLOAD = 0x54
SSTORE = 0x55
JUMP = 0x56
JUMPI = 0x57
PC = 0x58
MSIZE = 0x59
GAS = 0x5A
JUMPDEST = 0x5B
TLOAD = 0x5C
TSTORE = 0x5D
MCOPY = 0x5E
PUSH0 = 0x5F

# 0x60-0x7f push
PUSH1 = 0x60
PUSH32 = 0x7F

# 0x80 dup, 0x90 swap
DUP1 = 0x80
DUP16 = 0x8F
SWAP1 = 0x90
SWAP16 = 0x9F

# 0xa0 log
LOG0 = 0xA0
LOG4 = 0xA4

# 0xb0+ coreth multicoin (instructions.go:279, jump_table.go:416)
BALANCEMC = 0xCB
EMC = 0xCC
CALLEX = 0xCD

# 0xf0 system
CREATE = 0xF0
CALL = 0xF1
CALLCODE = 0xF2
RETURN = 0xF3
DELEGATECALL = 0xF4
CREATE2 = 0xF5
STATICCALL = 0xFA
REVERT = 0xFD
INVALID = 0xFE
SELFDESTRUCT = 0xFF


_NAMES = {v: k for k, v in list(globals().items()) if isinstance(v, int) and not k.startswith("_")}
for _i in range(32):
    _NAMES[PUSH1 + _i] = f"PUSH{_i + 1}"
for _i in range(16):
    _NAMES[DUP1 + _i] = f"DUP{_i + 1}"
    _NAMES[SWAP1 + _i] = f"SWAP{_i + 1}"
for _i in range(5):
    _NAMES[LOG0 + _i] = f"LOG{_i}"


def name(op: int) -> str:
    """Human-readable opcode name (opcodes.go opCodeToString)."""
    return _NAMES.get(op, f"opcode {op:#x} not defined")
