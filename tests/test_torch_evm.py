"""The port's EVM against the JAX package's on the same inputs, on the CPU.

(a) Every vector of tests/opcode_vectors.py:build_vectors() runs through
both packages' full transaction path (decode, sender recovery, state
transition, EVM, storage) under the Istanbul and Cortina configs of
tests/test_opcode_conformance.py and under both dispatch loops (the fast
loop and the legacy dict loop, chosen by `Config.fastloop`). Return data,
error, gas used, refund, logs, the vector's expected slots and the
post-state root must be equal, and the slots must hold the vector's
independent expectations. The transactions are signed once per fork and
calldata with the reference's signer; each package decodes the bytes.
(b) Each precompile on fixed inputs, called through `EVM.call` in both
packages: ecrecover, sha256, ripemd160, identity, modexp, bn256 add, mul
and pairing, blake2f, and the native-asset pair with the deprecated
contract: equal output, gas left and error class.
Nothing is compared by tolerance.
"""

import pytest

from coreth_tpu import params as jparams
from coreth_tpu.core import state_transition as jst
from coreth_tpu.core import types as jtypes
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu.evm import evm as jevm
from coreth_tpu.evm import precompiles as jprecompiles
from coreth_tpu.state.database import Database as JDatabase
from coreth_tpu.state.statedb import StateDB as JStateDB
from coreth_tpu.trie.triedb import TrieDatabase as JTrieDatabase
from coreth_tpu_torch import params
from coreth_tpu_torch.core import state_transition as st_mod
from coreth_tpu_torch.core import types
from coreth_tpu_torch.crypto.secp256k1 import priv_to_address, sign
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.evm import bn256
from coreth_tpu_torch.evm import evm as pevm
from coreth_tpu_torch.evm import precompiles
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.state.statedb import StateDB
from coreth_tpu_torch.trie.node import EMPTY_ROOT
from coreth_tpu_torch.trie.triedb import TrieDatabase

from opcode_vectors import build_vectors

# tests/test_opcode_conformance.py's sender key, contract and block
KEY = b"\x45" * 32
CONTRACT = b"\xcc" * 20
ENV = {"number": 7, "timestamp": 7, "gas_limit": 10_000_000,
       "coinbase": b"\xc0" * 20}
SENDER = priv_to_address(KEY)
VECTORS = build_vectors()


class _Pkg:
    """One package's entry points, so each case runs the same code twice."""

    def __init__(self, port: bool):
        if port:
            self.params, self.types, self.st, self.evm = (
                params, types, st_mod, pevm)
            self.MemoryDB, self.TrieDatabase = MemoryDB, TrieDatabase
            self.Database, self.StateDB = Database, StateDB
            self.precompiles = precompiles
        else:
            self.params, self.types, self.st, self.evm = (
                jparams, jtypes, jst, jevm)
            self.MemoryDB, self.TrieDatabase = JMemoryDB, JTrieDatabase
            self.Database, self.StateDB = JDatabase, JStateDB
            self.precompiles = jprecompiles

    def fork(self, name):
        return (self.params.ChainConfig(chain_id=43112) if name == "Istanbul"
                else self.params.TEST_CHAIN_CONFIG)

    def fresh_state(self):
        return self.StateDB(EMPTY_ROOT, self.Database(
            self.TrieDatabase(self.MemoryDB())))


PORT, REF = _Pkg(True), _Pkg(False)
FORKS = ("Istanbul", "Cortina")


def _base_fee(cfg):
    return (params.APRICOT_PHASE3_INITIAL_BASE_FEE
            if cfg.is_apricot_phase3(ENV["timestamp"]) else None)


_SIGNED = {}


def _signed_tx(fork, calldata):
    """The vector's transaction, signed once with the reference's signer."""
    key = (fork, calldata)
    if key not in _SIGNED:
        cfg = REF.fork(fork)
        tx = jtypes.Transaction(type=0, nonce=0, gas=8_000_000,
                                gas_price=_base_fee(cfg) or 10**9,
                                to=CONTRACT, value=0, data=calldata)
        _SIGNED[key] = jtypes.Signer(cfg.chain_id).sign(tx, KEY).encode()
    return _SIGNED[key]


def _err(err):
    return None if err is None else (type(err).__name__, str(err))


def run_vector(pkg, fork, fast, code, calldata, slots):
    cfg = pkg.fork(fork)
    st = pkg.fresh_state()
    st.add_balance(SENDER, 10**20)
    st.set_code(CONTRACT, code)
    st.commit()
    base_fee = _base_fee(cfg)
    tx = pkg.types.Transaction.decode(_signed_tx(fork, calldata))
    signer = pkg.types.Signer(cfg.chain_id)
    bctx = pkg.evm.BlockContext(
        block_number=ENV["number"], time=ENV["timestamp"],
        gas_limit=ENV["gas_limit"], coinbase=ENV["coinbase"],
        base_fee=base_fee)
    evm = pkg.evm.EVM(bctx, pkg.evm.TxContext(
        origin=SENDER, gas_price=tx.effective_gas_price(base_fee)),
        st, cfg, pkg.evm.Config(fastloop=fast))
    st.set_tx_context(tx.hash(), 0)
    msg = pkg.st.tx_as_message(tx, signer, base_fee)
    res = pkg.st.apply_message(evm, msg, pkg.st.GasPool(bctx.gas_limit))
    assert evm.interpreter.fast is fast
    refund = st.get_refund()
    logs = [(lg.address, list(lg.topics), lg.data)
            for lg in st.get_logs(tx.hash(), ENV["number"], b"\x00" * 32)]
    storage = {s: st.get_state(CONTRACT, s.to_bytes(32, "big"))
               for s in slots}
    return (res.return_data, _err(res.err), res.used_gas, refund, logs,
            storage, st.intermediate_root(True))


@pytest.mark.parametrize("fast", [True, False], ids=["fastloop", "legacy"])
@pytest.mark.parametrize("fork", FORKS)
def test_opcode_vectors_match_reference(fork, fast):
    diverged, wrong = [], []
    for name, code, calldata, expected in VECTORS:
        got = run_vector(PORT, fork, fast, code, calldata, expected)
        want = run_vector(REF, fork, fast, code, calldata, expected)
        if got != want:
            diverged.append(name)
        for slot, val in expected.items():
            if int.from_bytes(got[5][slot], "big") != val:
                wrong.append(f"{name}[{slot}]")
    assert not diverged, f"{len(diverged)}/{len(VECTORS)}: {diverged[:20]}"
    assert not wrong, f"{len(wrong)} slots off expectation: {wrong[:20]}"


def _addr(n):
    return b"\x00" * 19 + bytes([n])


def _ecrecover_input(valid):
    h = keccak256(b"message")
    v, r, s = sign(h, b"\x11" * 32)
    if not valid:
        v = 5
    return (h + (v + 27).to_bytes(32, "big") + r.to_bytes(32, "big")
            + s.to_bytes(32, "big"))


def _blake2f_input(rounds=12, final=1, length=213):
    inp = (rounds.to_bytes(4, "big") + bytes.fromhex(
        "48c9bdf267e6096a3ba7ca8485ae67bb2bf894fe72f36e3cf1361d5f3af54fa5"
        "d182e6ad7f520e511f6c3e2b8c68059b6bbd41fbabd9831f79217e1319cde05b")
        + b"abc".ljust(128, b"\x00") + (3).to_bytes(8, "little")
        + (0).to_bytes(8, "little") + bytes([final]))
    return inp[:length]


_G1 = (1, 2)
_G2 = (
    (10857046999023057135944570762232829481370756359578518086990519993285655852781,
     11559732032986387107991004021392285783925812861821192530917403151452391805634),
    (8495653923123431417604973247489272438418190587263600148770280649306958101930,
     4082367875863433681332203403145435568316851327593401208105741076214120093531),
)


def _pairing_input(ok):
    neg = (_G1[0], (-_G1[1]) % bn256.P)
    second = neg if ok else _G1
    return (bn256.g1_marshal(_G1) + bn256.g2_marshal_eip197(_G2)
            + bn256.g1_marshal(second) + bn256.g2_marshal_eip197(_G2))


def _modexp_input(b, e, m):
    def enc(x):
        return x.to_bytes(max(1, (x.bit_length() + 7) // 8), "big")
    bb, eb, mb = enc(b), enc(e), enc(m)
    return (len(bb).to_bytes(32, "big") + len(eb).to_bytes(32, "big")
            + len(mb).to_bytes(32, "big") + bb + eb + mb)


_G = (1).to_bytes(32, "big") + (2).to_bytes(32, "big")
ASSET = b"\xab" * 32
HOLDER = b"\x77" * 20

# (case id, precompile, input, gas)
PRECOMPILE_CASES = [
    ("ecrecover", _addr(1), _ecrecover_input(True), 100_000),
    ("ecrecover-bad-v", _addr(1), _ecrecover_input(False), 100_000),
    ("ecrecover-oog", _addr(1), _ecrecover_input(True), 2_999),
    ("sha256", _addr(2), b"abc" * 50, 100_000),
    ("ripemd160", _addr(3), b"abc" * 50, 100_000),
    ("identity", _addr(4), bytes(range(200)), 100_000),
    ("modexp", _addr(5), _modexp_input(3, 5, 7), 100_000),
    ("modexp-big", _addr(5), _modexp_input(2**255 - 19, 2**200 + 1,
                                            2**256 - 189), 100_000),
    ("bn256-add", _addr(6), _G + _G, 100_000),
    ("bn256-add-off-curve", _addr(6), _G + (1).to_bytes(32, "big") * 2,
     100_000),
    ("bn256-mul", _addr(7), _G + (12345).to_bytes(32, "big"), 100_000),
    ("bn256-pairing-true", _addr(8), _pairing_input(True), 1_000_000),
    ("bn256-pairing-false", _addr(8), _pairing_input(False), 1_000_000),
    ("bn256-pairing-empty", _addr(8), b"", 1_000_000),
    ("bn256-pairing-bad-length", _addr(8), b"\x00" * 100, 1_000_000),
    ("blake2f", _addr(9), _blake2f_input(), 100_000),
    ("blake2f-bad-length", _addr(9), _blake2f_input(length=212), 100_000),
    ("blake2f-bad-final", _addr(9), _blake2f_input(final=2), 100_000),
    ("native-asset-balance", precompiles.NATIVE_ASSET_BALANCE_ADDR,
     HOLDER + ASSET, 100_000),
    ("native-asset-balance-bad-input", precompiles.NATIVE_ASSET_BALANCE_ADDR,
     HOLDER, 100_000),
    ("native-asset-call", precompiles.NATIVE_ASSET_CALL_ADDR,
     HOLDER + ASSET + (5).to_bytes(32, "big") + b"\x01\x02", 200_000),
    ("genesis-contract-deprecated", precompiles.GENESIS_CONTRACT_ADDR,
     b"\x00" * 4, 100_000),
]


def _call_precompile(pkg, addr, input_, gas):
    """One EVM.call from a funded origin on an AP2 chain with no later fork
    (the native-asset pair is live there), as tests/test_evm.py does."""
    cfg = pkg.params.ChainConfig(chain_id=43112, apricot_phase1_time=0,
                                 apricot_phase2_time=0)
    st = pkg.fresh_state()
    origin = b"\x0a" * 20
    st.add_balance(origin, 10**18)
    st.add_balance_multicoin(origin, ASSET, 50)
    st.add_balance_multicoin(HOLDER, ASSET, 1234)
    bctx = pkg.evm.BlockContext(block_number=1, time=1, gas_limit=10**7)
    evm = pkg.evm.EVM(bctx, pkg.evm.TxContext(origin=origin), st, cfg,
                      pkg.evm.Config())
    st.prepare(evm.rules, origin, b"\x00" * 20, addr,
               list(evm.precompiles.keys()), [])
    ret, left, err = evm.call(origin, addr, input_, gas, 0)
    return (ret, left, _err(err), type(evm.precompiles[addr]).__name__,
            st.get_balance_multicoin(HOLDER, ASSET))


@pytest.mark.parametrize("case", PRECOMPILE_CASES, ids=lambda c: c[0])
def test_precompiles_match_reference(case):
    name, addr, input_, gas = case
    got = _call_precompile(PORT, addr, input_, gas)
    assert got == _call_precompile(REF, addr, input_, gas)
    if name == "bn256-pairing-true":
        assert int.from_bytes(got[0], "big") == 1 and got[2] is None
    if name == "ecrecover":
        assert got[0][12:] == priv_to_address(b"\x11" * 32)
