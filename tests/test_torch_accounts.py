"""The port's wallet building blocks (coreth_tpu_torch/accounts/{abi,
keystore,manager,external}.py, signer/, interfaces.py, ethclient's typed
surface) against the JAX package's, on the CPU.

Every case feeds the same seeded inputs to both packages and requires
equal outputs: ABI encodings and decodings, EIP-712 hashes and
signatures, keyfiles that each package decrypts from the other, the
manager's wallet events, the external signer's answers from one mock
clef daemon (tests/test_external_signer.py's, served by either package's
RPCServer). The port's AES-128-CTR is its own (the port imports no
cryptography package): it is held against `cryptography`'s on seeded
keys, counters and lengths, and against the FIPS-197 C.1 and SP 800-38A
F.5.1 vectors.
"""

import hashlib
import importlib
import threading
import time

import numpy as np
import pytest
from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

from coreth_tpu.accounts import abi as jabi
from coreth_tpu.accounts import keystore as jks
from coreth_tpu.accounts import manager as jmanager
from coreth_tpu import signer as jsigner
from coreth_tpu.crypto.secp256k1 import priv_to_address
from coreth_tpu_torch.accounts import abi as pabi
from coreth_tpu_torch.accounts import keystore as pks
from coreth_tpu_torch.accounts import manager as pmanager
from coreth_tpu_torch import signer as psigner

KEY = b"\x31" * 32
CHAIN_ID = 43112
PKGS = ("coreth_tpu", "coreth_tpu_torch")


def both(name):
    return [importlib.import_module(f"{p}.{name}") for p in PKGS]


# ------------------------------------------------------------------- ABI

TYPES = ["uint8", "uint256", "int32", "int256", "address", "bool", "bytes4",
         "bytes32", "bytes", "string", "uint256[]", "address[2]",
         "bytes[]", "string[2]", "uint16[][]", "function"]
TUPLE = [{"name": "a", "type": "uint64"}, {"name": "b", "type": "bytes"},
         {"name": "c", "type": "address[]"}]


def _value(t, rng):
    if t.endswith("]"):
        inner, n = t[:t.rindex("[")], t[t.rindex("[") + 1:-1]
        count = int(n) if n else int(rng.integers(0, 4))
        return [_value(inner, rng) for _ in range(count)]
    if t.startswith("uint"):
        return int.from_bytes(rng.bytes(32), "big") % (1 << int(t[4:]))
    if t.startswith("int"):
        bits = int(t[3:])
        return (int.from_bytes(rng.bytes(32), "big") % (1 << bits)
                - (1 << (bits - 1)))
    if t == "address":
        return rng.bytes(20)
    if t == "bool":
        return bool(rng.integers(0, 2))
    if t == "function":
        return rng.bytes(24)
    if t.startswith("bytes") and t != "bytes":
        return rng.bytes(int(t[5:]))
    if t == "bytes":
        return rng.bytes(int(rng.integers(0, 70)))
    if t == "string":
        return "".join(chr(int(c)) for c in rng.integers(32, 0x2FF, 9))
    raise AssertionError(t)


@pytest.mark.parametrize("seed", range(4))
def test_abi_pack_unpack_equal(seed):
    """Seeded values of every type of the grammar (static and dynamic,
    nested arrays, a tuple) pack to the reference's bytes and unpack to
    the reference's values."""
    rng = np.random.default_rng(seed)
    names = [TYPES[int(i)] for i in rng.choice(len(TYPES), 6, replace=False)]
    values = [_value(t, rng) for t in names]
    names.append("tuple")
    values.append((_value("uint64", rng), _value("bytes", rng),
                   _value("address[]", rng)))
    jt = [jabi.parse_type(t, TUPLE) for t in names]
    pt = [pabi.parse_type(t, TUPLE) for t in names]
    assert [t.canonical() for t in pt] == [t.canonical() for t in jt]
    enc = jabi.pack_values(jt, values)
    assert pabi.pack_values(pt, values) == enc
    assert pabi.unpack_values(pt, enc) == jabi.unpack_values(jt, enc)
    assert pabi.unpack_values(pt, enc)[:-1] == values[:-1]


def test_abi_container_selectors_events_and_errors():
    spec = [
        {"type": "function", "name": "transfer",
         "inputs": [{"name": "to", "type": "address"},
                    {"name": "amount", "type": "uint256"}],
         "outputs": [{"name": "", "type": "bool"}]},
        {"type": "function", "name": "keccak256Batch",
         "inputs": [{"name": "data", "type": "bytes[]"}],
         "outputs": [{"name": "", "type": "bytes32[]"}],
         "stateMutability": "view"},
        {"type": "event", "name": "Transfer", "inputs": [
            {"name": "from", "type": "address", "indexed": True},
            {"name": "to", "type": "address", "indexed": True},
            {"name": "memo", "type": "string", "indexed": True},
            {"name": "value", "type": "uint256", "indexed": False}]},
        {"type": "constructor",
         "inputs": [{"name": "x", "type": "uint8"}]},
    ]
    j, p = jabi.ABI(spec), pabi.ABI(spec)
    assert p.methods["transfer"].selector().hex() == "a9059cbb"
    for name in ("transfer", "keccak256Batch"):
        assert (p.methods[name].sig(), p.methods[name].selector()) == (
            j.methods[name].sig(), j.methods[name].selector())
    assert p.pack("transfer", b"\xbb" * 20, 7) == j.pack(
        "transfer", b"\xbb" * 20, 7)
    msgs = [b"\x01" * 40, b"", b"abc"]
    assert p.pack("keccak256Batch", msgs) == j.pack("keccak256Batch", msgs)
    ret = (jabi.pack_values([jabi.parse_type("bytes32[]")],
                            [[b"\x07" * 32, b"\x09" * 32]]))
    assert p.unpack("keccak256Batch", ret) == j.unpack("keccak256Batch", ret)
    e = p.events["Transfer"]
    assert e.topic() == j.events["Transfer"].topic()
    topics = [e.topic(), b"\x00" * 12 + b"\x0a" * 20,
              b"\x00" * 12 + b"\x0b" * 20, b"\x0c" * 32]
    data = (777).to_bytes(32, "big")
    assert p.decode_log("Transfer", topics, data) == j.decode_log(
        "Transfer", topics, data)
    assert [t.canonical() for _, t in p.constructor.inputs] == ["uint8"]
    for mod, typ, val in ((pabi, "uint8", 256), (pabi, "int8", -129),
                          (pabi, "address", b"\x01"), (pabi, "bytes2", b"x")):
        with pytest.raises(mod.ABIError):
            mod.pack_values([mod.parse_type(typ)], [val])
    with pytest.raises(pabi.ABIError):
        pabi.parse_type("bytes33")


# -------------------------------------------------------------- EIP-712

MAIL_TYPES = {
    "Person": [{"name": "name", "type": "string"},
               {"name": "wallet", "type": "address"}],
    "Mail": [{"name": "from", "type": "Person"},
             {"name": "to", "type": "Person"},
             {"name": "contents", "type": "string"}],
}
MAIL_DOMAIN = {"name": "Ether Mail", "version": "1", "chainId": 1,
               "verifyingContract": bytes.fromhex("cc" * 20)}
MAIL = {"from": {"name": "Cow", "wallet": bytes.fromhex(
            "cd2a3d9f938e13cd947ec05abc7fe734df8dd826")},
        "to": {"name": "Bob", "wallet": bytes.fromhex("bb" * 20)},
        "contents": "Hello, Bob!"}


def test_eip712_spec_example():
    """The EIP-712 specification's Mail example: its published domain
    separator, struct hash and digest, on both packages."""
    for mod in (jsigner, psigner):
        assert mod.encode_type("Mail", MAIL_TYPES) == (
            b"Mail(Person from,Person to,string contents)"
            b"Person(string name,address wallet)")
        assert mod.domain_separator(MAIL_DOMAIN).hex() == (
            "f2cee375fa42b42143804025fc449deafd50cc031ca257e0b194a650a912090f")
        assert mod.hash_struct("Mail", MAIL, MAIL_TYPES).hex() == (
            "c52c0ee5d84264471806290a3f2c4cecfc5490626bf912d01f240d7a274b371e")
        assert mod.typed_data_hash(MAIL_DOMAIN, "Mail", MAIL_TYPES,
                                   MAIL).hex() == (
            "be609aee343fb3c4b28e1df9e632fca64fcfaede20f02e86244efddf30957bd2")


@pytest.mark.parametrize("seed", range(3))
def test_eip712_seeded_hashes_and_signatures_equal(seed):
    rng = np.random.default_rng(100 + seed)
    types = {
        "Item": [{"name": "id", "type": "uint256"},
                 {"name": "tag", "type": "bytes32"},
                 {"name": "note", "type": "string"}],
        "Order": [{"name": "owner", "type": "address"},
                  {"name": "items", "type": "Item[]"},
                  {"name": "payload", "type": "bytes"},
                  {"name": "flags", "type": "bool[]"},
                  {"name": "deadline", "type": "uint64"}],
    }
    msg = {"owner": rng.bytes(20),
           "items": [{"id": int.from_bytes(rng.bytes(32), "big"),
                      "tag": rng.bytes(32), "note": f"n{int(k)}"}
                     for k in rng.integers(0, 99, int(rng.integers(1, 4)))],
           "payload": rng.bytes(int(rng.integers(0, 90))),
           "flags": [bool(b) for b in rng.integers(0, 2, 3)],
           "deadline": int(rng.integers(0, 2**62))}
    domain = {"name": "port", "version": str(seed), "chainId": CHAIN_ID,
              "salt": rng.bytes(32)}
    priv = b"\x01" + rng.bytes(31)
    for fn, args in (("encode_type", ("Order", types)),
                     ("hash_struct", ("Order", msg, types)),
                     ("domain_separator", (domain,)),
                     ("typed_data_hash", (domain, "Order", types, msg)),
                     ("sign_typed_data", (priv, domain, "Order", types, msg))):
        assert getattr(psigner, fn)(*args) == getattr(jsigner, fn)(*args), fn


# ------------------------------------------------------------ the cipher

def test_aes_fips197_and_sp800_38a_vectors():
    """FIPS-197 appendix C.1 (AES-128 on one block) and SP 800-38A F.5.1
    (CTR-AES128.Encrypt, four blocks)."""
    rk = pks._expand_key(bytes(range(16)))
    assert pks._encrypt_block(
        rk, bytes.fromhex("00112233445566778899aabbccddeeff")).hex() == (
        "69c4e0d86a7b0430d8cdb78070b4c55a")
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    ctr = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
    pt = bytes.fromhex(
        "6bc1bee22e409f96e93d7e117393172a" "ae2d8a571e03ac9c9eb76fac45af8e51"
        "30c81c46a35ce411e5fbc1191a0a52ef" "f69f2445df4f9b17ad2b417be66c3710")
    ct = bytes.fromhex(
        "874d6191b620e3261bef6864990db6ce" "9806f66b7970fdff8617187bb9fffdff"
        "5ae4df3edbd5d35e5b4f09020db03eab" "1e031dda2fbe03d1792170a0f3009cee")
    assert pks._aes_ctr(key, ctr, pt) == ct
    assert pks._aes_ctr(key, ctr, ct) == pt
    with pytest.raises(pks.KeyStoreError):
        pks._aes_ctr(b"\x00" * 24, ctr, pt)  # AES-128 only


@pytest.mark.parametrize("seed", range(4))
def test_aes_ctr_equals_cryptography(seed):
    """Seeded keys, counters (the all-ones counter wraps) and lengths,
    against cryptography's AES-CTR, which the reference calls."""
    rng = np.random.default_rng(200 + seed)
    for n in [0, 1, 15, 16, 17, 32, 33, int(rng.integers(34, 200))]:
        key = rng.bytes(16)
        iv = b"\xff" * 16 if n == 17 else rng.bytes(16)
        data = rng.bytes(n)
        enc = Cipher(algorithms.AES(key), modes.CTR(iv)).encryptor()
        assert pks._aes_ctr(key, iv, data) == enc.update(data) + enc.finalize()


# ----------------------------------------------------------------- keyfiles

GETH_VECTOR = {
    "crypto": {
        "cipher": "aes-128-ctr",
        "cipherparams": {"iv": "6087dab2f9fdbbfaddc31a909735c1e6"},
        "ciphertext": "5318b4d5bcd28de64ee5559e671353e16f075ecae9f99c7a79a"
                      "38af5f869aa46",
        "kdf": "pbkdf2",
        "kdfparams": {
            "c": 262144, "dklen": 32, "prf": "hmac-sha256",
            "salt": "ae3cd4e7013836a3df6bd7241b12db061dbe2c6785853cce422d"
                    "148a624ce0bd",
        },
        "mac": "517ead924a9d0dc3124507e3393d175ce3ff7c1e96529c6c555ce9e512"
               "05e9b2",
    },
    "id": "3198bc9c-6672-5ab3-d995-4942343ae5b6",
    "version": 3,
}


def test_web3_secret_storage_pbkdf2_vector():
    """The Web3 Secret Storage pbkdf2 vector of tests/test_accounts.py."""
    assert pks.decrypt_key(GETH_VECTOR, "testpassword").hex() == (
        "7a28b5ba57c53603b0b07b56bba752f7784bf506fa95edc395f5cf6c7514fe9d")


@pytest.mark.parametrize("seed", range(2))
def test_keyfiles_cross_both_ways(seed):
    """A light-scrypt keyfile of each package decrypts with the other's;
    a wrong password fails on both with the same error."""
    rng = np.random.default_rng(300 + seed)
    priv = b"\x02" + rng.bytes(31)
    pw = f"pw-{seed}"
    for enc, dec in ((pks, jks), (jks, pks)):
        kj = enc.encrypt_key(priv, pw, light=True)
        assert kj["crypto"]["kdfparams"]["n"] == pks.LIGHT_SCRYPT_N
        assert dec.decrypt_key(kj, pw) == priv
        assert kj["address"] == priv_to_address(priv).hex()
        with pytest.raises(pks.KeyStoreError, match=pks.ErrDecrypt):
            pks.decrypt_key(kj, "wrong")
        with pytest.raises(jks.KeyStoreError, match=jks.ErrDecrypt):
            jks.decrypt_key(kj, "wrong")
    # the keyfile's fields: the reference's layout
    kj = pks.encrypt_key(priv, pw, light=True)
    want = jks.encrypt_key(priv, pw, light=True)
    assert sorted(kj) == sorted(want) and kj["address"] == want["address"]
    assert sorted(kj["crypto"]) == sorted(want["crypto"])
    assert kj["crypto"]["kdfparams"].keys() == want["crypto"][
        "kdfparams"].keys()


def test_missing_scrypt_raises_and_never_switches_kdf(monkeypatch):
    kj = pks.encrypt_key(KEY, "pw", light=True)
    monkeypatch.delattr(hashlib, "scrypt")
    with pytest.raises(pks.KeyStoreError, match="scrypt is not available"):
        pks.decrypt_key(kj, "pw")
    with pytest.raises(pks.KeyStoreError, match="scrypt is not available"):
        pks.encrypt_key(KEY, "pw", light=True)
    # a pbkdf2 keyfile still opens
    assert len(pks.decrypt_key(GETH_VECTOR, "testpassword")) == 32


def test_keystore_lifecycle_matches_reference(tmp_path):
    """The same operations on a KeyStore of each package: accounts,
    lock/unlock, signatures, export, delete and the reference's errors."""
    from coreth_tpu.core.types import Signer, Transaction

    stores = [mod.KeyStore(str(tmp_path / mod.__name__), light=True)
              for mod in (jks, pks)]
    digest = b"\x05" * 32
    out = []
    for ks, mod in zip(stores, (jks, pks)):
        addr = ks.import_key(KEY, "pw").address
        rec = [addr, [a.address for a in ks.accounts()]]
        with pytest.raises(mod.KeyStoreError, match=mod.ErrLocked):
            ks.sign_hash(addr, digest)
        ks.unlock(addr, "pw")
        rec.append(ks.sign_hash(addr, digest))
        rec.append(ks.sign_hash_with_passphrase(addr, "pw", digest))
        tx = Transaction(type=2, chain_id=CHAIN_ID, nonce=0, max_fee=10**10,
                         gas=21000, to=b"\xbb" * 20, value=5)
        rec.append(ks.sign_tx(addr, tx, CHAIN_ID).encode())
        ks.lock_account(addr)
        with pytest.raises(mod.KeyStoreError, match=mod.ErrLocked):
            ks.sign_tx(addr, tx, CHAIN_ID)
        rec.append(ks.export_key(addr, "pw"))
        with pytest.raises(mod.KeyStoreError, match=mod.ErrDecrypt):
            ks.delete(addr, "nope")
        ks.delete(addr, "pw")
        rec.append(ks.accounts())
        with pytest.raises(mod.KeyStoreError, match=mod.ErrNoMatch):
            ks.export_key(addr, "pw")
        out.append(rec)
    assert out[1] == out[0]
    assert Signer(CHAIN_ID).sender(Transaction.decode(out[1][4])) == out[1][0]


def test_close_cancels_and_joins_relock_timers(tmp_path):
    """ROADMAP Queue 3: a timed unlock starts a relock timer in both
    packages; the port's close() locks the account and joins the timer,
    so no thread is left. (The reference has no close: its timer runs
    until it fires.)"""
    def timers():
        return [t for t in threading.enumerate()
                if t.name == "keystore-relock" and t not in before]

    before = set(threading.enumerate())
    ks = pks.KeyStore(str(tmp_path), light=True)
    addr = ks.import_key(KEY, "pw").address
    ks.unlock(addr, "pw", timeout=300)
    first, = timers()
    ks.unlock(addr, "pw", timeout=600)  # replaces the first timer
    first.join(timeout=5)
    second, = timers()
    ks.close()
    assert not second.is_alive() and not timers()
    with pytest.raises(pks.KeyStoreError, match=pks.ErrLocked):
        ks.sign_hash(addr, b"\x01" * 32)
    assert not hasattr(jks.KeyStore, "close")


def test_timed_unlock_relocks_on_both():
    import tempfile

    for mod in (jks, pks):
        with tempfile.TemporaryDirectory() as d:
            ks = mod.KeyStore(d, light=True)
            addr = ks.import_key(KEY, "pw").address
            ks.unlock(addr, "pw", timeout=0.05)
            ks.sign_hash(addr, b"\x01" * 32)
            deadline = time.time() + 5
            while addr in ks._unlocked and time.time() < deadline:
                time.sleep(0.01)
            with pytest.raises(mod.KeyStoreError, match=mod.ErrLocked):
                ks.sign_hash(addr, b"\x01" * 32)


# ---------------------------------------------------------------- manager

def test_manager_events_match_reference(tmp_path):
    """The same keystore operations under a manager of each package: the
    same arrived/dropped sequence (refresh() passes, then the polling
    watcher), and stop() joins the watcher."""
    seqs = []
    for mod, ksmod in ((jmanager, jks), (pmanager, pks)):
        ks = ksmod.KeyStore(str(tmp_path / mod.__name__), light=True)
        a1 = ks.import_key(b"\x41" * 32, "pw")
        mgr = mod.Manager(ks, poll_interval=0.02)
        events = []
        cancel = mgr.subscribe(
            lambda ev: events.append((ev.kind, ev.account.address)))
        assert [a.address for a in mgr.accounts()] == [a1.address]
        assert mgr.find(a1.address).address == a1.address
        ks.import_key(b"\x42" * 32, "pw")
        mgr.refresh()
        ks.delete(a1.address, "pw")
        mgr.refresh()
        mgr.start_watching()
        thread = mgr._thread
        ks.import_key(b"\x43" * 32, "pw")
        deadline = time.time() + 5
        while len(events) < 3 and time.time() < deadline:
            time.sleep(0.01)
        cancel()
        ks.import_key(b"\x44" * 32, "pw")
        mgr.refresh()
        mgr.stop()
        assert not thread.is_alive() and mgr._thread is None
        seqs.append((events, sorted(a.address for a in mgr.accounts())))
    assert seqs[1] == seqs[0]
    assert [k for k, _ in seqs[1][0]] == ["arrived", "dropped", "arrived"]


# ---------------------------------------------------------- external signer

@pytest.fixture(params=PKGS)
def daemon(request, tmp_path):
    """tests/test_external_signer.py's mock clef daemon, its account_*
    namespace on an RPCServer of either package over IPC."""
    from test_external_signer import MockClefAPI

    ksmod = importlib.import_module(f"{request.param}.accounts.keystore")
    server_mod = importlib.import_module(f"{request.param}.rpc.server")
    ks = ksmod.KeyStore(str(tmp_path / "keys"), light=True)
    addr = ks.import_key(KEY, "pw").address
    ks.unlock(addr, "pw")
    api = MockClefAPI(ks)
    server = server_mod.RPCServer()
    server.register_api("account", api)
    sock = str(tmp_path / "clef.ipc")
    stop = server.serve_ipc(sock)
    yield sock, api, addr
    stop()


def test_external_signer_matches_reference(daemon):
    """Both packages' ExternalSigner against the same daemon: the same
    version, accounts, backend rows, signed transactions (bytes) and data
    signatures; the same refusals of a tampered payload, a wrong-key
    signature and a daemon that is down."""
    from coreth_tpu.core.types import Transaction as JTx

    sock, api, addr = daemon
    ext = both("accounts.external")
    signers = [m.ExternalSigner(sock) for m in ext]
    txs = [JTx(type=2, chain_id=CHAIN_ID, nonce=3, max_fee=10**10,
               max_priority_fee=10**9, gas=21000, to=b"\xaa" * 20, value=1234),
           JTx(type=0, chain_id=CHAIN_ID, nonce=4, gas_price=10**10,
               gas=21000, to=b"\xbb" * 20, value=5),
           JTx(type=1, chain_id=CHAIN_ID, nonce=5, gas_price=10**10,
               gas=30000, to=b"\xcc" * 20, value=1,
               access_list=[(b"\xdd" * 20, [b"\x01" * 32])])]
    out = []
    for m, s in zip(ext, signers):
        tmod = importlib.import_module(m.__name__.rsplit(".", 2)[0]
                                       + ".core.types")
        rows = m.ExternalBackend(s).accounts()
        rec = [s.version(), s.accounts(), s.contains(addr),
               [(a.address, a.url) for a in rows],
               m.ExternalBackend(s).find(b"\x00" * 20),
               s.sign_data(addr, b"attack at dawn")]
        rec += [s.sign_tx(addr, tmod.Transaction.decode(t.encode()),
                          CHAIN_ID).encode() for t in txs]
        api.tamper_value = 999999
        with pytest.raises(m.ExternalSignerError, match="altered"):
            s.sign_tx(addr, tmod.Transaction.decode(txs[0].encode()),
                      CHAIN_ID)
        api.tamper_value, api.misbehave = None, True
        with pytest.raises(m.ExternalSignerError,
                           match="returned a transaction"):
            s.sign_tx(addr, tmod.Transaction.decode(txs[0].encode()),
                      CHAIN_ID)
        api.misbehave = False
        with pytest.raises(m.ExternalSignerError, match="unreachable"):
            m.ExternalSigner(sock + ".none", timeout=1).accounts()
        out.append(rec)
    assert out[1] == out[0]
    assert out[1][1] == [addr]


# ------------------------------------------------- interfaces and client

def test_client_and_bound_contract_satisfy_the_interfaces():
    """The port's ethclient.Client (HTTP and in-process) satisfies every
    protocol of interfaces.py, as the reference's does; BoundContract
    needs only the caller protocol."""
    from coreth_tpu_torch import interfaces as I
    from coreth_tpu_torch.accounts.bind import BoundContract
    from coreth_tpu_torch.ethclient import Client

    def protocols(mod):
        return [n for n in dir(mod) if n != "Protocol"
                and getattr(getattr(mod, n), "_is_protocol", False)]

    protos = protocols(I)
    assert protos == protocols(importlib.import_module(
        "coreth_tpu.interfaces"))
    assert len(protos) == 7
    for c in (Client(server=None), Client("http://127.0.0.1:1")):
        for name in protos:
            assert isinstance(c, getattr(I, name)), name

    calls = []

    class Stub:
        def call_contract(self, obj, block="latest"):
            calls.append((obj, block))
            return (7).to_bytes(32, "big")

    spec = [{"type": "function", "name": "f", "inputs": [],
             "outputs": [{"name": "", "type": "uint256"}],
             "stateMutability": "view"}]
    bc = BoundContract(b"\x01" * 20, pabi.ABI(spec), Stub())
    assert bc.call("f", block="0x1") == [7]
    assert calls == [({"from": "0x" + "00" * 20, "to": "0x" + "01" * 20,
                       "data": "0x26121ff0"}, "0x1")]
