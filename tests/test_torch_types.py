"""The port's transactions, signer, receipts, bloom, DeriveSha and native
secp256k1 against the JAX package's on the same seeded inputs, on the CPU.

(a) transactions of types 0 (unprotected and EIP-155), 1 and 2, signed
with the same keys in both packages: equal signatures, encodings, hashes
and senders; the port's `sender_batch` agrees with its one-shot
`sender` and with pure-Python recovery, and a decode round trip
recovers the same sender;
(b) receipts with logs: equal encodings and blooms, and a decode round
trip;
(c) `derive_sha` over 0, 1, 127, 128, 129 and 300 items: equal in both
packages and equal to the port's `Trie` root over the same index keys;
(d) the port's native secp256k1 against the reference's, one signature
at a time and in a batch, on 256 seeded signatures of which half are
corrupted.
Nothing is compared by tolerance.
"""

import numpy as np
import pytest

from coreth_tpu.core import types as jtypes
from coreth_tpu.crypto import secp256k1 as jsecp256k1
from coreth_tpu.native import secp as jsecp
from coreth_tpu.state.log import Log as JLog
from coreth_tpu_torch import rlp
from coreth_tpu_torch.core import types
from coreth_tpu_torch.crypto import secp256k1
from coreth_tpu_torch.native import keccak256, secp
from coreth_tpu_torch.state.log import Log
from coreth_tpu_torch.trie.trie import Trie

CHAIN_ID = 43112
SEED = 7


def _keys(n, seed=SEED):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, 32, dtype=np.uint8).tobytes()
            for _ in range(n)]


def _tx_fields(kind, i, rng):
    to = None if i % 5 == 4 else rng.integers(0, 256, 20,
                                              dtype=np.uint8).tobytes()
    data = rng.integers(0, 256, int(rng.integers(0, 70)),
                        dtype=np.uint8).tobytes()
    al = [(rng.integers(0, 256, 20, dtype=np.uint8).tobytes(),
           [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
            for _ in range(int(rng.integers(0, 3)))])
          for _ in range(int(rng.integers(0, 3)))]
    f = dict(nonce=int(rng.integers(0, 1 << 40)), gas=int(rng.integers(
        21000, 1 << 24)), to=to, value=int(rng.integers(0, 1 << 62)) * 7,
        data=data)
    if kind == "legacy-unprotected":
        f.update(type=0, gas_price=int(rng.integers(1, 1 << 40)))
    elif kind == "legacy-eip155":
        f.update(type=0, gas_price=int(rng.integers(1, 1 << 40)))
    elif kind == "access-list":
        f.update(type=1, gas_price=int(rng.integers(1, 1 << 40)),
                 access_list=al)
    else:
        fee = int(rng.integers(1, 1 << 40))
        f.update(type=2, max_fee=fee, gas_price=fee,
                 max_priority_fee=int(rng.integers(0, fee)), access_list=al)
    return f


KINDS = ("legacy-unprotected", "legacy-eip155", "access-list", "dynamic-fee")


@pytest.mark.parametrize("kind", KINDS)
def test_transactions_sign_encode_hash_and_sender_match(kind):
    rng = np.random.default_rng(SEED + KINDS.index(kind))
    chain_id = 0 if kind == "legacy-unprotected" else CHAIN_ID
    signer, jsigner = types.Signer(chain_id), jtypes.Signer(chain_id)
    keys = _keys(6, SEED + KINDS.index(kind))
    ported, fresh = [], []
    for i, key in enumerate(keys):
        f = _tx_fields(kind, i, rng)
        tx = signer.sign(types.Transaction(**f), key)
        jtx = jsigner.sign(jtypes.Transaction(**f), key)
        assert (tx.v, tx.r, tx.s) == (jtx.v, jtx.r, jtx.s)
        assert tx.encode() == jtx.encode()
        assert tx.hash() == jtx.hash()
        assert tx.protected == jtx.protected
        assert signer.sender(tx) == jsigner.sender(jtx)
        want = secp256k1.priv_to_address(key)
        assert signer.sender(tx) == want
        recid = signer._recid_of(tx)[0]
        msg = signer.sig_hash(tx, protected=tx.protected)
        assert secp256k1.recover_address(msg, recid, tx.r, tx.s) == want
        dec = types.Transaction.decode(tx.encode())
        assert dec.encode() == tx.encode() and dec._sender is None
        assert types.Transaction.decode(jtx.encode()).hash() == jtx.hash()
        ported.append(tx)
        fresh.append(dec)
    signer.sender_batch(fresh)
    assert [t._sender for t in fresh] == [t._sender for t in ported]
    # a tx signed for another chain is left uncached by the batch and
    # raises on the one-shot path, as in the reference
    if chain_id:
        other = types.Transaction.decode(ported[0].encode())
        types.Signer(chain_id + 1).sender_batch([other])
        assert other._sender is None
        with pytest.raises(ValueError, match="chain id"):
            types.Signer(chain_id + 1).sender(other)


def _logs(rng, n, log_cls):
    out = []
    for _ in range(n):
        addr = rng.integers(0, 256, 20, dtype=np.uint8).tobytes()
        topics = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
                  for _ in range(int(rng.integers(0, 5)))]
        data = rng.integers(0, 256, int(rng.integers(0, 100)),
                            dtype=np.uint8).tobytes()
        out.append(log_cls(addr, topics, data))
    return out


@pytest.mark.parametrize("tx_type", [0, 1, 2])
def test_receipts_and_bloom_encode_equal(tx_type):
    rng = np.random.default_rng(SEED + 10 + tx_type)
    jrng = np.random.default_rng(SEED + 10 + tx_type)
    cum = 0
    recs, jrecs = [], []
    for i in range(5):
        logs, jlogs = _logs(rng, i, Log), _logs(jrng, i, JLog)
        cum += 21000 + 1000 * i
        status = i % 2
        r = types.Receipt(type=tx_type, status=status, cumulative_gas_used=cum,
                          bloom=types.logs_bloom(logs), logs=logs)
        jr = jtypes.Receipt(type=tx_type, status=status,
                            cumulative_gas_used=cum,
                            bloom=jtypes.logs_bloom(jlogs), logs=jlogs)
        assert r.bloom == jr.bloom
        assert r.encode() == jr.encode()
        back = types.Receipt.decode(r.encode())
        assert back.encode() == r.encode()
        for lg in logs:
            assert types.bloom_lookup(r.bloom, lg.address)
            for t in lg.topics:
                assert types.bloom_lookup(r.bloom, t)
        recs.append(r)
        jrecs.append(jr)
    assert types.create_bloom(recs) == jtypes.create_bloom(jrecs)
    assert types.derive_sha(recs) == jtypes.derive_sha(jrecs)


class _Blob:
    def __init__(self, b):
        self.b = b

    def encode(self):
        return self.b


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 300])
def test_derive_sha_matches_reference_and_trie(n):
    rng = np.random.default_rng(SEED + n)
    blobs = [rng.integers(0, 256, int(rng.integers(1, 90)),
                          dtype=np.uint8).tobytes() for _ in range(n)]
    got = types.derive_sha([_Blob(b) for b in blobs])
    assert got == jtypes.derive_sha([_Blob(b) for b in blobs])
    t = Trie()
    for i, b in enumerate(blobs):
        t.update(rlp.encode(i), b)
    assert got == t.hash()


def test_create_address_matches_reference():
    rng = np.random.default_rng(SEED)
    for _ in range(20):
        sender = rng.integers(0, 256, 20, dtype=np.uint8).tobytes()
        nonce = int(rng.integers(0, 1 << 40))
        salt = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
        code_hash = keccak256(salt)
        assert (types.create_address(sender, nonce)
                == jtypes.create_address(sender, nonce))
        assert (types.create_address2(sender, salt, code_hash)
                == jtypes.create_address2(sender, salt, code_hash))


def _signatures(n=256):
    """(msg_hash, recid, r, s) and the signer's address (None where the
    signature is corrupted) per signature: half valid, a quarter with r or
    s out of range, a quarter with recid or r changed in range (recovering
    another key or nothing)."""
    rng = np.random.default_rng(SEED + 99)
    out = []
    for i in range(n):
        priv = rng.integers(1, 256, 32, dtype=np.uint8).tobytes()
        msg = keccak256(rng.integers(0, 256, 40, dtype=np.uint8).tobytes())
        v, r, s = secp256k1.sign(msg, priv)
        want = secp256k1.priv_to_address(priv) if i % 2 == 0 else None
        kind = i % 8
        if kind == 1:
            r = 0
        elif kind == 3:
            s = secp256k1.N + int(rng.integers(0, 1000))
        elif kind == 5:
            v = (v + 1) % 4
        elif kind == 7:
            r = int.from_bytes(rng.integers(0, 256, 32,
                                            dtype=np.uint8).tobytes(), "big")
        out.append(((msg, v, r, s), want))
    return out


def test_native_secp_matches_reference():
    cases = _signatures()
    sigs = [c for c, _ in cases]
    batch = secp.recover_batch(sigs)
    assert batch == jsecp.recover_batch(sigs)
    for i, (((msg, v, r, s), want), got) in enumerate(zip(cases, batch)):
        one = secp.recover_one(msg, v, r, s)
        assert one == got == jsecp.recover_one(msg, v, r, s)
        assert one == jsecp256k1.recover_address(msg, v, r, s)
        if want is not None:
            assert one == want
        elif i % 8 in (1, 3):
            assert one is None
