"""Encrypted key storage (semantics of coreth accounts/keystore/ — the
Web3 Secret Storage v3 format: scrypt/pbkdf2 KDF + AES-128-CTR +
keccak-256 MAC, key.go/passphrase.go); counterpart of
coreth_tpu/accounts/keystore.py.

KeyStore watches a directory of JSON key files and signs with unlocked
keys, like accounts/keystore/keystore.go.

The cipher is this module's own AES-128 (FIPS-197 key expansion and
rounds) in CTR mode (SP 800-38A), in plain Python: the port depends on
no cryptography package. It only ever encrypts a 32-byte key. scrypt is
hashlib's, which needs an OpenSSL that has it; where it is missing, an
scrypt keyfile raises KeyStoreError (the KDF is never switched).

Departure from the reference (ROADMAP Queue 3): close() cancels and
joins the relock timers of timed unlocks, and the VM closes its keystore
at shutdown(); the reference leaves them running.
"""

from __future__ import annotations

import hashlib
import json
import os
import secrets
import threading
import time
import uuid
from typing import Dict, List, Optional

from ..crypto.secp256k1 import priv_to_address, sign
from ..native import keccak256

STANDARD_SCRYPT_N = 1 << 18
STANDARD_SCRYPT_P = 1
LIGHT_SCRYPT_N = 1 << 12
LIGHT_SCRYPT_P = 6
SCRYPT_R = 8
SCRYPT_DKLEN = 32


class KeyStoreError(Exception):
    pass


ErrDecrypt = "could not decrypt key with given password"
ErrLocked = "password or unlock"
ErrNoMatch = "no key for given address or file"


# --- AES-128 (FIPS-197) in CTR mode (SP 800-38A 6.5) ----------------------


def _xtime(a: int) -> int:
    """Multiplication by x (0x02) in GF(2^8) mod x^8 + x^4 + x^3 + x + 1."""
    a <<= 1
    return (a ^ 0x11B) if a & 0x100 else a


def _make_sbox() -> bytes:
    """FIPS-197 5.1.1: the multiplicative inverse, then the affine map.
    p walks GF(2^8)* by the generator 3 while q walks its inverse (by
    3^-1), so q = p^-1 at every step."""
    sbox = bytearray(256)
    p = q = 1
    while True:
        p ^= _xtime(p)  # p *= 3
        q ^= q << 1  # q /= 3
        q ^= q << 2
        q ^= q << 4
        q &= 0xFF
        if q & 0x80:
            q ^= 0x09
        x = q
        for r in range(1, 5):
            x ^= ((q << r) | (q >> (8 - r))) & 0xFF
        sbox[p] = x ^ 0x63
        if p == 1:
            break
    sbox[0] = 0x63
    return bytes(sbox)


_SBOX = _make_sbox()


def _expand_key(key: bytes) -> list:
    """FIPS-197 5.2 for Nk = 4: the 11 round keys, 16 bytes each."""
    if len(key) != 16:
        raise KeyStoreError(f"AES-128 needs a 16-byte key, got {len(key)}")
    w = [list(key[4 * i:4 * i + 4]) for i in range(4)]
    rcon = 1
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = [_SBOX[b] for b in t[1:] + t[:1]]
            t[0] ^= rcon
            rcon = _xtime(rcon)
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [sum(w[4 * r:4 * r + 4], []) for r in range(11)]


def _encrypt_block(round_keys: list, block: bytes) -> bytes:
    """FIPS-197 5.1 Cipher on one 16-byte block; s[r + 4c] is row r,
    column c of the state."""
    s = [b ^ k for b, k in zip(block, round_keys[0])]
    for rnd in range(1, 11):
        s = [_SBOX[b] for b in s]  # SubBytes
        s = [s[(r + 4 * (c + r)) % 16]  # ShiftRows
             for c in range(4) for r in range(4)]
        if rnd != 10:  # MixColumns
            m = []
            for c in range(4):
                a = s[4 * c:4 * c + 4]
                x = a[0] ^ a[1] ^ a[2] ^ a[3]
                m += [a[r] ^ x ^ _xtime(a[r] ^ a[(r + 1) % 4])
                      for r in range(4)]
            s = m
        s = [b ^ k for b, k in zip(s, round_keys[rnd])]
    return bytes(s)


def _aes_ctr(key: bytes, iv: bytes, data: bytes) -> bytes:
    """AES-128-CTR: the keystream blocks encrypt IV, IV + 1, ... (a
    128-bit big-endian counter, wrapping), XORed into [data]."""
    round_keys = _expand_key(key)
    ctr = int.from_bytes(iv, "big")
    out = bytearray()
    for off in range(0, len(data), 16):
        ks = _encrypt_block(round_keys, ctr.to_bytes(16, "big"))
        out += bytes(a ^ b for a, b in zip(data[off:off + 16], ks))
        ctr = (ctr + 1) % (1 << 128)
    return bytes(out)


def _scrypt(password: str, salt: bytes, n: int, r: int, p: int,
            dklen: int) -> bytes:
    if not hasattr(hashlib, "scrypt"):
        raise KeyStoreError(
            "scrypt is not available (hashlib needs an OpenSSL with it)")
    return hashlib.scrypt(password.encode(), salt=salt, n=n, r=r, p=p,
                          dklen=dklen, maxmem=2**31 - 1)


def encrypt_key(priv: bytes, password: str, light: bool = False) -> dict:
    """EncryptKey (passphrase.go): produce a v3 keyfile JSON object."""
    n = LIGHT_SCRYPT_N if light else STANDARD_SCRYPT_N
    p = LIGHT_SCRYPT_P if light else STANDARD_SCRYPT_P
    salt = secrets.token_bytes(32)
    derived = _scrypt(password, salt, n, SCRYPT_R, p, SCRYPT_DKLEN)
    enc_key = derived[:16]
    iv = secrets.token_bytes(16)
    ciphertext = _aes_ctr(enc_key, iv, priv)
    mac = keccak256(derived[16:32] + ciphertext)
    return {
        "address": priv_to_address(priv).hex(),
        "crypto": {
            "cipher": "aes-128-ctr",
            "ciphertext": ciphertext.hex(),
            "cipherparams": {"iv": iv.hex()},
            "kdf": "scrypt",
            "kdfparams": {
                "dklen": SCRYPT_DKLEN, "n": n, "p": p, "r": SCRYPT_R,
                "salt": salt.hex(),
            },
            "mac": mac.hex(),
        },
        "id": str(uuid.uuid4()),
        "version": 3,
    }


def decrypt_key(keyjson: dict, password: str) -> bytes:
    """DecryptKey (passphrase.go): v3 with scrypt or pbkdf2."""
    if keyjson.get("version") != 3:
        raise KeyStoreError(f"unsupported key version {keyjson.get('version')}")
    crypto = keyjson["crypto"]
    if crypto["cipher"] != "aes-128-ctr":
        raise KeyStoreError(f"unsupported cipher {crypto['cipher']}")
    kdf = crypto["kdf"]
    kp = crypto["kdfparams"]
    salt = bytes.fromhex(kp["salt"])
    if kdf == "scrypt":
        derived = _scrypt(password, salt, kp["n"], kp["r"], kp["p"],
                          kp["dklen"])
    elif kdf == "pbkdf2":
        if kp.get("prf", "hmac-sha256") != "hmac-sha256":
            raise KeyStoreError("unsupported pbkdf2 prf")
        derived = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), salt, kp["c"], kp["dklen"]
        )
    else:
        raise KeyStoreError(f"unsupported kdf {kdf}")
    ciphertext = bytes.fromhex(crypto["ciphertext"])
    mac = keccak256(derived[16:32] + ciphertext)
    if mac.hex() != crypto["mac"]:
        raise KeyStoreError(ErrDecrypt)
    iv = bytes.fromhex(crypto["cipherparams"]["iv"])
    priv = _aes_ctr(derived[:16], iv, ciphertext)
    return priv


class Account:
    def __init__(self, address: bytes, url: str = ""):
        self.address = address
        self.url = url


class KeyStore:
    """Directory-backed keystore with unlock/lock (keystore.go)."""

    def __init__(self, keydir: str, light: bool = True):
        self.keydir = keydir
        self.light = light
        self.lock = threading.Lock()
        self._unlocked: Dict[bytes, bytes] = {}  # address -> priv
        self._relock: Dict[bytes, threading.Timer] = {}
        self._unlock_seq: Dict[bytes, int] = {}  # stale-timer fence
        os.makedirs(keydir, exist_ok=True)

    # --- account management ----------------------------------------------

    def accounts(self) -> List[Account]:
        out = []
        for name in sorted(os.listdir(self.keydir)):
            path = os.path.join(self.keydir, name)
            try:
                with open(path) as f:
                    kj = json.load(f)
                out.append(Account(bytes.fromhex(kj["address"]), path))
            except Exception:
                # corrupt/foreign file in the keystore dir: skipping is
                # correct, skipping invisibly is not — operators discover
                # missing accounts otherwise
                from ..metrics import count_drop

                count_drop("accounts/keystore/unreadable_file")
                continue
        return out

    def new_account(self, password: str) -> Account:
        priv = secrets.token_bytes(32)
        return self.import_key(priv, password)

    def import_key(self, priv: bytes, password: str) -> Account:
        kj = encrypt_key(priv, password, light=self.light)
        addr = priv_to_address(priv)
        ts = time.strftime("%Y-%m-%dT%H-%M-%S", time.gmtime())
        name = f"UTC--{ts}--{addr.hex()}"
        path = os.path.join(self.keydir, name)
        with open(path, "w") as f:
            json.dump(kj, f)
        os.chmod(path, 0o600)
        return Account(addr, path)

    def export_key(self, address: bytes, password: str) -> bytes:
        kj = self._find(address)
        return decrypt_key(kj, password)

    def delete(self, address: bytes, password: str) -> None:
        self.export_key(address, password)  # password check
        for acct in self.accounts():
            if acct.address == address:
                os.remove(acct.url)
                return
        raise KeyStoreError(ErrNoMatch)

    def _find(self, address: bytes) -> dict:
        for acct in self.accounts():
            if acct.address == address:
                with open(acct.url) as f:
                    return json.load(f)
        raise KeyStoreError(ErrNoMatch)

    # --- unlock / signing -------------------------------------------------

    def unlock(self, address: bytes, password: str,
               timeout: Optional[float] = None) -> None:
        """Unlock; timeout=None means until lock_account. A new unlock
        REPLACES any pending relock timer (keystore.go TimedUnlock drops
        the previous timer), so an indefinite unlock isn't cut short by an
        earlier timed one and repeated unlocks extend the window."""
        priv = self.export_key(address, password)
        with self.lock:
            self._unlocked[address] = priv
            # bump the fence FIRST: a timer that already fired and is
            # waiting on self.lock sees a stale seq and becomes a no-op
            # (keystore.go expire() checks unlock identity the same way)
            seq = self._unlock_seq.get(address, 0) + 1
            self._unlock_seq[address] = seq
            old = self._relock.pop(address, None)
            if old is not None:
                old.cancel()
            if timeout:
                t = threading.Timer(
                    timeout, lambda: self._timed_lock(address, seq))
                t.daemon = True
                t.name = "keystore-relock"
                self._relock[address] = t
                t.start()

    def _timed_lock(self, address: bytes, seq: int) -> None:
        with self.lock:
            if self._unlock_seq.get(address) != seq:
                return  # superseded by a newer unlock
            self._unlocked.pop(address, None)
            self._relock.pop(address, None)

    def close(self) -> None:
        """Lock every account and cancel and join the relock timers (the
        VM calls this at shutdown, so no timer thread outlives it)."""
        with self.lock:
            timers = list(self._relock.values())
            self._relock.clear()
            for address in list(self._unlocked):
                self._unlock_seq[address] = self._unlock_seq.get(address, 0) + 1
            self._unlocked.clear()
        for t in timers:
            t.cancel()
            t.join(timeout=5)

    def lock_account(self, address: bytes) -> None:
        with self.lock:
            self._unlocked.pop(address, None)
            self._unlock_seq[address] = self._unlock_seq.get(address, 0) + 1
            old = self._relock.pop(address, None)
            if old is not None:
                old.cancel()

    def sign_hash(self, address: bytes, digest: bytes) -> bytes:
        with self.lock:
            priv = self._unlocked.get(address)
        if priv is None:
            raise KeyStoreError(ErrLocked)
        v, r, s = sign(digest, priv)
        return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])

    def sign_tx(self, address: bytes, tx, chain_id: int):
        from ..core.types import Signer

        with self.lock:
            priv = self._unlocked.get(address)
        if priv is None:
            raise KeyStoreError(ErrLocked)
        return Signer(chain_id).sign(tx, priv)

    def sign_hash_with_passphrase(self, address: bytes, password: str,
                                  digest: bytes) -> bytes:
        priv = self.export_key(address, password)
        v, r, s = sign(digest, priv)
        return r.to_bytes(32, "big") + s.to_bytes(32, "big") + bytes([v])
