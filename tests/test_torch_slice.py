"""The port's slices end to end at a small size: a genesis state and one
block of churn committed through the port's planned path and through its
level-batched ("batched") path on the CPU, against the JAX package's own
StateDB in the same mode and its CPU Hasher.

~400 accounts, 6 contracts x 40 slots, then a block of balance churn plus
slot writes on top of the hashed state. The commit as a whole is above
BATCH_THRESHOLD; each storage trie is below it."""

import numpy as np
import pytest

from coreth_tpu import rlp as jrlp
from coreth_tpu.ethdb import MemoryDB
from coreth_tpu.native import keccak256_batch as j_keccak256_batch
from coreth_tpu.ops.device import PlannedModeKeccak
from coreth_tpu.ops.keccak_jax import BatchedKeccak
from coreth_tpu.state.account import EMPTY_CODE_HASH as J_EMPTY_CODE_HASH
from coreth_tpu.state.account import Account as JAccount
from coreth_tpu.state.database import Database
from coreth_tpu.state.statedb import StateDB
from coreth_tpu.trie.hasher import Hasher as JHasher
from coreth_tpu.trie.node import EMPTY_ROOT as J_EMPTY_ROOT
from coreth_tpu.trie.triedb import TrieDatabase
from coreth_tpu.trie.trie import Trie as JTrie
from coreth_tpu_torch import native, rlp
from coreth_tpu_torch.ops import keccak_planned
from coreth_tpu_torch.ops.device import get_batch_keccak
from coreth_tpu_torch.ops.keccak_planned import PlannedCommit, PlannedMode
from coreth_tpu_torch.state.account import EMPTY_CODE_HASH, Account
from coreth_tpu_torch.state.statedb import intermediate_root, \
    planned_intermediate_root
from coreth_tpu_torch.trie import hasher, planned
from coreth_tpu_torch.trie.node import EMPTY_ROOT
from coreth_tpu_torch.trie.planned import PlannedGraphBuilder
from coreth_tpu_torch.trie.secure import StateTrie

N_ACCOUNTS, N_CONTRACTS, N_SLOTS = 400, 6, 40


def _world(seed: int = 42):
    rng = np.random.default_rng(seed)
    addrs = [rng.bytes(20) for _ in range(N_ACCOUNTS)]
    state = {a: {"nonce": int(rng.integers(0, 1000)),
                 "balance": int.from_bytes(rng.bytes(10), "big") % 10**24,
                 "code": None, "slots": {}} for a in addrs}
    for a in addrs[:N_CONTRACTS]:
        state[a]["code"] = rng.bytes(int(rng.integers(10, 200)))
        # StateDB.set_state clears bit 0 of byte 0; use keys it keeps
        state[a]["slots"] = {bytes([k[0] & 0xFE]) + k[1:]: b"\x01" + rng.bytes(31)
                             for k in (rng.bytes(32) for _ in range(N_SLOTS))}
    return rng, addrs, state


def _block(rng, addrs, state):
    """Balance churn on 120 plain accounts, 10 slot writes in 3 contracts
    (5 overwrites, 5 new). Returns (touched accounts, slot writes)."""
    touched = [addrs[int(i)] for i in
               rng.choice(np.arange(N_CONTRACTS, N_ACCOUNTS), 120, replace=False)]
    for a in touched:
        state[a]["nonce"] += 1
        state[a]["balance"] += int(rng.integers(1, 10**12))
    writes = {}
    for a in addrs[:3]:
        old = sorted(state[a]["slots"])
        w = {old[int(i)]: b"\x02" + rng.bytes(31)
             for i in rng.choice(len(old), 5, replace=False)}
        for _ in range(5):
            k = rng.bytes(32)
            w[bytes([k[0] & 0xFE]) + k[1:]] = b"\x03" + rng.bytes(31)
        state[a]["slots"].update(w)
        writes[a] = w
    return touched + addrs[:3], writes


def _slot_value(v: bytes) -> bytes:
    return rlp.encode(v.lstrip(b"\x00"))


def _code_hash(s):
    return native.keccak256(s["code"]) if s["code"] else EMPTY_CODE_HASH


def _jax_storage_root(slots) -> bytes:
    from coreth_tpu.native import keccak256

    if not slots:
        return J_EMPTY_ROOT
    st = JTrie()
    for k, v in slots.items():
        st.update(keccak256(k), jrlp.encode(v.lstrip(b"\x00")))
    return bytes(JHasher().hash(st.root, True)[0])


def _jax_cpu_root(state) -> bytes:
    """Independent oracle: JAX tries hashed by the JAX recursive Hasher."""
    from coreth_tpu.native import keccak256

    acct = JTrie()
    for a, s in state.items():
        root = _jax_storage_root(s["slots"])
        code_hash = keccak256(s["code"]) if s["code"] else J_EMPTY_CODE_HASH
        acct.update(keccak256(a), JAccount(s["nonce"], s["balance"], root,
                                           code_hash).encode())
    return bytes(JHasher().hash(acct.root, True)[0])


def _jax_statedb(marker=None):
    """A JAX StateDB whose tries carry `marker` (default: the planned mode).
    A plain host batch keccak as marker makes every large trie hash through
    the JAX BatchedHasher, with no XLA compile."""
    if marker is None:
        marker = PlannedModeKeccak(BatchedKeccak().digests)
    return StateDB(J_EMPTY_ROOT, Database(TrieDatabase(MemoryDB(),
                                                       batch_keccak=marker)))


def _port_objects(state, addrs, mode):
    """address -> (Account with an empty root, its storage StateTrie)."""
    objs = {}
    for a in addrs:
        s = state[a]
        st = None
        if s["slots"]:
            st = StateTrie(batch_keccak=mode)
            for k, v in s["slots"].items():
                st.update(k, _slot_value(v))
        objs[a] = (Account(s["nonce"], s["balance"], EMPTY_ROOT,
                           _code_hash(s)), st)
    return objs


def _port_block(objs, state, touched, writes):
    """Apply the block to the port's objects; returns the changed map."""
    changed = {}
    for a in touched:
        acct, st = objs[a]
        acct.nonce, acct.balance = state[a]["nonce"], state[a]["balance"]
        for k, v in writes.get(a, {}).items():
            st.update(k, _slot_value(v))
        changed[a] = (acct, st if a in writes else None)
    return changed


def _jax_apply(sdb, state, addrs, slot_writes=None):
    for a in addrs:
        s = state[a]
        sdb.set_nonce(a, s["nonce"])
        sdb.set_balance(a, s["balance"])
        if slot_writes is None and s["code"]:
            sdb.set_code(a, s["code"])
        slots = s["slots"] if slot_writes is None else slot_writes.get(a, {})
        for k, v in slots.items():
            sdb.set_state(a, k, v)


@pytest.fixture(scope="module")
def slice_roots():
    """Roots from the port's planned path and from both JAX oracles, for the
    genesis commit and the block commit."""
    rng, addrs, state = _world()
    out = {}

    # the JAX package's own StateDB planned path
    sdb = _jax_statedb()
    _jax_apply(sdb, state, addrs)
    out["jax_statedb_genesis"] = sdb.intermediate_root(False)
    out["jax_cpu_genesis"] = _jax_cpu_root(state)

    # the port: StateTrie + PlannedGraphBuilder + PlannedCommit on the CPU
    planned.planned_fallbacks = 0
    commit = PlannedCommit(device="cpu")
    mode = PlannedMode(commit)
    account_trie = StateTrie(batch_keccak=mode)
    objs = _port_objects(state, addrs, mode)
    builder = PlannedGraphBuilder()
    out["port_genesis"] = planned_intermediate_root(
        account_trie, objs, planned=commit, builder=builder)
    out["genesis_segments"] = len(builder.plan[0])
    out["genesis_dispatches"] = commit.last_dispatches

    touched, writes = _block(rng, addrs, state)
    _jax_apply(sdb, state, touched, slot_writes=writes)
    out["jax_statedb_block"] = sdb.intermediate_root(False)
    out["jax_cpu_block"] = _jax_cpu_root(state)

    changed = _port_block(objs, state, touched, writes)
    out["port_block"] = planned_intermediate_root(account_trie, changed,
                                                  planned=commit)
    out["block_dispatches"] = commit.last_dispatches
    out["fallbacks"] = planned.planned_fallbacks
    out["storage_roots"] = [
        (objs[a][0].root, _jax_storage_root(state[a]["slots"]))
        for a in addrs[:N_CONTRACTS]]
    return out


def test_genesis_root_matches_jax_statedb_and_cpu_hasher(slice_roots):
    r = slice_roots
    assert r["port_genesis"] == r["jax_statedb_genesis"] == r["jax_cpu_genesis"]
    assert r["genesis_segments"] > 1 and r["genesis_dispatches"] == 1


def test_block_root_matches_jax_statedb_and_cpu_hasher(slice_roots):
    r = slice_roots
    assert r["port_block"] == r["jax_statedb_block"] == r["jax_cpu_block"]
    assert r["port_block"] != r["port_genesis"]
    assert r["block_dispatches"] == 1


def test_no_planned_fallbacks(slice_roots):
    assert slice_roots["fallbacks"] == 0


def test_storage_roots_patched_into_accounts(slice_roots):
    """After the block each contract's Account.root is its storage root,
    read back from the device digests."""
    for got, want in slice_roots["storage_roots"]:
        assert got == want != EMPTY_ROOT
    assert EMPTY_CODE_HASH == J_EMPTY_CODE_HASH


@pytest.fixture(scope="module")
def batched_roots(slice_roots):
    """The same world and block through the port's "batched" mode
    (intermediate_root on get_batch_keccak("batched", device="cpu"):
    BatchedHasher over K2's plain version) and through a JAX StateDB whose
    tries hash with the JAX BatchedHasher on the native host keccak."""
    rng, addrs, state = _world()
    out = {"jax_cpu_genesis": slice_roots["jax_cpu_genesis"],
           "jax_cpu_block": slice_roots["jax_cpu_block"]}

    sdb = _jax_statedb(j_keccak256_batch)
    _jax_apply(sdb, state, addrs)
    out["jax_statedb_genesis"] = sdb.intermediate_root(False)

    mode = get_batch_keccak("batched", device="cpu")
    mode.batched.reset_totals()
    hasher.keccak_batches = 0
    account_trie = StateTrie(batch_keccak=mode)
    objs = _port_objects(state, addrs, mode)
    out["port_genesis"] = intermediate_root(account_trie, dict(objs), mode,
                                            device="cpu")
    out["genesis_batches"] = hasher.keccak_batches
    out["genesis_launches"] = mode.batched.launches

    touched, writes = _block(rng, addrs, state)
    _jax_apply(sdb, state, touched, slot_writes=writes)
    out["jax_statedb_block"] = sdb.intermediate_root(False)
    changed = _port_block(objs, state, touched, writes)
    out["port_block"] = intermediate_root(account_trie, changed, mode,
                                          device="cpu")
    out["block_batches"] = hasher.keccak_batches - out["genesis_batches"]
    out["storage_roots"] = [
        (objs[a][0].root, _jax_storage_root(state[a]["slots"]))
        for a in addrs[:N_CONTRACTS]]
    return out


def test_batched_genesis_root_matches_jax_statedb_and_cpu_hasher(
        batched_roots):
    r = batched_roots
    assert r["port_genesis"] == r["jax_statedb_genesis"] == \
        r["jax_cpu_genesis"]
    # the account trie went level by level through the batch seam
    assert r["genesis_batches"] >= 3
    assert r["genesis_launches"] >= r["genesis_batches"]


def test_batched_block_root_matches_jax_statedb_and_cpu_hasher(batched_roots):
    r = batched_roots
    assert r["port_block"] == r["jax_statedb_block"] == r["jax_cpu_block"]
    assert r["block_batches"] >= 3
    for got, want in r["storage_roots"]:
        assert got == want != EMPTY_ROOT


def test_too_many_segments_commit_falls_back_to_batched(monkeypatch,
                                                        slice_roots):
    """planned_intermediate_root over a graph larger than the segment table:
    the holes heal through each storage trie's own hash() and the account
    trie through its own Trie.hash, whose planned re-plan overflows too and
    goes to BatchedHasher on its marker (two fallbacks per commit); the
    roots stay the CPU Hasher's."""
    monkeypatch.setattr(keccak_planned, "MAX_SEGMENTS", 2)
    monkeypatch.setattr(planned, "planned_fallbacks", 0)
    monkeypatch.setattr(hasher, "keccak_batches", 0)
    rng, addrs, state = _world()
    commit = PlannedCommit(device="cpu")
    mode = PlannedMode(commit)
    account_trie = StateTrie(batch_keccak=mode)
    objs = _port_objects(state, addrs, mode)
    assert planned_intermediate_root(account_trie, dict(objs),
                                     planned=commit) == \
        slice_roots["jax_cpu_genesis"]
    assert planned.planned_fallbacks == 2
    assert commit.last_dispatches == 0
    assert hasher.keccak_batches >= 3
    for a in addrs[:N_CONTRACTS]:
        assert objs[a][0].root == _jax_storage_root(state[a]["slots"])
    touched, writes = _block(rng, addrs, state)
    changed = _port_block(objs, state, touched, writes)
    assert intermediate_root(account_trie, changed, mode) == \
        slice_roots["jax_cpu_block"]
    assert planned.planned_fallbacks == 4
