"""The port's device-resident commit (coreth_tpu_torch/ops/keccak_resident.py
ResidentExecutor with native/mpt.IncrementalTrie) on the CPU, against the
JAX package on the same seeded inputs.

The reference is the JAX ResidentExecutor (XLA on the JAX CPU backend, in
its per-segment form, template mode, lean rows on), fed from the JAX
package's own IncrementalTrie: one run over a genesis of 500 keys and five
rounds of churn gives the root and digest matrix of each commit. The
port's executor, lean rows on and off, must give the same roots, and the
port trie's export must equal the JAX trie's, array by
array (JAX tries driven through a recording stand-in executor give the
exports of each lean setting at no device cost). Tolerance zero throughout.
The rest holds the port's executor to the native host commit of a twin
JAX trie: growth, deletion down to empty, ownership, mode pinning,
pipelined dispatch, the staging ring, the store readback, and the
resident block commit of statedb.resident_intermediate_root."""

import numpy as np
import pytest

from coreth_tpu.native import mpt as jmpt
from coreth_tpu.ops.keccak_resident import \
    ResidentExecutor as JResidentExecutor
from coreth_tpu_torch import rlp
from coreth_tpu_torch.device import hopper_available
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch.native.mpt import EMPTY_ROOT, IncrementalTrie
from coreth_tpu_torch.ops import keccak_cuda
from coreth_tpu_torch.ops.keccak_planned import PlannedCommit, PlannedMode
from coreth_tpu_torch.ops.keccak_resident import LEAN_WORDS, \
    ResidentExecutor, _pow2_bucket
from coreth_tpu_torch.state.account import Account
from coreth_tpu_torch.state.statedb import batch_storage_roots, \
    planned_intermediate_root, resident_intermediate_root
from coreth_tpu_torch.trie.hasher import Hasher
from coreth_tpu_torch.trie.secure import StateTrie
from coreth_tpu_torch.trie.trie import trie_from_items

N_GENESIS, ROUNDS, CHURN = 500, 5, 12


def _items(rng, n):
    keys = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    lens = rng.integers(1, 110, n)
    return [(keys[i].tobytes(), rng.bytes(int(lens[i]))) for i in range(n)]


def _churn(rng, keys, n):
    """n mixed updates: replace (45%), insert (30%), delete (25%)."""
    batch = []
    for _ in range(n):
        r = rng.random()
        if r < 0.45:
            batch.append((keys[int(rng.integers(len(keys)))],
                          rng.bytes(int(rng.integers(1, 100)))))
        elif r < 0.75:
            k = rng.bytes(32)
            keys.append(k)
            batch.append((k, rng.bytes(int(rng.integers(1, 100)))))
        else:
            batch.append((keys[int(rng.integers(len(keys)))], b""))
    return batch


def _sequence(seed=11, n=N_GENESIS, rounds=ROUNDS, churn=CHURN):
    rng = np.random.default_rng(seed)
    items = _items(rng, n)
    keys = [k for k, _ in items]
    return items, [_churn(rng, keys, churn) for _ in range(rounds)]


class _JaxRecording(JResidentExecutor):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.digs = []

    def run(self, export):
        root = super().run(export)
        self.digs.append(np.asarray(self.last_dig))
        return root


class _ExportRecorder:
    """Stand-in executor for a JAX IncrementalTrie's resident commits: it
    keeps each export and runs nothing (the plan needs no digests)."""

    def __init__(self):
        self.exports = []

    def check_binding(self, tree):
        pass

    def bind(self, tree):
        pass

    def run(self, export):
        self.exports.append(export)


class _Recording(ResidentExecutor):
    def __init__(self):
        super().__init__(device="cpu")
        self.exports = []

    def run(self, export):
        self.exports.append(export)
        return super().run(export)


@pytest.fixture(scope="module")
def seq():
    return _sequence()


@pytest.fixture(scope="module")
def jax_ref(seq):
    """The JAX package's roots and digest matrices per commit (per-segment
    ResidentExecutor, template mode, lean on), and its trie's exports per
    lean setting."""
    items, batches = seq
    t = jmpt.IncrementalTrie(items)
    t.set_lean(True)
    ex = _JaxRecording(fused=False)
    roots = []
    for batch in [()] + batches:
        t.update(batch)
        roots.append(t.commit_template(ex))
    exports = {}
    for lean in (True, False):
        rec = _ExportRecorder()
        tl = jmpt.IncrementalTrie(items)
        tl.set_lean(lean)
        for batch in [()] + batches:
            tl.update(batch)
            tl.commit_resident(rec)
        exports[lean] = rec.exports
    host = jmpt.IncrementalTrie(items)
    want = []
    for batch in [()] + batches:
        host.update(batch)
        want.append(host.commit_cpu())
    assert roots == want
    return {"roots": roots, "digs": ex.digs, "exports": exports}


def _assert_same_export(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        if k == "fresh":
            assert sorted(x) == sorted(y)
            for cls in x:
                assert np.array_equal(x[cls][0], y[cls][0])
                assert np.array_equal(x[cls][1], y[cls][1])
        elif k == "lean":
            assert (x is None) == (y is None)
            if x is not None:
                for u, v in zip(x, y):
                    assert np.array_equal(u, v)
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("lean", [True, False])
def test_resident_commits_equal_jax(seq, jax_ref, lean):
    items, batches = seq
    t = IncrementalTrie(items)
    t.set_lean(lean)
    ex = _Recording()
    roots = []
    for batch in [()] + batches:
        t.update(batch)
        roots.append(ex.root_bytes(t.commit_resident(ex)))
    assert roots == jax_ref["roots"]
    assert len(ex.exports) == len(jax_ref["exports"][lean]) == ROUNDS + 1
    for mine, theirs in zip(ex.exports, jax_ref["exports"][lean]):
        _assert_same_export(mine, theirs)
    # two uploads: the packed rows and one int32 table of every index
    assert ex.last_transfers == 2 and ex.last_dispatches == 1
    if lean:
        n = ex.exports[-1]["lean"][1].shape[0]
        assert ex.last_lean_rows == n
        assert ex.last_lean_wire_bytes == n * (4 * LEAN_WORDS + 8)


def test_template_digests_equal_jax(seq, jax_ref):
    """Template mode: roots equal, and each commit's digest matrix equal to
    the JAX executor's (per-segment form) in every real lane; pad lanes
    hash the arena's scratch row, whose content the forms fill
    differently."""
    items, batches = seq
    t = IncrementalTrie(items)
    t.set_lean(True)
    ex = _Recording()
    for i, batch in enumerate([()] + batches):
        t.update(batch)
        assert t.commit_template(ex) == jax_ref["roots"][i]
        assert t.root() == jax_ref["roots"][i]
        mine, theirs = ex.host_digests(), jax_ref["digs"][i]
        assert mine.shape == theirs.shape
        real = np.flatnonzero(ex.exports[i]["lane_slot"] >= 2) + 1
        assert real.size == ex.exports[i]["num_dirty"]
        assert np.array_equal(mine[real], theirs[real])
        assert not mine[0].any()
    # the template trie's host cache serves the node export directly
    host = jmpt.IncrementalTrie(items)
    for batch in batches:
        host.update(batch)
    host.commit_cpu()
    assert np.array_equal(t.export_nodes()[0], host.export_nodes()[0])


def _oracle(state):
    if not state:
        return EMPTY_ROOT
    return jmpt.plan_from_items(sorted(state.items())).execute_cpu()


def test_growth_reallocates_store_and_arenas():
    rng = np.random.default_rng(5)
    state = dict(_items(rng, 40))
    t = IncrementalTrie(sorted(state.items()))
    ex = ResidentExecutor(device="cpu")
    assert ex.root_bytes(t.commit_resident(ex)) == _oracle(state)
    store_cap, rows_cap = ex.store.shape[0], ex.arenas[1].shape[0]
    before = ex.device_bytes()
    batch = _items(rng, 5000)
    state.update(batch)
    t.update(batch)
    assert ex.root_bytes(t.commit_resident(ex)) == _oracle(state)
    assert ex.store.shape[0] > store_cap and ex.arenas[1].shape[0] > rows_cap
    assert ex.device_bytes() > before
    # the grown state keeps serving delta patches
    batch = [(k, rng.bytes(50)) for k, _ in batch[:30]]
    state.update(batch)
    t.update(batch)
    assert ex.root_bytes(t.commit_resident(ex)) == _oracle(state)


def test_delete_down_to_empty_and_back():
    rng = np.random.default_rng(6)
    items = _items(rng, 30)
    t = IncrementalTrie(items)
    ex = ResidentExecutor(device="cpu")
    assert ex.root_bytes(t.commit_resident(ex)) == _oracle(dict(items))
    t.update([(k, b"") for k, _ in items[:25]])
    assert ex.root_bytes(t.commit_resident(ex)) == _oracle(dict(items[25:]))
    t.update([(k, b"") for k, _ in items[25:]])
    assert ex.root_bytes(t.commit_resident(ex)) == EMPTY_ROOT
    assert t.num_nodes == 0
    t.update(items[:10])
    assert ex.root_bytes(t.commit_resident(ex)) == _oracle(dict(items[:10]))


def test_executor_refuses_a_second_trie_and_modes_are_pinned():
    rng = np.random.default_rng(7)
    items = _items(rng, 50)
    t1, t2 = IncrementalTrie(items), IncrementalTrie(items)
    ex = ResidentExecutor(device="cpu")
    t1.commit_resident(ex)
    with pytest.raises(RuntimeError, match="another trie"):
        t2.commit_resident(ex)
    with pytest.raises(RuntimeError, match="resident mode"):
        t1.root()
    with pytest.raises(RuntimeError, match="commit mode"):
        t1.commit_cpu()
    with pytest.raises(RuntimeError, match="commit mode"):
        t1.commit_template(ex)
    t3 = IncrementalTrie(items)
    t3.commit_cpu()
    with pytest.raises(RuntimeError, match="commit mode"):
        t3.commit_resident(ResidentExecutor(device="cpu"))
    # a node too wide for a resident row: the plan raises before the mode
    # is pinned, so the trie still commits on the host
    t4 = IncrementalTrie([(b"\x01" * 32, b"\x00" * 9000)])
    with pytest.raises(ValueError, match="row limit"):
        t4.commit_resident(ResidentExecutor(device="cpu"))
    assert t4.commit_cpu() == _oracle({b"\x01" * 32: b"\x00" * 9000})
    with pytest.raises(NotImplementedError, match="item 6"):
        ResidentExecutor(device="cpu", sharding=object())


def test_pipelined_dispatch_with_rejected_block():
    """pipeline_depth 2: up to two commits queued before their roots are
    read, one block rejected (checkpoint, update, commit, rollback,
    commit): every resolved root equals the host twin's."""
    items, batches = _sequence(seed=12, n=500, rounds=5)
    t = IncrementalTrie(items)
    t.set_lean(True)
    host = jmpt.IncrementalTrie(items)
    ex = ResidentExecutor(device="cpu", pipeline_depth=2)
    pending = [(t.commit_resident_dispatch(ex), host.commit_cpu())]
    for i, batch in enumerate(batches):
        if i == 2:
            t.checkpoint()
            t.update(batch)
            pending.append((t.commit_resident_dispatch(ex), None))
            t.rollback()
            pending.append((t.commit_resident_dispatch(ex),
                            host.commit_cpu()))
            continue
        t.update(batch)
        host.update(batch)
        pending.append((t.commit_resident_dispatch(ex), host.commit_cpu()))
    got = [resolve() for resolve, _ in pending]
    want = [w for _, w in pending]
    rejected = 3
    assert got[rejected] not in (got[rejected - 1], None)
    assert got[rejected + 1] == got[rejected - 1]
    assert [g for g, w in zip(got, want) if w is not None] == \
        [w for w in want if w is not None]
    assert ex.root_bytes(t.commit_resident(ex)) == want[-1]  # nothing dirty


def _ring_ptrs(ex):
    return [(a.data_ptr(), r.data_ptr()) for a, r, _ in ex._ring]


def test_staging_ring_hits_on_repeated_shapes():
    """pipeline_depth 2: the ring fills to three entries, then every commit
    of the same shape reuses its oldest entry's buffers."""
    rng = np.random.default_rng(8)
    items = _items(rng, 400)
    state = dict(items)
    keys = [k for k, _ in items[:6]]
    t = IncrementalTrie(items)
    ex = ResidentExecutor(device="cpu", pipeline_depth=2)
    t.commit_resident(ex)
    seen = []
    for _ in range(6):
        batch = [(k, rng.bytes(40)) for k in keys]
        state.update(batch)
        t.update(batch)
        assert ex.root_bytes(t.commit_resident(ex)) == _oracle(state)
        seen.append(_ring_ptrs(ex)[-1])
        assert len(ex._ring) <= 3  # depth + 1
    assert seen[3:] == seen[:3]
    ex.pipeline_depth = 0  # lowering the depth shrinks the ring
    batch = [(keys[0], b"z")]
    state.update(batch)
    t.update(batch)
    assert ex.root_bytes(t.commit_resident(ex)) == _oracle(state)
    assert len(ex._ring) == 1


def test_staging_ring_replaces_outsized_buffers():
    """After the genesis' large upload, a small block's commit gives the
    genesis-sized staging buffers up; a larger commit grows them."""
    rng = np.random.default_rng(9)
    items = _items(rng, 3000)
    state = dict(items)
    t = IncrementalTrie(items)
    ex = ResidentExecutor(device="cpu")
    t.commit_resident(ex)
    aux, rows, _ = ex._ring[0]
    genesis_rows = rows.numel()
    assert 4 * (aux.numel() + genesis_rows) >= ex.h2d_bytes
    batch = [(items[0][0], b"small")]
    state.update(batch)
    t.update(batch)
    assert ex.root_bytes(t.commit_resident(ex)) == _oracle(state)
    assert ex._ring[0][1].numel() < genesis_rows // 4
    batch = _items(rng, 2000)
    state.update(batch)
    t.update(batch)
    assert ex.root_bytes(t.commit_resident(ex)) == _oracle(state)
    assert ex._ring[0][1].numel() > genesis_rows // 4


def test_store_readback_and_rebase():
    items, batches = _sequence(seed=13, n=400, rounds=3)
    t = IncrementalTrie(items)
    host = jmpt.IncrementalTrie(items)
    ex = ResidentExecutor(device="cpu")
    t.commit_resident(ex)
    for batch in batches:
        t.update(batch)
        host.update(batch)
        t.commit_resident(ex)
    want = host.commit_cpu()
    assert ex.root_bytes(ex.last_root) == want
    t.absorb_store_parts(ex.store_parts())
    got, jgot = t.export_nodes(), host.export_nodes()
    assert np.array_equal(got[0], jgot[0]) and got[1] == jgot[1]
    t.absorb_store(ex.store)
    t.rebase_residency()
    ex2 = ResidentExecutor(device="cpu")
    assert ex.root_bytes(t.commit_resident(ex2)) == want
    assert ex2.h2d_bytes > ex.h2d_bytes  # every row uploaded again


def test_pow2_bucket():
    assert [_pow2_bucket(n) for n in (0, 1, 16, 17, 1000)] == \
        [16, 16, 16, 32, 1024]


# ---- the resident block commit (statedb.resident_intermediate_root) ----

N_ACCOUNTS, N_CONTRACTS, N_SLOTS = 150, 3, 50


def _slot(v: bytes) -> bytes:
    return rlp.encode(v.lstrip(b"\x00"))


class _World:
    """Accounts and storage as plain data, apart from any trie: the oracle
    builds independent tries from it."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.addrs = [self.rng.bytes(20) for _ in range(N_ACCOUNTS)]
        self.acct = {a: [int(self.rng.integers(0, 1000)),
                         int(self.rng.integers(1, 10**18))]
                     for a in self.addrs}
        self.slots = {a: {self.rng.bytes(32): b"\x01" + self.rng.bytes(31)
                          for _ in range(N_SLOTS)}
                      for a in self.addrs[:N_CONTRACTS]}

    def storage_root(self, a):
        if not self.slots.get(a):
            return EMPTY_ROOT
        t = trie_from_items((keccak256(k), _slot(v))
                            for k, v in self.slots[a].items())
        return bytes(Hasher().hash(t.root, True)[0])

    def oracle(self):
        t = trie_from_items(
            (keccak256(a), Account(nonce=n, balance=b,
                                   root=self.storage_root(a)).encode())
            for a, (n, b) in self.acct.items())
        return bytes(Hasher().hash(t.root, True)[0])


class _State:
    """One trie state of the world: Account objects and storage tries."""

    def __init__(self, world, mode=None):
        self.world, self.mode = world, mode
        self.accounts = {}
        self.storage = {}

    def changes(self, addrs, writes):
        changed = {}
        for a in addrs:
            if a not in self.world.acct:
                changed[a] = (None, None)
                self.accounts.pop(a, None)
                continue
            n, b = self.world.acct[a]
            acct = self.accounts.setdefault(a, Account())
            acct.nonce, acct.balance = n, b
            st = None
            if a in writes:
                st = self.storage.setdefault(
                    a, StateTrie(batch_keccak=self.mode))
                for k, v in writes[a].items():
                    st.update(k, _slot(v))
            changed[a] = (acct, st)
        return changed


def _blocks(world):
    """Genesis, then three blocks: (touched addresses, slot writes)."""
    rng = world.rng
    out = [(list(world.addrs), {a: dict(s) for a, s in world.slots.items()})]
    # block 1: balances of 20 accounts, 60 fresh slots in two contracts
    # (120 pending writes: one storage program)
    touched = [world.addrs[int(i)] for i in
               rng.choice(np.arange(N_CONTRACTS, N_ACCOUNTS), 20,
                          replace=False)]
    writes = {}
    for a in world.addrs[:2]:
        writes[a] = {rng.bytes(32): b"\x02" + rng.bytes(31)
                     for _ in range(60)}
        touched.append(a)
    out.append((touched, writes))
    # block 2: 5 slot overwrites (each trie's own hash) and two deletions
    a = world.addrs[2]
    writes = {a: {k: b"\x03" + rng.bytes(31)
                  for k in list(world.slots[a])[:5]}}
    out.append(([a, world.addrs[10], world.addrs[11]], writes))
    # block 3: balance churn only
    out.append(([world.addrs[int(i)] for i in rng.choice(
        np.arange(20, N_ACCOUNTS), 30, replace=False)], {}))
    return out


def _apply(world, i, touched, writes):
    if i == 2:  # block 2 deletes two accounts
        for a in touched[1:]:
            world.acct.pop(a)
    for a in touched:
        if a in world.acct and i:
            world.acct[a][1] += 10**15 + i
    for a, w in writes.items():
        world.slots.setdefault(a, {}).update(w)


def test_resident_intermediate_root_matches_planned_and_hasher():
    """Genesis plus three blocks through resident_intermediate_root (lean
    resident and template mode side by side) on the CPU: every root equals
    planned_intermediate_root on a twin state and the CPU Hasher over
    independent tries."""
    world = _World(21)
    planned = PlannedCommit(device="cpu")
    mode = PlannedMode(planned)
    res, twin = _State(world, mode), _State(world, mode)
    acct_trie = StateTrie(batch_keccak=mode)
    t_res, t_tpl = IncrementalTrie(), IncrementalTrie()
    t_res.set_lean(True)
    ex_res = ResidentExecutor(device="cpu")
    ex_tpl = ResidentExecutor(device="cpu")
    for i, (touched, writes) in enumerate(_blocks(world)):
        if i:
            _apply(world, i, touched, writes)
        changed = res.changes(touched, writes)
        got = resident_intermediate_root(t_res, ex_res, changed,
                                         device="cpu")
        got_tpl = resident_intermediate_root(t_tpl, ex_tpl, changed,
                                             template=True, device="cpu")
        want = planned_intermediate_root(
            acct_trie, twin.changes(touched, writes),
            planned=planned)
        assert got == got_tpl == want == world.oracle(), f"block {i}"
    assert t_tpl.root() == want


def test_batch_storage_roots_hashes_every_dirty_trie():
    world = _World(22)
    state = _State(world, PlannedMode(PlannedCommit(device="cpu")))
    changed = state.changes(world.addrs[:5], world.slots)
    assert batch_storage_roots(changed, device="cpu") == N_CONTRACTS
    for a in world.addrs[:N_CONTRACTS]:
        acct, st = changed[a]
        assert acct.root == world.storage_root(a) == st.hash()
        assert st.trie.unhashed == 0
    assert batch_storage_roots(changed, device="cpu") == 0  # all clean


@pytest.mark.cuda
def test_resident_on_cuda_equals_cpu():
    """K1 through the resident executor on the card: every root equals the
    CPU executor's, pipelined and in template mode, and K1 launched."""
    if not hopper_available():
        pytest.skip("needs a CUDA device with compute capability >= 9.0")
    items, batches = _sequence(seed=14, n=3000, rounds=6, churn=40)
    tc, tg, tt = (IncrementalTrie(items) for _ in range(3))
    tg.set_lean(True)
    exc = ResidentExecutor(device="cpu")
    exg = ResidentExecutor(pipeline_depth=2)
    ext = ResidentExecutor()
    keccak_cuda.reset_counts()
    want, resolves, tpl = [], [], []
    for batch in [()] + batches:
        for t in (tc, tg, tt):
            t.update(batch)
        want.append(exc.root_bytes(tc.commit_resident(exc)))
        resolves.append(tg.commit_resident_dispatch(exg))
        tpl.append(tt.commit_template(ext))
    assert [r() for r in resolves] == want == tpl
    assert keccak_cuda.launches > 0
    assert exg.last_events is not None
