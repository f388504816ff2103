"""The port's mesh-sharded resident mirror on the CPU, after
tests/test_resident_mesh.py and tests/test_per_shard_absorb.py.

The port's mirrors run on virtual meshes of n CPU positions
(ResidentAccountMirror(mesh_devices=n, device="cpu"): the executor's store
and arenas split by rows over n shards, K1's plain version per shard).
Every root must equal the native host oracle's and the reference mirror's
(its host mode: the same lifecycle over the native hasher), at widths 1,
2, 4 and 8, through a reject and a reorg; tolerance zero.

The ladder, by the port's rule (ROADMAP Queue 3): a wedge or a K1 error
on a mesh commit raises to the caller with the applied stack unchanged;
only take_over_host() moves the mirror down, one rung a call: mesh ->
single device (host-oracle re-proof, state/resident/mesh_demotions),
then single device -> host. The reference walks the same ladder by
itself inside the failing commit."""

import random

import pytest

from coreth_tpu import params as jparams
from coreth_tpu.consensus.dummy import new_dummy_engine as j_new_dummy_engine
from coreth_tpu.core.chain_makers import generate_chain as j_generate_chain
from coreth_tpu.core.genesis import Genesis as JGenesis
from coreth_tpu.core.genesis import GenesisAccount as JGenesisAccount
from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.crypto.secp256k1 import priv_to_address
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu.state.database import Database as JDatabase
from coreth_tpu.trie.resident_mirror import \
    ResidentAccountMirror as JResidentAccountMirror
from coreth_tpu.trie.triedb import TrieDatabase as JTrieDatabase
from coreth_tpu_torch import fault, params, parallel
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Block
from coreth_tpu_torch.device import DeviceWedgedError, KernelLaunchError
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.metrics import default_registry
from coreth_tpu_torch.native.mpt import IncrementalTrie, plan_from_items
from coreth_tpu_torch.ops.device import default_ladder
from coreth_tpu_torch.ops.keccak_resident import ResidentExecutor
from coreth_tpu_torch.parallel import MeshConfigError
from coreth_tpu_torch.trie.resident_mirror import ResidentAccountMirror

WIDTHS = (1, 2, 4, 8)


@pytest.fixture(autouse=True)
def _clear():
    yield
    fault.clear_all()
    default_ladder().reset()


def _count(name):
    return default_registry.counter(name).count()


def _rand_items(rng, n):
    return {rng.randbytes(32): rng.randbytes(rng.randint(1, 90))
            for _ in range(n)}


def _oracle(state: dict) -> bytes:
    return plan_from_items(sorted(state.items())).execute_cpu()


def _apply(state: dict, batch):
    out = dict(state)
    for k, v in batch:
        if v:
            out[k] = v
        else:
            out.pop(k, None)
    return out


def _batch(rng, state, n):
    keys = list(state)
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.5 and keys:
            out.append((rng.choice(keys), rng.randbytes(60)))
        elif r < 0.85:
            out.append((rng.randbytes(32), rng.randbytes(40)))
        elif keys:
            out.append((rng.choice(keys), b""))
    return out


def _hash(i: int) -> bytes:
    return bytes([i & 0xFF, (i >> 8) & 0xFF]) * 16


def _mesh_mirror(genesis, width, **kw):
    return ResidentAccountMirror(sorted(genesis.items()), mesh_devices=width,
                                 device="cpu", **kw)


@pytest.mark.parametrize("width", WIDTHS)
def test_mesh_width_matches_oracles(width):
    """Linear chain + reject + reorg at every width: every root equals
    the host oracle's and the reference mirror's; the executor really is
    sharded `width` ways, and its accounting says so."""
    rng = random.Random(4100 + width)
    genesis = _rand_items(rng, 1200)
    m = _mesh_mirror(genesis, width)
    ref = JResidentAccountMirror(sorted(genesis.items()), prefer_host=True)
    assert not m.host_mode and m.shards == m.ex.shards == width
    assert m.mesh_devices == width
    assert m.root_of(m.GENESIS) == ref.root_of(ref.GENESIS) == \
        _oracle(genesis)
    state, parent = genesis, m.GENESIS
    states = {parent: genesis}
    for i in range(1, 5):
        h = _hash(i)
        batch = _batch(rng, state, 30)
        state = _apply(state, batch)
        states[h] = state
        want = _oracle(state)
        assert m.verify(parent, h, batch) == ref.verify(parent, h, batch) \
            == want, f"block {i}"
        parent = h
    for mm in (m, ref):
        mm.reject(_hash(4))
    assert m.root_of(_hash(3)) == _oracle(states[_hash(3)])
    # reorg: a sibling of block 3 on top of block 2 (rewind + replay)
    fork = _batch(rng, states[_hash(2)], 30)
    want = _oracle(_apply(states[_hash(2)], fork))
    assert m.verify(_hash(2), _hash(99), fork) == \
        ref.verify(_hash(2), _hash(99), fork) == want
    assert m.ex.last_gather_bytes == 0
    assert len(m.ex.last_shard_lanes) == width
    assert sum(m.ex.last_shard_lanes) > 0
    assert (m.ex.last_gather_bytes_modeled > 0) == (width > 1)
    if width > 1:
        assert len(m.ex._store_parts) == width and m.ex.store is None
    # the sharded store reads back whole: the interval export's image
    # hashes to the same root on the host
    disk = MemoryDB()
    assert m.export_to(disk, at_block=_hash(99)) > 0
    assert m.spot_check()


def test_mesh_width_past_the_knob_raises():
    with pytest.raises(MeshConfigError, match="does not divide"):
        ResidentAccountMirror([(b"\x01" * 32, b"v")], mesh_devices=3,
                              device="cpu")


# ---- per-shard absorb against the full readback -------------------------


def _workload(seed, n=1200, rounds=3, churn=60):
    rng = random.Random(seed)
    state = _rand_items(rng, n)
    boot = sorted(state.items())
    batches = []
    for _ in range(rounds):
        b = _batch(rng, state, churn)
        batches.append(b)
        state = _apply(state, b)
    return boot, batches


@pytest.mark.parametrize("width", [2, 8])
def test_per_shard_absorb_matches_full_readback(width):
    """Template commits on a sharded executor: the per-shard absorb (each
    shard's digests read back from its own store block) and the one full
    readback leave the same host digest cache, node image and roots as
    the host commit; only the full readback counts a measured gather."""
    boot, batches = _workload(5000 + width)
    mesh = parallel.make_mesh(width, device="cpu")
    a, b, h = (IncrementalTrie(boot) for _ in range(3))
    ea = parallel.resident_executor_over_mesh(mesh)
    eb = parallel.resident_executor_over_mesh(mesh)
    d2h0, gather0 = (_count("resident/absorb_d2h_bytes"),
                     _count("resident/gather_bytes"))
    for batch in [()] + batches:
        for t in (a, b, h):
            t.update(batch)
        want = h.commit_cpu()
        assert a.commit_template(ea) == want
        assert b.commit_template(eb, full_readback=True) == want
        assert ea.last_gather_bytes == 0 and ea.last_absorb_d2h_bytes > 0
        assert eb.last_gather_bytes > 0
        assert a.root() == b.root() == want
    na, nb, nh = (t.export_nodes() for t in (a, b, h))
    assert set(map(bytes, na[0])) == set(map(bytes, nb[0])) == \
        set(map(bytes, nh[0]))
    assert _count("resident/absorb_d2h_bytes") > d2h0
    assert _count("resident/gather_bytes") > gather0


def test_store_parts_cover_the_sharded_store():
    """The interval absorb's per-shard readback: contiguous parts, one a
    shard, that rebuild the host digest cache exactly."""
    boot, batches = _workload(5100, rounds=1)
    ex = parallel.resident_executor_over_mesh(
        parallel.make_mesh(4, device="cpu"))
    t, h = IncrementalTrie(boot), IncrementalTrie(boot)
    for batch in [()] + batches:
        t.update(batch)
        h.update(batch)
        assert ex.root_bytes(t.commit_resident(ex)) == h.commit_cpu()
    parts = ex.store_parts()
    assert len(parts) == 4
    assert [p[0] for p in parts] == [i * parts[0][1] for i in range(4)]
    assert parts[-1][1] == ex.store_capacity
    t.absorb_store_parts(parts)
    assert set(map(bytes, t.export_nodes()[0])) == \
        set(map(bytes, h.export_nodes()[0]))


# ---- the ladder, by the caller ------------------------------------------


def test_mesh_ladder_walked_by_the_caller_bit_exact():
    """A K1 error on a mesh commit raises with the applied stack as it
    was and marks the device untrusted; take_over_host() then demotes
    mesh -> single device (host-oracle re-proof, mesh_demotions, no
    takeover), a reject crosses the boundary, and a second call lands on
    the host. Every root along the way is the oracle's."""
    rng = random.Random(4300)
    genesis = _rand_items(rng, 800)
    m = _mesh_mirror(genesis, 4)
    b1 = _batch(rng, genesis, 20)
    s1 = _apply(genesis, b1)
    assert m.verify(m.GENESIS, _hash(1), b1) == _oracle(s1)
    real = m.ex.seg_impl
    calls = []

    def failing(words):
        calls.append(words.shape[0])
        raise KernelLaunchError("segment_keccak launch failed: CUDA error 700")

    m.ex.seg_impl = failing
    b2 = _batch(rng, s1, 20)
    s2 = _apply(s1, b2)
    wedges, dem0, to0 = (_count("state/resident/device_wedges"),
                         _count("state/resident/mesh_demotions"),
                         _count("state/resident/device_takeovers"))
    with pytest.raises(KernelLaunchError):
        m.verify(_hash(1), _hash(2), b2)
    assert calls and m.head == _hash(1) and m.root_of(_hash(2)) is None
    assert _count("state/resident/device_wedges") == wedges + 1
    with pytest.raises(DeviceWedgedError, match="take_over_host"):
        m.verify(_hash(1), _hash(2), b2)
    assert m.shards == 4  # nothing moved by itself
    m.ex.seg_impl = real

    assert m.take_over_host("test") == "device"
    assert not m.host_mode and m.shards == 1 and m.ex.shards == 1
    assert _count("state/resident/mesh_demotions") == dem0 + 1
    assert _count("state/resident/device_takeovers") == to0
    assert m.verify(_hash(1), _hash(2), b2) == _oracle(s2)
    b3 = _batch(rng, s2, 20)
    s3 = _apply(s2, b3)
    assert m.verify(_hash(2), _hash(3), b3) == _oracle(s3)
    m.reject(_hash(3))
    assert m.root_of(_hash(2)) == _oracle(s2)

    assert m.take_over_host("again") == "host"
    assert m.host_mode and m.shards == 1
    assert _count("state/resident/device_takeovers") == to0 + 1
    b4 = _batch(rng, s2, 20)
    s4 = _apply(s2, b4)
    assert m.verify(_hash(2), _hash(4), b4) == _oracle(s4)
    assert m.take_over_host("no-op") == "host"


def test_mid_window_wedge_raises_then_lands_one_rung_down():
    """A wedge while a depth-2 pipeline window is in flight on a 4-shard
    mesh: the drain raises DeviceWedgedError with the window and the
    applied stack as they were; take_over_host() settles the window on
    the single-device rung, every root its header's."""
    rng = random.Random(4200)
    genesis = _rand_items(rng, 800)
    # a dispatched commit's drain keeps the watchdog budget it was
    # dispatched with
    m = _mesh_mirror(genesis, 4, pipeline_depth=2, device_timeout=2.0)
    assert m._pipelining() and m.shards == 4
    state, parent = genesis, m.GENESIS
    expected = {}
    for i in range(1, 3):
        h = _hash(i)
        batch = _batch(rng, state, 20)
        state = _apply(state, batch)
        expected[h] = _oracle(state)
        assert m.verify(parent, h, batch,
                        expected_root=expected[h]) == expected[h]
        parent = h
    assert len(m._inflight) == 2
    applied = list(m._applied)
    fault.set_failpoint("resident/before_absorb", "hang")
    with pytest.raises(DeviceWedgedError):
        m.accept(_hash(1))
    assert m._applied == applied and len(m._inflight) == 2
    fault.clear_all()
    assert m.take_over_host("wedged drain") == "device"
    assert m._inflight == [] and m.shards == 1
    for h, root in expected.items():
        assert m.root_of(h) == root
    batch = _batch(rng, state, 20)
    state = _apply(state, batch)
    assert m.verify(parent, _hash(3), batch) == _oracle(state)


def test_failed_rebuild_lands_on_the_host(monkeypatch):
    """The single-device rebuild fails (its K1 raises): the demotion
    counts mesh_demotion_failures and the same call lands on the host,
    bit-exact."""
    rng = random.Random(4400)
    genesis = _rand_items(rng, 400)
    m = _mesh_mirror(genesis, 2)
    b1 = _batch(rng, genesis, 20)
    s1 = _apply(genesis, b1)
    assert m.verify(m.GENESIS, _hash(1), b1) == _oracle(s1)
    fail0 = _count("state/resident/mesh_demotion_failures")

    def refuse(self, export):
        raise KernelLaunchError("segment_keccak launch failed")

    monkeypatch.setattr(ResidentExecutor, "run", refuse)
    assert m.take_over_host("dead backend") == "host"
    assert m.host_mode
    assert _count("state/resident/mesh_demotion_failures") == fail0 + 1
    b2 = _batch(rng, s1, 20)
    assert m.verify(_hash(1), _hash(2), b2) == _oracle(_apply(s1, b2))


def test_mesh_spanning_processes_skips_to_the_host(monkeypatch):
    """The cross-process branch, by forcing its predicate: the
    single-device rung would be a unilateral local rebuild, so the mirror
    goes straight to the host."""
    rng = random.Random(4500)
    genesis = _rand_items(rng, 300)
    m = _mesh_mirror(genesis, 2)
    assert not m.ex.spans_processes
    monkeypatch.setattr(parallel, "mesh_spans_processes", lambda mesh: True)
    assert m.ex.spans_processes
    skips, dem0 = (_count("state/resident/mesh_demotion_cross_process_skips"),
                   _count("state/resident/mesh_demotions"))
    assert m.take_over_host("spans processes") == "host"
    assert _count(
        "state/resident/mesh_demotion_cross_process_skips") == skips + 1
    assert _count("state/resident/mesh_demotions") == dem0
    b1 = _batch(rng, genesis, 10)
    assert m.verify(m.GENESIS, _hash(1), b1) == \
        _oracle(_apply(genesis, b1))


# ---- the chain: the knob, the flight record, take_over_host -------------

KEY = b"\x11" * 32
ADDR = priv_to_address(KEY)
CHAIN_ID = 43112


@pytest.fixture(scope="module")
def chain_blocks():
    """Three blocks of one transfer each, built by the reference's
    generate_chain (signed once, decoded into the port)."""
    jdisk = JMemoryDB()
    db = JDatabase(JTrieDatabase(jdisk))
    gen = JGenesis(config=jparams.TEST_CHAIN_CONFIG,
                   gas_limit=jparams.CORTINA_GAS_LIMIT,
                   alloc={ADDR: JGenesisAccount(balance=10**22)})
    genesis = gen.commit(jdisk, db)
    signer = JSigner(CHAIN_ID)

    def tx_gen(i, bg):
        bf = bg.base_fee() or jparams.APRICOT_PHASE3_INITIAL_BASE_FEE
        tx = JTransaction(type=2, chain_id=CHAIN_ID, nonce=i, max_fee=bf * 2,
                          max_priority_fee=0, gas=21000, to=b"\x22" * 20,
                          value=1000 + i)
        bg.add_tx(signer.sign(tx, KEY))

    blocks, _ = j_generate_chain(jparams.TEST_CHAIN_CONFIG, genesis,
                                 j_new_dummy_engine(), db, 3, gen=tx_gen)
    return [Block.decode(b.encode()) for b in blocks]


def _chain(mesh):
    return BlockChain(
        MemoryDB(), CacheConfig(pruning=True, resident_account_trie=True,
                                resident_mesh_devices=mesh),
        params.TEST_CHAIN_CONFIG,
        Genesis(config=params.TEST_CHAIN_CONFIG,
                gas_limit=params.CORTINA_GAS_LIMIT,
                alloc={ADDR: GenesisAccount(balance=10**22)}),
        new_dummy_engine(), device="cpu")


@pytest.mark.parametrize("mesh", [0, 2])
def test_chain_flight_record_mesh_keys_unragged(chain_blocks, mesh):
    """Every insert's flight record carries resident.shards and the gather
    counters explicitly: shards=1 and zeros unsharded, the mesh's width
    and a modeled gather (but no measured one) sharded."""
    chain = _chain(mesh)
    try:
        assert chain.mirror.shards == max(1, mesh)
        for b in chain_blocks[:2]:
            chain.insert_block(b)
        recs = chain.flight_recorder.last()
        assert len(recs) == 2
        for r in recs:
            c = r["counters"]
            assert r["resident"]["shards"] == max(1, mesh)
            assert c["resident/gather_bytes"] == 0
            assert (c["resident/gather_bytes_modeled"] > 0) == (mesh > 1)
            for k in ("resident/absorb_d2h_bytes", "resident/lean_wire_bytes",
                      "resident/h2d_bytes"):
                assert k in c
    finally:
        chain.stop()


def test_chain_mesh_fault_reaches_insert_block_then_walks_down(chain_blocks):
    """A K1 error on the chain's mesh commit reaches insert_block with the
    head unchanged and the ladder healthy; take_over_host() lands on a
    single device (flight event mirror/mesh_demotion, the ladder left
    healthy), the retried insert lands, and the next call lands on the
    host and demotes the ladder."""
    chain = _chain(4)
    lad = default_ladder()
    try:
        chain.insert_block(chain_blocks[0])
        head = chain.current_block.hash()
        real = chain.mirror.ex.seg_impl

        def failing(words):
            raise KernelLaunchError("segment_keccak launch failed")

        chain.mirror.ex.seg_impl = failing
        with pytest.raises(KernelLaunchError):
            chain.insert_block(chain_blocks[1])
        assert chain.current_block.hash() == head and lad.healthy
        assert chain.mirror.shards == 4
        chain.mirror.ex.seg_impl = real
        assert chain.take_over_host("test") == "device"
        assert lad.healthy and chain.mirror.shards == 1
        events = [e["event"] for e in chain.flight_recorder.events()]
        assert "mirror/mesh_demotion" in events
        chain.insert_block(chain_blocks[1])
        assert chain.current_block.root == chain_blocks[1].root
        assert chain.take_over_host("test") == "host"
        assert chain.mirror.host_mode and not lad.healthy
        chain.insert_block(chain_blocks[2])
        assert chain.current_block.root == chain_blocks[2].root
    finally:
        chain.stop()
        lad.reset()


def test_mesh_knob_threads_through_the_stack():
    """resident-mesh-devices reaches the chain's mirror: 8 positions on
    the chain's device argument."""
    chain = _chain(8)
    try:
        assert chain.cache_config.resident_mesh_devices == 8
        assert chain.mirror.mesh_devices == 8 and chain.mirror.shards == 8
        assert all(d.type == "cpu" for d in chain.mirror.ex.shard_devices)
    finally:
        chain.stop()
