"""The port's branch-aware resident mirror (coreth_tpu_torch/trie/
resident_mirror.py) against the JAX package's, on the CPU.

The reference side is coreth_tpu's ResidentAccountMirror in host mode
(prefer_host=True: native host commits, no XLA compile). The port side is
the port's mirror on device="cpu", whose ResidentExecutor runs kernel K1's
plain version. Both take the same seeded batches through the corpus of
tests/test_resident_mirror.py (linear chain with finality flush, sibling
competition and reorg, rejecting an applied branch, flushed history being
final, a failed export write, an unknown parent); every root, every
MirrorError raised or not, every read and the bytes export_to writes must
be equal (tolerance zero). Then the port's pipelined dispatch (depth 2) and
template mode against its host twin, the device watchdog (a wedge raises;
the host takeover only when asked), MirrorStateTrie's disk fallback (host
mode only), the resident/commit span against the reference's, and the
device rules. The cuda case runs the mirror on K1 and skips here.
"""

import threading

import numpy as np
import pytest
import torch

from coreth_tpu.ethdb import MemoryDB as RefMemoryDB
from coreth_tpu.metrics import spans as ref_spans
from coreth_tpu.trie.resident_mirror import MirrorError as RefMirrorError
from coreth_tpu.trie.resident_mirror import \
    ResidentAccountMirror as RefMirror
from coreth_tpu_torch import fault
from coreth_tpu_torch.device import hopper_available
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.metrics import default_registry
from coreth_tpu_torch.metrics import spans
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch.device import DeviceWedgedError
from coreth_tpu_torch.native.mpt import plan_from_items
from coreth_tpu_torch.ops import keccak_cuda
from coreth_tpu_torch.ops.keccak_resident import ResidentExecutor
from coreth_tpu_torch.state.resident_trie import MirrorStateTrie
from coreth_tpu_torch.trie.resident_mirror import MirrorError, \
    ResidentAccountMirror
from coreth_tpu_torch.trie.triedb import TrieDatabase


@pytest.fixture(autouse=True)
def _no_host_override(monkeypatch):
    # the mode under test is chosen by the arguments alone
    monkeypatch.delenv("CORETH_TPU_RESIDENT_HOST", raising=False)
    monkeypatch.delenv("CORETH_TPU_RESIDENT_TIMEOUT", raising=False)


def _rand_items(rng, n):
    return {rng.bytes(32): rng.bytes(int(rng.integers(1, 91)))
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
    """n seeded updates on `state`: half overwrites, a third new keys, the
    rest deletions."""
    keys = sorted(state)
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.5 and keys:
            out.append((keys[int(rng.integers(len(keys)))], rng.bytes(60)))
        elif r < 0.85:
            out.append((rng.bytes(32), rng.bytes(40)))
        elif keys:
            out.append((keys[int(rng.integers(len(keys)))], b""))
    return out


def _counter(name: str) -> int:
    return default_registry.counter(name).count()


class _Pair:
    """The reference mirror (host mode) and the port's (device="cpu"),
    driven op by op: each call's result, or the MirrorError it raised,
    must agree; the port's result is returned or its error re-raised."""

    def __init__(self, items, **port_kw):
        self.ref = RefMirror(items, prefer_host=True)
        self.port = ResidentAccountMirror(items, device="cpu", **port_kw)
        assert self.port.host_mode is False and self.port.ex is not None

    def set_tip_buffer(self, n):
        self.ref.TIP_BUFFER = self.port.TIP_BUFFER = n

    @property
    def head(self):
        assert self.ref.head == self.port.head
        return self.port.head

    def __getattr__(self, op):
        def call(*args, **kw):
            outs = []
            for m, err in ((self.ref, RefMirrorError),
                           (self.port, MirrorError)):
                try:
                    outs.append((True, getattr(m, op)(*args, **kw)))
                except err as e:
                    outs.append((False, str(e)))
            assert outs[0] == outs[1], (op, outs)
            ok, val = outs[1]
            if not ok:
                raise MirrorError(val)
            return val
        return call

    def export_both(self, **kw) -> int:
        """export_to into a fresh store on each side: the counts and the
        stores' bytes must be equal."""
        ref_db, db = RefMemoryDB(), MemoryDB()
        n_ref = self.ref.export_to(ref_db, **kw)
        n = self.port.export_to(db, **kw)
        assert n == n_ref
        assert sorted(db.iterate()) == sorted(ref_db.iterate())
        return n


def test_linear_chain_with_finality_flush():
    rng = np.random.default_rng(41)
    genesis = _rand_items(rng, 400)
    m = _Pair(sorted(genesis.items()), lean_rows=True)
    assert m.root_of(m.port.GENESIS) == _oracle(genesis)
    assert m.export_both() > 0  # the genesis image
    state = genesis
    m.set_tip_buffer(4)  # window semantics, not size: keep the test light
    n_blocks = 4 + 6
    roots = {}
    for i in range(n_blocks):
        h = bytes([i + 1]) * 32
        batch = _batch(rng, state, 30)
        state = _apply(state, batch)
        root = m.verify(m.head, h, batch)
        assert root == _oracle(state), f"block {i}"
        roots[h] = root
        m.accept(h)
        assert m.head == h
        assert len(m.port._applied) <= 4 + 1
    assert m.root_of(bytes([1]) * 32) is None
    recent = bytes([n_blocks - 1]) * 32
    assert m.root_of(recent) == roots[recent]
    # reads at the head, and at a retained block (a tip-buffer rewind)
    for k in sorted(state)[:20]:
        assert m.read(roots[bytes([n_blocks]) * 32], k) == state[k]
    assert m.read(roots[recent], sorted(state)[0]) is not None
    assert m.export_both(at_block=bytes([n_blocks]) * 32) > 0


def test_sibling_competition_and_reorg():
    rng = np.random.default_rng(42)
    genesis = _rand_items(rng, 300)
    m = _Pair(sorted(genesis.items()))
    b1 = b"\x01" * 32
    batch1 = _batch(rng, genesis, 25)
    state1 = _apply(genesis, batch1)
    assert m.verify(m.port.GENESIS, b1, batch1) == _oracle(state1)
    a, b = b"\x0a" * 32, b"\x0b" * 32
    batch_a, batch_b = _batch(rng, state1, 20), _batch(rng, state1, 20)
    state_a, state_b = _apply(state1, batch_a), _apply(state1, batch_b)
    assert m.verify(b1, a, batch_a) == _oracle(state_a)
    assert m.verify(b1, b, batch_b) == _oracle(state_b)  # rewind A, replay
    a2 = b"\x2a" * 32
    batch_a2 = _batch(rng, state_a, 10)
    assert m.verify(a, a2, batch_a2) == _oracle(_apply(state_a, batch_a2))
    # a read at B's root while the head sits on the losing branch
    k = batch_b[0][0]
    assert m.read(m.root_of(b), k) == state_b.get(k)
    assert m.verify(b1, b, batch_b) == _oracle(state_b)
    m.accept(b1)
    m.accept(b)
    m.reject(a)
    assert m.root_of(a) is None and m.root_of(a2) is None
    b3 = b"\x03" * 32
    batch3 = _batch(rng, state_b, 15)
    assert m.verify(b, b3, batch3) == _oracle(_apply(state_b, batch3))
    with pytest.raises(MirrorError, match="ACCEPTED"):
        m.reject(b)


def test_reject_applied_branch_rewinds():
    rng = np.random.default_rng(43)
    genesis = _rand_items(rng, 200)
    m = _Pair(sorted(genesis.items()), template_residency=True)
    b1, b2 = b"\x01" * 32, b"\x02" * 32
    batch1 = _batch(rng, genesis, 20)
    m.verify(m.port.GENESIS, b1, batch1)
    m.verify(b1, b2, _batch(rng, _apply(genesis, batch1), 20))
    m.reject(b1)
    assert m.head == m.port.GENESIS
    assert m.root_of(b2) is None
    b1b = b"\x11" * 32
    batch1b = _batch(rng, genesis, 10)
    assert m.verify(m.port.GENESIS, b1b, batch1b) == \
        _oracle(_apply(genesis, batch1b))
    # the miner's anonymous preview, then the block that adopts it
    batch2 = _batch(rng, _apply(genesis, batch1b), 10)
    root = m.preview(b1b, batch2)
    assert m.verify(b1b, b"\x12" * 32, batch2) == root


def test_flushed_history_is_final():
    rng = np.random.default_rng(44)
    genesis = _rand_items(rng, 100)
    m = _Pair(sorted(genesis.items()))
    m.set_tip_buffer(4)
    state = genesis
    for i in range(4 + 2):
        h = bytes([i + 1]) * 32
        batch = _batch(rng, state, 10)
        state = _apply(state, batch)
        m.verify(m.head, h, batch)
        m.accept(h)
    with pytest.raises(MirrorError, match="unknown parent"):
        m.verify(m.port.GENESIS, b"\x0f" * 32, [])
    parent = bytes([4]) * 32
    sib = b"\xee" * 32
    assert m.verify(parent, sib, []) == m.root_of(parent)
    m.reject(sib)


class _FailAtWrite:
    class _Batch:
        def put(self, k, v):
            pass

        def write(self):
            raise OSError("disk full")

    def new_batch(self):
        return self._Batch()


def test_failed_export_write_degrades_to_full_image():
    rng = np.random.default_rng(46)
    genesis = _rand_items(rng, 120)
    m = _Pair(sorted(genesis.items()))
    n0 = m.export_both()
    assert n0 > 0
    keys = sorted(genesis)
    m.verify(m.head, b"\x01" * 32, [(keys[0], b"changed")])
    for side in (m.ref, m.port):
        with pytest.raises(OSError):
            side.export_to(_FailAtWrite())
    n_repair = m.export_both()  # a FULL image, equal on both sides
    assert n_repair >= n0
    assert m.export_both() == 0  # deltas are trusted again


def test_unknown_parent_rejected():
    rng = np.random.default_rng(45)
    m = _Pair(sorted(_rand_items(rng, 50).items()))
    with pytest.raises(MirrorError, match="unknown parent"):
        m.verify(b"\x77" * 32, b"\x78" * 32, [])
    with pytest.raises(MirrorError, match="never saw"):
        m.accept(b"\x78" * 32)
    with pytest.raises(MirrorError, match="not resident"):
        m.read(b"\x79" * 32, b"\x00" * 32)


def test_pipelined_and_template_against_the_host_twin():
    """A pipelined at depth 2 (lean rows), B template and C the port's own
    host twin over one chain with a sibling and a reject: every root
    equal. A dispatch recorded under a wrong header root is caught at the
    next drain: MirrorError, a pipeline_divergences count, and the block
    and its descendants rewound."""
    rng = np.random.default_rng(47)
    genesis = sorted(_rand_items(rng, 300).items())
    a = ResidentAccountMirror(genesis, device="cpu", pipeline_depth=2,
                              lean_rows=True)
    b = ResidentAccountMirror(genesis, device="cpu", template_residency=True)
    c = ResidentAccountMirror(genesis, prefer_host=True)
    assert c.host_mode and c.ex is None
    assert a.head == b.head == c.head == a.GENESIS
    assert a.root_of(a.GENESIS) == b.root_of(b.GENESIS) == \
        c.root_of(c.GENESIS)
    state = dict(genesis)
    parent = a.GENESIS
    for i in range(6):
        h = bytes([i + 1]) * 32
        batch = _batch(rng, state, 25)
        want = c.verify(parent, h, batch)
        assert a.verify(parent, h, batch, expected_root=want) == want
        assert b.verify(parent, h, batch) == want
        if i == 3:
            # a sibling verified and rejected on all three
            sib = b"\xee" * 32
            sb = _batch(rng, state, 12)
            want_sib = c.verify(parent, sib, sb)
            assert a.verify(parent, sib, sb, expected_root=want_sib) == \
                want_sib
            assert b.verify(parent, sib, sb) == want_sib
            for m in (a, b, c):
                m.reject(sib)
        for m in (a, b, c):
            m.accept(h)
        state = _apply(state, batch)
        parent = h
    assert a.last_overlap_fraction >= 0.0
    assert a.spot_check() and b.spot_check()
    for k in sorted(state)[:10]:
        root = c.root_of(parent)
        assert a.read(root, k) == b.read(root, k) == c.read(root, k)
    db_a, db_c = MemoryDB(), MemoryDB()
    a.export_to(db_a)
    c.export_to(db_c)
    assert dict(db_a.iterate()) == dict(db_c.iterate())
    divergences = _counter("state/resident/pipeline_divergences")
    bad = b"\xbb" * 32
    a.verify(parent, bad, _batch(rng, state, 5), expected_root=b"\x00" * 32)
    with pytest.raises(MirrorError, match="mismatch"):
        a.accept(bad)
    assert _counter("state/resident/pipeline_divergences") == divergences + 1
    assert a.root_of(bad) is None and a.head == parent
    assert not a.host_mode


class _Wedgeable:
    """A ResidentExecutor stand-in: forwards to a real executor, and once
    armed, its next run waits on an event that the test sets only after
    the watchdog has given up: a device that stops answering."""

    def __init__(self, ex):
        self._ex = ex
        self.armed = False
        self.release = threading.Event()

    def run(self, export):
        if self.armed:
            self.armed = False
            if not self.release.wait(120):  # bounded, as every wait here
                raise RuntimeError("the wedged run was never released")
        return self._ex.run(export)

    def __getattr__(self, name):
        return getattr(self._ex, name)


_LOUD = ("state/resident/device_wedges", "state/resident/device_takeovers",
         "state/resident/fallbacks")


def test_watchdog_takes_over_on_the_host():
    """A commit the device does not answer within device_timeout raises
    DeviceWedgedError (state/resident/device_wedges counts 1) and leaves
    the applied stack as it was; every later device operation raises too,
    and nothing moves to the host by itself. take_over_host(), which the
    caller asks for, moves the mirror there (state/resident/device_takeovers
    counts 1): the same block then verifies with the host twin's root, and
    so do the blocks after it. A wedged pipelined drain (the
    resident/before_absorb failpoint) raises with its window still in
    flight, and take_over_host settles that window on the host. The
    watchdog's budget is generous except around the wedged call, so a
    loaded test host cannot trip it elsewhere."""
    rng = np.random.default_rng(48)
    genesis = sorted(_rand_items(rng, 200).items())
    wedge = _Wedgeable(ResidentExecutor(device="cpu"))
    m = ResidentAccountMirror(genesis, executor=wedge, device_timeout=60)
    twin = ResidentAccountMirror(genesis, prefer_host=True)
    wedges, takeovers, fallbacks = (_counter(n) for n in _LOUD)
    state = dict(genesis)
    parent = m.GENESIS
    for i in range(4):
        h = bytes([i + 1]) * 32
        batch = _batch(rng, state, 20)
        want = twin.verify(parent, h, batch)
        if i == 1:
            wedge.armed = True
            m.device_timeout = 0.5
            applied = list(m._applied)
            with pytest.raises(DeviceWedgedError, match="within 0.5s"):
                m.verify(parent, h, batch)
            assert m._applied == applied and m.root_of(h) is None
            with pytest.raises(DeviceWedgedError, match="stopped answering"):
                m.verify(parent, h, batch)
            with pytest.raises(DeviceWedgedError, match="stopped answering"):
                m.export_to(MemoryDB())
            assert m._applied == applied and not m.host_mode
            assert [_counter(n) for n in _LOUD] == \
                [wedges + 1, takeovers, fallbacks]
            m.take_over_host("the test asks")
            assert m.host_mode
        assert m.verify(parent, h, batch) == want
        m.accept(h)
        twin.accept(h)
        state = _apply(state, batch)
        parent = h
    wedge.release.set()  # the abandoned worker runs on: executor only
    assert _counter(_LOUD[1]) == takeovers + 1
    db, db_twin = MemoryDB(), MemoryDB()
    m.export_to(db)  # degraded: a full image
    twin.export_to(db_twin)
    assert dict(db.iterate()) == dict(db_twin.iterate())

    # a pipelined commit's resolve keeps the budget it was dispatched
    # with: 2 s is far above a 200-key commit on a loaded host
    p = ResidentAccountMirror(genesis, device="cpu", pipeline_depth=2,
                              device_timeout=2.0)
    parent = p.GENESIS
    state = dict(genesis)
    twin = ResidentAccountMirror(genesis, prefer_host=True)
    for i in range(3):
        h = bytes([i + 1]) * 32
        batch = _batch(rng, state, 15)
        want = twin.verify(parent, h, batch)
        assert p.verify(parent, h, batch, expected_root=want) == want
        state = _apply(state, batch)
        parent = h
    assert len(p._inflight) == 2
    applied = list(p._applied)
    # parks the next resolve until disarmed: the drain wedges and raises
    fault.set_failpoint("resident/before_absorb", "hang*1")
    try:
        with pytest.raises(DeviceWedgedError, match="resident drain"):
            p.accept(parent)
    finally:
        fault.set_failpoint("resident/before_absorb", None)
    assert len(p._inflight) == 2 and p._applied == applied
    assert not p.host_mode
    p.take_over_host()
    assert p.host_mode and not p._inflight and p._applied == applied
    p.accept(parent)
    assert [_counter(n) for n in _LOUD] == \
        [wedges + 2, takeovers + 2, fallbacks]
    assert p.root_of(parent) == twin.root_of(parent)
    assert p.spot_check()


def test_mirror_state_trie_falls_back_only_in_host_mode():
    """A MirrorStateTrie whose root the mirror dropped between open and
    hash (its block rejected): on a device mirror hash() and commit_block()
    raise the MirrorError and nothing is counted; on a mirror in host mode
    both hash the batch on the disk path, each counted in
    state/resident/fallbacks, and the commit detaches the mirror."""
    rng = np.random.default_rng(50)
    genesis = _rand_items(rng, 120)
    h1, h2 = b"\x01" * 32, b"\x02" * 32
    batch1 = _batch(rng, genesis, 15)
    addr = rng.bytes(20)
    want = _oracle(_apply(_apply(genesis, batch1),
                          [(keccak256(addr), b"fresh")]))
    for kw in ({"device": "cpu"}, {"prefer_host": True}):
        m = ResidentAccountMirror(sorted(genesis.items()), **kw)
        r1 = m.verify(m.GENESIS, h1, batch1)
        db = MemoryDB()
        m.export_to(db, at_block=h1)  # the disk path's nodes of r1
        t = MirrorStateTrie(m, r1, TrieDatabase(db))
        t.update(addr, b"fresh")
        m.reject(h1)
        fallbacks = _counter("state/resident/fallbacks")
        if not m.host_mode:
            with pytest.raises(MirrorError, match="not resident"):
                t.hash()
            with pytest.raises(MirrorError, match="not resident"):
                t.commit_block(h2, h1)
            assert _counter("state/resident/fallbacks") == fallbacks
            assert not getattr(m, "detached", False)
            continue
        assert t.hash() == want
        root, nodeset = t.commit_block(h2, h1)
        assert root == want and nodeset is not None and m.detached
        assert _counter("state/resident/fallbacks") == fallbacks + 2


def test_spans_record_each_commit():
    """With spans on, the port's mirror opens one resident/commit span per
    commit, as the reference's does over the same blocks, and its Chrome
    trace carries them."""
    rng = np.random.default_rng(51)
    genesis = _rand_items(rng, 100)
    spans.tracer.clear()
    ref_spans.tracer.clear()
    spans.set_enabled(True)
    ref_spans.set_enabled(True)
    try:
        m = _Pair(sorted(genesis.items()))
        state, parent = genesis, m.port.GENESIS
        for i in range(3):
            h = bytes([i + 1]) * 32
            batch = _batch(rng, state, 10)
            m.verify(parent, h, batch)
            state, parent = _apply(state, batch), h
        m.verify(m.port.GENESIS, b"\xee" * 32, [])
        m.verify(b"\x01" * 32, b"\xef" * 32, [])
    finally:
        spans.set_enabled(False)
        ref_spans.set_enabled(False)
    got = [e for e in spans.tracer.chrome_trace(clear=True)["traceEvents"]
           if e["name"] == "resident/commit"]
    ref = [s for s in ref_spans.tracer.snapshot(clear=True)
           if s.name == "resident/commit"]
    # genesis, three blocks, the sibling at genesis, then block 1's replay
    # and the sibling on it
    assert len(got) == len(ref) == 1 + 3 + 1 + 2
    assert all(e["args"]["host_mode"] is False and e["dur"] > 0
               for e in got)


def test_device_rules(monkeypatch):
    """None is CUDA and raises without it; "cpu" and host mode only when
    asked (the argument, or CORETH_TPU_RESIDENT_HOST=1); the mesh rung
    takes the first n CUDA devices for None (none here: MeshConfigError)
    and n positions on the device named."""
    from coreth_tpu_torch.parallel import MeshConfigError

    items = [(b"\x01" * 32, b"v" * 40), (b"\x02" * 32, b"w")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResidentAccountMirror(items)
    with pytest.raises(MeshConfigError, match="only 0 CUDA device"):
        ResidentAccountMirror(items, mesh_devices=4)
    want = _oracle(dict(items))
    mesh = ResidentAccountMirror(items, mesh_devices=4, device="cpu")
    assert mesh.shards == 4 and mesh.root_of(mesh.GENESIS) == want
    assert ResidentAccountMirror(items, device="cpu").root_of(
        ResidentAccountMirror.GENESIS) == want
    fastpath = _counter("state/resident/cpu_fastpath")
    assert ResidentAccountMirror(items, prefer_host=True).host_mode
    monkeypatch.setenv("CORETH_TPU_RESIDENT_HOST", "1")
    host = ResidentAccountMirror(items)
    assert host.host_mode and host.root_of(host.GENESIS) == want
    assert _counter("state/resident/cpu_fastpath") == fastpath + 2


@pytest.mark.cuda
def test_mirror_on_k1_equals_the_host_twin():
    """The mirror on the card (K1 through ResidentExecutor): pipelined,
    template and a watchdog on, every root equal to the host twin's, the
    spot-check passes, no wedge, takeover or fallback."""
    if not hopper_available():
        pytest.skip("needs a CUDA device with compute capability >= 9.0")
    rng = np.random.default_rng(49)
    genesis = sorted(_rand_items(rng, 3000).items())
    a = ResidentAccountMirror(genesis, pipeline_depth=2, lean_rows=True,
                              device_timeout=60)
    b = ResidentAccountMirror(genesis, template_residency=True)
    c = ResidentAccountMirror(genesis, prefer_host=True)
    loud = [_counter(n) for n in _LOUD]
    keccak_cuda.reset_counts()
    state, parent = dict(genesis), a.GENESIS
    for i in range(6):
        h = bytes([i + 1]) * 32
        batch = _batch(rng, state, 60)
        want = c.verify(parent, h, batch)
        assert a.verify(parent, h, batch, expected_root=want) == want
        assert b.verify(parent, h, batch) == want
        for m in (a, b, c):
            m.accept(h)
        state, parent = _apply(state, batch), h
    assert keccak_cuda.launches > 0
    assert a.spot_check() and b.spot_check()
    assert not a.host_mode and not b.host_mode
    assert [_counter(n) for n in _LOUD] == loud
