"""The port's trie writers (coreth_tpu_torch/core/state_manager.py) against
the JAX package's, on the CPU.

The detach corpus of tests/test_resident_detach.py, driven into both
packages' ResidentTrieWriter through the same stub events: after a disk
fallback sets mirror.detached, post-detach blocks go to a
CappedMemoryTrieWriter (interval commits, balanced reference and
dereference, a shutdown commit) while pre-detach blocks still ride the
mirror. What the stubs record must be equal. Then the capped and archival
writers over the same event streams, and the bounded tip buffer.
"""

import pytest

from coreth_tpu.core import state_manager as ref_sm
from coreth_tpu.trie.resident_mirror import MirrorError as RefMirrorError
from coreth_tpu_torch.core import state_manager as port_sm
from coreth_tpu_torch.trie.resident_mirror import MirrorError

SIDES = ((ref_sm, RefMirrorError), (port_sm, MirrorError))


class StubBlock:
    def __init__(self, number, root):
        self.number = number
        self.root = root
        self._hash = b"B" + number.to_bytes(8, "big") + root[:23]

    def hash(self):
        return self._hash


class StubMirror:
    """Accepts only blocks it 'knows'; reject keeps the real contract:
    silent for unknown blocks, MirrorError for accepted ones."""

    def __init__(self, error):
        self.error = error
        self.known = set()
        self.accepted = set()
        self.rejected = []
        self.exports = []
        self.detached = False

    def accept(self, h):
        if h not in self.known:
            raise self.error("unknown block")
        self.accepted.add(h)

    def reject(self, h):
        if h in self.accepted:
            raise self.error("rejecting an ACCEPTED block")
        self.rejected.append(h)

    def export_to(self, diskdb, at_block=None, pre_write=None):
        if pre_write is not None:
            pre_write()
        self.exports.append(at_block)


class StubTrieDB:
    def __init__(self):
        self.refs = {}
        self.commits = []
        self.caps = []
        self.dirty_size = 0
        self.diskdb = object()

    def reference(self, root):
        self.refs[root] = self.refs.get(root, 0) + 1

    def dereference(self, root):
        self.refs[root] = self.refs.get(root, 0) - 1

    def commit(self, root):
        self.commits.append(root)

    def cap(self, limit):
        self.caps.append(limit)


def blk(n):
    return StubBlock(n, bytes([n % 256]) * 32)


def _record(db, mirror):
    return (db.refs, db.commits, db.caps, sorted(mirror.accepted),
            mirror.rejected, mirror.exports)


def _drive(script, interval=4):
    """Run `script(writer, db, mirror)` against each package's
    ResidentTrieWriter over fresh stubs; the stubs' records must be equal.
    Returns the port side's (writer, db, mirror)."""
    out = []
    for sm, error in SIDES:
        db, mirror = StubTrieDB(), StubMirror(error)
        w = sm.ResidentTrieWriter(db, mirror, commit_interval=interval)
        script(w, db, mirror)
        out.append((w, db, mirror))
    assert _record(*out[0][1:]) == _record(*out[1][1:])
    return out[1]


def test_attached_blocks_ride_the_mirror():
    def script(w, db, mirror):
        b = blk(4)
        mirror.known.add(b.hash())
        w.insert_trie(b)
        w.accept_trie(b)
    _w, db, mirror = _drive(script)
    assert mirror.exports == [blk(4).hash()]  # interval boundary export
    assert db.commits == [] and db.caps == [0]  # the storage forest capped


def test_detached_blocks_get_capped_policy():
    def script(w, db, mirror):
        mirror.detached = True
        for n in range(1, 5):
            b = blk(n)
            w.insert_trie(b)
            assert db.refs[b.root] == 1
            w.accept_trie(b)
        w.shutdown()
    _w, db, mirror = _drive(script, interval=2)
    roots = [blk(n).root for n in range(1, 5)]
    assert db.commits == [roots[1], roots[3], roots[3]]
    assert mirror.exports == []


def test_detached_reject_balances_reference():
    def script(w, db, mirror):
        mirror.detached = True
        b = blk(7)
        w.insert_trie(b)
        w.reject_trie(b)
        assert db.refs[b.root] == 0 and mirror.rejected == []
        # a double reject leaves the forest alone and reaches the mirror,
        # which is silent for a block it never saw
        w.reject_trie(b)
    _w, db, mirror = _drive(script)
    assert db.refs[blk(7).root] == 0
    assert mirror.rejected == [blk(7).hash()]


def test_detached_duplicate_reject_of_accepted_block_is_noop():
    def script(w, db, mirror):
        b = blk(3)
        mirror.known.add(b.hash())
        w.insert_trie(b)
        w.accept_trie(b)
        mirror.detached = True
        w.reject_trie(b)
    _w, db, _mirror = _drive(script)
    assert db.refs.get(blk(3).root, 0) == 0 and db.commits == []


def test_pre_detach_blocks_still_accept_through_mirror():
    def script(w, db, mirror):
        early, late = blk(1), blk(2)
        mirror.known.add(early.hash())
        w.insert_trie(early)
        mirror.detached = True
        w.insert_trie(late)
        w.accept_trie(early)
        w.accept_trie(late)
    _w, db, mirror = _drive(script, interval=2)
    assert blk(1).hash() in mirror.accepted
    assert db.commits == [blk(2).root]


def test_accept_miss_and_shutdown_export():
    """A block the mirror never saw (and no detach) is an accept miss: no
    export; shutdown exports the last accepted block once more."""
    def script(w, db, mirror):
        for n in (1, 2, 3):
            b = blk(n)
            if n != 2:
                mirror.known.add(b.hash())
            w.insert_trie(b)
            w.accept_trie(b)
        w.shutdown()
    _w, _db, mirror = _drive(script, interval=3)
    assert mirror.exports == [blk(3).hash(), blk(3).hash()]


@pytest.mark.parametrize("kind", ["capped", "archival"])
def test_forest_writers_match(kind):
    """CappedMemoryTrieWriter (interval commits, the flush window's caps,
    the tip buffer's dereferences) and NoPruningTrieWriter over one event
    stream record the same calls in both packages."""
    records = []
    for sm, _error in SIDES:
        db = StubTrieDB()
        if kind == "capped":
            w = sm.CappedMemoryTrieWriter(db, commit_interval=40,
                                          memory_cap=8 * 1024 * 1024)
            w.flush_step_size = 1024
        else:
            w = sm.NoPruningTrieWriter(db)
        for n in range(1, 90):
            b = blk(n)
            db.dirty_size = 4096 * (n % 7) * 1024
            w.insert_trie(b)
            if n % 9 == 0:
                w.reject_trie(b)
            else:
                w.accept_trie(b)
        w.shutdown()
        records.append((db.refs, db.commits, db.caps))
    assert records[0] == records[1]
    assert records[1][1]  # something was committed


def test_bounded_buffer_evicts_oldest():
    evicted = []
    buf = port_sm._BoundedBuffer(3, evicted.append)
    assert buf.last() is None
    for i in range(5):
        buf.insert(i)
    assert evicted == [0, 1] and buf.last() == 4
