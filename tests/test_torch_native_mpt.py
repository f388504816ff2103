"""The port's native planner bridge (coreth_tpu_torch/native/mpt.py) against
the JAX package's (coreth_tpu/native/mpt.py) on the same seeded inputs.

Both packages build their own copy of mpt.cpp / mpt_inc.cpp; every export
array, digest matrix and root must be bit-equal (tolerance zero), and the
port's device executions on the CPU (PlannedCommit with the plain segment
Keccak) must give the host roots. Also the shared build helper: its file
lock (concurrent builds compile once) and a failed build raising."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from coreth_tpu.native import mpt as jmpt
from coreth_tpu.trie.trie import Trie as JTrie
from coreth_tpu_torch import native
from coreth_tpu_torch.native import _build
from coreth_tpu_torch.native import mpt
from coreth_tpu_torch.ops.keccak_planned import PlannedCommit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _items(n, seed, vmin=1, vmax=120):
    """n (key32, value) pairs from numpy's default_rng(seed); values
    vmin..vmax bytes (short ones embed, long ones span two blocks)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    lens = rng.integers(vmin, vmax + 1, n)
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


@pytest.mark.parametrize("n,seed", [(1, 0), (60, 1), (3000, 2)])
def test_plan_exports_equal_jax(n, seed):
    items = _items(n, seed)
    p, j = mpt.plan_from_items(items), jmpt.plan_from_items(items)
    assert (p.num_hashed, p.num_nodes, p.total_lanes, p.root_pos) == \
        (j.num_hashed, j.num_nodes, j.total_lanes, j.root_pos)
    pw, jw = p.export_words(), j.export_words()
    assert [tuple(s) for s in pw[0]] == [tuple(s) for s in jw[0]]
    for a, b in zip(pw[1:], jw[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    pe, je = p.export(), j.export()
    assert [tuple(s) for s in pe[0]] == [tuple(s) for s in je[0]]
    for a, b in zip(pe[1:], je[1:]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("fused", [True, False])
def test_execute_planned_on_cpu_equals_jax_execute_cpu(fused):
    items = _items(2500, 3)
    p, j = mpt.plan_from_items(items), jmpt.plan_from_items(items)
    want = j.execute_cpu()
    assert p.execute_cpu() == want
    assert p.execute_cpu(threads=4) == want
    assert p.execute_planned(device="cpu") == want
    assert p.execute_planned(PlannedCommit(fused=fused, device="cpu")) == want
    proot, pdig, pmask = p.execute_cpu_digests()
    jroot, jdig, jmask = j.execute_cpu_digests()
    assert proot == jroot == want
    assert np.array_equal(pdig, jdig) and np.array_equal(pmask, jmask)
    # the device commit's digest matrix equals the host's on real lanes
    _root, dig = PlannedCommit(device="cpu").run(*p.export_words(),
                                                 p.root_pos, want_digests=True)
    dig8 = np.ascontiguousarray(dig).view(np.uint8).reshape(-1, 32)
    assert np.array_equal(dig8[pmask], pdig[pmask])


def test_items_to_arrays_and_plan_rejections():
    k1, k2 = b"\x01" * 32, b"\x02" * 32
    keys, vals, off = mpt.items_to_arrays([(k2, b"b"), (k1, b"a"), (k2, b"c")])
    jkeys, jvals, joff = jmpt.items_to_arrays(
        [(k2, b"b"), (k1, b"a"), (k2, b"c")])
    assert np.array_equal(keys, jkeys) and vals == jvals == b"ac"
    assert np.array_equal(off, joff)
    with pytest.raises(ValueError):
        mpt.items_to_arrays([])
    with pytest.raises(ValueError):  # unsorted keys
        mpt.plan_commit(np.stack([np.frombuffer(k2, np.uint8),
                                  np.frombuffer(k1, np.uint8)]), b"ab",
                        np.array([0, 1, 2], np.uint64))
    assert mpt.EMPTY_ROOT == jmpt.EMPTY_ROOT
    assert mpt.LEAN_ROW_WIDTH == jmpt.LEAN_ROW_WIDTH


def _both(items):
    return mpt.IncrementalTrie(items), jmpt.IncrementalTrie(items)


def test_incremental_churn_with_checkpoints_equals_jax():
    """Inserts, updates and deletes over nested checkpoint / rollback /
    discard rounds: port commit_cpu == JAX commit_cpu every round, port
    commit_device on the CPU == both, and reads, dirty stats and the
    node exports (full and delta) equal."""
    rng = np.random.default_rng(7)
    items = _items(1500, 4)
    keys = [k for k, _ in items]
    p, j = _both(items)
    d = mpt.IncrementalTrie(items)
    planned = PlannedCommit(device="cpu")
    want = j.commit_cpu()
    assert p.commit_cpu() == want
    assert d.commit_device(planned) == want
    assert p.num_nodes == j.num_nodes == d.num_nodes
    for rnd in range(6):
        batch = _churn(rng, keys, 40)
        if rnd == 2:  # rejected block: the root comes back
            for t in (p, j, d):
                t.checkpoint()
            n = [t.update(batch) for t in (p, j, d)]
            assert n[0] == n[1] == n[2]
            assert p.commit_cpu() == j.commit_cpu() == d.commit_device(
                planned)
            assert p.rollback() == j.rollback() == d.rollback()
            assert p.commit_cpu() == j.commit_cpu() == want
            assert d.commit_device(planned) == want
            continue
        if rnd == 3:  # nested scopes: inner rolled back, outer kept
            for t in (p, j, d):
                t.checkpoint()
                t.update(batch[:20])
                t.checkpoint()
                t.update(batch[20:])
                t.rollback()
                t.discard_checkpoint()
            batch = []
        if rnd == 4:  # an accepted scope, flushed as finalized history
            for t in (p, j, d):
                t.checkpoint()
                t.update(batch)
                t.discard_checkpoint()
                t.checkpoint()
                t.flush_oldest_checkpoints(1)
            batch = []
        for t in (p, j, d):
            t.update(batch)
        assert p.dirty_stats()[0] >= 0
        want = j.commit_cpu()
        assert p.commit_cpu() == want, f"round {rnd}"
        assert d.commit_device(planned) == want, f"round {rnd}"
        assert p.root() == d.root() == j.root() == want
        for k in keys[:50] + [b"\xff" * 32]:
            assert p.get(k) == j.get(k) == d.get(k)
        for delta in (False, True):
            pe, je = p.export_nodes(delta), j.export_nodes(delta)
            assert np.array_equal(pe[0], je[0]) and pe[1] == je[1]
            assert np.array_equal(pe[2], je[2])
    with pytest.raises(ValueError):
        p.get(b"short")
    # a committed trie with nothing dirty returns its cached root
    assert p.commit_cpu() == d.commit_device(planned) == want
    assert p.commit_cpu(threads=4) == want


def test_incremental_root_equals_python_trie():
    items = _items(400, 9)
    t = JTrie()
    for k, v in items:
        t.update(k, v)
    p = mpt.IncrementalTrie(items)
    assert p.commit_cpu() == t.hash()
    assert mpt.IncrementalTrie().root() == mpt.EMPTY_ROOT


def test_default_cpu_threads(monkeypatch):
    monkeypatch.setenv("CORETH_TPU_CPU_THREADS", "3")
    assert native.default_cpu_threads() == 3 == mpt.default_cpu_threads()
    monkeypatch.setenv("CORETH_TPU_CPU_THREADS", "junk")
    assert native.default_cpu_threads() == min(16, os.cpu_count() or 1)


_BUILD_CHILD = textwrap.dedent('''
    import sys
    sys.path.insert(0, {repo!r})
    from coreth_tpu_torch.native._build import build_and_load
    lib = build_and_load([{cc!r}, "-O0", "-shared", "-fPIC"], [{src!r}],
                         "libtiny.so", build_dir={out!r})
    print(lib.tiny())
''')


def test_concurrent_builds_compile_once(tmp_path):
    """Two processes build one source at once through a compiler wrapper
    that counts its runs and holds the compile for a second: the lock lets
    one compile and the other load its library."""
    src = tmp_path / "tiny.cpp"
    src.write_text('extern "C" int tiny() { return 42; }\n')
    count = tmp_path / "count"
    cc = tmp_path / "cc.sh"
    cc.write_text(f"#!/bin/sh\necho run >> {count}\nsleep 1\nexec g++ \"$@\"\n")
    cc.chmod(0o755)
    out = tmp_path / "build"
    code = _BUILD_CHILD.format(repo=REPO, cc=str(cc), src=str(src),
                               out=str(out))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    results = [p.communicate(timeout=120) for p in procs]
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr
        assert stdout.strip() == "42"
    assert count.read_text().count("run") == 1
    assert (out / "libtiny.so.lock").exists()
    assert not [f for f in os.listdir(out) if f.startswith("tmp")]


def test_failed_build_raises(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="build of libbroken.so failed"):
        _build.build_and_load(["g++", "-shared", "-fPIC"], [str(src)],
                              "libbroken.so", build_dir=str(tmp_path / "b"))
    with pytest.raises(RuntimeError, match="failed"):
        _build.build_and_load([str(tmp_path / "no-such-compiler")],
                              [str(src)], "libnone.so",
                              build_dir=str(tmp_path / "b"))
    assert not os.path.exists(tmp_path / "b" / "libbroken.so")
