"""Port planned executor against the JAX package's, fed the SAME export.

The JAX PlannedGraphBuilder lays a graph out, plan_from_export carries the
numpy plan across, and the port's PlannedCommit (fused and per-segment, on
the CPU) must give the JAX PlannedCommit's root and every lane's digest
exactly. The port's own builder must lay out the identical plan."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from coreth_tpu import rlp as jrlp
from coreth_tpu.ops.keccak_fused import SegmentSpec as JSegmentSpec
from coreth_tpu.ops.keccak_planned import PlannedCommit as JPlannedCommit
from coreth_tpu.ops.keccak_planned import \
    _strip_contributions as j_strip_contributions
from coreth_tpu.trie.encoding import key_to_hex as j_key_to_hex
from coreth_tpu.trie.planned import PlannedGraphBuilder as JBuilder
from coreth_tpu.trie.trie import Trie as JTrie
from coreth_tpu_torch.ops.keccak_planned import PlannedCommit, \
    _strip_contributions, plan_from_export
from coreth_tpu_torch.trie.encoding import key_to_hex
from coreth_tpu_torch.trie.planned import PlannedGraphBuilder
from coreth_tpu_torch.trie.trie import trie_from_items


@pytest.mark.parametrize("seed", [0, 1])
def test_strip_contributions_matches_jax(seed):
    rng = np.random.default_rng(seed)
    g, p = 40, 64
    dig = rng.integers(0, 2**32, size=(g + 1, 8), dtype=np.uint32)
    dig[0] = 0
    child = rng.integers(0, g + 1, p).astype(np.int32)
    child[:4] = 0                               # zero-sentinel rows
    shift = (np.arange(p) % 4).astype(np.int32)  # all four shifts
    want = np.asarray(j_strip_contributions(
        jnp.asarray(dig), jnp.asarray(child), jnp.asarray(shift)))
    got = _strip_contributions(torch.from_numpy(dig.view(np.int32)),
                               torch.from_numpy(child),
                               torch.from_numpy(shift))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint64),
                                  want.astype(np.uint64))


def _account_rlp(root: bytes) -> bytes:
    return jrlp.encode([1, 10**18, root, b"\xcc" * 32, 0])


def _graph(build_trie, key_to_hex_fn, builder_cls, seed=13):
    """Two storage tries plus an account trie whose two account leaves
    carry storage-root holes (as in tests/test_planned_graph.py)."""
    rng = random.Random(seed)
    b = builder_cls()
    handles = {}
    for who in ("alice", "bob"):
        items = [(rng.randbytes(32), rng.randbytes(rng.randint(1, 40)))
                 for _ in range(60)]
        handles[who] = b.add_trie(build_trie(items).root)
    accounts = {rng.randbytes(32): _account_rlp(rng.randbytes(32))
                for _ in range(150)}
    # a few long values give multi-block lanes
    for _ in range(5):
        accounts[rng.randbytes(32)] = rng.randbytes(rng.randint(140, 400))
    key_a, key_b = rng.randbytes(32), rng.randbytes(32)
    accounts[key_a] = accounts[key_b] = _account_rlp(b"\x00" * 32)
    probe = _account_rlp(b"\xee" * 32)
    off = probe.index(b"\xee" * 32)
    at = build_trie(sorted(accounts.items()))
    b.add_account_trie(at.root, {
        key_to_hex_fn(key_a): (off, handles["alice"]),
        key_to_hex_fn(key_b): (off, handles["bob"]),
    })
    return b


def _jax_trie(items):
    t = JTrie()
    for k, v in items:
        t.update(k, v)
    return t


@pytest.fixture(scope="module")
def jax_plan():
    """One export from the JAX builder plus the JAX executor's result."""
    built = _graph(_jax_trie, j_key_to_hex, JBuilder).build()
    specs, flat, dst, child, shift, root_pos, _total = built
    root, dig = JPlannedCommit(fused=True).run(
        specs, flat, dst, child, shift, root_pos, want_digests=True)
    export = ([tuple(s) for s in specs], np.asarray(flat), np.asarray(dst),
              np.asarray(child), np.asarray(shift), root_pos)
    return export, root, np.asarray(dig)


@pytest.mark.parametrize("fused", [True, False])
def test_planned_commit_matches_jax_on_shared_export(jax_plan, fused):
    export, want_root, want_dig = jax_plan
    assert len(export[0]) > 4  # several segments, with patches
    pc = PlannedCommit(fused=fused, device="cpu")
    root, dig = pc.run(*plan_from_export(*export), want_digests=True)
    assert root == want_root
    np.testing.assert_array_equal(dig, want_dig)
    root_only, none = pc.run(*plan_from_export(*export))
    assert root_only == want_root and none is None
    flat_bytes = export[1].nbytes
    n_pat = len(export[2])
    assert pc.last_h2d_bytes == flat_bytes + 12 * n_pat
    assert (pc.last_transfers, pc.last_dispatches) == \
        ((2, 1) if fused else (4, len(export[0])))


def test_port_builder_lays_out_the_jax_plan(jax_plan):
    export, want_root, want_dig = jax_plan
    b = _graph(trie_from_items, key_to_hex, PlannedGraphBuilder)
    specs, flat, dst, child, shift, root_pos, _total = b.build()
    assert [tuple(s) for s in specs] == export[0]
    np.testing.assert_array_equal(flat, export[1])
    np.testing.assert_array_equal(dst, export[2])
    np.testing.assert_array_equal(child, export[3])
    np.testing.assert_array_equal(shift, export[4])
    assert root_pos == export[5]
    # and runs end to end to the same root and digests
    b2 = _graph(trie_from_items, key_to_hex, PlannedGraphBuilder)
    assert b2.run(device="cpu") == want_root
    np.testing.assert_array_equal(b2.digests, want_dig)


def test_patch_past_the_end_is_dropped_like_jax():
    """mode="drop": strip words at or past the stream's end are discarded,
    not clamped onto the last word."""
    rng = np.random.default_rng(7)
    specs = [(1, 16, 0, 0), (1, 16, 16, 16)]
    w = 2 * 16 * 34
    flat = rng.integers(0, 2**32, w, dtype=np.uint32)
    dst = np.zeros(16, np.int32)
    dst[:3] = (w - 4, w - 1, w + 5)   # partly and wholly past the end
    dst[3:6] = (16 * 34 + 3, 16 * 34 + 40, 20 * 34)
    child = np.full(16, -1, np.int32)
    child[:6] = (0, 1, 2, 3, 4, 5)
    shift = np.zeros(16, np.int32)
    shift[:6] = (1, 2, 3, 0, 3, 1)
    jspecs = tuple(JSegmentSpec(*s) for s in specs)
    want_root, want_dig = JPlannedCommit(fused=True).run(
        jspecs, flat, dst, child, shift, 20, want_digests=True)
    for fused in (True, False):
        root, dig = PlannedCommit(fused=fused, device="cpu").run(
            *plan_from_export(specs, flat, dst, child, shift, 20),
            want_digests=True)
        assert root == want_root
        np.testing.assert_array_equal(dig, np.asarray(want_dig))
