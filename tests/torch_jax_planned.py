"""The JAX package's device programs on the CPU with its host Keccak-f,
for the tests that hold the port against the reference.

Its default executors compile an XLA scan of Keccak-f per segment shape,
about a minute on the CPU. The tests plug the JAX package's reference
Keccak-f (ops/keccak_ref.keccak_f1600, over numpy lanes) in where the
hash goes: its PlannedCommit's per-segment form (fused=False) and its
sharded executors at the seg_impl seam, as tests/test_torch_statedb.py
does, and its fused commit's variable-length segment hash
(keccak_fused._keccak_segment, re-traced with jax_fused_commit). The
patch tables, the digest tables and the executors' runs are still the
reference's own."""

import jax
import jax.numpy as jnp
import numpy as np

from coreth_tpu.ops import keccak_fused as jkeccak_fused
from coreth_tpu.ops import keccak_planned as jkeccak_planned
from coreth_tpu.ops.keccak_ref import keccak_f1600 as j_keccak_f1600

_COMMIT = []


def host_segment_keccak(words):
    """uint32[P, L, 34] -> uint32[P, 8] on the host: the JAX package's
    reference Keccak-f, each of its 25 lanes a numpy uint64[P]."""
    w = np.asarray(words).astype(np.uint64)
    lanes = w[:, :, 0::2] | (w[:, :, 1::2] << np.uint64(32))
    st = [np.zeros(w.shape[0], np.uint64) for _ in range(25)]
    for b in range(w.shape[1]):
        for i in range(17):
            st[i] = st[i] ^ lanes[:, b, i]
        st = j_keccak_f1600(st)
    out = np.empty((w.shape[0], 8), np.uint32)
    for i in range(4):
        out[:, 2 * i] = (st[i] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        out[:, 2 * i + 1] = (st[i] >> np.uint64(32)).astype(np.uint32)
    return out


def host_keccak_blocks(words, nblocks):
    """uint32[P, L, 34] + int32[P] -> uint32[P, 8]: each lane hashed over
    its own block count, an all-zero digest where the count is outside
    [1, L] (the reference's masked scan, keccak_fused._keccak_segment)."""
    w = np.asarray(words)
    nb = np.asarray(nblocks)
    out = np.zeros((w.shape[0], 8), np.uint32)
    for b in range(1, w.shape[1] + 1):
        sel = np.nonzero(nb == b)[0]
        if sel.size:
            out[sel] = host_segment_keccak(w[sel, :b])
    return out


def _keccak_segment(words, nblocks):
    return jax.pure_callback(
        host_keccak_blocks,
        jax.ShapeDtypeStruct((words.shape[0], 8), jnp.uint32), words,
        nblocks)


def jax_fused_commit(monkeypatch):
    """The JAX package's fused_commit re-traced over host_keccak_blocks,
    installed as its module's fused_commit (FusedHasher's default)."""
    monkeypatch.setattr(jkeccak_fused, "_keccak_segment", _keccak_segment)
    fn = jax.jit(jkeccak_fused.fused_commit.__wrapped__,
                 static_argnames=("specs",))
    monkeypatch.setattr(jkeccak_fused, "fused_commit", fn)
    return fn


def seg_impl(words):
    """The host Keccak-f at the JAX package's seg_impl seams."""
    return jax.pure_callback(
        host_segment_keccak,
        jax.ShapeDtypeStruct((words.shape[0], 8), jnp.uint32), words)


def jax_planned_commit():
    """One shared JAX PlannedCommit on the host Keccak-f (its compiled
    steps are cached on the instance)."""
    if not _COMMIT:
        _COMMIT.append(jkeccak_planned.PlannedCommit(seg_impl=seg_impl,
                                                     fused=False))
    return _COMMIT[0]


def patch_default(monkeypatch):
    """Make it the JAX package's default_planned_commit()."""
    monkeypatch.setattr(jkeccak_planned, "_default_commit",
                        jax_planned_commit())
