"""The JAX package's planned executor on the CPU, for the tests that hold
the port's bintrie planned commit and shadow against the reference.

Its default executor compiles an XLA scan of Keccak-f per segment shape,
about a minute on the CPU. The tests plug the JAX package's reference
Keccak-f (ops/keccak_ref.keccak_f1600, over numpy lanes) into its
PlannedCommit's per-segment form (fused=False) at the seg_impl seam, as
tests/test_torch_statedb.py does; the patch tables, the digest table and
the executor's run are still the reference's own."""

import jax
import jax.numpy as jnp
import numpy as np

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


def _seg_impl(words):
    return jax.pure_callback(
        host_segment_keccak,
        jax.ShapeDtypeStruct((words.shape[0], 8), jnp.uint32), words)


def jax_planned_commit():
    """One shared JAX PlannedCommit on the host Keccak-f (its compiled
    steps are cached on the instance)."""
    if not _COMMIT:
        _COMMIT.append(jkeccak_planned.PlannedCommit(seg_impl=_seg_impl,
                                                     fused=False))
    return _COMMIT[0]


def patch_default(monkeypatch):
    """Make it the JAX package's default_planned_commit()."""
    monkeypatch.setattr(jkeccak_planned, "_default_commit",
                        jax_planned_commit())
