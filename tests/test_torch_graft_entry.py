"""The port's counterpart of __graft_entry__.py
(coreth_tpu_torch/graft_entry.py) against the reference's.

entry(): the reference's `entry()` runs on JAX's CPU and the port's
`entry(device="cpu")` on the same seed; their step outputs are compared
word for word (tolerance 0). dryrun_multichip(): the port's runs on a
virtual 4-position CPU mesh at a reduced size, and its plan and roots are
held against the reference's own native planner and incremental trie on
the same items. The reference's jitted dry run is not run here: its
compiles alone take minutes on the CPU.
"""

import random

import numpy as np
import pytest
import torch

from coreth_tpu_torch import graft_entry
from coreth_tpu_torch.ops.keccak_torch import to_int32
from coreth_tpu_torch.parallel import MeshConfigError

LEAVES, RESIDENT = 2_000, 500


def test_entry_matches_the_reference_word_for_word():
    import __graft_entry__ as ref

    ref_fn, ref_args = ref.entry()
    ref_words, ref_dig = (np.asarray(a) for a in ref_fn(*ref_args))
    fn, args = graft_entry.entry(device="cpu")
    before = [a.clone() for a in args]
    # the same example arguments: the words as u32 bits, the +1 child
    # rows, the metadata and the segment
    assert np.array_equal(args[0].numpy().view(np.uint32),
                          np.asarray(ref_args[0]))
    for mine, theirs in zip(args[1:], ref_args[1:]):
        assert np.array_equal(mine.numpy().astype(np.int64),
                              np.asarray(theirs).astype(np.int64))
    words, dig = fn(*args)
    assert words.dtype == torch.int64 and dig.dtype == torch.int32
    assert np.array_equal((words & 0xFFFFFFFF).numpy().astype(np.uint32),
                          ref_words)
    assert np.array_equal(dig.numpy().view(np.uint32), ref_dig)
    # the step wrote its segment's digests (its patches add the zero
    # digests of the example's fresh table, as in the reference)
    assert dig.abs().sum() > 0
    # the arguments are left as they were, and the step runs again
    for a, b in zip(args, before):
        assert torch.equal(a, b)
    again = fn(*args)
    assert torch.equal(again[0], words) and torch.equal(again[1], dig)


def test_the_step_over_every_segment_of_the_entry_plan_is_the_host_commit():
    """The entry's step, chained over every segment of its plan in
    order, is the whole planned commit: every real lane's digest and the
    root equal the native planner's host execution."""
    import functools

    plan = graft_entry.entry_plan()
    specs = plan.export_words()[0]
    _fn, args = graft_entry.entry(device="cpu")
    words, dig = args[0], args[1]
    for i, sp in enumerate(specs):
        step = functools.partial(
            graft_entry.segment_step, graft_entry.segment_keccak_plain,
            lanes=sp.lanes, blocks=sp.blocks, npatch=sp.n_patches)
        w64, dig = step(words, dig, *args[2:6],
                        torch.tensor(i, dtype=torch.int32))
        words = to_int32(w64)
    root, want, real = plan.execute_cpu_digests()
    got = dig[1:].numpy().view(np.uint8).reshape(-1, 32)
    assert np.array_equal(got[real], want[real])
    assert got[plan.root_pos].tobytes() == root


def _reference_summary():
    """What the reference's native planner and incremental trie give for
    the dry run's items (legs 3 and 4), on the same rng sequence."""
    from coreth_tpu.native.mpt import IncrementalTrie, plan_from_items

    rng = random.Random(9)
    items = [(rng.randbytes(32), rng.randbytes(rng.randint(40, 90)))
             for _ in range(LEAVES)]
    plan = plan_from_items(items)
    specs = plan.export_words()[0]
    planned = {"leaves": LEAVES, "nodes": plan.num_hashed,
               "segments": len(specs),
               "lane_buckets": sorted({s.lanes for s in specs}),
               "root": plan.execute_cpu().hex()}
    res_items = sorted(
        {rng.randbytes(32): rng.randbytes(rng.randint(1, 90))
         for _ in range(RESIDENT)}.items())
    keys = [k for k, _ in res_items]
    t = IncrementalTrie(res_items)
    roots = [t.commit_cpu()]
    for _ in range(3):
        t.update([(keys[rng.randrange(len(keys))], rng.randbytes(40))
                  for _ in range(150)])
        roots.append(t.commit_cpu())
    roots.append(roots[-1])  # the rollback lands on the last round's root
    return planned, [r.hex() for r in roots]


def test_dryrun_multichip_on_a_virtual_cpu_mesh(capsys):
    summary = graft_entry.dryrun_multichip(
        4, device="cpu", leaves=LEAVES, resident_items=RESIDENT)
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("dryrun_multichip OK: ")]
    assert len(lines) == 4, lines
    assert summary["devices"] == ["cpu"] * 4
    assert summary["commit_step"]["lanes"] == 16
    assert summary["sharded_seg"] == {"lanes": 4096, "shards": 4}
    planned, roots = _reference_summary()
    got = {k: summary["planned"][k] for k in planned}
    assert got == planned
    assert planned["nodes"] == summary["planned"]["lanes"]
    assert summary["resident"]["shards"] == 4
    assert summary["resident"]["rounds"] == 3
    assert summary["resident"]["roots"] == roots


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(MeshConfigError, match="only 0 CUDA"):
        graft_entry.dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.dryrun_multichip(4, device="cuda:0")


@pytest.mark.cuda
def test_entry_on_the_card_equals_its_plain_version():
    """entry() on the card launches K1 once and gives the words and
    digests of the same step with the plain segment hash."""
    from coreth_tpu_torch.device import hopper_available
    from coreth_tpu_torch.ops import keccak_cuda
    from coreth_tpu_torch.ops.keccak_staged import segment_keccak_plain

    if not hopper_available():
        pytest.skip("needs a CUDA device with compute capability >= 9.0")
    fn, args = graft_entry.entry()
    plain_fn, plain_args = graft_entry.entry(
        "cuda", seg_impl=segment_keccak_plain)
    keccak_cuda.reset_counts()
    words, dig = fn(*args)
    assert keccak_cuda.launches == 1
    want_words, want_dig = plain_fn(*plain_args)
    assert torch.equal(words, want_words) and torch.equal(dig, want_dig)
    cpu_words, cpu_dig = graft_entry.entry("cpu")[0](
        *graft_entry.entry("cpu")[1])
    assert torch.equal(words.cpu(), cpu_words)
    assert torch.equal(dig.cpu(), cpu_dig)
