"""The two compile-check entry points of the repo's __graft_entry__.py
(which stays the JAX package's), on the port.

entry(device=None) -> (fn, example_args): the flagship step, one
    planned-commit segment step on kernel K1 (ops/keccak_cuda.
    segment_keccak on CUDA tensors): patch-add the child digests into the
    word stream, hash the segment, write its digests. The example
    arguments come from a real plan of a 300-leaf trie, built by the
    port's native planner (native/mpt.py).

dryrun_multichip(n_devices, device=None, ...) -> summary dict: the
    reference's four legs on the port's mesh (parallel/__init__.py), each
    checked bit-exact against a host oracle: commit_step over n*4
    messages (K2 a shard), sharded_seg_impl over n*1024 lanes (K1 a
    shard), a planned commit over a many-segment plan with its hashing
    sharded, and the resident executor with its store and arenas split
    across the mesh through churn and a rollback.

Both run on the card unless the caller names another device: device=None
is CUDA (the first n CUDA devices for the mesh) and raises without it;
device="cuda:0" gives a virtual mesh that repeats the one card, and
device="cpu" runs the kernels' plain versions (the tests). Where the
reference skips a leg because its native planner is missing, the port
raises: its planners are built from source with g++ at first use.
"""

from __future__ import annotations

import functools
import random

import numpy as np
import torch

from .device import DeviceLike, resolve
from .native import keccak256, keccak256_batch
from .native.mpt import IncrementalTrie, plan_from_items
from .ops.keccak_fused import SegmentSpec
from .ops.keccak_planned import MAX_SEGMENTS, _step
from .ops.keccak_staged import segment_keccak_plain
from .ops.keccak_torch import MASK32, WORDS_PER_BLOCK, \
    digest_words_to_bytes, int32_to_words, pack_messages, words_to_int32

ENTRY_LEAVES = 300
ENTRY_VALUE_BYTES = 50


def segment_step(seg_impl, flat_words: torch.Tensor, dig: torch.Tensor,
                 dstw_all: torch.Tensor, child_all: torch.Tensor,
                 shift_all: torch.Tensor, meta: torch.Tensor,
                 seg_i: torch.Tensor, *, lanes: int, blocks: int,
                 npatch: int):
    """The reference's non-donating `_make_step` (coreth_tpu/ops/
    keccak_planned.py:67) on the port's `_apply_patches` + `_step`, on
    copies of its arguments. flat_words int32[W] (u32 bits), dig
    int32[1 + G, 8], the three patch tables int32[P], meta
    int32[MAX_SEGMENTS, 3] = (word_off, gstart, patch_off), seg_i a 0-d
    int32 -> (words int64[W] in [0, 2**32), dig int32[1 + G, 8]), new
    tensors."""
    word_off, gstart, patch_off = (int(v) for v in
                                   meta[int(seg_i)].tolist())
    flat64 = torch.empty(flat_words.shape[0] + 1, dtype=torch.int64,
                         device=flat_words.device)
    flat64[:-1] = flat_words.long() & MASK32
    flat64[-1] = 0  # the scratch word of dropped patch indices
    out = dig.clone()
    sl = slice(patch_off, patch_off + npatch)
    _step(seg_impl, flat64, out, dstw_all[sl], child_all[sl], shift_all[sl],
          word_off, SegmentSpec(blocks, lanes, gstart, npatch))
    return flat64[:-1], out


def entry_plan():
    """The real plan entry() takes its example from: a 300-leaf trie of
    32-byte keys and 50-byte values from random.Random(3)."""
    rng = random.Random(3)
    items = [(rng.randbytes(32), rng.randbytes(ENTRY_VALUE_BYTES))
             for _ in range(ENTRY_LEAVES)]
    return plan_from_items(items)


def entry(device: DeviceLike = None, seg_impl=None):
    """(fn, example_args): one planned-commit segment step. fn(*args)
    returns (flat_words, digests) as new tensors and leaves its arguments
    as they were. seg_impl defaults to K1's wrapper, ops/keccak_cuda.
    segment_keccak: K1 for CUDA tensors, its plain version for CPU ones;
    chip_smoke.py passes the plain version on the card to hold the two
    against each other."""
    dev = resolve(device)
    if seg_impl is None:
        from .ops.keccak_cuda import segment_keccak as seg_impl
    plan = entry_plan()
    specs, flat_words, dst, child, shift = plan.export_words()
    meta = np.zeros((MAX_SEGMENTS, 3), np.int32)
    patch_off = word_off = 0
    for i, sp in enumerate(specs):
        meta[i] = (word_off, sp.gstart, patch_off)
        word_off += sp.lanes * sp.blocks * WORDS_PER_BLOCK
        patch_off += sp.n_patches
    # a segment WITH patches: the step must hold the patch-scatter, the
    # core of the planned design, not just the keccak
    seg_i, s = next((i, sp) for i, sp in enumerate(specs)
                    if sp.n_patches > 0)
    total_lanes = sum(sp.lanes for sp in specs)

    def up(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    fn = functools.partial(segment_step, seg_impl, lanes=s.lanes,
                           blocks=s.blocks, npatch=s.n_patches)
    args = (
        up(words_to_int32(flat_words)),
        torch.zeros((1 + total_lanes, 8), dtype=torch.int32, device=dev),
        up(dst.astype(np.int32)),
        up((child + 1).astype(np.int32)),
        up(shift.astype(np.int32)),
        up(meta),
        torch.tensor(seg_i, dtype=torch.int32, device=dev),
    )
    return fn, args


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     leaves: int = 20_000,
                     resident_items: int = 2_000) -> dict:
    """The reference's dry run (__graft_entry__.py:68-233) on the port's
    mesh of n positions: the first n CUDA devices (device None; raises
    when fewer are visible), or n times the one device named. Prints the
    reference's `dryrun_multichip OK: ...` lines and returns, per leg,
    its lanes, segments, lane buckets and roots."""
    from .ops.keccak_planned import PlannedCommit
    from .parallel import (commit_step, make_mesh,
                           resident_executor_over_mesh, sharded_seg_impl,
                           shard_devices)

    mesh = make_mesh(n_devices, device=device)
    devs = shard_devices(mesh)
    summary: dict = {"devices": [str(d) for d in devs]}

    # 1. the sharded commit step (K2 a shard), mixed-length messages
    msgs = [bytes([i]) * (1 + 7 * i) for i in range(n_devices * 4)]
    words, nblocks = pack_messages(msgs)
    out, checksum = commit_step(mesh)(words, nblocks)
    host = int32_to_words(out)
    checksum = int(checksum)
    digests = digest_words_to_bytes(host)
    for m, d in zip(msgs, digests):
        if d != keccak256(m):
            raise AssertionError("sharded digest mismatch vs the host "
                                 "Keccak")
    if checksum != int(np.sum(host, dtype=np.uint32).item() & MASK32):
        raise AssertionError("commit_step checksum mismatch")
    print(f"dryrun_multichip OK: {len(msgs)} lanes over {n_devices} "
          f"devices, checksum={checksum:#010x}")
    summary["commit_step"] = {"lanes": len(msgs), "checksum": checksum}

    # 2. the segment hash sharded over the mesh (K1 a shard): the
    # reference traces its Pallas leg structurally; the port runs it and
    # holds it against the plain version and the host Keccak
    lanes_p = n_devices * 1024
    srng = random.Random(11)
    seg_msgs = [srng.randbytes(srng.randrange(136)) for _ in range(lanes_p)]
    seg_words, _ = pack_messages(seg_msgs)
    home = devs[0]
    wt = torch.from_numpy(words_to_int32(seg_words)).to(home)
    got = sharded_seg_impl(mesh)(wt)
    if tuple(got.shape) != (lanes_p, 8):
        raise AssertionError(f"sharded segment output {tuple(got.shape)}")
    plain = segment_keccak_plain(wt)
    if not torch.equal(got, plain):
        raise AssertionError("sharded K1 != its plain version")
    if digest_words_to_bytes(int32_to_words(got)) != \
            keccak256_batch(seg_msgs):
        raise AssertionError("sharded K1 != the host Keccak")
    print(f"dryrun_multichip OK: segment kernel sharded over the mesh "
          f"({n_devices} shards x 1024 lanes) — bit-exact vs its plain "
          f"version and the host Keccak")
    summary["sharded_seg"] = {"lanes": lanes_p, "shards": len(devs)}

    # 3. a whole trie commit with its hashing sharded over the mesh,
    # checked per lane against the host oracle
    rng = random.Random(9)
    items = [(rng.randbytes(32), rng.randbytes(rng.randint(40, 90)))
             for _ in range(leaves)]
    plan = plan_from_items(items)
    specs, flat_words, dst, child, shift = plan.export_words()
    lane_counts = sorted({s.lanes for s in specs})
    if len(specs) < 8:
        raise AssertionError(f"want a many-segment plan, got {len(specs)}")
    if len(lane_counts) < 3:
        raise AssertionError(f"want uneven lane counts, got {lane_counts}")
    runner = PlannedCommit(seg_impl=sharded_seg_impl(mesh), device=home)
    root_dev, dig_dev = runner.run(specs, flat_words, dst, child, shift,
                                   plan.root_pos, want_digests=True)
    root_cpu, dig_cpu, real = plan.execute_cpu_digests()
    if root_dev != root_cpu:
        raise AssertionError("sharded commit root mismatch vs host")
    dev8 = np.ascontiguousarray(dig_dev).view(np.uint8).reshape(-1, 32)
    bad = (dev8[real] != dig_cpu[real]).any(axis=1)
    if bad.any():
        raise AssertionError(
            f"{int(bad.sum())}/{int(real.sum())} per-lane digests differ "
            f"between the sharded device commit and the host oracle")
    print(f"dryrun_multichip OK: sharded planned commit — "
          f"{plan.num_hashed} nodes, {len(specs)} segments, lane buckets "
          f"{lane_counts}, {int(real.sum())} per-lane digests bit-exact "
          f"vs host oracle")
    summary["planned"] = {"leaves": leaves, "nodes": plan.num_hashed,
                          "segments": len(specs),
                          "lane_buckets": lane_counts,
                          "lanes": int(real.sum()), "root": root_dev.hex()}

    # 4. the resident executor, store and arenas split across the mesh,
    # through warm-trie churn and a rollback
    ex = resident_executor_over_mesh(mesh)
    res_items = sorted(
        {rng.randbytes(32): rng.randbytes(rng.randint(1, 90))
         for _ in range(resident_items)}.items())
    res_keys = [k for k, _ in res_items]
    dev_tree = IncrementalTrie(res_items)
    oracle = IncrementalTrie(res_items)
    root = ex.root_bytes(dev_tree.commit_resident(ex))
    roots = [root]
    if root != oracle.commit_cpu():
        raise AssertionError("resident initial root mismatch")
    parts = ex.store_parts()
    if ex.shards != n_devices or len(parts) != n_devices:
        raise AssertionError(
            f"digest store not split across the mesh: {ex.shards} "
            f"shard(s), {len(parts)} part(s)")
    rounds = 0
    for rnd in range(3):
        ups = [(res_keys[rng.randrange(len(res_keys))], rng.randbytes(40))
               for _ in range(150)]
        dev_tree.update(ups)
        oracle.update(ups)
        root = ex.root_bytes(dev_tree.commit_resident(ex))
        if root != oracle.commit_cpu():
            raise AssertionError(f"resident round {rnd} mismatch")
        roots.append(root)
        rounds += 1
    dev_tree.checkpoint()
    dev_tree.update([(res_keys[0], b"speculative")])
    ex.root_bytes(dev_tree.commit_resident(ex))
    dev_tree.rollback()
    root = ex.root_bytes(dev_tree.commit_resident(ex))
    if root != oracle.commit_cpu():
        raise AssertionError("resident post-rollback mismatch")
    roots.append(root)
    print(f"dryrun_multichip OK: RESIDENT executor sharded over "
          f"{n_devices} devices — store/arena rows split {ex.shards} ways "
          f"(store parts {[p[1] - p[0] for p in parts]} slots), {rounds} "
          f"churn rounds + rollback bit-exact vs host oracle")
    summary["resident"] = {"items": len(res_items), "rounds": rounds,
                           "shards": ex.shards,
                           "roots": [r.hex() for r in roots]}
    return summary

