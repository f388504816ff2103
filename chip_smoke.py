#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two commit paths on one H100 and check them.

    python3 chip_smoke.py            # full size: 1,000,000 accounts
    python3 chip_smoke.py --accounts 20000 --contracts 50   # a quick run
    python3 chip_smoke.py --device cpu --accounts 2000 --contracts 8
        # rehearsal on the CPU with the plain versions; prints no result

Phases (each passes or the script exits non-zero):
  1. card: nvidia-smi name and power limit, torch and CUDA versions
  2. build: the host Keccak (g++), kernels K1 and K2 (nvcc), in parallel
  3. K1 against its plain torch version over a (P, L) grid, bit for bit,
     plus the known Keccak vectors
  4. K2 against its plain torch version over a (B, L) grid with random
     block counts and edge lanes (nblocks 0 and L + 1: zero digests), plus
     BatchedKeccak on the card over the known vectors and messages of
     135-1200 bytes against the host keccak
  5. planned genesis commit: 1M accounts (1,000 contracts x 100 storage
     slots) composed as StateDB._planned_intermediate_root does and
     committed through K1; the root must equal the CPU Hasher's root of an
     independent trie built from the same items, and the same plan run
     through the plain version must give every lane's digest
  6. batched genesis commit: the same items in fresh tries committed by
     intermediate_root on get_batch_keccak("batched"): every trie above
     the threshold hashed level by level through K2; the same oracle root,
     and every K2 lane's digest equal to the plain version's
  7. block: 700 transfers plus 50 contracts x 20 slot writes, made once
     and applied to both states; both roots checked against the oracle
  8. fallback: a small state through the planned marker with MAX_SEGMENTS
     lowered, so that TooManySegments sends it to BatchedHasher on K2
Before the last line it prints one JSON object describing each kernel
(launches on its main path, max error, ms, plain ms, bound ms); the last
line is {"ok": true, "device": {...}}. Nothing of jax or coreth_tpu is
imported.
"""

from __future__ import annotations

import argparse
import gc
import json
import resource
import subprocess
import sys
import threading
import time
from collections import defaultdict

import numpy as np
import torch

from coreth_tpu_torch import rlp
from coreth_tpu_torch.device import resolve
from coreth_tpu_torch.native import keccak256, keccak256_batch
from coreth_tpu_torch.ops import keccak_cuda, keccak_planned
from coreth_tpu_torch.ops.device import get_batch_keccak
from coreth_tpu_torch.ops.keccak_planned import MAX_SEGMENTS, PlannedCommit, \
    PlannedMode, default_planned_commit
from coreth_tpu_torch.ops.keccak_staged import segment_keccak_plain
from coreth_tpu_torch.ops.keccak_torch import RATE, BatchedKeccak, \
    digest_words_to_bytes, int32_to_words, keccak256_blocks_plain, \
    pack_messages, words_to_int32
from coreth_tpu_torch.state.account import EMPTY_CODE_HASH, Account
from coreth_tpu_torch.state.statedb import intermediate_root, \
    planned_intermediate_root
from coreth_tpu_torch.trie import hasher as hasher_mod
from coreth_tpu_torch.trie import planned as planned_mod
from coreth_tpu_torch.trie.hasher import Hasher
from coreth_tpu_torch.trie.node import EMPTY_ROOT
from coreth_tpu_torch.trie.planned import PlannedGraphBuilder
from coreth_tpu_torch.trie.secure import StateTrie
from coreth_tpu_torch.trie.trie import trie_from_items

# Bound model for K1 and K2 (csrc/segment_keccak.cu header): 32-bit integer
# ALU operations per 136-byte block absorbed, with LOP3 folding, and the
# H100 SXM's integer rate (132 SMs x 64 ops/clock x 1.98 GHz) and memory
# rate.
K1_OPS_PER_BLOCK = 24 * 180 + 34
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12

KNOWN = {
    b"": "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470",
    b"\x80": "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421",
    b"abc": "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45",
}
GRID_L = (1, 2, 3, 4, 5, 9, 17)
GRID_P = (1, 31, 1024, 1040, 65537)
# messages straddling the 136-byte rate: 1, 2, 2, 3 and 9 blocks
BLOCK_EDGE_LENGTHS = (135, 136, 271, 272, 1200)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def k1_bound_ms(shapes):
    """Least time for K1 over [(P, L)]: the larger of ops / int rate and
    bytes / HBM rate (each input word read once, each digest written
    once); returns (ms, "operations" | "bytes")."""
    ops = sum(p * l * K1_OPS_PER_BLOCK for p, l in shapes)
    nbytes = sum(p * l * RATE + p * 32 for p, l in shapes)
    t_ops, t_bytes = ops / INT32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def k2_bound_ms(inputs, pad_lanes: int = 0):
    """Least time for K2 over [(words, nblocks)]: counted over the blocks
    the lanes really absorb (nblocks[i] for the lanes in [1, L]), each
    absorbed block read once, each block count read and each digest
    written once; `pad_lanes` of _pad_batch's padding lanes (one block
    each) are left out. Returns (ms, "operations" | "bytes")."""
    absorbed = lanes = 0
    for words, nblocks in inputs:
        nb = nblocks.long()
        absorbed += int(torch.where((nb >= 1) & (nb <= words.shape[1]), nb,
                                    torch.zeros_like(nb)).sum())
        lanes += words.shape[0]
    absorbed -= pad_lanes
    lanes -= pad_lanes
    t_ops = absorbed * K1_OPS_PER_BLOCK / INT32_OPS_PER_S
    t_bytes = (absorbed * RATE + lanes * 36) / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_ms(fn, args, reps: int) -> float:
    """Mean ms per call of fn(*args) after one warm call: CUDA events on
    the card, the host clock in a CPU rehearsal."""
    fn(*args)
    if not args[0].is_cuda:
        t = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        return (time.perf_counter() - t) * 1e3 / reps
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn(*args)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> int:
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def rss_gib() -> float:
    """Peak resident memory of this process so far."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


# ----------------------------------------------------------------- phases

def phase_card(dev) -> str:
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if dev.type != "cuda":
        return "cpu rehearsal"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")
    return card


def phase_build(dev) -> None:
    times, errors = {}, []

    def build(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except BaseException as e:  # re-raised below, in the main thread
            errors.append(e)
        times[name] = time.perf_counter() - t0

    from coreth_tpu_torch import native
    jobs = [("host keccak (g++)", native.load)]
    if dev.type == "cuda":
        jobs.append(("K1 segment_keccak (nvcc)", keccak_cuda.K1.load))
        jobs.append(("K2 keccak_blocks (nvcc)", keccak_cuda.K2.load))
    threads = [threading.Thread(target=build, args=job) for job in jobs]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for name, s in times.items():
        log(f"build {name}: {s:.2f} s")
    log(f"build total (parallel): {time.perf_counter() - t0:.2f} s")
    if dev.type == "cuda":
        for name, kernel in (("K1", keccak_cuda.K1), ("K2", keccak_cuda.K2)):
            for line in kernel.build_log().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"{name} ptxas: {line.strip()}")


def phase_grid(dev, seed: int) -> int:
    """K1 == plain on random words; returns the max abs error (0)."""
    rng = np.random.default_rng(seed)
    worst = 0
    for blocks in GRID_L:
        for p in GRID_P:
            w = rng.integers(0, 2**32, size=(p, blocks, 34), dtype=np.uint32)
            x = torch.from_numpy(words_to_int32(w)).to(dev)
            got = keccak_cuda.segment_keccak(x)
            want = segment_keccak_plain(x)
            worst = max(worst, max_abs_err(got, want))
            check(torch.equal(got, want), f"K1 != plain at P={p} L={blocks}")
    log(f"K1 vs plain: {len(GRID_L) * len(GRID_P)} shapes bit-equal "
        f"(L in {GRID_L}, P in {GRID_P})")
    msgs = list(KNOWN)
    words, _ = pack_messages(msgs)
    x = torch.from_numpy(words_to_int32(words)).to(dev)
    digs = digest_words_to_bytes(int32_to_words(keccak_cuda.segment_keccak(x)))
    for m, d in zip(msgs, digs):
        check(d.hex() == KNOWN[m], f"K1 known vector keccak({m!r})")
        check(keccak256(m).hex() == KNOWN[m], f"host known vector {m!r}")
    log("K1 and host keccak: known vectors ok")
    return worst


def phase_grid_k2(dev, seed: int) -> int:
    """K2 == plain on random words and block counts, edge lanes zero; then
    BatchedKeccak on the device against the host keccak. Returns the max
    abs error (0)."""
    rng = np.random.default_rng(seed + 1)
    worst = 0
    for blocks in GRID_L:
        for b in GRID_P:
            w = rng.integers(0, 2**32, size=(b, blocks, 34), dtype=np.uint32)
            nb = rng.integers(1, blocks + 1, b).astype(np.int32)
            if b >= 3:
                nb[-2:] = (0, blocks + 1)  # never snapshotted: zero digests
            x = torch.from_numpy(words_to_int32(w)).to(dev)
            n = torch.from_numpy(nb).to(dev)
            got = keccak_cuda.keccak256_blocks(x, n)
            want = keccak256_blocks_plain(x, n)
            worst = max(worst, max_abs_err(got, want))
            check(torch.equal(got, want), f"K2 != plain at B={b} L={blocks}")
            if b >= 3:
                check(not bool(got[-2:].any()),
                      f"K2 edge lanes not zero at B={b} L={blocks}")
    log(f"K2 vs plain: {len(GRID_L) * len(GRID_P)} shapes bit-equal "
        f"(L in {GRID_L}, B in {GRID_P}, nblocks in [1, L] plus edge lanes "
        f"0 and L + 1 giving zero digests)")
    msgs = list(KNOWN) + [rng.bytes(n) for n in BLOCK_EDGE_LENGTHS]
    got = BatchedKeccak(device=dev).digests(msgs)
    check(got == [keccak256(m) for m in msgs],
          "BatchedKeccak on the device != host keccak")
    for m, d in zip(KNOWN, got):
        check(d.hex() == KNOWN[m], f"K2 known vector keccak({m!r})")
    log(f"K2 through BatchedKeccak: known vectors and {BLOCK_EDGE_LENGTHS}"
        f"-byte messages equal the host keccak")
    if dev.type == "cuda":
        log(k2_latency_split(dev))
    return worst


def profiled_device_ms(fn, kernel: str):
    """Device time of the kernels whose name holds `kernel` while fn()
    runs, from torch.profiler's CUDA activity (CUPTI); None where the trace
    shows no device time for them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if kernel in e.key)
    return us / 1e3 if us else None


def k2_latency_split(dev, lanes: int = 128, reps: int = 200) -> str:
    """K2 on one bucket of `lanes` (_pad_batch's floor, 1 of the card's
    132 SMs) with no block to absorb (nblocks 0: launch, read the counts,
    write zero digests), one block (L = 1) and sixteen (L = 16), each
    warmed first. For `reps` back-to-back wrapper calls: the mean per call
    on CUDA events (as check_and_time_k2 times the main path's buckets),
    the mean host time to enqueue one call, and the mean kernel time in the
    profiler's trace. Where the events read no more than the host enqueue
    time, the card waits on the host."""
    cases = {"no block": (1, 0), "L=1": (1, 1), "L=16": (16, 16)}
    args = {}
    for name, (blocks, nb) in cases.items():
        args[name] = (
            torch.zeros((lanes, blocks, 34), dtype=torch.int32, device=dev),
            torch.full((lanes,), nb, dtype=torch.int32, device=dev))
        for _ in range(10):
            keccak_cuda.keccak256_blocks(*args[name])
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    parts = []
    for name, a in args.items():
        t0.record()
        h0 = time.perf_counter()
        for _ in range(reps):
            keccak_cuda.keccak256_blocks(*a)
        host_us = (time.perf_counter() - h0) / reps * 1e6
        t1.record()
        t1.synchronize()
        event_us = t0.elapsed_time(t1) / reps * 1e3

        def run(a=a):
            for _ in range(reps):
                keccak_cuda.keccak256_blocks(*a)
        kernel_ms = profiled_device_ms(run, "keccak_blocks_kernel")
        kernel = ("not measured (no device time in the trace)"
                  if kernel_ms is None else f"{kernel_ms / reps * 1e3:.3f} us")
        parts.append(f"{name} {event_us:.3f} us per call (events), host "
                     f"enqueue {host_us:.3f} us, kernel {kernel}")
    return (f"K2 latency split, one {lanes}-lane bucket, {reps} back-to-back "
            f"calls each: " + "; ".join(parts))


class _Recorder:
    """seg_impl that runs the plain version and keeps each input."""

    def __init__(self):
        self.inputs = []

    def __call__(self, words):
        self.inputs.append(words.clone())
        return segment_keccak_plain(words)


class World:
    """The state's items, kept apart from the port's tries: the oracle is
    built from these, never from the tries the main path hashed."""

    def __init__(self, n_accounts, n_contracts, n_slots, seed):
        rng = np.random.default_rng(seed)
        raw = rng.bytes(20 * n_accounts)
        self.addrs = [raw[20 * i:20 * i + 20] for i in range(n_accounts)]
        self.nonce = [int(v) for v in rng.integers(0, 1 << 16, n_accounts)]
        bal = rng.bytes(10 * n_accounts)
        self.balance = [int.from_bytes(bal[10 * i:10 * i + 10], "big") % 10**24
                        for i in range(n_accounts)]
        self.code_hash = [EMPTY_CODE_HASH] * n_accounts
        self.storage = {}  # account index -> {slot key: 32-byte value}
        for c in range(n_contracts):
            self.code_hash[c] = keccak256(rng.bytes(64))
            keys = rng.bytes(32 * n_slots)
            vals = rng.bytes(32 * n_slots)
            self.storage[c] = {
                keys[32 * s:32 * s + 32]: b"\x01" + vals[32 * s + 1:32 * s + 32]
                for s in range(n_slots)}
        self.rng = rng

    def account(self, i, root) -> Account:
        return Account(nonce=self.nonce[i], balance=self.balance[i],
                       root=root, code_hash=self.code_hash[i])


def slot_value(v: bytes) -> bytes:
    return rlp.encode(v.lstrip(b"\x00"))


class Oracle:
    """Independent tries hashed by the recursive CPU Hasher."""

    def __init__(self, world: World):
        self.world = world
        self.keys = keccak256_batch(world.addrs, threads=8)
        self.storage = {}
        self.roots = {}
        for c, slots in world.storage.items():
            t = trie_from_items((keccak256(k), slot_value(v))
                                for k, v in slots.items())
            self.storage[c] = t
            self.roots[c] = bytes(Hasher().hash(t.root, True)[0])
        self.trie = trie_from_items(
            (self.keys[i], world.account(i, self.root_of(i)).encode())
            for i in range(len(world.addrs)))

    def root_of(self, i):
        return self.roots.get(i, EMPTY_ROOT)

    def apply(self, accounts, slot_writes):
        for c, writes in slot_writes.items():
            for k, v in writes.items():
                self.storage[c].update(keccak256(k), slot_value(v))
            self.roots[c] = bytes(Hasher().hash(self.storage[c].root, True)[0])
        for i in accounts:
            self.trie.update(self.keys[i],
                             self.world.account(i, self.root_of(i)).encode())

    def root(self) -> bytes:
        return bytes(Hasher().hash(self.trie.root, True)[0])


def commit(dev, account_trie, changed, label):
    """One planned-path commit: counts zeroed before, read after."""
    keccak_cuda.launches = keccak_cuda.blocks_launches = 0
    planned_mod.planned_fallbacks = 0
    builder = PlannedGraphBuilder()
    t0 = time.perf_counter()
    root = planned_intermediate_root(account_trie, changed, device=dev,
                                     builder=builder)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = keccak_cuda.launches
    fallbacks = planned_mod.planned_fallbacks
    pc = default_planned_commit(dev)
    specs = builder.plan[0]
    check(fallbacks == 0, f"{label}: planned_fallbacks == {fallbacks}")
    check(keccak_cuda.blocks_launches == 0,
          f"{label}: the planned path launched K2")
    check(dev.type != "cuda" or launches >= len(specs),
          f"{label}: K1 launched {launches} times for {len(specs)} segments")
    log(f"{label}: nodes hashed {builder.n_hashed}, segments {len(specs)} "
        f"(MAX_SEGMENTS headroom {MAX_SEGMENTS - len(specs)}), "
        f"lanes {sum(s.lanes for s in specs)}, K1 launches {launches}")
    dev_ms = ("not measured (cpu)" if pc.last_device_ms is None
              else f"{pc.last_device_ms:.3f} ms (upload "
                   f"{pc.last_upload_ms:.3f} ms)")
    log(f"{label}: host plan {builder.plan_ms:.1f} ms, device (upload to "
        f"last digest, CUDA events) {dev_ms}, "
        f"h2d {pc.last_h2d_bytes} B in {pc.last_transfers} transfers, "
        f"commit wall {wall_ms:.1f} ms")
    return root, builder, launches


def check_and_time(dev, builder, label):
    """Same plan through the plain version: every digest equal. Then time
    K1 and the plain version on each segment's words, and a warm re-run
    of the whole plan through the default commit."""
    pc = default_planned_commit(dev)
    pc.run(*builder.plan)
    if pc.last_device_ms is not None:
        log(f"{label}: warm re-run of the plan: device {pc.last_device_ms:.3f}"
            f" ms (upload {pc.last_upload_ms:.3f} ms)")
    rec = _Recorder()
    _root, dig = PlannedCommit(seg_impl=rec, device=dev).run(
        *builder.plan, want_digests=True)
    check(np.array_equal(dig, builder.digests),
          f"{label}: K1 digests != plain digests")
    err = 0
    k1_ms = plain_ms = 0.0
    shapes = []
    for x in rec.inputs:
        got = keccak_cuda.segment_keccak(x)
        err = max(err, max_abs_err(got, segment_keccak_plain(x)))
        k1_ms += time_ms(keccak_cuda.segment_keccak, (x,), reps=10)
        plain_ms += time_ms(segment_keccak_plain, (x,), reps=1)
        shapes.append((x.shape[0], x.shape[1]))
    bound, by = k1_bound_ms(shapes)
    log(f"{label}: every lane digest equal to the plain version "
        f"({dig.shape[0]} lanes); K1 {k1_ms:.4f} ms over {len(shapes)} "
        f"segments, bound {bound:.4f} ms ({by}), plain {plain_ms:.3f} ms")
    return err, k1_ms, plain_ms, shapes


def genesis_tries(world: World, mode):
    """Fresh tries holding the genesis items, every trie carrying `mode`:
    (account trie, address -> (Account, storage StateTrie or None))."""
    account_trie = StateTrie(batch_keccak=mode)
    changed = {}
    for c, slots in world.storage.items():
        st = StateTrie(batch_keccak=mode)
        for k, v in slots.items():
            st.update(k, slot_value(v))
        changed[world.addrs[c]] = (world.account(c, EMPTY_ROOT), st)
    for i in range(len(world.addrs)):
        if i not in world.storage:
            changed[world.addrs[i]] = (world.account(i, EMPTY_ROOT), None)
    return account_trie, changed


def phase_genesis(dev, world: World, oracle_root: bytes):
    t0 = time.perf_counter()
    account_trie, changed = genesis_tries(world, PlannedMode(device=dev))
    log(f"genesis: {len(world.addrs)} accounts, {len(world.storage)} "
        f"contracts x {len(next(iter(world.storage.values())))} slots built "
        f"in {time.perf_counter() - t0:.1f} s")
    root, builder, launches = commit(dev, account_trie, changed, "genesis")
    check(root == oracle_root, f"genesis root {root.hex()} != CPU oracle "
          f"{oracle_root.hex()}")
    log(f"genesis root {root.hex()} == independent CPU Hasher root")
    return account_trie, changed, root, builder, launches


class _BlocksRecorder:
    """BatchedKeccak impl that launches K2 (keccak_cuda.keccak256_blocks,
    which counts the launch) and keeps each input and output."""

    def __init__(self):
        self.records = []

    def __call__(self, words, nblocks):
        out = keccak_cuda.keccak256_blocks(words, nblocks)
        self.records.append((words, nblocks, out))
        return out


class _GcPauses:
    """Host time the garbage collector paused the process, by generation,
    while the context is open."""

    def __init__(self):
        self.ms = defaultdict(float)
        self.count = defaultdict(int)
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.ms[info["generation"]] += (time.perf_counter() - self._t) * 1e3
            self.count[info["generation"]] += 1

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)

    def __str__(self):
        return ", ".join(f"gen {g}: {self.count[g]} in {self.ms[g]:.1f} ms"
                         for g in sorted(self.count)) or "none"


def cuda_mallocs(dev) -> int:
    """Device segments the caching allocator has obtained so far."""
    if dev.type != "cuda":
        return 0
    return torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)


def commit_batched(dev, mode, account_trie, changed, label):
    """One batched-path commit through intermediate_root: counts zeroed
    before, read after. Returns (root, K2 launches, recorder)."""
    bk = mode.batched
    rec = _BlocksRecorder()
    bk.impl, default_impl = rec, bk.impl
    bk.reset_totals()
    keccak_cuda.launches = keccak_cuda.blocks_launches = 0
    hasher_mod.keccak_batches = hasher_mod.keccak_batch_msgs = 0
    planned_mod.planned_fallbacks = 0
    mallocs = cuda_mallocs(dev)
    try:
        with _GcPauses() as pauses:
            t0 = time.perf_counter()
            root = intermediate_root(account_trie, changed,
                                     batch_keccak=mode, device=dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        bk.impl = default_impl
    mallocs = cuda_mallocs(dev) - mallocs
    k1, k2 = keccak_cuda.launches, keccak_cuda.blocks_launches
    check(k1 == 0, f"{label}: the batched path launched K1 {k1} times")
    check(planned_mod.planned_fallbacks == 0, f"{label}: planned fallback")
    check(bk.calls > 0 and bk.calls == hasher_mod.keccak_batches,
          f"{label}: {bk.calls} BatchedKeccak calls for "
          f"{hasher_mod.keccak_batches} level batches")
    check(dev.type != "cuda" or (k2 >= bk.calls and k2 == bk.launches),
          f"{label}: K2 launched {k2} times for {bk.calls} calls and "
          f"{bk.launches} buckets")
    dev_ms = ("not measured (cpu)" if bk.device_ms is None
              else f"{bk.device_ms:.3f} ms")
    log(f"{label}: nodes hashed {hasher_mod.keccak_batch_msgs}, level "
        f"batches {hasher_mod.keccak_batches}, BatchedKeccak calls "
        f"{bk.calls}, K2 launches {k2}, lanes {bk.lanes} real / "
        f"{bk.padded_lanes} padded, h2d {bk.h2d_bytes} B, device (uploads to "
        f"digest readbacks, CUDA events) {dev_ms}, commit wall {wall_ms:.1f} "
        f"ms")
    log(f"{label}: during the commit: garbage collector pauses ({pauses}), "
        f"new device segments (cudaMalloc) {mallocs}")
    return root, k2, rec


def check_and_time_k2(rec: _BlocksRecorder, label, pad_lanes: int):
    """Every lane K2 hashed on the main path against the plain version on
    the same inputs (concatenated by L: the function is per lane); then K2
    timed on each recorded input and the plain version on each group.
    `pad_lanes`: how many of the lanes are _pad_batch's padding."""
    groups = defaultdict(list)
    for words, nblocks, out in rec.records:
        groups[words.shape[1]].append((words, nblocks, out))
    err = lanes = 0
    plain_ms = 0.0
    for blocks in sorted(groups):
        g = groups[blocks]
        words = torch.cat([w for w, _, _ in g])
        nblocks = torch.cat([n for _, n, _ in g])
        got = torch.cat([o for _, _, o in g])
        want = keccak256_blocks_plain(words, nblocks)
        err = max(err, max_abs_err(got, want))
        check(torch.equal(got, want),
              f"{label}: K2 digests != plain digests at L={blocks}")
        lanes += words.shape[0]
        plain_ms += time_ms(keccak256_blocks_plain, (words, nblocks), reps=1)
        del words, nblocks, got, want
    k2_ms = sum(time_ms(keccak_cuda.keccak256_blocks, (w, n), reps=10)
                for w, n, _ in rec.records)
    inputs = [(w, n) for w, n, _ in rec.records]
    if inputs[0][0].is_cuda:
        kernel_ms = profiled_device_ms(
            lambda: [keccak_cuda.keccak256_blocks(w, n) for w, n in inputs],
            "keccak_blocks_kernel")
        log(f"{label}: K2 kernel time in the profiler's trace, one launch "
            f"per recorded input: " + ("not measured (no device time)"
                                       if kernel_ms is None
                                       else f"{kernel_ms:.4f} ms"))
    bound, by = k2_bound_ms(inputs)
    real_bound, real_by = k2_bound_ms(inputs, pad_lanes)
    log(f"{label}: every K2 lane digest equal to the plain version "
        f"({lanes} lanes in {len(rec.records)} launches, L in "
        f"{sorted(groups)}); K2 {k2_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
        f"{real_bound:.4f} ms ({real_by}) over the {lanes - pad_lanes} real "
        f"lanes alone), plain {plain_ms:.3f} ms (one call per L)")
    if inputs[0][0].is_cuda:
        log(f"{label}: replayed round trips (upload, K2, readback; CUDA "
            f"events) {replay_round_trips(inputs)}")
    return err, k2_ms, plain_ms, inputs


def replay_round_trips(inputs) -> str:
    """Each recorded bucket again as BatchedKeccak runs it, from host
    arrays: upload, K2, digest readback, timed by CUDA events as
    BatchedKeccak.device_ms is; summed for buckets up to 1024 lanes and
    above."""
    host = [(w.cpu().numpy(), n.cpu().numpy()) for w, n in inputs]
    dev = inputs[0][0].device
    small = large = 0.0
    n_small = n_large = 0
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    for w, n in host:
        t0.record()
        out = keccak_cuda.keccak256_blocks(torch.from_numpy(w).to(dev),
                                           torch.from_numpy(n).to(dev))
        out.cpu()
        t1.record()
        t1.synchronize()
        if w.shape[0] <= 1024:
            small += t0.elapsed_time(t1)
            n_small += 1
        else:
            large += t0.elapsed_time(t1)
            n_large += 1
    return (f"{small + large:.3f} ms: {n_small} buckets of <= 1024 lanes "
            f"{small:.3f} ms, {n_large} larger {large:.3f} ms")


def phase_genesis_batched(dev, world: World, oracle_root: bytes):
    mode = get_batch_keccak("batched", dev)
    t0 = time.perf_counter()
    account_trie, changed = genesis_tries(world, mode)
    log(f"batched genesis: fresh tries built in "
        f"{time.perf_counter() - t0:.1f} s")
    root, launches, rec = commit_batched(dev, mode, account_trie, changed,
                                         "batched genesis")
    check(root == oracle_root, f"batched genesis root {root.hex()} != CPU "
          f"oracle {oracle_root.hex()}")
    log(f"batched genesis root {root.hex()} == independent CPU Hasher root")
    return mode, account_trie, changed, launches, rec


def make_block(world: World, n_transfers=700, n_contracts=50, n_writes=20):
    rng = world.rng
    n = len(world.addrs)
    plain_pool = np.arange(len(world.storage), n)
    touched = set()
    for _ in range(n_transfers):
        s, r = (int(v) for v in rng.choice(plain_pool, 2, replace=False))
        value = int(rng.integers(1, 10**12))
        fee = 21000 * 25 * 10**9
        if world.balance[s] < value + fee:
            world.balance[s] += 10**20
        world.nonce[s] += 1
        world.balance[s] -= value + fee
        world.balance[r] += value
        touched.update((s, r))
    writes = {}
    n_contracts = min(n_contracts, len(world.storage))
    for c in (int(v) for v in rng.choice(sorted(world.storage), n_contracts,
                                         replace=False)):
        old = list(world.storage[c])
        w = {}
        for k in rng.choice(len(old), min(n_writes // 2, len(old)),
                            replace=False):
            w[old[int(k)]] = b"\x02" + rng.bytes(31)
        for _ in range(n_writes - n_writes // 2):
            w[rng.bytes(32)] = b"\x03" + rng.bytes(31)
        world.storage[c].update(w)
        writes[c] = w
        touched.add(c)
    return sorted(touched), writes


def block_changes(world, changed_genesis, accounts, writes):
    """The block's changed map over one state's genesis objects."""
    changed = {}
    for i in accounts:
        addr = world.addrs[i]
        acct, st = changed_genesis[addr]
        acct.nonce, acct.balance = world.nonce[i], world.balance[i]
        if i in writes:
            for k, v in writes[i].items():
                st.update(k, slot_value(v))
            changed[addr] = (acct, st)
        else:
            changed[addr] = (acct, None)
    return changed


def phase_fallback(dev, seed: int):
    """A small state through the planned marker with the segment table cut
    to 2: TooManySegments sends the account trie to BatchedHasher on K2."""
    world = World(3000, 5, 20, seed + 2)
    want = Oracle(world).root()
    mode = PlannedMode(device=dev)
    account_trie, changed = genesis_tries(world, mode)
    keccak_cuda.launches = keccak_cuda.blocks_launches = 0
    planned_mod.planned_fallbacks = 0
    keccak_planned.MAX_SEGMENTS = 2
    try:
        root = intermediate_root(account_trie, changed, batch_keccak=mode,
                                 device=dev)
    finally:
        keccak_planned.MAX_SEGMENTS = MAX_SEGMENTS
    fallbacks, k2 = planned_mod.planned_fallbacks, keccak_cuda.blocks_launches
    check(root == want, f"fallback root {root.hex()} != CPU Hasher "
          f"{want.hex()}")
    # the commit overflows, then the account trie's own re-plan does too
    check(fallbacks == 2, f"fallback: planned_fallbacks == {fallbacks}")
    check(keccak_cuda.launches == 0, "fallback: K1 launched")
    check(dev.type != "cuda" or k2 > 0, "fallback: K2 never launched")
    log(f"fallback (3000 accounts, MAX_SEGMENTS 2): root == CPU Hasher root, "
        f"planned_fallbacks {fallbacks}, K2 launches {k2}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--accounts", type=int, default=1_000_000)
    ap.add_argument("--contracts", type=int, default=1_000)
    ap.add_argument("--slots", type=int, default=100)
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--device", default="cuda",
                    help="'cpu' rehearses with the plain versions")
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = resolve(args.device)
    t_start = time.perf_counter()

    card = phase_card(dev)
    phase_build(dev)
    grid_err = phase_grid(dev, args.seed)
    grid2_err = phase_grid_k2(dev, args.seed)

    t0 = time.perf_counter()
    world = World(args.accounts, args.contracts, args.slots, args.seed)
    oracle = Oracle(world)
    oracle_root = oracle.root()
    log(f"genesis: CPU oracle (independent tries) "
        f"{time.perf_counter() - t0:.1f} s; peak RSS {rss_gib():.1f} GiB")

    # planned path (K1)
    p_trie, p_changed, _root, g_builder, g_launches = phase_genesis(
        dev, world, oracle_root)
    g_err, g_ms, g_plain, g_shapes = check_and_time(dev, g_builder, "genesis")
    del g_builder
    # batched path (K2)
    mode, b_trie, b_changed, bg_launches, bg_rec = phase_genesis_batched(
        dev, world, oracle_root)
    bg_pad = mode.batched.padded_lanes - mode.batched.lanes
    bg_err, bg_ms, bg_plain, bg_inputs = check_and_time_k2(
        bg_rec, "batched genesis", bg_pad)
    del bg_rec
    log(f"after both genesis commits: peak RSS {rss_gib():.1f} GiB")

    # one block, made once, applied to the oracle and to both states
    accounts, writes = make_block(world)
    log(f"block: {len(accounts)} account updates, {len(writes)} contracts, "
        f"{sum(len(w) for w in writes.values())} slot writes")
    t0 = time.perf_counter()
    oracle.apply(accounts, writes)
    want = oracle.root()
    log(f"block: CPU oracle {time.perf_counter() - t0:.1f} s")
    root, b_builder, b_launches = commit(
        dev, p_trie, block_changes(world, p_changed, accounts, writes),
        "block")
    check(root == want, f"block root {root.hex()} != CPU oracle {want.hex()}")
    log(f"block root {root.hex()} == independent CPU Hasher root")
    b_err, b_ms, b_plain, b_shapes = check_and_time(dev, b_builder, "block")
    del b_builder, p_trie, p_changed
    root, bb_launches, bb_rec = commit_batched(
        dev, mode, b_trie, block_changes(world, b_changed, accounts, writes),
        "batched block")
    check(root == want, f"batched block root {root.hex()} != CPU oracle "
          f"{want.hex()}")
    log(f"batched block root {root.hex()} == independent CPU Hasher root")
    bb_pad = mode.batched.padded_lanes - mode.batched.lanes
    bb_err, bb_ms, bb_plain, bb_inputs = check_and_time_k2(
        bb_rec, "batched block", bb_pad)
    del bb_rec

    phase_fallback(dev, args.seed)

    k1_bound, k1_by = k1_bound_ms(g_shapes + b_shapes)
    k2_bound, k2_by = k2_bound_ms(bg_inputs + bb_inputs)
    k2_real, _ = k2_bound_ms(bg_inputs + bb_inputs, bg_pad + bb_pad)
    log(f"K2 bound over both commits {k2_bound:.4f} ms ({k2_by}), over "
        f"their real lanes alone {k2_real:.4f} ms")
    log(f"peak RSS {rss_gib():.1f} GiB")
    log(f"card {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "segment_keccak",
        "route": "cuda",
        "source": "coreth_tpu_torch/ops/csrc/segment_keccak.cu",
        "replaces": "coreth_tpu/ops/keccak_pallas.py:211",
        "launches": g_launches + b_launches,
        "max_abs_err": max(grid_err, g_err, b_err),
        "ms": g_ms + b_ms,
        "plain_ms": g_plain + b_plain,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
    }, {
        "name": "keccak_blocks",
        "route": "cuda",
        "source": "coreth_tpu_torch/ops/csrc/keccak_blocks.cu",
        "replaces": "coreth_tpu/ops/keccak_pallas.py:126",
        "launches": bg_launches + bb_launches,
        "max_abs_err": max(grid2_err, bg_err, bb_err),
        "ms": bg_ms + bb_ms,
        "plain_ms": bg_plain + bb_plain,
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
    }]}), flush=True)
    if dev.type != "cuda":
        return 0  # a rehearsal prints no result line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
