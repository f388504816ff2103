#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's three commit paths on one H100 and check them.

    python3 chip_smoke.py            # full size: 1,000,000 accounts
    python3 chip_smoke.py --accounts 20000 --contracts 50   # a quick run
    python3 chip_smoke.py --device cpu --accounts 2000 --contracts 8
        # rehearsal on the CPU with the plain versions; prints no result

Phases (each passes or the script exits non-zero):
  1. card: nvidia-smi name and power limit, torch and CUDA versions
  2. build: the host Keccak and the native planners (g++), kernels K1 and
     K2 (nvcc), in parallel; ptxas registers and spills of their four
     kernels
  3. K1 against its plain torch version over a (P, L) grid, bit for bit,
     plus the known Keccak vectors, through each variant forced (1: one
     thread per lane, 2: cooperative) and the launch's own choice; the
     grid's P includes the sizes either side of K1's kCoopMaxLanes
  4. K2 the same over a (B, L) grid with random block counts and edge
     lanes (nblocks 0 and L + 1: zero digests), plus BatchedKeccak on the
     card over the known vectors and messages of 135-1200 bytes against the
     host keccak; K2's latency split for both variants
  4b. the variant sweep: both variants of K1 and K2 at B in SWEEP_B x L in
     (1, 4) on CUDA events and in the profiler's trace, and the crossover
     that sets kCoopMaxLanes
  5. planned genesis commit: 1M accounts (1,000 contracts x 100 storage
     slots) composed as StateDB._planned_intermediate_root does and
     committed through K1; the root must equal the CPU Hasher's root of an
     independent trie built from the same items, and the same plan run
     through the plain version must give every lane's digest
  6. batched genesis commit: the same items in fresh tries committed by
     intermediate_root on get_batch_keccak("batched"): every trie above
     the threshold hashed level by level through K2; the same oracle root,
     and every K2 lane's digest equal to the plain version's
  6b. resident genesis: two sets of the contracts' storage tries (A's and
     B's), each hashed in one program (batch_storage_roots), then three
     native IncrementalTries from the
     genesis leaves (keccak(address), account RLP): A device-resident
     (ResidentExecutor on K1, lean rows), B template mode (its executor
     records every K1 input), C the native host commit; all three roots
     equal the oracle's. Prints the native plan and export ms, the device
     window, h2d bytes and transfers, and the device bytes of store and
     arenas
  7. block: 700 transfers plus 50 contracts x 20 slot writes, made once
     and applied to every state; every root checked against the oracle
     (A and B through resident_intermediate_root)
  7b. resident blocks: --blocks (16) further seeded blocks, A pipelined at
     depth 2 (commit_resident_dispatch), B template through
     resident_intermediate_root (each with its own storage program), C on
     the host, each root equal to the
     oracle's; the middle block is rejected (checkpoint, update, commit,
     rollback, commit) and its rollback root must equal its parent's. Every
     recorded K1 input is held against the plain version (with the main
     path's own output), each launch must have run the variant its shape
     calls for, and K1 is timed on them
Every kernel time read from the profiler's trace is checked against the
number of launches the session made (phases 3-7b): where the trace holds
another number of records, the time reads "not measured" (None in the
JSON line).
  8. fallback: a small state through the planned marker with MAX_SEGMENTS
     lowered, so that TooManySegments sends it to BatchedHasher on K2
Before the last line it prints one JSON object describing each kernel
(launches on its main paths, max error, ms, plain ms, bound ms, and per
variant its launches and kernel ms in the profiler's trace; K1's entry
sums the planned and the resident paths); the last
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
from coreth_tpu_torch.native import keccak256, keccak256_batch, mpt
from coreth_tpu_torch.native.mpt import IncrementalTrie, plan_from_items
from coreth_tpu_torch.ops import keccak_cuda, keccak_planned
from coreth_tpu_torch.ops.device import get_batch_keccak
from coreth_tpu_torch.ops.keccak_planned import MAX_SEGMENTS, PlannedCommit, \
    PlannedMode, default_planned_commit
from coreth_tpu_torch.ops.keccak_resident import ResidentExecutor
from coreth_tpu_torch.ops.keccak_staged import segment_keccak_plain
from coreth_tpu_torch.ops.keccak_torch import RATE, BatchedKeccak, \
    digest_words_to_bytes, int32_to_words, keccak256_blocks_plain, \
    pack_messages, words_to_int32
from coreth_tpu_torch.state.account import EMPTY_CODE_HASH, Account
from coreth_tpu_torch.state.statedb import batch_storage_roots, \
    intermediate_root, planned_intermediate_root, resident_intermediate_root, \
    resident_items
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
# forced one thread per lane, forced cooperative, the launch's own choice
VARIANTS = (keccak_cuda.THREAD, keccak_cuda.COOP, None)
# 2048 and 4096 place the crossover between 1024 and 8192
SWEEP_B = (128, 1024, 2048, 4096, 8192, 65536, 524288)
SWEEP_L = (1, 4)
# the profiler's kernel names of each kernel's two variants
KERNEL_NAMES = {
    "K1": {keccak_cuda.THREAD: "segment_keccak_kernel",
           keccak_cuda.COOP: "segment_keccak_coop_kernel"},
    "K2": {keccak_cuda.THREAD: "keccak_blocks_kernel",
           keccak_cuda.COOP: "keccak_blocks_coop_kernel"},
}
VARIANT_NAME = {keccak_cuda.THREAD: "thread", keccak_cuda.COOP: "coop"}


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
    jobs = [("host keccak (g++)", native.load),
            ("native planner (g++)", mpt.load),
            ("native incremental trie (g++)", mpt.load_inc)]
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
            for fn, (regs, stores, loads) in ptxas_report(
                    kernel.build_log()).items():
                log(f"{name} ptxas {fn}: {regs} registers, spill stores "
                    f"{stores} B, spill loads {loads} B")
            log(f"{name} kCoopMaxLanes {kernel.coop_max_lanes}")


def ptxas_report(build_log: str) -> dict:
    """{kernel name: (registers, spill store bytes, spill load bytes)} from
    nvcc's -Xptxas -v output, for the names in KERNEL_NAMES."""
    names = [n for v in KERNEL_NAMES.values() for n in v.values()]
    out, current, spill = {}, None, (None, None)
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            # a name's length prefix in the mangled symbol keeps
            # keccak_blocks_kernel apart from keccak_blocks_coop_kernel
            current = next((n for n in names if f"{len(n)}{n}" in mangled),
                           None)
        elif "spill stores" in line and current:
            nums = [int(t) for t in line.replace(",", " ").split()
                    if t.isdigit()]
            spill = (nums[1], nums[2])  # stack frame, stores, loads
        elif "Used" in line and "registers" in line and current:
            regs = int(line.split("Used")[1].split()[0])
            out[current] = (regs, *spill)
            current = None
    return out


def grid_sizes(kernel) -> tuple:
    """GRID_P plus the sizes either side of the kernel's kCoopMaxLanes."""
    t = kernel.coop_max_lanes
    return GRID_P if t is None else GRID_P + (t, t + 1)


def grid_variants(dev) -> tuple:
    """Every variant on the card; the CPU rehearsal's plain version is the
    same whatever the variant, so it runs once."""
    return VARIANTS if dev.type == "cuda" else (None,)


def phase_grid(dev, seed: int) -> int:
    """K1 == plain on random words through every variant; returns the max
    abs error (0)."""
    rng = np.random.default_rng(seed)
    worst = 0
    sizes, variants = grid_sizes(keccak_cuda.K1), grid_variants(dev)
    for blocks in GRID_L:
        for p in sizes:
            w = rng.integers(0, 2**32, size=(p, blocks, 34), dtype=np.uint32)
            x = torch.from_numpy(words_to_int32(w)).to(dev)
            want = segment_keccak_plain(x)
            for v in variants:
                got = keccak_cuda.segment_keccak(x, variant=v)
                worst = max(worst, max_abs_err(got, want))
                check(torch.equal(got, want),
                      f"K1 != plain at P={p} L={blocks} variant {v}")
    log(f"K1 vs plain: {len(GRID_L) * len(sizes)} shapes x variants "
        f"{variants} bit-equal (L in {GRID_L}, P in {sizes})")
    msgs = list(KNOWN)
    words, _ = pack_messages(msgs)
    x = torch.from_numpy(words_to_int32(words)).to(dev)
    for v in variants:
        digs = digest_words_to_bytes(int32_to_words(
            keccak_cuda.segment_keccak(x, variant=v)))
        for m, d in zip(msgs, digs):
            check(d.hex() == KNOWN[m], f"K1 variant {v} known vector {m!r}")
    for m in msgs:
        check(keccak256(m).hex() == KNOWN[m], f"host known vector {m!r}")
    log(f"K1 (variants {variants}) and host keccak: known vectors ok")
    return worst


def phase_grid_k2(dev, seed: int) -> int:
    """K2 == plain on random words and block counts through every variant,
    edge lanes zero; then BatchedKeccak on the device, and K2 directly per
    variant, against the host keccak. Returns the max abs error (0)."""
    rng = np.random.default_rng(seed + 1)
    worst = 0
    sizes, variants = grid_sizes(keccak_cuda.K2), grid_variants(dev)
    for blocks in GRID_L:
        for b in sizes:
            w = rng.integers(0, 2**32, size=(b, blocks, 34), dtype=np.uint32)
            nb = rng.integers(1, blocks + 1, b).astype(np.int32)
            if b >= 3:
                nb[-2:] = (0, blocks + 1)  # never snapshotted: zero digests
            x = torch.from_numpy(words_to_int32(w)).to(dev)
            n = torch.from_numpy(nb).to(dev)
            want = keccak256_blocks_plain(x, n)
            for v in variants:
                got = keccak_cuda.keccak256_blocks(x, n, variant=v)
                worst = max(worst, max_abs_err(got, want))
                check(torch.equal(got, want),
                      f"K2 != plain at B={b} L={blocks} variant {v}")
                if b >= 3:
                    check(not bool(got[-2:].any()), f"K2 edge lanes not "
                          f"zero at B={b} L={blocks} variant {v}")
    log(f"K2 vs plain: {len(GRID_L) * len(sizes)} shapes x variants "
        f"{variants} bit-equal (L in {GRID_L}, B in {sizes}, nblocks in "
        f"[1, L] plus edge lanes 0 and L + 1 giving zero digests)")
    msgs = list(KNOWN) + [rng.bytes(n) for n in BLOCK_EDGE_LENGTHS]
    want = [keccak256(m) for m in msgs]
    got = BatchedKeccak(device=dev).digests(msgs)
    check(got == want, "BatchedKeccak on the device != host keccak")
    for m, d in zip(KNOWN, got):
        check(d.hex() == KNOWN[m], f"K2 known vector keccak({m!r})")
    words, nblocks = pack_messages(msgs)
    x = torch.from_numpy(words_to_int32(words)).to(dev)
    n = torch.from_numpy(nblocks.astype(np.int32)).to(dev)
    for v in variants:
        got = digest_words_to_bytes(int32_to_words(
            keccak_cuda.keccak256_blocks(x, n, variant=v)))
        check(got == want, f"K2 variant {v} != host keccak")
    log(f"K2 through BatchedKeccak and each variant {variants}: known "
        f"vectors and {BLOCK_EDGE_LENGTHS}-byte messages equal the host "
        f"keccak")
    if dev.type == "cuda":
        for v in (keccak_cuda.THREAD, keccak_cuda.COOP):
            log(k2_latency_split(dev, v))
        log(enqueue_breakdown(dev))
    return worst


LEAD_IN = 512  # launches of each profiled kernel before fn(): the card's
# traces drop a prefix of a session's kernel records (2 to 249 on an H100)
LEAD_GAP_S = 0.05  # idle card between the lead-in and fn()


def _lead_in(names) -> None:
    """LEAD_IN launches of each kernel in `names` on a one-lane input."""
    w = torch.zeros((1, 1, 34), dtype=torch.int32, device="cuda")
    n = torch.ones(1, dtype=torch.int32, device="cuda")
    for kname, variants in KERNEL_NAMES.items():
        for v, name in variants.items():
            for _ in range(LEAD_IN if name in names else 0):
                if kname == "K1":
                    keccak_cuda.segment_keccak(w, variant=v)
                else:
                    keccak_cuda.keccak256_blocks(w, n, variant=v)


def profiled_device_ms(fn, kernels: dict) -> list:
    """Device time of the kernels whose name holds each key of `kernels`
    while fn() runs, from torch.profiler's CUDA activity (CUPTI). The
    session opens with a lead-in (LEAD_IN launches of each kernel, then
    LEAD_GAP_S of idle card); the records after that gap are fn()'s. Each
    value is the number of launches of that kernel fn() makes: a name
    whose records after the gap are another number, or that shows no
    device time, reads None, and the shortfall is logged. The garbage
    collector is off during the session. A name matches itself alone: no
    kernel name here holds another."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    gc_on = gc.isenabled()
    gc.disable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _lead_in(kernels)
            torch.cuda.synchronize()
            time.sleep(LEAD_GAP_S)
            fn()
            torch.cuda.synchronize()
    finally:
        if gc_on:
            gc.enable()
    recs = sorted((e for e in prof.events()
                   if any(k in e.name for k in kernels)),
                  key=lambda e: e.time_range.start)
    gap_us = LEAD_GAP_S * 1e6 / 2
    cut = next((i for i in range(1, len(recs))
                if recs[i].time_range.start - recs[i - 1].time_range.end
                >= gap_us), None)
    n_lead = LEAD_IN * len(kernels)
    if cut is None:
        log(f"profiler: no idle gap after the lead-in among {len(recs)} "
            f"kernel records; not measured")
        return [None] * len(kernels)
    out, short = [], []
    for k, want in kernels.items():
        got = [e for e in recs[cut:] if k in e.name]
        us = sum(e.time_range.elapsed_us() for e in got)
        if len(got) != want:
            short.append(f"{k} {len(got)} of {want}")
        out.append(us / 1e3 if us and len(got) == want else None)
    if short or cut != n_lead:
        log(f"profiler: the trace holds {cut} of the lead-in's {n_lead} "
            f"kernel records" + (f"; after it {', '.join(short)}, not "
                                 f"measured" if short else ""))
    return out


def k2_latency_split(dev, variant: int, lanes: int = 128,
                     reps: int = 200) -> str:
    """K2, forced to `variant`, on one bucket of `lanes` (_pad_batch's
    floor) with no block to absorb (nblocks 0: launch, read the counts,
    write zero digests), one block (L = 1) and sixteen (L = 16), each
    warmed first. For `reps` back-to-back wrapper calls: the mean per call
    on CUDA events (as check_and_time_k2 times the main path's buckets),
    the mean host time to enqueue one call, and the mean kernel time in the
    profiler's trace. Where the events read no more than the host enqueue
    time, the card waits on the host."""
    cases = {"no block": (1, 0), "L=1": (1, 1), "L=16": (16, 16)}
    name_in_trace = KERNEL_NAMES["K2"][variant]
    args = {}
    for name, (blocks, nb) in cases.items():
        args[name] = (
            torch.zeros((lanes, blocks, 34), dtype=torch.int32, device=dev),
            torch.full((lanes,), nb, dtype=torch.int32, device=dev), variant)
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
        kernel_ms, = profiled_device_ms(run, {name_in_trace: reps})
        kernel = ("not measured (no device time in the trace)"
                  if kernel_ms is None else f"{kernel_ms / reps * 1e3:.3f} us")
        parts.append(f"{name} {event_us:.3f} us per call (events), host "
                     f"enqueue {host_us:.3f} us, kernel {kernel}")
    return (f"K2 latency split, variant {variant} "
            f"({VARIANT_NAME[variant]}), one {lanes}-lane bucket, {reps} "
            f"back-to-back calls each: " + "; ".join(parts))


def enqueue_breakdown(dev, lanes: int = 128, reps: int = 1000) -> str:
    """What one K2 wrapper call with no block to absorb costs the host,
    part by part, as the mean over `reps` back-to-back calls on the host
    clock: the input checks, the output allocation, the device and raw
    stream lookups, the bare ctypes call into the library (argument
    conversion, cudaLaunchKernel, cudaGetLastError), the whole wrapper,
    and as a yardstick one PyTorch kernel launch (Tensor.zero_ on the
    output)."""
    w = torch.zeros((lanes, 1, 34), dtype=torch.int32, device=dev)
    n = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    out = keccak_cuda.keccak256_blocks(w, n)
    fn, index = keccak_cuda.K2.load(), w.get_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    ptrs = (w.data_ptr(), n.data_ptr(), out.data_ptr(), lanes, 1,
            keccak_cuda.THREAD)
    parts = {
        "checks": lambda: keccak_cuda._check("keccak256_blocks", w, None),
        "allocation": lambda: w.new_empty((lanes, 8)),
        "device and stream": lambda: (
            torch._C._cuda_getDevice(),
            torch._C._cuda_getCurrentRawStream(index)),
        "ctypes launch": lambda: fn(*ptrs, stream),
        "whole wrapper": lambda: keccak_cuda.keccak256_blocks(w, n),
        "yardstick Tensor.zero_": lambda: out.zero_(),
    }
    times = []
    for name, call in parts.items():
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        times.append(f"{name} {(time.perf_counter() - t0) / reps * 1e6:.3f}")
        torch.cuda.synchronize()
    return (f"K2 host enqueue by part, one {lanes}-lane call with no block, "
            f"us per call over {reps}: " + ", ".join(times))


def phase_sweep(dev, reps: int = 20) -> dict:
    """Both variants of K1 and K2 at B in SWEEP_B x L in SWEEP_L, every
    lane absorbing L blocks: mean ms per call on CUDA events and kernel ms
    per call in the profiler's trace, the two variants' digests equal.
    Prints each (B, L) and, per kernel and L, the crossover: the largest B
    at which the cooperative kernel is faster in the trace. Returns
    {(kernel, L): that B or None}."""
    t_start = time.perf_counter()
    calls = {"K1": lambda w, n, v: keccak_cuda.segment_keccak(w, variant=v),
             "K2": lambda w, n, v: keccak_cuda.keccak256_blocks(w, n,
                                                               variant=v)}
    crossover = {}
    for kname, call in calls.items():
        for blocks in SWEEP_L:
            coop_wins = []
            for b in SWEEP_B:
                w = torch.randint(-2**31, 2**31, (b, blocks, 34),
                                  dtype=torch.int32, device=dev)
                n = torch.full((b,), blocks, dtype=torch.int32, device=dev)
                outs = [call(w, n, v) for v in KERNEL_NAMES[kname]]
                check(torch.equal(*outs), f"sweep {kname} B={b} L={blocks}: "
                      f"the variants disagree")
                ev = {v: time_ms(call, (w, n, v), reps)
                      for v in KERNEL_NAMES[kname]}

                def run():
                    for v in KERNEL_NAMES[kname]:
                        for _ in range(reps):
                            call(w, n, v)
                kern = dict(zip(KERNEL_NAMES[kname], profiled_device_ms(
                    run, {name: reps
                          for name in KERNEL_NAMES[kname].values()})))
                kern = {v: None if ms is None else ms / reps
                        for v, ms in kern.items()}
                bound, by = k1_bound_ms([(b, blocks)])
                log(f"sweep {kname} B={b} L={blocks}: " + ", ".join(
                    f"{VARIANT_NAME[v]} {ev[v]:.4f} ms events / "
                    + ("not measured" if kern[v] is None
                       else f"{kern[v]:.4f} ms kernel")
                    for v in KERNEL_NAMES[kname])
                    + f"; bound {bound:.4f} ms ({by})")
                t, c = (kern[keccak_cuda.THREAD], kern[keccak_cuda.COOP])
                if t is None or c is None:
                    t, c = ev[keccak_cuda.THREAD], ev[keccak_cuda.COOP]
                coop_wins.append(c < t)
                del w, n, outs
            last = max((b for b, won in zip(SWEEP_B, coop_wins) if won),
                       default=None)
            crossover[(kname, blocks)] = last
            log(f"sweep crossover {kname} L={blocks}: cooperative faster at "
                f"B in {[b for b, won in zip(SWEEP_B, coop_wins) if won]}, "
                f"one thread per lane at "
                f"{[b for b, won in zip(SWEEP_B, coop_wins) if not won]}")
    log(f"sweep: {time.perf_counter() - t_start:.1f} s")
    return crossover


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
    """One planned-path commit: counts zeroed before, read after. Returns
    (root, builder, K1 launches, of them cooperative)."""
    keccak_cuda.reset_counts()
    planned_mod.planned_fallbacks = 0
    builder = PlannedGraphBuilder()
    t0 = time.perf_counter()
    root = planned_intermediate_root(account_trie, changed, device=dev,
                                     builder=builder)
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches, coop = keccak_cuda.launches, keccak_cuda.launches_coop
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
        f"lanes {sum(s.lanes for s in specs)}, K1 launches {launches} "
        f"(cooperative {coop})")
    dev_ms = ("not measured (cpu)" if pc.last_device_ms is None
              else f"{pc.last_device_ms:.3f} ms (upload "
                   f"{pc.last_upload_ms:.3f} ms)")
    log(f"{label}: host plan {builder.plan_ms:.1f} ms, device (upload to "
        f"last digest, CUDA events) {dev_ms}, "
        f"h2d {pc.last_h2d_bytes} B in {pc.last_transfers} transfers, "
        f"commit wall {wall_ms:.1f} ms")
    return root, builder, launches, coop


def timed_variant(call, args, coop_count: str):
    """(time_ms of call(*args) over 10 calls, the variant the launches
    picked on their own), the variant as the wrapper's cooperative count,
    keccak_cuda.<coop_count>, records it."""
    before = getattr(keccak_cuda, coop_count)
    ms = time_ms(call, args, reps=10)
    coop = getattr(keccak_cuda, coop_count) > before
    return ms, keccak_cuda.COOP if coop else keccak_cuda.THREAD


def kernel_ms_by_variant(kname: str, call, inputs, ran: dict,
                         reps: int) -> dict:
    """{variant: kernel ms per pass over `inputs`} in the profiler's trace,
    each input run `reps` times in one session through `call` (the
    launch's own choice of variant); `ran` is {variant: inputs that launch
    it}, 0.0 for a variant not in it, None where the trace does not hold
    exactly reps x ran[variant] records of the variant."""
    def run():
        for args in inputs:
            for _ in range(reps):
                call(*args)
    names = KERNEL_NAMES[kname]
    got = profiled_device_ms(run, {name: reps * ran.get(v, 0)
                                   for v, name in names.items()})
    return {v: (0.0 if v not in ran else None if ms is None else ms / reps)
            for v, ms in zip(names, got)}


def fmt_ms(ms) -> str:
    return ("not measured (records short or no device time)" if ms is None
            else f"{ms:.4f} ms")


def check_and_time(dev, builder, label):
    """Same plan through the plain version: every digest equal. Then time
    K1 and the plain version on each segment's words (per segment: P, L,
    the variant the launch picks, ms on events, bound), K1's kernel time in
    the profiler's trace per variant, and a warm re-run of the whole plan
    through the default commit."""
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
    log(f"{label}: every lane digest equal to the plain version "
        f"({dig.shape[0]} lanes)")
    return time_k1(dev, rec.inputs, label)


def time_k1(dev, inputs, label, per_segment: bool = True, outputs=None):
    """K1 against the plain version on each recorded input (and the main
    path's own `outputs` of them, when given): per input, or with
    per_segment=False once per L over the concatenated inputs of that L,
    the plain version timed on the same calls. Then K1 timed on each input
    (logged per segment when `per_segment`: P, L, the variant the launch
    picks, ms on events, bound), and K1's kernel time in the profiler's
    trace per variant. Returns (max abs error, K1 ms, plain ms, [(P, L)],
    {variant: kernel ms})."""
    err = 0
    k1_ms = plain_ms = 0.0
    shapes = []
    by_variant = defaultdict(float)
    n_by_variant = defaultdict(int)
    cuda = dev.type == "cuda"
    # the plain version per input, or once per L over the inputs of that L
    # concatenated (the function is per lane)
    groups = defaultdict(list)
    for i, x in enumerate(inputs):
        groups[i if per_segment else x.shape[1]].append(i)
    for idx in groups.values():
        x = (inputs[idx[0]] if len(idx) == 1
             else torch.cat([inputs[i] for i in idx]))
        want = segment_keccak_plain(x)
        plain_ms += time_ms(segment_keccak_plain, (x,), reps=1)
        err = max(err, max_abs_err(keccak_cuda.segment_keccak(x), want))
        if outputs is not None:
            got = (outputs[idx[0]] if len(idx) == 1
                   else torch.cat([outputs[i] for i in idx]))
            err = max(err, max_abs_err(got, want))
        del x, want
    for x in inputs:
        ms, v = timed_variant(keccak_cuda.segment_keccak, (x,),
                              "launches_coop")
        k1_ms += ms
        p, blocks = x.shape[0], x.shape[1]
        shapes.append((p, blocks))
        if cuda:
            by_variant[v] += ms
            n_by_variant[v] += 1
            if per_segment:
                bound, by = k1_bound_ms([(p, blocks)])
                log(f"{label}: K1 segment (P, L, variant, ms, bound) = ({p}, "
                    f"{blocks}, {v}, {ms:.4f}, {bound:.4f} {by})")
    check(err == 0, f"{label}: K1 != plain version (max abs err {err})")
    bound, by = k1_bound_ms(shapes)
    log(f"{label}: K1 {k1_ms:.4f} ms over {len(shapes)} segments, bound "
        f"{bound:.4f} ms ({by}), plain {plain_ms:.3f} ms")
    kernel = {}
    if cuda:
        kernel = kernel_ms_by_variant(
            "K1", keccak_cuda.segment_keccak, [(x,) for x in inputs],
            n_by_variant, reps=10)
        log(f"{label}: K1 by variant, events / kernel in the profiler's "
            f"trace (each segment 10 times in one session): " + "; ".join(
                f"{VARIANT_NAME[v]} {by_variant[v]:.4f} ms / "
                f"{fmt_ms(kernel[v])}" for v in KERNEL_NAMES["K1"]))
    return err, k1_ms, plain_ms, shapes, kernel


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
    root, builder, launches, coop = commit(dev, account_trie, changed,
                                           "genesis")
    check(root == oracle_root, f"genesis root {root.hex()} != CPU oracle "
          f"{oracle_root.hex()}")
    log(f"genesis root {root.hex()} == independent CPU Hasher root")
    return account_trie, changed, builder, launches, coop


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
    before, read after. Returns (root, K2 launches, of them cooperative,
    recorder)."""
    bk = mode.batched
    rec = _BlocksRecorder()
    bk.impl, default_impl = rec, bk.impl
    bk.reset_totals()
    keccak_cuda.reset_counts()
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
    k2_coop = keccak_cuda.blocks_launches_coop
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
        f"{bk.calls}, K2 launches {k2} (cooperative {k2_coop}), lanes "
        f"{bk.lanes} real / "
        f"{bk.padded_lanes} padded, h2d {bk.h2d_bytes} B, device (uploads to "
        f"digest readbacks, CUDA events) {dev_ms}, commit wall {wall_ms:.1f} "
        f"ms")
    log(f"{label}: during the commit: garbage collector pauses ({pauses}), "
        f"new device segments (cudaMalloc) {mallocs}")
    return root, k2, k2_coop, rec


def check_and_time_k2(rec: _BlocksRecorder, label, pad_lanes: int,
                      profile_reps: int):
    """Every lane K2 hashed on the main path against the plain version on
    the same inputs (concatenated by L: the function is per lane); then K2
    timed on each recorded input (events, split by the variant the launch
    picks) and the plain version on each group, and K2's kernel time per
    variant in the profiler's trace, each input run `profile_reps` times
    in one session. `pad_lanes`: how many of the lanes are _pad_batch's
    padding."""
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
    inputs = [(w, n) for w, n, _ in rec.records]
    cuda = inputs[0][0].is_cuda
    k2_ms = 0.0
    by_variant = defaultdict(float)
    n_by_variant = defaultdict(int)
    for w, n in inputs:
        ms, v = timed_variant(keccak_cuda.keccak256_blocks, (w, n),
                              "blocks_launches_coop")
        k2_ms += ms
        by_variant[v] += ms
        n_by_variant[v] += 1
    kernel = {}
    if cuda:
        kernel = kernel_ms_by_variant("K2", keccak_cuda.keccak256_blocks,
                                      inputs, n_by_variant,
                                      reps=profile_reps)
        log(f"{label}: K2 by variant, events / kernel in the profiler's "
            f"trace (each input {profile_reps} times in one session): "
            + "; ".join(f"{VARIANT_NAME[v]} {by_variant[v]:.4f} ms / "
                        f"{fmt_ms(kernel[v])}" for v in KERNEL_NAMES["K2"]))
    bound, by = k2_bound_ms(inputs)
    real_bound, real_by = k2_bound_ms(inputs, pad_lanes)
    log(f"{label}: every K2 lane digest equal to the plain version "
        f"({lanes} lanes in {len(rec.records)} launches, L in "
        f"{sorted(groups)}); K2 {k2_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
        f"{real_bound:.4f} ms ({real_by}) over the {lanes - pad_lanes} real "
        f"lanes alone), plain {plain_ms:.3f} ms (one call per L)")
    if cuda:
        log(f"{label}: replayed round trips (upload, K2, readback; CUDA "
            f"events) {replay_round_trips(inputs)}")
    return err, k2_ms, plain_ms, inputs, kernel


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
    root, launches, coop, rec = commit_batched(dev, mode, account_trie,
                                               changed, "batched genesis")
    check(root == oracle_root, f"batched genesis root {root.hex()} != CPU "
          f"oracle {oracle_root.hex()}")
    check(dev.type != "cuda" or coop > 0,
          "batched genesis: the cooperative K2 kernel never ran")
    log(f"batched genesis root {root.hex()} == independent CPU Hasher root")
    return mode, account_trie, changed, launches, coop, rec


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
    keccak_cuda.reset_counts()
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


class _K1Recorder:
    """seg_impl that launches K1 (keccak_cuda.segment_keccak, which counts
    the launch) and keeps each input, its output and the variant that ran
    (None on the CPU)."""

    def __init__(self):
        self.records = []

    def __call__(self, words):
        coop = keccak_cuda.launches_coop
        out = keccak_cuda.segment_keccak(words)
        ran = None
        if words.is_cuda:
            ran = (keccak_cuda.COOP if keccak_cuda.launches_coop > coop
                   else keccak_cuda.THREAD)
        self.records.append((words.clone(), out, ran))
        return out


def check_variants(rec: _K1Recorder, label) -> dict:
    """Each recorded K1 launch ran the variant its lane count calls for
    (cooperative up to kCoopMaxLanes), so every variant some shape calls
    for ran. Returns {variant: launches}."""
    check(len(rec.records) > 0, f"{label}: no K1 launch recorded")
    limit = keccak_cuda.K1.coop_max_lanes
    ran = defaultdict(int)
    for words, _out, v in rec.records:
        want = (keccak_cuda.COOP if words.shape[0] <= limit
                else keccak_cuda.THREAD)
        check(v == want, f"{label}: P={words.shape[0]} ran variant {v}, "
              f"the shape calls for {want}")
        ran[v] += 1
    return dict(ran)


class ResidentState:
    """The resident path's state: three native account tries from the
    genesis leaves, and two sets of the contracts' storage tries, so that
    each of A's and B's block commits runs its own storage program.

    A  resident, lean rows on; commits pipelined (depth 2) after block 1;
       storage tries `storage_a`, which C reads too
    B  template mode; its executor records every K1 input; `storage_b`
    C  the native host commit (commit_cpu), the twin."""

    def __init__(self, dev, world: World, oracle: Oracle):
        self.dev, self.world = dev, world
        self.storage_a = self._storage_tries(dev, world, oracle, "A")
        self.storage_b = self._storage_tries(dev, world, oracle, "B")
        t0 = time.perf_counter()
        items = [(oracle.keys[i], world.account(i, oracle.root_of(i)).encode())
                 for i in range(len(world.addrs))]
        self.a, self.b, self.c = (IncrementalTrie(items) for _ in range(3))
        del items
        self.a.set_lean(True)
        self.rec = _K1Recorder()
        self.ex_a = ResidentExecutor(device=dev)
        self.ex_b = ResidentExecutor(seg_impl=self.rec, device=dev)
        log(f"resident: three native tries of {self.a.num_nodes} nodes "
            f"built in {time.perf_counter() - t0:.1f} s")

    @staticmethod
    def _storage_tries(dev, world: World, oracle: Oracle, name: str):
        """The contracts' storage tries, hashed in one program
        (batch_storage_roots), every root checked against the oracle's."""
        mode = PlannedMode(device=dev)
        storage, changed = {}, {}
        t0 = time.perf_counter()
        for c, slots in world.storage.items():
            st = StateTrie(batch_keccak=mode)
            for k, v in slots.items():
                st.update(k, slot_value(v))
            storage[c] = st
            changed[world.addrs[c]] = (world.account(c, EMPTY_ROOT), st)
        n = batch_storage_roots(changed, device=dev)
        check(n == len(world.storage), f"resident storage {name}: {n} tries "
              f"hashed")
        for c in world.storage:
            check(changed[world.addrs[c]][0].root == oracle.roots[c],
                  f"resident storage {name}: root of contract {c} != oracle")
        log(f"resident storage {name}: {n} tries hashed in one program "
            f"(batch_storage_roots), roots equal the oracle's, "
            f"{time.perf_counter() - t0:.1f} s")
        return storage

    def changes(self, accounts, writes, storage):
        """The block's changed map over `storage` (storage_a or storage_b):
        fresh Account objects from the world, each written contract's
        storage trie updated."""
        changed = {}
        for i in accounts:
            st = None
            if i in writes:
                st = storage[i]
                for k, v in writes[i].items():
                    st.update(k, slot_value(v))
            changed[self.world.addrs[i]] = (
                self.world.account(i, EMPTY_ROOT), st)
        return changed


def warm_up_resident(dev) -> None:
    """One small resident commit on a throwaway trie and executor, so the
    genesis window does not carry the first launch of each torch kernel
    the executor uses (their modules load lazily)."""
    rng = np.random.default_rng(0)
    items = [(rng.bytes(32), rng.bytes(int(n)))
             for n in rng.integers(1, 120, 2000)]
    t = IncrementalTrie(items)
    t.set_lean(True)
    ex = ResidentExecutor(device=dev)
    check(ex.root_bytes(t.commit_resident(ex))
          == plan_from_items(items).execute_cpu(), "resident warm-up root")
    t.update([(k, b"w") for k, _ in items[:100]])
    check(ex.root_bytes(t.commit_resident(ex))
          == plan_from_items([(k, b"w") for k, _ in items[:100]]
                             + items[100:]).execute_cpu(),
          "resident warm-up block root")


def window_ms(dev, events, t_read=None):
    """(upload ms, device ms) of a resident run from its events: from the
    first upload to the store scatter, or to `t_read` (an event recorded
    after the root's readback) when given; None on the CPU."""
    if dev.type != "cuda" or events is None:
        return None
    t0, t_up, t_done = events
    end = t_read if t_read is not None else t_done
    end.synchronize()
    return t0.elapsed_time(t_up), t0.elapsed_time(end)


def read_event(dev):
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def fmt_window(w) -> str:
    return ("not measured (cpu)" if w is None
            else f"{w[1]:.3f} ms (upload {w[0]:.3f} ms)")


def phase_resident_genesis(dev, world: World, oracle: Oracle,
                           oracle_root: bytes, planned_plan_ms: float):
    """Genesis through the resident path: A resident and B template on the
    card, C on the host, every root equal to the oracle's."""
    rs = ResidentState(dev, world, oracle)
    warm_up_resident(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    keccak_cuda.reset_counts()
    t0 = time.perf_counter()
    root_a = rs.ex_a.root_bytes(rs.a.commit_resident(rs.ex_a))
    wall_a = (time.perf_counter() - t0) * 1e3
    win_a = window_ms(dev, rs.ex_a.last_events, read_event(dev))
    t0 = time.perf_counter()
    root_b = rs.b.commit_template(rs.ex_b)
    wall_b = (time.perf_counter() - t0) * 1e3
    launches, coop = keccak_cuda.launches, keccak_cuda.launches_coop
    t0 = time.perf_counter()
    root_c = rs.c.commit_cpu(threads=8)
    wall_c = (time.perf_counter() - t0) * 1e3
    check(root_a == oracle_root, f"resident genesis root {root_a.hex()} != "
          f"oracle {oracle_root.hex()}")
    check(root_b == oracle_root, "template genesis root != oracle")
    check(root_c == oracle_root, "native host genesis root != oracle")
    check(dev.type != "cuda" or launches == 2 * len(rs.rec.records),
          f"resident genesis: {launches} K1 launches for "
          f"{len(rs.rec.records)} segments in each of A and B")
    ex = rs.ex_a
    log(f"resident genesis root {root_a.hex()} == oracle (A resident, B "
        f"template, C native host)")
    log(f"resident genesis A: native plan {rs.a.last_plan_ms:.1f} ms, export "
        f"{rs.a.last_export_ms:.1f} ms (PlannedGraphBuilder.build at the same "
        f"genesis, this run: {planned_plan_ms:.1f} ms); device window (first "
        f"upload to root readback, CUDA events) {fmt_window(win_a)}; h2d "
        f"{ex.h2d_bytes} B in {ex.last_transfers} transfers, lean rows "
        f"{ex.last_lean_rows}; commit wall {wall_a:.1f} ms; store + arenas "
        f"on the device {ex.device_bytes()} B (store {ex.store.numel() * 4}, "
        f"arenas " + ", ".join(f"class {c}: {a.numel() * 4}"
                               for c, a in ex.arenas.items()) + ")")
    log(f"resident genesis B (template): plan {rs.b.last_plan_ms:.1f} ms, "
        f"export {rs.b.last_export_ms:.1f} ms, absorb "
        f"{rs.b.last_absorb_ms:.1f} ms, h2d {rs.ex_b.h2d_bytes} B, commit "
        f"wall {wall_b:.1f} ms; C (native host, 8 threads): plan "
        f"{rs.c.last_plan_ms:.1f} ms, hash {rs.c.last_host_hash_ms:.1f} ms, "
        f"commit wall {wall_c:.1f} ms")
    peak = ("not measured (cpu)" if dev.type != "cuda" else
            f"{torch.cuda.max_memory_allocated(dev)} B")
    log(f"resident genesis: K1 launches {launches} (cooperative {coop}) over "
        f"A and B, {len(rs.rec.records)} segments each; peak device memory "
        f"allocated during A's and B's commits {peak}")
    return rs, launches, coop


def rejected_items(world: World, oracle: Oracle, rng, n_old=300, n_new=50):
    """A block that will be rejected: random account values on existing
    keys and new keys, kept apart from the world and the oracle."""
    picks = rng.choice(np.arange(len(world.storage), len(world.addrs)),
                       n_old, replace=False)
    items = [(oracle.keys[int(i)],
              Account(nonce=int(rng.integers(1, 1 << 20)),
                      balance=int(rng.integers(1, 1 << 62))).encode())
             for i in picks]
    items += [(rng.bytes(32), Account(nonce=1).encode())
              for _ in range(n_new)]
    return items


def phase_resident_blocks(dev, world: World, oracle: Oracle,
                          rs: ResidentState, block1, want1: bytes,
                          n_blocks: int, rejected_at: int):
    """Block 1 (the block the other paths committed) through
    resident_intermediate_root on A and B, then `n_blocks` further seeded
    blocks with A pipelined at depth 2, B in template mode through
    resident_intermediate_root and C on the host; block `rejected_at` is
    rejected (checkpoint, update, commit, rollback, commit) and its
    rollback root must equal its parent's. Every root equals the Python
    oracle's and C's."""
    keccak_cuda.reset_counts()
    rec_before = len(rs.rec.records)
    accounts, writes = block1
    changed = rs.changes(accounts, writes, rs.storage_a)
    t0 = time.perf_counter()
    root_a = resident_intermediate_root(rs.a, rs.ex_a, changed, device=dev)
    wall = (time.perf_counter() - t0) * 1e3
    win = window_ms(dev, rs.ex_a.last_events, read_event(dev))
    t0 = time.perf_counter()
    root_b = resident_intermediate_root(
        rs.b, rs.ex_b, rs.changes(accounts, writes, rs.storage_b),
        template=True, device=dev)
    wall_b = (time.perf_counter() - t0) * 1e3
    rs.c.update(resident_items(changed, device=dev))
    root_c = rs.c.commit_cpu(threads=8)
    check(root_a == root_b == root_c == want1,
          f"resident block 1: {root_a.hex()} / {root_b.hex()} / "
          f"{root_c.hex()} != oracle {want1.hex()}")
    log(f"resident block 1 root == oracle (A, B, C); A: plan "
        f"{rs.a.last_plan_ms:.2f} ms, export {rs.a.last_export_ms:.2f} ms, "
        f"device window (to root readback) {fmt_window(win)}, h2d "
        f"{rs.ex_a.h2d_bytes} B in {rs.ex_a.last_transfers} transfers, "
        f"lean rows {rs.ex_a.last_lean_rows}, commit wall (storage program "
        f"included) {wall:.1f} ms; B (template, its own storage program) "
        f"commit wall {wall_b:.1f} ms")

    rs.ex_a.pipeline_depth = 2
    rng = np.random.default_rng(world.rng.integers(1 << 31))
    pending = []  # (resolve, events, expected root or None, label)
    windows, h2d, plan_ms, export_ms, b_ms, c_ms = [], [], [], [], [], []
    items_ms = []  # A's resident_items: storage program and account RLP
    enqueue_ms = []  # dispatch's host time past the plan and the export
    parent = want1
    t_blocks = time.perf_counter()

    def drain(keep):
        while len(pending) > keep:
            resolve, events, want, label = pending.pop(0)
            got = resolve()
            if want is not None:
                check(got == want, f"{label}: pipelined resident root "
                      f"{got.hex()} != {want.hex()}")
            w = window_ms(dev, events)
            if w is not None:
                windows.append(w)

    def dispatch(want, label):
        t0 = time.perf_counter()
        resolve = rs.a.commit_resident_dispatch(rs.ex_a)
        wall = (time.perf_counter() - t0) * 1e3
        pending.append((resolve, rs.ex_a.last_events, want, label))
        h2d.append(rs.ex_a.h2d_bytes)
        plan_ms.append(rs.a.last_plan_ms)
        export_ms.append(rs.a.last_export_ms)
        enqueue_ms.append(wall - rs.a.last_plan_ms - rs.a.last_export_ms)
        drain(2)

    for blk in range(2, n_blocks + 2):
        label = f"resident block {blk}"
        if blk == rejected_at:
            items = rejected_items(world, oracle, rng)
            for t in (rs.a, rs.b, rs.c):
                t.checkpoint()
                t.update(items)
            dispatch(None, label + " (rejected)")
            bad_b = rs.b.commit_template(rs.ex_b)
            bad_c = rs.c.commit_cpu(threads=8)
            check(bad_b == bad_c != parent, f"{label}: rejected roots "
                  f"{bad_b.hex()} / {bad_c.hex()}")
            for t in (rs.a, rs.b, rs.c):
                t.rollback()
            dispatch(parent, label + " rolled back")
            drain(0)
            check(rs.b.commit_template(rs.ex_b) == parent,
                  f"{label}: template rollback root != parent")
            check(rs.c.commit_cpu(threads=8) == parent,
                  f"{label}: host rollback root != parent")
            log(f"{label}: rejected root {bad_c.hex()} (A, B, C equal); "
                f"after rollback every root == the parent's {parent.hex()}")
            continue
        accounts, writes = make_block(world)
        oracle.apply(accounts, writes)
        want = oracle.root()
        changed = rs.changes(accounts, writes, rs.storage_a)
        t0 = time.perf_counter()
        items = resident_items(changed, device=dev)
        items_ms.append((time.perf_counter() - t0) * 1e3)
        rs.a.update(items)
        dispatch(want, label)
        changed_b = rs.changes(accounts, writes, rs.storage_b)
        t0 = time.perf_counter()
        root_b = resident_intermediate_root(rs.b, rs.ex_b, changed_b,
                                            template=True, device=dev)
        b_ms.append((time.perf_counter() - t0) * 1e3)
        rs.c.update(resident_items(changed, device=dev))
        t0 = time.perf_counter()
        root_c = rs.c.commit_cpu(threads=8)
        c_ms.append((time.perf_counter() - t0) * 1e3)
        check(root_b == root_c == want, f"{label}: template {root_b.hex()} "
              f"/ host {root_c.hex()} != oracle {want.hex()}")
        parent = want
    drain(0)
    launches, coop = keccak_cuda.launches, keccak_cuda.launches_coop
    check(dev.type != "cuda" or launches > 0, "resident blocks: no K1 launch")
    log(f"resident blocks 2-{n_blocks + 1}: every root == the Python oracle "
        f"and C (A pipelined at depth 2, B template, block {rejected_at} "
        f"rejected); {time.perf_counter() - t_blocks:.1f} s")

    def stats(xs, unit="ms"):
        if not xs:
            return "not measured"
        return (f"mean {sum(xs) / len(xs):.3f} {unit}, min {min(xs):.3f}, "
                f"max {max(xs):.3f}")
    log(f"resident blocks, A per commit: storage program and account RLP "
        f"(resident_items) {stats(items_ms)}; native plan {stats(plan_ms)}; "
        f"export {stats(export_ms)}; h2d {stats(h2d, 'B')}; device window "
        f"(first upload to store scatter, CUDA events) "
        f"{stats([w[1] for w in windows])}, of which upload "
        f"{stats([w[0] for w in windows])}; host time to stage and enqueue "
        f"the commit (dispatch less plan and export) {stats(enqueue_ms)}")
    log(f"resident blocks: B (template, its own storage program included) "
        f"commit wall {stats(b_ms)}; C (native host) commit {stats(c_ms)}")
    log(f"resident blocks: K1 launches {launches} (cooperative {coop}) over A "
        f"and B; store + arenas on the device {rs.ex_a.device_bytes()} B")
    return launches, coop, rec_before


def variants_json(launches: int, coop: int, *kernel_ms: dict) -> dict:
    """Per variant: main-path launches and kernel ms in the profiler's
    trace summed over the commits (None where a trace held no device time
    or another number of records than launches, or on the CPU)."""
    out = {}
    for v, n in ((keccak_cuda.THREAD, launches - coop),
                 (keccak_cuda.COOP, coop)):
        parts = [k.get(v) for k in kernel_ms]
        ms = (None if not all(kernel_ms) or None in parts
              else sum(parts))
        out[VARIANT_NAME[v]] = {"launches": n, "kernel_ms": ms}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--accounts", type=int, default=1_000_000)
    ap.add_argument("--contracts", type=int, default=1_000)
    ap.add_argument("--slots", type=int, default=100)
    ap.add_argument("--seed", type=int, default=20)
    ap.add_argument("--blocks", type=int, default=16,
                    help="resident blocks after the first, one rejected")
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
    if dev.type == "cuda":
        phase_sweep(dev)

    t0 = time.perf_counter()
    world = World(args.accounts, args.contracts, args.slots, args.seed)
    oracle = Oracle(world)
    oracle_root = oracle.root()
    log(f"genesis: CPU oracle (independent tries) "
        f"{time.perf_counter() - t0:.1f} s; peak RSS {rss_gib():.1f} GiB")

    # planned path (K1)
    p_trie, p_changed, g_builder, g_launches, g_coop = phase_genesis(
        dev, world, oracle_root)
    g_err, g_ms, g_plain, g_shapes, g_kernel = check_and_time(
        dev, g_builder, "genesis")
    g_plan_ms = g_builder.plan_ms
    del g_builder
    # batched path (K2)
    mode, b_trie, b_changed, bg_launches, bg_coop, bg_rec = \
        phase_genesis_batched(dev, world, oracle_root)
    bg_pad = mode.batched.padded_lanes - mode.batched.lanes
    bg_err, bg_ms, bg_plain, bg_inputs, bg_kernel = check_and_time_k2(
        bg_rec, "batched genesis", bg_pad, profile_reps=1)
    del bg_rec
    # resident path (K1): native tries, the account trie on the device
    rs, rg_launches, rg_coop = phase_resident_genesis(
        dev, world, oracle, oracle_root, g_plan_ms)
    log(f"after the three genesis commits: peak RSS {rss_gib():.1f} GiB")

    # one block, made once, applied to the oracle and to both states
    accounts, writes = make_block(world)
    log(f"block: {len(accounts)} account updates, {len(writes)} contracts, "
        f"{sum(len(w) for w in writes.values())} slot writes")
    t0 = time.perf_counter()
    oracle.apply(accounts, writes)
    want = oracle.root()
    log(f"block: CPU oracle {time.perf_counter() - t0:.1f} s")
    root, b_builder, b_launches, b_coop = commit(
        dev, p_trie, block_changes(world, p_changed, accounts, writes),
        "block")
    check(root == want, f"block root {root.hex()} != CPU oracle {want.hex()}")
    check(dev.type != "cuda" or b_coop > 0,
          "block: the cooperative K1 kernel never ran")
    log(f"block root {root.hex()} == independent CPU Hasher root")
    b_err, b_ms, b_plain, b_shapes, b_kernel = check_and_time(
        dev, b_builder, "block")
    del b_builder, p_trie, p_changed
    root, bb_launches, bb_coop, bb_rec = commit_batched(
        dev, mode, b_trie, block_changes(world, b_changed, accounts, writes),
        "batched block")
    check(root == want, f"batched block root {root.hex()} != CPU oracle "
          f"{want.hex()}")
    log(f"batched block root {root.hex()} == independent CPU Hasher root")
    bb_pad = mode.batched.padded_lanes - mode.batched.lanes
    bb_err, bb_ms, bb_plain, bb_inputs, bb_kernel = check_and_time_k2(
        bb_rec, "batched block", bb_pad, profile_reps=10)
    del bb_rec

    rb_launches, rb_coop, n_genesis = phase_resident_blocks(
        dev, world, oracle, rs, (accounts, writes), want, args.blocks,
        rejected_at=2 + args.blocks // 2)
    if dev.type == "cuda":
        ran = check_variants(rs.rec, "resident")
        log(f"resident: every K1 launch ran the variant its shape calls for "
            f"({', '.join(f'{VARIANT_NAME[v]} {n}' for v, n in ran.items())})")
    records, rs.rec.records = rs.rec.records, []
    rg_err, rg_ms, rg_plain, rg_shapes, rg_kernel = time_k1(
        dev, [r[0] for r in records[:n_genesis]], "resident genesis",
        outputs=[r[1] for r in records[:n_genesis]])
    rb_err, rb_ms, rb_plain, rb_shapes, rb_kernel = time_k1(
        dev, [r[0] for r in records[n_genesis:]], "resident blocks",
        per_segment=False, outputs=[r[1] for r in records[n_genesis:]])
    del records, rs

    phase_fallback(dev, args.seed)

    k1_shapes = g_shapes + b_shapes + rg_shapes + rb_shapes
    k1_bound, k1_by = k1_bound_ms(k1_shapes)
    rk_bound, rk_by = k1_bound_ms(rg_shapes + rb_shapes)
    log(f"K1 bound over the resident inputs {rk_bound:.4f} ms ({rk_by}; "
        f"genesis {k1_bound_ms(rg_shapes)[0]:.4f} ms, blocks "
        f"{k1_bound_ms(rb_shapes)[0]:.4f} ms); K1 events {rg_ms:.4f} / "
        f"{rb_ms:.4f} ms")
    k1_launches = g_launches + b_launches + rg_launches + rb_launches
    k1_coop = g_coop + b_coop + rg_coop + rb_coop
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
        "launches": k1_launches,
        "max_abs_err": max(grid_err, g_err, b_err, rg_err, rb_err),
        "ms": g_ms + b_ms + rg_ms + rb_ms,
        "plain_ms": g_plain + b_plain + rg_plain + rb_plain,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
        "variants": variants_json(k1_launches, k1_coop, g_kernel, b_kernel,
                                  rg_kernel, rb_kernel),
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
        "variants": variants_json(bg_launches + bb_launches,
                                  bg_coop + bb_coop, bg_kernel, bb_kernel),
    }]}), flush=True)
    if dev.type != "cuda":
        return 0  # a rehearsal prints no result line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
