#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one H100 and check it.

    python3 chip_smoke.py            # full size: 1,000,000 accounts
    python3 chip_smoke.py --accounts 20000 --contracts 50   # a quick run
    python3 chip_smoke.py --device cpu --accounts 2000 --contracts 8
        # rehearsal on the CPU with the plain versions; prints no result

Phases (each passes or the script exits non-zero):
  1. card: nvidia-smi name and power limit, torch and CUDA versions
  2. build: the host Keccak (g++) and kernel K1 (nvcc), in parallel
  3. K1 against its plain torch version over a (P, L) grid, bit for bit,
     plus the known Keccak vectors
  4. genesis commit: 1M accounts (1,000 contracts x 100 storage slots)
     composed as StateDB._planned_intermediate_root does and committed
     through K1 on the card; the root must equal the CPU Hasher's root of
     an independent trie built from the same items, and the same plan run
     through the plain version must give every lane's digest
  5. block commit: 700 transfers plus 50 contracts x 20 slot writes on top
     of the genesis state, checked the same way
Before the last line it prints one JSON object describing each kernel
(launches on the main path, max error, ms, plain ms, bound ms); the last
line is {"ok": true, "device": {...}}. Nothing of jax or coreth_tpu is
imported.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from coreth_tpu_torch import rlp
from coreth_tpu_torch.device import resolve
from coreth_tpu_torch.native import keccak256, keccak256_batch
from coreth_tpu_torch.ops import keccak_cuda
from coreth_tpu_torch.ops.keccak_planned import MAX_SEGMENTS, PlannedCommit, \
    PlannedMode, default_planned_commit
from coreth_tpu_torch.ops.keccak_staged import segment_keccak_plain
from coreth_tpu_torch.ops.keccak_torch import RATE, digest_words_to_bytes, \
    int32_to_words, pack_messages, words_to_int32
from coreth_tpu_torch.state.account import EMPTY_CODE_HASH, Account
from coreth_tpu_torch.state.statedb import planned_intermediate_root
from coreth_tpu_torch.trie import planned as planned_mod
from coreth_tpu_torch.trie.hasher import Hasher
from coreth_tpu_torch.trie.node import EMPTY_ROOT
from coreth_tpu_torch.trie.planned import PlannedGraphBuilder
from coreth_tpu_torch.trie.secure import StateTrie
from coreth_tpu_torch.trie.trie import trie_from_items

# Bound model for K1 (csrc/segment_keccak.cu header): 32-bit integer ALU
# operations per 136-byte block with LOP3 folding, and the H100 SXM's
# integer rate (132 SMs x 64 ops/clock x 1.98 GHz) and memory rate.
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


def time_ms(fn, x, reps: int) -> float:
    """Mean ms per call after one warm call: CUDA events on the card, the
    host clock in a CPU rehearsal."""
    fn(x)
    if not x.is_cuda:
        t = time.perf_counter()
        for _ in range(reps):
            fn(x)
        return (time.perf_counter() - t) * 1e3 / reps
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn(x)
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


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
        jobs.append(("K1 segment_keccak (nvcc)", keccak_cuda.load))
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
        for line in keccak_cuda.build_log().splitlines():
            if "registers" in line or "spill" in line:
                log(f"K1 ptxas: {line.strip()}")


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
            err = int((got.long() - want.long()).abs().max())
            worst = max(worst, err)
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
    """One main-path commit: counts zeroed before, read after."""
    keccak_cuda.launches = 0
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
        err = max(err, int((got.long() - segment_keccak_plain(x).long())
                           .abs().max()))
        k1_ms += time_ms(keccak_cuda.segment_keccak, x, reps=10)
        plain_ms += time_ms(segment_keccak_plain, x, reps=1)
        shapes.append((x.shape[0], x.shape[1]))
    bound, by = k1_bound_ms(shapes)
    log(f"{label}: every lane digest equal to the plain version "
        f"({dig.shape[0]} lanes); K1 {k1_ms:.4f} ms over {len(shapes)} "
        f"segments, bound {bound:.4f} ms ({by}), plain {plain_ms:.3f} ms")
    return err, k1_ms, plain_ms, shapes


def phase_genesis(dev, world: World, oracle_root: bytes):
    mode = PlannedMode(device=dev)
    account_trie = StateTrie(batch_keccak=mode)
    changed = {}
    t0 = time.perf_counter()
    for c, slots in world.storage.items():
        st = StateTrie(batch_keccak=mode)
        for k, v in slots.items():
            st.update(k, slot_value(v))
        changed[world.addrs[c]] = (world.account(c, EMPTY_ROOT), st)
    for i in range(len(world.addrs)):
        if i not in world.storage:
            changed[world.addrs[i]] = (world.account(i, EMPTY_ROOT), None)
    log(f"genesis: {len(world.addrs)} accounts, {len(world.storage)} "
        f"contracts x {len(next(iter(world.storage.values())))} slots built "
        f"in {time.perf_counter() - t0:.1f} s")
    root, builder, launches = commit(dev, account_trie, changed, "genesis")
    check(root == oracle_root, f"genesis root {root.hex()} != CPU oracle "
          f"{oracle_root.hex()}")
    log(f"genesis root {root.hex()} == independent CPU Hasher root")
    return account_trie, changed, root, builder, launches


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


def phase_block(dev, world, oracle, account_trie, changed_genesis):
    accounts, writes = make_block(world)
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
    n_slots = sum(len(w) for w in writes.values())
    log(f"block: {len(accounts)} account updates, {len(writes)} contracts, "
        f"{n_slots} slot writes")
    t0 = time.perf_counter()
    oracle.apply(accounts, writes)
    want = oracle.root()
    log(f"block: CPU oracle {time.perf_counter() - t0:.1f} s")
    root, builder, launches = commit(dev, account_trie, changed, "block")
    check(root == want, f"block root {root.hex()} != CPU oracle {want.hex()}")
    log(f"block root {root.hex()} == independent CPU Hasher root")
    return builder, launches


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

    t0 = time.perf_counter()
    world = World(args.accounts, args.contracts, args.slots, args.seed)
    oracle = Oracle(world)
    oracle_root = oracle.root()
    log(f"genesis: CPU oracle (independent tries) {time.perf_counter() - t0:.1f} s")
    account_trie, changed, _root, g_builder, g_launches = phase_genesis(
        dev, world, oracle_root)
    g_err, g_ms, g_plain, g_shapes = check_and_time(dev, g_builder, "genesis")
    del g_builder
    b_builder, b_launches = phase_block(dev, world, oracle, account_trie, changed)
    b_err, b_ms, b_plain, b_shapes = check_and_time(dev, b_builder, "block")
    bound_ms, bound_by = k1_bound_ms(g_shapes + b_shapes)

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
        "bound_ms": bound_ms,
        "bound_by": bound_by,
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
