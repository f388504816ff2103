"""The blocks loop: an archive C-Chain node (pruning off: every block's
state committed to its store) building, verifying and accepting full
blocks of signed transactions, one at a time.

Set-up: the genesis world and every block the run can use, made and
signed before the port is imported (lib/vm_traffic.py, lib/signer.py):
`warmup_blocks`, then enough for `seconds` at `window_blocks_per_s_max`
(a fixed ceiling, from the traffic file), plus `prepare_margin_blocks`;
the collector then freezes those prepared objects, so that it keeps
scanning the port's own objects as a node's collector does. Then the
store, a fresh directory under the run's temporary directory
(tempfile.gettempdir(), which honours TMPDIR) holding the port's
SQLiteDB; the VM booted on it from the configuration's VM JSON
(VM.initialize: the genesis committed, the chain, the tx pool, the
miner); its block clock set `block_gap_s` of chain time after the
parent, so that tip-0 transactions owe no block gas cost; then the
warm-up blocks.

A block: each transaction decoded from its signed bytes and given to
VM.issue_tx; VM.build_block; VMBlock.verify; VM.set_preference;
VMBlock.accept; the chain's acceptor drained (the block's state
persisted) before the next block starts.

Window: the window closes with the first block that ends after
`seconds`, or, for a program faster than the ceiling, when the prepared
blocks are spent (said in the log; the rate is then over the shorter
window).

After it: the VM shut down and its store closed; then, by the
reference (portbench/reference/chain.py) over the same transactions:
every root of the run (the genesis and set-up's blocks too), every
receipt's status and gas, every issued transaction included, and every
accepted block's touched accounts and written slots read back from the
store file (portbench/reference/store.py). The store's directory is
deleted when the run ends, also on an error.

The control (--control 1) puts the reference in the program's place,
with each block's last transaction lost, over `control_blocks` blocks.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import torch

from portbench.lib import vm_traffic
from portbench.lib.kernels import K1Shapes
from portbench.reference.chain import ChainReference
from portbench.reference.store import read_back

STORE_PREFIX = "portbench-archive-"


def _lead_in(device):
    """Kernels for the trace to drop: tiny K1 launches (none without a
    device: the CPU's plain version makes no device records)."""
    from coreth_tpu_torch.ops import keccak_cuda

    if device.type != "cuda":
        return
    w = torch.zeros((1, 1, 34), dtype=torch.int32, device=device)
    for _ in range(512):
        keccak_cuda.segment_keccak(w)


def _host_state() -> str:
    """What a run before this one could have left behind: stores of this
    loop under the temporary directory, the kernel's dirty and writeback
    pages, and child processes of this process."""
    tmp = tempfile.gettempdir()
    try:
        left = [e for e in os.listdir(tmp) if e.startswith(STORE_PREFIX)]
    except OSError:
        left = []
    mem = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                k, v = line.split(":", 1)
                if k in ("Dirty", "Writeback", "MemAvailable"):
                    mem[k] = v.strip()
    except OSError:
        pass
    kids = 0
    try:
        me = str(os.getpid())
        for pid in os.listdir("/proc"):
            if pid.isdigit():
                with contextlib.suppress(OSError):
                    with open(f"/proc/{pid}/stat") as f:
                        if f.read().rsplit(")", 1)[1].split()[1] == me:
                            kids += 1
    except OSError:
        pass
    return (f"{len(left)} stores under {tmp}; " + ", ".join(
        f"{k} {v}" for k, v in mem.items()) + f"; {kids} child processes")


def _reference(run, world, strict=True) -> ChainReference:
    cfg = run.config
    return ChainReference(world.addrs, world.nonce, world.balance,
                          world.code, world.storage, world.coinbase,
                          int(cfg["gas_limit"]),
                          int(run.traffic["block_gap_s"]), device=run.device,
                          strict=strict)


def run(run) -> None:
    cfg, tr = run.config, run.traffic
    run.log("blocks: before set-up: " + _host_state())
    t0 = time.perf_counter()
    world = vm_traffic.World(cfg, tr, run.seed)
    gen = vm_traffic.Blocks(world, tr, run.seed)
    warm = int(tr["warmup_blocks"])
    if run.control:
        n_total = int(tr["control_blocks"])
    else:
        n_total = warm + int(math.ceil(float(tr["window_blocks_per_s_max"])
                                       * run.seconds)) \
            + int(tr["prepare_margin_blocks"])
    blocks = [gen.next_block() for _ in range(n_total)]
    t1 = time.perf_counter()
    gen.sign(blocks)
    run.log(f"blocks: a world of {len(world.addrs)} accounts and "
            f"{n_total} blocks of {len(blocks[0])} transactions made in "
            f"{t1 - t0:.3f} s, signed in {time.perf_counter() - t1:.3f} s "
            f"({n_total - warm} for the window)")
    del gen
    if run.control:
        return _control(run, world, blocks)
    # the prepared inputs leave the collector's view; the port, imported
    # after this, keeps all of its objects in it
    gc.collect()
    gc.freeze()
    store = tempfile.mkdtemp(prefix=STORE_PREFIX)
    try:
        got = _run_port(run, world, blocks, store)
        gc.collect()
        if run.cuda():
            torch.cuda.empty_cache()
        _compare(run, world, blocks, got, store)
    finally:
        shutil.rmtree(store, ignore_errors=True)
        run.log("blocks: after the run: " + _host_state())


def _genesis(world, cfg):
    from coreth_tpu_torch import params
    from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount

    conf = params.TEST_CHAIN_CONFIG
    if conf.chain_id != int(cfg["chain_id"]):
        raise ValueError(f"the port's local chain config has chain id "
                         f"{conf.chain_id}, the configuration "
                         f"{cfg['chain_id']}")
    return Genesis(config=conf, alloc={
        a: GenesisAccount(balance=world.balance[i], nonce=world.nonce[i],
                          code=world.code.get(i, b""),
                          storage=world.storage.get(i, {}))
        for i, a in enumerate(world.addrs)})


def _run_port(run, world, blocks, store) -> dict:
    """The port's part: boot, warm-up, window; returns what the
    comparison reads, the VM shut down and its store closed."""
    from coreth_tpu_torch.core.types import Transaction
    from coreth_tpu_torch.ethdb.sqlitedb import SQLiteDB
    from coreth_tpu_torch.ops import keccak_cuda
    from coreth_tpu_torch.vm.shared_memory import Memory
    from coreth_tpu_torch.vm.vm import VM, SnowContext

    cfg, tr, dev = run.config, run.traffic, run.device
    db = SQLiteDB(os.path.join(store, "chain.db"),
                  sync=bool(cfg["store"]["sync"]))
    vm = VM()
    try:
        genesis = _genesis(world, cfg)
        t0 = time.perf_counter()
        vm.initialize(SnowContext(shared_memory=Memory()), db, genesis,
                      config_bytes=json.dumps(cfg["vm_config"]).encode(),
                      device=dev)
        run.log(f"blocks: VM.initialize {time.perf_counter() - t0:.3f} s "
                f"({len(world.addrs)} accounts, store {store})")
        del genesis
        return _drive(run, vm, blocks, Transaction, keccak_cuda)
    finally:
        if vm.initialized:
            vm.shutdown()
        db.close()


def _drive(run, vm, blocks, Transaction, keccak_cuda) -> dict:
    tr, dev = run.traffic, run.device
    gap = int(tr["block_gap_s"])
    chain = vm.blockchain
    vm.miner.clock = lambda: chain.current_block.time + gap
    # K1's shapes, recorded while profiling, from the planned commit the
    # VM's state hashes through (PlannedMode.commit)
    commit = getattr(vm.state_database.triedb.batch_keccak, "commit", None)
    shapes = None
    if run.trace and commit is not None and hasattr(commit, "_impl"):
        shapes = K1Shapes(commit._impl)
        commit._impl = shapes
    run.objects.update(vm=vm, chain=chain)
    accepted = []
    split = {k: [] for k in ("issue", "build", "verify", "accept")}

    def step(i, note):
        l0 = keccak_cuda.launches
        t = [time.perf_counter()]
        with note("blocks.issue"):
            for tx in blocks[i]:
                vm.issue_tx(Transaction.decode(tx.raw))
        t.append(time.perf_counter())
        with note("blocks.build"):
            vmb = vm.build_block()
        t.append(time.perf_counter())
        with note("blocks.verify"):
            vmb.verify()
        t.append(time.perf_counter())
        with note("blocks.accept"):
            vm.set_preference(vmb.id())
            vmb.accept()
        with note("blocks.persist"):
            chain.drain_acceptor_queue()
        t.append(time.perf_counter())
        for name, a, b in zip(split, t, t[1:]):
            split[name].append((b - a) * 1e3)
        accepted.append(vmb.id())
        run.notes["last_block"] = vmb.id()
        return (t[-1] - t[0]) * 1e3, keccak_cuda.launches - l0

    plain = lambda name: contextlib.nullcontext()  # noqa: E731
    warm = int(tr["warmup_blocks"])
    t0 = time.perf_counter()
    for i in range(warm):
        step(i, plain)
    run.log(f"blocks: warm-up {warm} blocks in "
            f"{time.perf_counter() - t0:.3f} s")
    if run.trace:
        from torch.profiler import record_function as note
    else:
        note = plain
    skip, prof_n = int(tr["profile_skip_blocks"]), int(tr["profile_blocks"])
    run.notes["profiled_blocks"] = (skip, skip + prof_n)
    block_ms = run.series["block_ms"]
    launches = run.series["k1_launches"]
    n_total = len(blocks)
    i = warm
    seg_t = []
    t_open = run.window_open()
    deadline = t_open + run.seconds
    while time.perf_counter() < deadline:
        if i == n_total:
            run.log(f"blocks: the {n_total - warm} blocks made for the "
                    f"window are spent before {run.seconds} s: the window "
                    f"closes early (window_blocks_per_s_max is too low for "
                    f"this program)")
            break
        k = i - warm
        if run.trace and k == skip:
            run.profile_begin(lambda: _lead_in(dev))
            if shapes is not None:
                shapes.on = True
        ms, n = step(i, note)
        seg_t.append(time.perf_counter())
        block_ms.append(ms)
        launches.append(n)
        run.after_block()
        if run.trace and k == skip + prof_n - 1:
            if shapes is not None:
                shapes.on = False
                run.notes["k1_shapes"] = shapes.shapes
            run.notes["k1_launches_profiled"] = sum(launches[skip:])
            run.profile_end()
        i += 1
    t_close = time.perf_counter()
    run.profile_end()
    run.window_close()
    if shapes is not None:
        commit._impl = shapes.inner
    n_window = i - warm
    run.attempted = n_window
    run.e2e["commit_rate"] = n_window / (t_close - t_open)
    run.log(f"blocks: {n_window} blocks in {t_close - t_open:.3f} s")
    segs = np.histogram(np.array(seg_t) - t_open,
                        bins=np.arange(0, run.seconds + 10, 10))[0]
    run.log(f"blocks: blocks per 10 s: {segs.tolist()}")
    if n_window:
        run.log("blocks: median ms a window block: " + ", ".join(
            f"{name} {statistics.median(v[warm:]):.3f}"
            for name, v in split.items()) + "; block ms p50 %.3f max %.3f"
            % (statistics.median(block_ms), max(block_ms)))
    # what the comparison reads, before the VM stops
    out = {"roots": [chain.genesis_block.root], "blocks": [],
           "issued": [tx.hash for b in blocks[:i] for tx in b]}
    for h in accepted:
        blk = chain.get_block(h)
        receipts = chain.get_receipts(h)
        out["roots"].append(blk.header.root)
        out["blocks"].append((
            blk.number, blk.header.gas_used,
            [(tx.hash(), r.status, r.gas_used, r.cumulative_gas_used)
             for tx, r in zip(blk.transactions, receipts)]))
    last = chain.flight_recorder.find(accepted[-1]) if accepted else None
    if last is not None:
        run.log(f"blocks: the last block's flight record ({last.get('run')}"
                f" run): " + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                                       last["phases"].items()))
    run.objects.clear()
    return out


def _compare(run, world, blocks, got, store):
    """Every number the run is judged by, against the reference."""
    t0 = time.perf_counter()
    ref = _reference(run, world)
    n = len(got["blocks"])
    want_receipts = {}
    for b in blocks[:n]:
        for h, status, gas in ref.apply_block(b):
            want_receipts[h] = (status, gas)
    want = ref.roots()
    run.log(f"reference: {n} blocks over {len(world.addrs)} accounts in "
            f"{time.perf_counter() - t0:.3f} s; base fees "
            f"{[b['base_fee'] for b in ref.blocks[:3]]} ... "
            f"{ref.blocks[-1]['base_fee'] if ref.blocks else None}")
    _check_roots(run, got["roots"], want)
    _check_receipts(run, got["blocks"], want_receipts)
    included = {h for _, _, rs in got["blocks"] for h, *_ in rs}
    lost = sum(1 for h in got["issued"] if h not in included)
    run.log(f"blocks: {len(got['issued'])} transactions issued, {lost} "
            f"not in an accepted block")
    run.check("lost_txs", lost, 0)
    t0 = time.perf_counter()
    reads, bad = read_back(os.path.join(store, "chain.db"),
                           [(want[k], *ref.reads(k)) for k in
                            range(1, n + 1)], run.device)
    run.log(f"read-back: {reads} accounts and slots of {n} blocks read "
            f"from the store in {time.perf_counter() - t0:.3f} s, {bad} "
            f"differ")
    run.check("readback_mismatches", bad, 0)


def _check_roots(run, got, want) -> None:
    bad = [k for k in range(max(len(got), len(want)))
           if k >= len(got) or k >= len(want) or got[k] != want[k]]
    warm = int(run.traffic["warmup_blocks"])
    run.failed = sum(1 for k in bad if k > warm)
    if bad:
        k = bad[0]
        run.log(f"blocks: root {k} (0 = genesis) is "
                f"{got[k].hex() if k < len(got) else None}, the "
                f"reference's {want[k].hex() if k < len(want) else None}")
    run.log(f"blocks: {len(got)} roots compared, {len(bad)} differ")
    run.check("root_mismatches", len(bad), 0)


def _check_receipts(run, blocks, want) -> None:
    """Each receipt's status, gas used and cumulative gas (the block's
    order, the reference's gas) against the reference's."""
    bad = 0
    for _number, _gas, receipts in blocks:
        cum = 0
        for h, status, gas, cumulative in receipts:
            w = want.get(h)
            if w is not None:
                cum += w[1]
            bad += w is None or (status, gas, cumulative) != (*w, cum)
    run.log(f"blocks: {sum(len(r) for _, _, r in blocks)} receipts "
            f"compared, {bad} differ")
    run.check("receipt_mismatches", bad, 0)


def _control(run, world, blocks):
    """The reference in the program's place, with each block's last
    transaction lost (a lost transaction breaks the guarantees that every
    root and receipt is the reference's and that no issued transaction
    is lost), against the reference."""
    run.window_open()
    run.window_close()
    lossy = _reference(run, world, strict=False)
    got_blocks = []
    for b in blocks:
        rs = lossy.apply_block(b, drop_last=True)
        got_blocks.append((0, 0, _cumulative(rs)))
    got = {"roots": lossy.roots(), "blocks": got_blocks,
           "issued": [tx.hash for b in blocks for tx in b]}
    ref = _reference(run, world)
    want_receipts = {}
    for b in blocks:
        for h, status, gas in ref.apply_block(b):
            want_receipts[h] = (status, gas)
    _check_roots(run, got["roots"], ref.roots())
    _check_receipts(run, got["blocks"], want_receipts)
    included = {h for _, _, rs in got_blocks for h, *_ in rs}
    run.check("lost_txs", sum(1 for h in got["issued"]
                              if h not in included), 0)
    run.attempted = len(blocks)
    run.e2e["commit_rate"] = 0.0


def _cumulative(receipts):
    out, cum = [], 0
    for h, status, gas in receipts:
        cum += gas
        out.append((h, status, gas, cum))
    return out
