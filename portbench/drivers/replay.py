"""The replay loop: a validator catching up with the chain, committing
full blocks' account-trie change sets back to back on the resident
mirror, one block at a time.

Set-up: the accounts from the seed; every block the run can use, made
before the port is built: `warmup_blocks`, then enough for `seconds` at
`window_blocks_per_s_max` (a fixed ceiling, from the traffic file), plus
`prepare_margin_blocks`; the collector then freezes those prepared
objects, so that it keeps scanning the port's own objects as a node's
collector does. Then the mirror over the accounts
(trie/resident_mirror.py: its executor on the device, K1), configured as
the configuration's VM JSON configures a chain's mirror, and the
warm-up blocks through the loop (every shape and the mirror's tip buffer
filled).

Window: each block is ResidentAccountMirror.verify(parent, hash,
batch), then the ResidentTrieWriter's insert_trie and accept_trie, as
the chain drives them; the next block starts when the last is accepted.
The window closes with the first block that ends after `seconds`, or,
for a program faster than the ceiling, when the prepared blocks are
spent (said in the log; the rate is then over the shorter window).

After it: every block's root (set-up's too) against the reference
(portbench/reference/mpt.py over the same change sets), on the device
once the mirror is freed.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import time

import numpy as np
import torch

from portbench.lib.kernels import K1Shapes
from portbench.lib.replay_traffic import ReplayTraffic
from portbench.lib import accounts


class _Block:
    """What a trie writer reads of a block."""

    def __init__(self, number: int, root: bytes, h: bytes):
        self.number, self.root, self._h = number, root, h

    def hash(self) -> bytes:
        return self._h


def _mirror(items, config: dict, device):
    """The mirror as BlockChain._boot_mirror builds it from the VM's
    configuration (vm/config.py defaults for every key the JSON leaves
    out)."""
    from coreth_tpu_torch.core.blockchain import CacheConfig
    from coreth_tpu_torch.core.state_manager import ResidentTrieWriter
    from coreth_tpu_torch.ethdb import MemoryDB
    from coreth_tpu_torch.trie.resident_mirror import ResidentAccountMirror
    from coreth_tpu_torch.trie.triedb import TrieDatabase
    from coreth_tpu_torch.vm.config import parse_config

    vmc = parse_config(json.dumps(config["vm_config"]).encode())
    prefer = vmc.resident_prefer_host
    mirror = ResidentAccountMirror(
        items,
        device_timeout=vmc.resident_commit_timeout or None,
        cpu_threads=vmc.cpu_threads,
        prefer_host=None if prefer == "auto" else bool(prefer),
        pipeline_depth=vmc.resident_pipeline_depth,
        template_residency=vmc.resident_template_residency,
        mesh_devices=vmc.resident_mesh_devices,
        lean_rows=CacheConfig().resident_lean_rows,
        device=device)
    writer = ResidentTrieWriter(
        TrieDatabase(MemoryDB()), mirror,
        commit_interval=vmc.commit_interval,
        memory_cap=vmc.trie_dirty_cache * 1024 * 1024)
    return mirror, writer


def _lead_in(device):
    """Kernels for the trace to drop: tiny K1 launches (none without a
    device: the CPU's plain version makes no device records)."""
    from coreth_tpu_torch.ops import keccak_cuda

    if device.type != "cuda":
        return
    w = torch.zeros((1, 1, 34), dtype=torch.int32, device=device)
    for _ in range(512):
        keccak_cuda.segment_keccak(w)


def run(run) -> None:
    cfg, tr, dev = run.config, run.traffic, run.device
    traffic = ReplayTraffic(cfg, tr, run.seed)
    keys, vals, vlens = traffic.genesis()
    blocks = []  # (indices, rows, lengths, hash[, the mirror's batch])
    if run.control:
        return _control(run, traffic, keys, vals, vlens, blocks)
    items = list(zip(accounts.key_list(keys),
                     accounts.byte_list(vals, vlens)))
    warm = int(tr["warmup_blocks"])
    n_total = warm + int(math.ceil(float(tr["window_blocks_per_s_max"])
                                   * run.seconds)) \
        + int(tr["prepare_margin_blocks"])
    t0 = time.perf_counter()
    while len(blocks) < n_total:
        idx, rows, lens, h = traffic.next_block()
        blocks.append((idx, rows, lens, h, list(zip(
            accounts.key_list(keys[idx]), accounts.byte_list(rows, lens)))))
    # the prepared inputs leave the collector's view; the port, imported
    # after this, keeps all of its objects in it
    gc.collect()
    gc.freeze()
    run.log(f"replay: {n_total} blocks made in "
            f"{time.perf_counter() - t0:.3f} s ({n_total - warm} for the "
            f"window)")
    from coreth_tpu_torch.ops import keccak_cuda

    t0 = time.perf_counter()
    mirror, writer = _mirror(items, cfg, dev)
    run.log(f"replay: mirror over {len(items)} accounts in "
            f"{time.perf_counter() - t0:.3f} s")
    del items
    run.objects.update(mirror=mirror, executor=mirror.ex)
    shapes = None
    if run.trace and mirror.ex is not None:
        shapes = K1Shapes(mirror.ex.seg_impl)
        mirror.ex.seg_impl = shapes
    genesis_root = mirror.root_of(mirror.GENESIS)
    roots = []
    parent = [mirror.GENESIS]
    accept_ms = []

    def step(i, note):
        idx, rows, lens, h, batch = blocks[i]
        l0 = keccak_cuda.launches
        with note("replay.verify"):
            ta = time.perf_counter()
            root = mirror.verify(parent[0], h, batch)
            tb = time.perf_counter()
        with note("replay.accept"):
            blk = _Block(i + 1, root, h)
            writer.insert_trie(blk)
            writer.accept_trie(blk)
        accept_ms.append((time.perf_counter() - tb) * 1e3)
        parent[0] = h
        roots.append(root)
        return (tb - ta) * 1e3, keccak_cuda.launches - l0

    plain = lambda name: contextlib.nullcontext()  # noqa: E731
    t0 = time.perf_counter()
    for i in range(warm):
        step(i, plain)
    run.log(f"replay: warm-up {warm} blocks in "
            f"{time.perf_counter() - t0:.3f} s")

    if run.trace:
        from torch.profiler import record_function as note
    else:
        note = plain
    skip, prof_n = int(tr["profile_skip_blocks"]), int(tr["profile_blocks"])
    run.notes["profiled_blocks"] = (skip, skip + prof_n)
    verify_ms = run.series["verify_ms"]
    launches = run.series["k1_launches"]
    i = warm
    seg_t = []
    t_open = run.window_open()
    deadline = t_open + run.seconds
    while time.perf_counter() < deadline:
        if i == n_total:
            run.log(f"replay: the {n_total - warm} blocks made for the "
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
        verify_ms.append(ms)
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
    n_window = i - warm
    run.attempted = n_window
    run.e2e["commit_rate"] = n_window / (t_close - t_open)
    run.log(f"replay: {n_window} blocks in {t_close - t_open:.3f} s")
    # how the host's speed moves inside one window (PERF.md section 2)
    segs = np.histogram(np.array(seg_t) - t_open,
                        bins=np.arange(0, run.seconds + 10, 10))[0]
    run.log(f"replay: blocks per 10 s: {segs.tolist()}")
    acc = accept_ms[warm:]
    run.log("replay: verify ms p50 %.3f p90 %.3f p99 %.3f max %.3f; accept "
            "ms p50 %.3f max %.3f; outside both %.3f s"
            % (*np.percentile(verify_ms, [50, 90, 99]), max(verify_ms),
               float(np.median(acc)), max(acc),
               (t_close - t_open) - (sum(verify_ms) + sum(acc)) / 1e3))

    # free the program's state and the batches, then the reference
    run.objects.clear()
    del mirror, writer, shapes
    blocks[:] = [b[:4] for b in blocks[:i]]
    gc.collect()
    if run.cuda():
        torch.cuda.empty_cache()
    _compare(run, keys, vals, vlens, blocks, [genesis_root] + roots, warm)


def _reference_roots(run, keys, vals, vlens, blocks, drop_last=False):
    """Roots after each block by the reference, [genesis, block 1, ...],
    on the run's device. drop_last leaves out each block's last write
    (the control)."""
    from portbench.reference import mpt

    dev = run.device
    t0 = time.perf_counter()
    st = mpt.Structure(torch.from_numpy(np.ascontiguousarray(keys)).to(dev))
    ups = []
    for idx, rows, lens, *_ in blocks:
        cut = len(idx) - 1 if drop_last else len(idx)
        ups.append((torch.from_numpy(idx[:cut].astype(np.int64)).to(dev),
                    torch.from_numpy(rows[:cut]).to(dev),
                    torch.from_numpy(lens[:cut]).to(dev)))
    out = mpt.roots(st, torch.from_numpy(vals).to(dev),
                    torch.from_numpy(vlens).to(dev), ups)[:, 0].cpu().numpy()
    run.log(f"reference: {len(blocks)} blocks over {keys.shape[0]} keys in "
            f"{time.perf_counter() - t0:.3f} s")
    return [out[k].tobytes() for k in range(out.shape[0])]


def _compare(run, keys, vals, vlens, blocks, got, warm):
    want = _reference_roots(run, keys, vals, vlens, blocks)
    bad = [k for k in range(len(got)) if got[k] != want[k]]
    run.failed = sum(1 for k in bad if k > warm)
    if bad:
        k = bad[0]
        run.log(f"replay: root {k} (0 = genesis) is {got[k].hex()}, the "
                f"reference's {want[k].hex()}")
    run.log(f"replay: {len(got)} roots compared, {len(bad)} differ")
    run.check("root_mismatches", len(bad), 0)


def _control(run, traffic, keys, vals, vlens, blocks):
    """The control in the program's place: the reference with each block's
    last write left out (a dropped write breaks the guarantee that every
    block's root is the reference's), over as many blocks as a run
    commits, against the reference."""
    n = int(run.traffic["control_blocks"])
    for _ in range(n):
        blocks.append(traffic.next_block())
    run.window_open()
    run.window_close()
    got = _reference_roots(run, keys, vals, vlens, blocks, drop_last=True)
    run.attempted = n
    run.e2e["commit_rate"] = 0.0
    _compare(run, keys, vals, vlens, blocks, got, 0)
