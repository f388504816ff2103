#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's commit paths and chain on one H100; check them.

    python3 chip_smoke.py            # full size: 1,000,000 accounts
    python3 chip_smoke.py --accounts 20000 --contracts 50   # a quick run
    python3 chip_smoke.py --device cpu --accounts 2000 --contracts 8
        # rehearsal on the CPU with the plain versions; prints no result

Phases (each passes or the script exits non-zero):
  1. card: nvidia-smi name and power limit, torch and CUDA versions
  2. build: the host Keccak, the native planners and the native secp256k1
     (g++), kernels K1 and K2 (nvcc), in parallel; ptxas registers and
     spills of their four kernels
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
  4c. the world and its CPU oracle, then gc.freeze(): the harness's own
     objects leave the garbage collector's view, so the port's pauses
     measured after it do not traverse them
  5. planned genesis, through the VM: the 1M-account world (1,000
     contracts x 100 storage slots, each with the hand-assembled
     store-and-log code STORE_AND_LOG; 1,500 plain accounts at addresses
     of seeded private keys, each with at least 10^21 wei) as a Genesis
     alloc, and VM().initialize(SnowContext(shared_memory=Memory()),
     MemoryDB(), genesis, config_bytes=<JSON>, device=cuda), the JSON as
     AvalancheGo hands it over ({"insert-pipeline-depth": 2}; the CPU
     rehearsal adds "resident-account-trie": true): the VM's TrieDatabase
     is on get_batch_keccak("auto") (the planned marker), and its
     BlockChain's _setup_genesis is Genesis.commit, every storage trie and
     the account trie in one K1 program; then the default "auto" boots the
     resident mirror (one leaf scan, the mirror's genesis commit on K1),
     generates the snapshot tree's disk layer and backfills the bloom
     index; then the VM's tx pool, miner, atomic mempool and trie. The root must equal the CPU Hasher's root of an independent
     trie built from the same items, and the same plan run through the
     plain version must give every lane's digest; the mirror must be on
     the device; the mirror boot's K1 launches are recorded, each held
     against the plain version and timed. Prints the boot split
     (_setup_genesis, mirror boot with its leaf scan, snapshot generation,
     bloom backfill), the commit's
     wall split (alloc writes, finalise, intermediate_root, trie commit
     into NodeSets, TrieDatabase.update and .commit) and what the
     MemoryDB holds
  6. batched genesis commit: the same items in fresh tries committed by
     intermediate_root on get_batch_keccak("batched"): every trie above
     the threshold hashed level by level through K2; the same oracle root,
     and every K2 lane's digest equal to the plain version's
  7. block: 700 transfers plus 50 contracts x 20 slot writes, made once
     and applied to every state: on the planned state as StateDB
     operations and StateDB.commit, then TrieDatabase.commit, and a fresh
     TrieDatabase and StateDB over the same MemoryDB read back every
     account the block touched, 1,000 others and every slot written; on
     the batched state through intermediate_root. Every root checked
     against the oracle
  7b. EVM: --evm-blocks (4) blocks of signed type-2 transactions on
     TEST_CHAIN_CONFIG (15,000,000 gas, tip 0), each filled to over 90% of
     its gas limit: 23 calls to seeded genesis contracts, each storing 20
     slots (half existing, half new) and logging once, among transfers
     from the keyed accounts to seeded plain accounts. Signed once; each
     mode's run decodes them anew and recovers its own senders (native
     secp256k1, Signer.sender_batch), then generate_chain from the planned
     genesis (EVM, receipts, the dummy engine's finalize_and_assemble, whose
     StateDB.intermediate_root is the device commit, then StateDB.commit)
     on a TrieDatabase of its own over an overlay of the genesis store
     (reads fall through, writes stay in the overlay), in three modes:
     off (CPU Hasher), batched (K2) and planned (K1); then --option-blocks
     (6) more blocks in planned mode alone, for the chain's execution
     options. Block for block the three give equal block hashes, header
     roots, receipts, blooms and gas used, and each root (the options
     blocks' too) equals an oracle derived from the transaction list, the
     receipts' gas used and the base fee alone (no EVM). The
     planned chain's last root is committed and every account and slot
     the blocks touched, the coinbase and 1,000 others read back through a
     fresh TrieDatabase. Every K1 (planned) and K2 (batched) input is held
     against the plain version and timed; each launch ran the variant its
     shape calls for. Per block and mode it prints transactions, gas,
     sender recovery, EVM, finalize_and_assemble (intermediate_root,
     derive_sha), StateDB.commit, device window, launches, Mgas/s and the
     garbage collector's pauses
  7c. chain: the EVM blocks, decoded anew, into the VM's chain of phase 5
     (built with insert_pipeline_depth=2, the one execution option the
     reference reads only at construction) the way a validator takes
     them, back to back (each block's insert tail overlapping the next
     insert). The first --evm-blocks through insert_block_manual(writes=
     True), the serial path (the sender cacher, StateProcessor.process,
     validate_state, StateDB.commit with the header root handed to the
     mirror: the storage tries in one planned program on K1, the account
     trie on the mirror's ResidentExecutor on K1); then the options
     blocks: one with CORETH_TPU_EVM_PARALLEL=4 (Block-STM on four
     threads) and one with CORETH_TPU_EVM_EXEC_SHARDS=2 (two worker
     processes started from a forkserver) through insert_block_manual, and
     the rest through insert_block, so through the pipeline, back to back
     with the shards on (the submit stage speculates through the shard
     pool; the commit thread folds, validates and commits on K1), drained;
     set_preference, accept, the acceptor queue drained (stop() comes
     after phase 7d). Every commit root equals the header root (the EVM
     phase held those against its oracle) and the mirror's; the head is
     the last block; each block ran the mode it asked for (serial,
     parallel, shards, the pipeline's spec) and no speculative fallback
     was counted; the shard workers hold no CUDA context and no jax,
     jaxlib or coreth_tpu module; no bad block; no device wedge, takeover,
     fallback, pipeline divergence or mirror quarantine counted; the
     snapshot's account of every touched address equals the trie's; after
     stop() the last root reads back through a fresh TrieDatabase. The
     planned programs and the executor launch K1 through recorders: both
     ran, each launch the variant its shape calls for, every input held
     against the plain version. Per block it prints the mode asked for
     and run (conflicts, re-executions, fallback, per-worker ShardStats,
     overlap_fraction), the flight record's phases (recover, verify,
     execute, validate, commit, write; fold for the pipelined blocks),
     the resident timers, the mirror's device window, K1 launches and
     Mgas/s over the insert (over the commit stage for the pipelined
     blocks); then the pipelined blocks' wall from the first submit to
     the drain, the accept time, and a respawn: a shard worker SIGKILLed,
     replaced and pinged clean. The shard pool's forkserver imports this
     script once before it forks a worker (core/shard_worker.py), so its
     work stays under `if __name__ == "__main__"`
  7d. VM: --vm-blocks (2) blocks of the EVM phase's mix (368 signed
     transactions from the keyed accounts' next nonces, 23 of them calls
     that store 20 slots and log) through the VM on that chain: each
     transaction issued through vm.issue_tx, and in the first block one
     ImportTx (consuming a UTXO seeded into the shared memory from the X
     chain) and one ExportTx through vm.issue_atomic_tx; then
     vm.build_block() (the miner from the tx pool and the atomic mempool;
     finalize_and_assemble's intermediate_root: the storage programs on
     K1 under the degradation ladder, the account trie on the mirror's
     executor on K1; insert_block_manual(writes=False)), vmb.verify()
     (insert_block_manual(writes=True), the atomic backend),
     vm.set_preference, vmb.accept(), the acceptor drained. Every header
     root equals the EVM-independent oracle's (evm_oracle_block over the
     block's own transaction order, the fees to the miner's coinbase,
     plus the atomic txs' balance and nonce changes); the head is
     vm.last_accepted(); the mempool and the tx pool end empty; the shared
     memory holds the export's UTXO and not the import's; no loud,
     fallback or ops/device/* counter moves. Per block it prints issue,
     build, verify and accept ms, the K1 launches of build and verify
     (storage programs, resident executor), the flight record's phases,
     the mirror's window and Mgas/s over build + verify; the K1 launches
     are recorded and held against the plain version. Then vm.shutdown()
     (the chain's stop() and its shutdown export), the forkserver and the
     resource tracker stopped (exec_shards.stop_servers), and no process
     the run started may be left, here and again at the end; the last
     accepted root reads back through a fresh TrieDatabase
  8. the mirrors (the resident path, K1): one ordered leaf scan
     (trie/iterator.iterate_leaves) of the planned genesis' persisted
     account trie boots three ResidentAccountMirrors, each installed on a
     Database over the genesis store with the planned marker (its storage
     programs record every K1 input): A resident (lean rows, pipeline depth
     2, watchdog on), B template residency (watchdog on), C the native
     host twin; each genesis root equals the oracle's. Then block 1 (the
     block of phase 7) and --blocks (4) seeded blocks as StateDB
     operations on a StateDB over each mirror and StateDB.commit(
     block_hash=, parent_block_hash=), accepted two blocks behind through
     each mirror's ResidentTrieWriter; A's MirrorStateTrie carries the
     oracle's root as expected_root from block 2, so its commits pipeline;
     a sibling of the middle block is verified on all three and rejected
     through reject_trie. Every root equals the oracle's. A's writer
     exports at commit_interval 4 and at shutdown; a fresh TrieDatabase
     over the store then reads back every account the last block touched,
     999 others and every slot the blocks wrote. A.spot_check() passes, A
     and B end on the device, and no device wedge, takeover, fallback or
     pipeline divergence is counted. Spans are on for the blocks: the
     resident/commit and state/hash_plan/storage spans are read back.
     Every K1 input of A's and B's executors and of the storage programs
     is held against the plain version and timed
  8b. ladder drill: a VM of its own over --drill-accounts (2,000)
     accounts, booted from JSON with device-call-timeout 1.0,
     device-probe-interval 0.05, device-promote-after 2 and
     commit-interval 1, its blocks of 6 contract calls (120 slot writes)
     and 10 transfers through the VM, every root the oracle's. Only a
     caller demotes the ladder; a failed dispatch reaches its caller:
     raise (ops/device/dispatch armed raise*1: build_block raises the
     error, the head stays, no demotion; then the block builds with
     storage K1 launches), hang (the dispatch hangs: the watchdog's
     DeviceWedgedError reaches build_block within 3 s, the head stays, no
     demotion; released, the block builds on K1), takeover (the probes
     failing, chain.take_over_host() demotes the ladder: device/demote in
     the flight events, a block hashed on the host with 0 K1 launches),
     recover (cleared: the probes, K2 on the card, re-promote, the
     listener reboots the mirror on the device and the next block
     launches K1 in the storage programs and the executor). Then the
     ladder is reset to its defaults. Before it, the main paths' loud
     counters, ops/device/* among them, must all be 0; after it
     demotions 1, promotions 1, dispatch errors 2. Its K1 launches and
     the probes' K2 launches are held against the plain versions
  8c. commitment VM: a VM of its own over --shadow-accounts (50,000)
     accounts (the main world's shape: 1 contract per 1,000 accounts with
     100 slots, 1,500 keyed), booted from JSON {"state-backend":
     "bintrie-shadow", "shadow-check-interval": 2} with the chain's other
     defaults (the mirror on "auto"), on a genesis whose config enables
     TpuKeccakConfig(timestamp=0) and holds two forwarder contracts
     (STATICCALL the precompile with the calldata, store keccak256 of the
     return data in a slot of their own per call). Every state commit also
     advances the bintrie shadow: at 64 updates or more through its
     planned commit, one K1 segment a depth level. --shadow-blocks (3)
     blocks through vm_block, each the EVM phase's mix with its transfers
     trimmed for two keccak256Batch(bytes[]) calls of 128 seeded 512-byte
     messages (the precompile hashes them on K2 through the VM's device
     seam). Every MPT root equals the oracle's (the forwarders' slots from
     the host batch keccak); the shadow root of the genesis and of every
     block equals bintrie.reference_root over a content map built from
     the oracle's world; build and verify commit the same transition with
     the same bintrie root; the canonical rebuild ran; no quarantine,
     shadow error, loud, fallback or ops/device/* counter moves. Then one
     direct contract.run of the first call's messages equals the host
     batch keccak; witnesses of 100 seeded accounts and 100 absent keys
     verify against the last shadow root; MPTBackend.prove / verify agree
     for the same accounts at the head's (resident) root; a range proof of
     1,000 consecutive account leaves is accepted and refused with one leaf
     dropped. Every K1 input of the phase (the shadow's, the MPT genesis,
     the mirror boot, the storage programs, the resident executor) and
     every K2 input of the precompile is recorded and held against the
     plain versions; the launches are logged by source, with the
     bintrie/planned counters and the chain/commit/mpt and
     chain/commit/bintrie timers
  8d. mesh and legacy executors: a trie of --mesh-accounts (100,000)
     seeded leaves and 3 blocks of 2,000 updates (the native host
     planner's root of each state the oracle), on meshes of width 1 on
     the card and width 4 on [cuda:0] * 4 (and on min(count, 4) real
     devices when the machine has several): parallel.ShardedKeccak of
     4,000 messages (K2 per shard) against the host keccak, commit_step's
     digests and checksum, planned_commit_over_mesh (K1 per shard and
     segment) of the trie, and a ResidentAccountMirror(mesh_devices=...)
     over the blocks, every root the oracle's, then take_over_host() one
     rung a call (width 4: mesh -> single device -> host; width 1:
     host), a block committed on each rung. Then a block's plan through
     CommitPlan.execute_device (fused_commit: K2 a segment) and
     execute_staged (StagedCommit: K1 a segment), root and every real
     lane's digest the host's; and a BlockChain in device-hasher "fused"
     (the mirror off, so the account trie too goes through FusedHasher)
     over a 2,000-account genesis taking 2 blocks of 154 transactions
     made on the CPU Hasher, every root the header's. Every K1 and K2
     launch of the phase goes through a recorder and is held against the
     plain versions; the phase's wall and launches are printed
  9. watchdog drill: a 2,000-key mirror whose executor hangs once: the
     commit raises DeviceWedgedError with the applied stack unchanged and
     nothing on the host; the drill then asks for the host
     (take_over_host), and every root equals its host twin's: exactly one
     wedge and one takeover counted
Every kernel time read from the profiler's trace is checked against the
number of launches the session made (phases 3-8): where the trace holds
another number of records, the time reads "not measured" (None in the
JSON line).
  10. fallback: Genesis.commit of a small state on the planned marker with
     MAX_SEGMENTS lowered, so that TooManySegments sends it to
     BatchedHasher on K2
Before the last line it prints one JSON object describing each kernel
(launches on its main paths, max error, ms, plain ms, bound ms, and per
variant its launches and kernel ms in the profiler's trace; K1's entry
sums the planned path, the chain and the mirrors); the last
line is {"ok": true, "device": {...}}. Nothing of jax or coreth_tpu is
imported.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import gc
import json
import os
import resource
import signal
import subprocess
import sys
import threading
import time
from collections import defaultdict
from unittest import mock

import numpy as np
import torch

from coreth_tpu_torch import fault, params, parallel, rlp
from coreth_tpu_torch.bintrie import shadow as shadow_mod
from coreth_tpu_torch.bintrie import witness as bwitness
from coreth_tpu_torch.bintrie.tree import reference_root
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core import types as types_mod
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
from coreth_tpu_torch.core import exec_shards
from coreth_tpu_torch.core.bloom_index import BloomIndexer
from coreth_tpu_torch.core.chain_makers import generate_chain
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.state_manager import ResidentTrieWriter
from coreth_tpu_torch.core.types import Block, Signer, Transaction
from coreth_tpu_torch.crypto.secp256k1 import priv_to_address
from coreth_tpu_torch.device import DeviceWedgedError, resolve
from coreth_tpu_torch.ethdb import KeyValueStore, MemoryDB
from coreth_tpu_torch.native import keccak256, keccak256_batch, mpt
from coreth_tpu_torch.native.mpt import IncrementalTrie, plan_from_items
from coreth_tpu_torch.ops import keccak_cuda, keccak_planned
from coreth_tpu_torch.ops import device as device_mod
from coreth_tpu_torch.ops.device import default_ladder, get_batch_keccak
from coreth_tpu_torch.ops.keccak_planned import MAX_SEGMENTS, PlannedCommit, \
    PlannedMode, default_planned_commit
from coreth_tpu_torch.metrics import default_registry, spans
from coreth_tpu_torch.precompile import TPU_KECCAK_ADDR, TpuKeccakConfig, \
    function_selector
from coreth_tpu_torch.precompile import tpu_keccak
from coreth_tpu_torch.ops.keccak_resident import ResidentExecutor
from coreth_tpu_torch.ops.keccak_staged import segment_keccak_plain
from coreth_tpu_torch.ops.keccak_torch import RATE, BatchedKeccak, \
    digest_words_to_bytes, int32_to_words, keccak256_blocks_plain, \
    pack_messages, words_to_int32
from coreth_tpu_torch.state.account import EMPTY_CODE_HASH, Account, \
    normalize_state_key
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.state.snapshot import Tree as SnapshotTree
from coreth_tpu_torch.state.statedb import StateDB, _slim_to_account, \
    intermediate_root
from coreth_tpu_torch.trie import hasher as hasher_mod
from coreth_tpu_torch.trie import planned as planned_mod
from coreth_tpu_torch.trie.hasher import Hasher
from coreth_tpu_torch.trie.iterator import iterate_leaves
from coreth_tpu_torch.trie.node import EMPTY_ROOT, ProofError
from coreth_tpu_torch.trie.proof import prove as mpt_prove
from coreth_tpu_torch.trie.proof_range import verify_range_proof
from coreth_tpu_torch.trie.planned import PlannedGraphBuilder
from coreth_tpu_torch.trie.resident_mirror import ResidentAccountMirror
from coreth_tpu_torch.trie.secure import StateTrie
from coreth_tpu_torch.trie.trie import trie_from_items
from coreth_tpu_torch.trie.triedb import TrieDatabase
from coreth_tpu_torch.vm import atomic_tx
from coreth_tpu_torch.vm.shared_memory import Element, Memory, Requests
from coreth_tpu_torch.vm.vm import VM, SnowContext

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

# The genesis contracts' code, assembled by hand: for each 64-byte (key,
# value) pair of the calldata SSTORE value at key, then one LOG1 whose data
# is the first pair and whose topic is the caller; zero-padded to 64 bytes.
STORE_AND_LOG = bytes([
    0x60, 0x00,  # 00 PUSH1 0        i
    0x5B,        # 02 JUMPDEST       loop: [i]
    0x80,        # 03 DUP1
    0x36,        # 04 CALLDATASIZE
    0x11,        # 05 GT             size > i
    0x15,        # 06 ISZERO
    0x60, 0x18,  # 07 PUSH1 0x18
    0x57,        # 09 JUMPI          done -> 0x18
    0x80,        # 0a DUP1
    0x60, 0x20,  # 0b PUSH1 32
    0x01,        # 0d ADD
    0x35,        # 0e CALLDATALOAD   value = calldata[i + 32]
    0x81,        # 0f DUP2
    0x35,        # 10 CALLDATALOAD   key = calldata[i]
    0x55,        # 11 SSTORE
    0x60, 0x40,  # 12 PUSH1 64
    0x01,        # 14 ADD            i += 64
    0x60, 0x02,  # 15 PUSH1 0x02
    0x56,        # 17 JUMP
    0x5B,        # 18 JUMPDEST       done: [i]
    0x33,        # 19 CALLER         the log's topic
    0x60, 0x40,  # 1a PUSH1 64
    0x60, 0x00,  # 1c PUSH1 0
    0x60, 0x00,  # 1e PUSH1 0
    0x37,        # 20 CALLDATACOPY   memory[0:64] = calldata[0:64]
    0x60, 0x40,  # 21 PUSH1 64
    0x60, 0x00,  # 23 PUSH1 0
    0xA1,        # 25 LOG1           (0, 64, caller)
    0x00,        # 26 STOP
])
CONTRACT_CODE = STORE_AND_LOG + bytes(64 - len(STORE_AND_LOG))
# The EVM phase's blocks: ~half the gas in 20-write contract calls (about
# 315,000 gas each; planned at EVM_CALL_PLAN so the block never overfills),
# the rest in 21,000-gas transfers, to EVM_FILL of the gas limit.
EVM_KEYED = 1500
EVM_CALLS = 23
EVM_WRITES = 20
EVM_CALL_PLAN = 320_000
EVM_CALL_GAS = 400_000
EVM_FILL = 0.975
EVM_MAX_FEE = 10**12  # above every base fee of a few blocks; tip 0
EVM_COINBASE = b"\x00" * 20  # chain_makers' header coinbase
# The chain phase's execution options: the pipeline's depth, the workers
# of the thread-parallel block and the shards of the sharded ones
PIPELINE_DEPTH = 2
OPTION_WORKERS = 4
OPTION_SHARDS = 2


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"FAILED: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def mark(t_start: float, phase: str) -> None:
    """The run's elapsed seconds as `phase` starts."""
    log(f"-- t = {time.perf_counter() - t_start:.1f} s: {phase}")


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


def descendants() -> list:
    """(pid, command) of every living process this one started, directly
    or not, from /proc (a zombie not yet reaped counts too)."""
    parent = {}
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # pid (comm) state ppid ...: comm may hold spaces and parentheses
        comm = stat[stat.index("(") + 1:stat.rindex(")")]
        parent[int(d)] = (int(stat[stat.rindex(")") + 2:].split()[1]), comm)
    out, todo = [], [os.getpid()]
    while todo:
        p = todo.pop()
        for c, (pp, comm) in parent.items():
            if pp == p:
                out.append((c, comm))
                todo.append(c)
    return out


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
    from coreth_tpu_torch.native import secp
    jobs = [("host keccak (g++)", native.load),
            ("native planner (g++)", mpt.load),
            ("native incremental trie (g++)", mpt.load_inc),
            ("native secp256k1 (g++)", secp.load)]
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

    def __init__(self, n_accounts, n_contracts, n_slots, seed, n_keyed=0):
        rng = np.random.default_rng(seed)
        raw = rng.bytes(20 * n_accounts)
        self.addrs = [raw[20 * i:20 * i + 20] for i in range(n_accounts)]
        self.nonce = [int(v) for v in rng.integers(0, 1 << 16, n_accounts)]
        bal = rng.bytes(10 * n_accounts)
        self.balance = [int.from_bytes(bal[10 * i:10 * i + 10], "big") % 10**24
                        for i in range(n_accounts)]
        self.code_hash = [EMPTY_CODE_HASH] * n_accounts
        self.code = {}  # account index -> contract code
        # account index -> {slot key: 32-byte value}; keys as StateDB keeps
        # them (normalize_state_key)
        self.storage = {}
        for c in range(n_contracts):
            self.code[c] = CONTRACT_CODE
            self.code_hash[c] = keccak256(self.code[c])
            keys = rng.bytes(32 * n_slots)
            vals = rng.bytes(32 * n_slots)
            self.storage[c] = {
                normalize_state_key(keys[32 * s:32 * s + 32]):
                    b"\x01" + vals[32 * s + 1:32 * s + 32]
                for s in range(n_slots)}
        # the first n_keyed plain accounts: addresses of seeded private keys,
        # each with at least 10^21 wei (the EVM phase's senders)
        self.keyed = []  # [(account index, private key)]
        for i in range(n_contracts, min(n_contracts + n_keyed, n_accounts)):
            key = b"\x01" + rng.bytes(31)
            self.addrs[i] = priv_to_address(key)
            self.balance[i] += 10**21
            self.keyed.append((i, key))
        self.rng = rng

    def account(self, i, root) -> Account:
        return Account(nonce=self.nonce[i], balance=self.balance[i],
                       root=root, code_hash=self.code_hash[i])

    def snapshot(self) -> "World":
        """A copy whose balances, nonces and slots change apart from this
        one's (addresses, code and keys are shared)."""
        w = copy.copy(self)
        w.nonce, w.balance = list(self.nonce), list(self.balance)
        w.storage = {c: dict(slots) for c, slots in self.storage.items()}
        return w


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

    def snapshot(self, world: World) -> "Oracle":
        """An oracle over `world` (a snapshot of this one's) that updates
        apart from this one: the tries are shared until written, since a
        Trie update copies the nodes on its path."""
        o = copy.copy(self)
        o.world = world
        o.storage = {c: copy.copy(t) for c, t in self.storage.items()}
        o.roots = dict(self.roots)
        o.trie = copy.copy(self.trie)
        return o


class _Timed:
    """Wall ms of each wrapped method, summed over its calls (nested calls
    count in both), and every PlannedGraphBuilder that ran, while open."""

    METHODS = ((Genesis, "to_block"), (StateDB, "commit"),
               (StateDB, "intermediate_root"), (StateDB, "finalise"),
               (TrieDatabase, "update"), (TrieDatabase, "commit"))

    def __init__(self):
        self.ms = defaultdict(float)
        self.builders = []
        self._saved = []

    def _wrap(self, cls, name):
        orig = getattr(cls, name)
        label = f"{cls.__name__}.{name}"

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                self.ms[label] += (time.perf_counter() - t0) * 1e3
        self._saved.append((cls, name, orig))
        setattr(cls, name, timed)

    def __enter__(self):
        for cls, name in self.METHODS:
            self._wrap(cls, name)
        run = PlannedGraphBuilder.run
        builders = self.builders

        def recorded(b, *a, **kw):
            builders.append(b)
            return run(b, *a, **kw)
        self._saved.append((PlannedGraphBuilder, "run", run))
        PlannedGraphBuilder.run = recorded
        return self

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._saved):
            setattr(cls, name, orig)


def planned_commit_report(dev, timed: _Timed, label):
    """Checks and logs of one planned StateDB commit, its counts zeroed
    before it: one PlannedGraphBuilder run, no fallback, no K2, K1 at
    least once a segment. Returns (builder, K1 launches, of them
    cooperative)."""
    launches, coop = keccak_cuda.launches, keccak_cuda.launches_coop
    fallbacks = planned_mod.planned_fallbacks
    check(len(timed.builders) == 1,
          f"{label}: {len(timed.builders)} planned programs, not one")
    builder = timed.builders[0]
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
        f"h2d {pc.last_h2d_bytes} B in {pc.last_transfers} transfers")
    return builder, launches, coop


def wall_split(timed: _Timed) -> str:
    """The commit wall split by the wrapped methods (ms)."""
    ms = timed.ms
    ir = ms["StateDB.intermediate_root"]
    parts = []
    if "Genesis.to_block" in ms:
        parts.append(("alloc writes (to_block less StateDB.commit)",
                      ms["Genesis.to_block"] - ms["StateDB.commit"]))
    parts += [("finalise", ms["StateDB.finalise"]),
              ("intermediate_root less finalise",
               ir - ms["StateDB.finalise"]),
              ("trie commit into NodeSets",
               ms["StateDB.commit"] - ir - ms["TrieDatabase.update"]),
              ("TrieDatabase.update", ms["TrieDatabase.update"]),
              ("TrieDatabase.commit", ms["TrieDatabase.commit"])]
    return ", ".join(f"{name} {v:.1f}" for name, v in parts)


def store_report(diskdb) -> str:
    """Entries and bytes (key + value) in the MemoryDB, trie nodes (32-byte
    keys) apart, and the time to read them all back in key order."""
    t0 = time.perf_counter()
    n = nbytes = nodes = node_bytes = 0
    for k, v in diskdb.iterate():
        n += 1
        nbytes += len(k) + len(v)
        if len(k) == 32:
            nodes += 1
            node_bytes += len(k) + len(v)
    return (f"{n} entries, {nbytes} B; trie nodes {nodes}, {node_bytes} B "
            f"(iterated in {(time.perf_counter() - t0) * 1e3:.1f} ms)")


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


def genesis_alloc(world: World) -> Genesis:
    """The world as a Genesis alloc under TEST_CHAIN_CONFIG."""
    return Genesis(config=params.TEST_CHAIN_CONFIG, alloc={
        addr: GenesisAccount(balance=world.balance[i], nonce=world.nonce[i],
                             code=world.code.get(i, b""),
                             storage=world.storage.get(i, {}))
        for i, addr in enumerate(world.addrs)})


class _ChainBoot:
    """While open: the wall ms of the chain's boot steps (BlockChain.
    _setup_genesis, _boot_mirror and the ResidentAccountMirror
    construction inside it, the snapshot Tree's _generate, the bloom
    backfill's BloomIndexer.add_block calls) and the K1 launches of the
    mirror boot, each recorded (`rec`): inside _boot_mirror the module's
    segment_keccak, which the mirror's ResidentExecutor takes as its
    default at construction, is a _K1Recorder over it."""

    STEPS = ((BlockChain, "_setup_genesis"), (BlockChain, "_boot_mirror"),
             (ResidentAccountMirror, "__init__"), (SnapshotTree, "_generate"),
             (BloomIndexer, "add_block"))

    def __init__(self):
        self.ms = defaultdict(float)
        self.boot_launches = self.boot_coop = 0
        self.rec = _K1Recorder(keccak_cuda.segment_keccak)
        self._saved = []

    def __enter__(self):
        for cls, name in self.STEPS:
            orig = getattr(cls, name)
            label = f"{cls.__name__}.{name}"

            def timed(*a, _orig=orig, _label=label, **kw):
                boot = _label == "BlockChain._boot_mirror"
                l0, c0 = keccak_cuda.launches, keccak_cuda.launches_coop
                if boot:
                    keccak_cuda.segment_keccak = self.rec
                t0 = time.perf_counter()
                try:
                    return _orig(*a, **kw)
                finally:
                    self.ms[_label] += (time.perf_counter() - t0) * 1e3
                    if boot:
                        keccak_cuda.segment_keccak = self.rec.launch
                        self.boot_launches += keccak_cuda.launches - l0
                        self.boot_coop += keccak_cuda.launches_coop - c0
            self._saved.append((cls, name, orig))
            setattr(cls, name, timed)
        return self

    def __exit__(self, *exc):
        for cls, name, orig in reversed(self._saved):
            setattr(cls, name, orig)


def vm_config(dev) -> dict:
    """The VM's JSON config, as AvalancheGo hands it over: the defaults but
    for the insert pipeline at depth 2 (the one execution option read only
    at construction); "auto" boots the resident mirror on CUDA. The CPU
    rehearsal asks for the mirror, which "auto" leaves off there."""
    cfg = {"insert-pipeline-depth": PIPELINE_DEPTH}
    if dev.type != "cuda":
        cfg["resident-account-trie"] = True
    return cfg


def chain_clock(vm, gap: int = 10):
    """The VM's block clock: each block `gap` seconds of chain time after
    its parent (as generate_chain's blocks), so tip-0 blocks owe no block
    gas cost."""
    return lambda: vm.blockchain.current_block.time + gap


def phase_genesis(dev, world: World, oracle_root: bytes):
    """The planned genesis through the VM (module docstring, phase 5):
    VM.initialize(SnowContext(shared_memory=Memory()), MemoryDB(), the
    world's Genesis, config_bytes=<JSON>, device=dev) builds its state's
    TrieDatabase on get_batch_keccak("auto", dev) and its BlockChain,
    whose _setup_genesis is Genesis.commit on the planned marker, every
    storage trie and the account trie in one K1 program, persisted into
    the MemoryDB; then the default "auto" probe boots the resident mirror
    (one leaf scan, the mirror's genesis commit on K1), the snapshot tree
    generates its disk layer and the bloom index backfills; then the
    VM's tx pool, miner, mempool, atomic trie and block builder. Returns
    (VM, its shared Memory, MemoryDB, genesis block, builder, K1 launches
    of the genesis program, of them cooperative, the mirror boot's K1
    launches, of them cooperative, their recorder)."""
    t0 = time.perf_counter()
    gen = genesis_alloc(world)
    log(f"genesis: {len(world.addrs)} accounts, {len(world.storage)} "
        f"contracts x {len(next(iter(world.storage.values())))} slots as a "
        f"Genesis alloc in {time.perf_counter() - t0:.1f} s")
    diskdb = MemoryDB()
    keccak_cuda.reset_counts()
    planned_mod.planned_fallbacks = 0
    cfg = json.dumps(vm_config(dev))
    mem = Memory()
    vm = VM()
    with _Timed() as timed, _GcPauses() as pauses, _ChainBoot() as boot:
        t0 = time.perf_counter()
        vm.initialize(SnowContext(shared_memory=mem), diskdb, gen,
                      config_bytes=cfg.encode(), device=dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    del gen
    vm.miner.clock = chain_clock(vm)
    chain = vm.blockchain
    tdb = chain.state_database.triedb
    check(getattr(tdb.batch_keccak, "planned", False)
          and chain.pipeline is not None,
          "vm: the state's seam is not the planned marker, or no pipeline")
    block = chain.genesis_block
    check(chain.mirror is not None and not chain.mirror.host_mode,
          "chain: the resident mirror did not boot on the device")
    check(chain.snaps is not None and chain.snaps.disk_layer.root
          == block.root, "chain: no snapshot disk layer at the genesis root")
    check(chain.mirror.root_of(block.hash()) == block.root,
          "chain: the mirror's genesis root differs from the block's")
    chain.mirror.ex.seg_impl = boot.rec.launch
    check(dev.type != "cuda" or len(boot.rec.records)
          == boot.boot_launches > 0,
          f"chain: mirror boot launched K1 {boot.boot_launches} times, "
          f"{len(boot.rec.records)} recorded")
    builder, launches, coop = planned_commit_report(dev, timed, "genesis")
    launches -= boot.boot_launches
    coop -= boot.boot_coop
    check(block.root == oracle_root, f"genesis root {block.root.hex()} != "
          f"CPU oracle {oracle_root.hex()}")
    log(f"genesis root {block.root.hex()} == independent CPU Hasher root; "
        f"block {block.hash().hex()}")
    ms = boot.ms
    mirror_ms = ms["ResidentAccountMirror.__init__"]
    log(f"genesis: VM.initialize(config_bytes={cfg}, device={dev}) wall "
        f"{wall_ms:.1f} ms: BlockChain._setup_genesis "
        f"(Genesis.commit) {ms['BlockChain._setup_genesis']:.1f}, mirror boot"
        f" {ms['BlockChain._boot_mirror']:.1f} (leaf scan "
        f"{ms['BlockChain._boot_mirror'] - mirror_ms:.1f}, mirror "
        f"construction and genesis commit {mirror_ms:.1f}; K1 launches "
        f"{boot.boot_launches}, cooperative {boot.boot_coop}), snapshot "
        f"generation {ms['Tree._generate']:.1f}, bloom backfill "
        f"{ms['BloomIndexer.add_block']:.1f} ms")
    log(f"genesis: Genesis.commit wall {ms['BlockChain._setup_genesis']:.1f}"
        f" ms: {wall_split(timed)} ms; garbage collector pauses over the "
        f"chain's construction ({pauses})")
    log(f"genesis: persisted {store_report(diskdb)} (the snapshot's flat "
        f"entries included); dirty nodes left {tdb.dirty_size} B")
    return (vm, mem, diskdb, block, builder, launches, coop,
            boot.boot_launches, boot.boot_coop, boot.rec)


def phase_block(dev, world: World, diskdb, tdb, parent, block, want,
                seed):
    """The block as StateDB operations on the planned marker over the
    genesis state (each transfer and each contract's writes a transaction,
    finalise(True) after it), StateDB.commit, TrieDatabase.commit; then a
    fresh TrieDatabase and StateDB over the same MemoryDB read back every
    account the block touched, 1,000 seeded others and every slot written:
    the acknowledged writes. Returns (builder, K1 launches, cooperative)."""
    accounts, writes, transfers = block
    keccak_cuda.reset_counts()
    planned_mod.planned_fallbacks = 0
    t0 = time.perf_counter()
    sdb = StateDB(parent, Database(tdb))
    apply_block(sdb, world.addrs, transfers, writes)
    ops_ms = (time.perf_counter() - t0) * 1e3
    with _Timed() as timed:
        root = sdb.commit(True)
        tdb.commit(root)
    wall_ms = (time.perf_counter() - t0) * 1e3
    builder, launches, coop = planned_commit_report(dev, timed, "block")
    check(root == want, f"block root {root.hex()} != CPU oracle {want.hex()}")
    check(dev.type != "cuda" or coop > 0,
          "block: the cooperative K1 kernel never ran")
    log(f"block root {root.hex()} == independent CPU Hasher root")
    log(f"block: wall {wall_ms:.1f} ms: StateDB operations ("
        f"{len(transfers) + len(writes)} transactions) {ops_ms:.1f}, "
        f"StateDB.commit "
        f"{timed.ms['StateDB.commit']:.1f} ({wall_split(timed)}) ms; dirty "
        f"nodes left {tdb.dirty_size} B")
    read_back(world, diskdb, root, accounts, writes, seed, "block")
    return builder, launches, coop


class _BlocksRecorder:
    """BatchedKeccak impl that launches K2 (`launch`, default
    keccak_cuda.keccak256_blocks, which counts the launch) and keeps each
    input and output."""

    def __init__(self, launch=None):
        self.launch = launch
        self.records = []

    def __call__(self, words, nblocks):
        out = (self.launch or keccak_cuda.keccak256_blocks)(words, nblocks)
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


TRANSFER_FEE = 21000 * 25 * 10**9


def make_block(world: World, n_transfers=700, n_contracts=50, n_writes=20):
    """A seeded block, applied to `world`: `n_transfers` transfers between
    plain accounts, then `n_writes` slot writes (half new) in each of
    `n_contracts` contracts. Returns (sorted account indices touched,
    {contract: {key: value}}, [(sender, receiver, value, top-up)])."""
    rng = world.rng
    n = len(world.addrs)
    plain_pool = np.arange(len(world.storage), n)
    touched = set()
    transfers = []
    for _ in range(n_transfers):
        s, r = (int(v) for v in rng.choice(plain_pool, 2, replace=False))
        value = int(rng.integers(1, 10**12))
        topup = 0
        if world.balance[s] < value + TRANSFER_FEE:
            topup = 10**20
        world.balance[s] += topup
        world.nonce[s] += 1
        world.balance[s] -= value + TRANSFER_FEE
        world.balance[r] += value
        touched.update((s, r))
        transfers.append((s, r, value, topup))
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
            w[normalize_state_key(rng.bytes(32))] = b"\x03" + rng.bytes(31)
        world.storage[c].update(w)
        writes[c] = w
        touched.add(c)
    return sorted(touched), writes, transfers


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
    """Genesis.commit of a small state on the planned marker with the
    segment table cut to 2: TooManySegments sends it to BatchedHasher on
    K2."""
    world = World(3000, 5, 20, seed + 2)
    want = Oracle(world).root()
    disk = MemoryDB()
    tdb = TrieDatabase(disk, batch_keccak=get_batch_keccak("planned", dev))
    keccak_cuda.reset_counts()
    planned_mod.planned_fallbacks = 0
    keccak_planned.MAX_SEGMENTS = 2
    try:
        root = genesis_alloc(world).commit(disk, Database(tdb)).root
    finally:
        keccak_planned.MAX_SEGMENTS = MAX_SEGMENTS
    fallbacks, k2 = planned_mod.planned_fallbacks, keccak_cuda.blocks_launches
    check(root == want, f"fallback root {root.hex()} != CPU Hasher "
          f"{want.hex()}")
    # the commit overflows, then the account trie's own re-plan does too
    check(fallbacks == 2, f"fallback: planned_fallbacks == {fallbacks}")
    check(keccak_cuda.launches == 0, "fallback: K1 launched")
    check(dev.type != "cuda" or k2 > 0, "fallback: K2 never launched")
    log(f"fallback (Genesis.commit, 3000 accounts, MAX_SEGMENTS 2): root == "
        f"CPU Hasher root, planned_fallbacks {fallbacks}, K2 launches {k2}")


class _K1Recorder:
    """seg_impl that launches K1 (`launch`, default keccak_cuda.
    segment_keccak, which counts the launch) and keeps each input, its
    output and the variant that ran (None on the CPU)."""

    def __init__(self, launch=None):
        self.launch = launch
        self.records = []

    def __call__(self, words):
        coop = keccak_cuda.launches_coop
        out = (self.launch or keccak_cuda.segment_keccak)(words)
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


def fmt_window(w) -> str:
    return ("not measured (cpu)" if w is None
            else f"{w[1]:.3f} ms (upload {w[0]:.3f} ms)")


def stats(xs, unit="ms") -> str:
    if not xs:
        return "not measured"
    return (f"median {float(np.median(xs)):.3f} {unit}, mean "
            f"{sum(xs) / len(xs):.3f}, min {min(xs):.3f}, max {max(xs):.3f} "
            f"(n={len(xs)})")


LOUD = ("state/resident/device_wedges", "state/resident/device_takeovers",
        "state/resident/fallbacks", "state/resident/pipeline_divergences")


def loud_counts() -> dict:
    return {name: default_registry.counter(name).count() for name in LOUD}


def apply_block(sdb: StateDB, addrs, transfers, writes) -> None:
    """A block's transactions as StateDB operations: each transfer (top-up,
    nonce, value and fee) and each contract's slot writes a transaction,
    finalise(True) after each."""
    for s, r, value, topup in transfers:
        if topup:
            sdb.add_balance(addrs[s], topup)
        sdb.set_nonce(addrs[s], sdb.get_nonce(addrs[s]) + 1)
        sdb.sub_balance(addrs[s], value + TRANSFER_FEE)
        sdb.add_balance(addrs[r], value)
        sdb.finalise(True)
    for c, w in writes.items():
        for k, v in w.items():
            sdb.set_state(addrs[c], k, v)
        sdb.finalise(True)


def read_back(world: World, diskdb, root, accounts, slot_keys, seed,
              label) -> None:
    """Through a fresh TrieDatabase and StateDB over `diskdb` at `root`:
    every account in `accounts`, 1,000 seeded others less those, and for
    each contract among them or in `slot_keys` (contract -> keys) its keys
    there, else three of its genesis slots, must equal the world's values:
    the acknowledged writes."""
    addrs = world.addrs
    t0 = time.perf_counter()
    back = StateDB(root, Database(TrieDatabase(diskdb)))
    rng = np.random.default_rng(seed)
    others = sorted(set(int(i) for i in rng.choice(len(addrs), 1000,
                                                   replace=False))
                    - set(accounts))
    slots = 0
    for i in list(accounts) + others:
        a = addrs[i]
        got = (back.get_nonce(a), back.get_balance(a), back.get_code_hash(a))
        check(got == (world.nonce[i], world.balance[i], world.code_hash[i]),
              f"{label}: read-back of account {i}: {got}")
        if i in world.code:
            check(back.get_code(a) == world.code[i],
                  f"{label}: read-back of account {i}: code")
    for c in sorted((set(accounts) | set(others) | set(slot_keys))
                    & set(world.storage)):
        keys = sorted(slot_keys.get(c, ())) or list(world.storage[c])[:3]
        for k in keys:
            check(back.get_state(addrs[c], k) == world.storage[c][k],
                  f"{label}: read-back of contract {c}: slot {k.hex()}")
            slots += 1
    log(f"{label}: read back through a fresh TrieDatabase {len(accounts)} "
        f"accounts the block touched, {len(others)} others and {slots} slots"
        f" ({sum(len(k) for k in slot_keys.values())} written), all equal "
        f"to the world's, in {(time.perf_counter() - t0) * 1e3:.1f} ms")


class _Blk:
    """What a ResidentTrieWriter reads of a block: number, root, hash."""

    def __init__(self, number, root, h):
        self.number, self.root, self._h = number, root, h

    def hash(self):
        return self._h


def block_hash(n: int) -> bytes:
    return keccak256(b"mirror block %d" % n)


class MirrorRun:
    """The mirror phase's three mirrors, booted from one leaf scan of the
    planned genesis' persisted account trie, each installed on its own
    Database over one TrieDatabase on the planned marker (the storage
    programs, which record every K1 input) over the genesis store.

    A  resident, lean rows, pipeline_depth 2 (blocks after the first carry
       the oracle's root as MirrorStateTrie.expected_root), watchdog on;
       its writer exports at commit_interval 4 and at shutdown
    B  template residency, watchdog on
    C  the native host twin (prefer_host=True)
    A's and B's executors record every K1 input (_K1Recorder)."""

    NAMES = ("C", "B", "A")  # C first: its root is the one A pipelines on
    INTERVAL = 4  # one interval export at the default --blocks (4)

    def __init__(self, dev, diskdb, items, timeout):
        self.dev = dev
        self.rec = {"A": _K1Recorder(), "B": _K1Recorder(),
                    "storage": _K1Recorder()}
        self.tdb = TrieDatabase(diskdb, batch_keccak=PlannedMode(
            PlannedCommit(seg_impl=self.rec["storage"], device=dev)))
        kwargs = {
            "A": dict(executor=ResidentExecutor(seg_impl=self.rec["A"],
                                                device=dev),
                      lean_rows=True, pipeline_depth=2,
                      device_timeout=timeout),
            "B": dict(executor=ResidentExecutor(seg_impl=self.rec["B"],
                                                device=dev),
                      template_residency=True, device_timeout=timeout),
            "C": dict(prefer_host=True),
        }
        self.m, self.db, self.writer, self.genesis = {}, {}, {}, {}
        for name in ("A", "B", "C"):
            t0 = time.perf_counter()
            m = ResidentAccountMirror(items, device=dev, **kwargs[name])
            wall = (time.perf_counter() - t0) * 1e3
            self.m[name] = m
            db = Database(self.tdb)
            db.mirror = m
            self.db[name] = db
            self.writer[name] = ResidentTrieWriter(
                self.tdb, m, commit_interval=self.INTERVAL if name == "A"
                else 0)
            win = (window_ms(dev, m.ex.last_events)
                   if m.ex is not None else None)
            self.genesis[name] = (m.root_of(m.GENESIS), wall, win,
                                  m.trie.last_plan_ms, m.trie.last_export_ms)
        self.exports = []  # (nodes, ms) of A's exports
        export = self.m["A"].export_to

        def timed_export(*a, **kw):
            t0 = time.perf_counter()
            n = export(*a, **kw)
            self.exports.append((n, (time.perf_counter() - t0) * 1e3))
            return n
        self.m["A"].export_to = timed_export
        self.ms = defaultdict(lambda: defaultdict(list))
        self.events, self.h2d = [], []

    def commit(self, name, parent_root, parent_h, h, number, ops,
               expected=None):
        """One block on one mirror: a StateDB at parent_root on the
        mirror, `ops` applied, StateDB.commit(block_hash=h,
        parent_block_hash=parent_h), the writer's insert_trie. Returns the
        root (A's is the expected root while it is in flight)."""
        ms = self.ms[name]
        t0 = time.perf_counter()
        sdb = StateDB(parent_root, self.db[name])
        check(getattr(sdb.trie, "resident", False),
              f"mirror {name}: StateDB at {parent_root.hex()} is not on the "
              f"mirror")
        ops(sdb)
        t1 = time.perf_counter()
        sdb.trie.expected_root = expected
        root = sdb.commit(True, block_hash=h, parent_block_hash=parent_h)
        t2 = time.perf_counter()
        self.writer[name].insert_trie(_Blk(number, root, h))
        ms["ops"].append((t1 - t0) * 1e3)
        ms["commit"].append((t2 - t1) * 1e3)
        ms["writer"].append((time.perf_counter() - t2) * 1e3)
        if name == "A":
            self.events.append(self.m["A"].ex.last_events)
            self.h2d.append(self.m["A"].ex.h2d_bytes)
        return root

    def accept(self, number, root, h):
        for name in self.NAMES:
            t0 = time.perf_counter()
            self.writer[name].accept_trie(_Blk(number, root, h))
            self.ms[name]["writer"].append((time.perf_counter() - t0) * 1e3)

    def reject(self, number, root, h):
        for name in self.NAMES:
            self.writer[name].reject_trie(_Blk(number, root, h))


def sibling_ops(world: World, rng, n_old=300, n_new=50):
    """A sibling block's StateDB operations: new balances and nonces on
    `n_old` plain accounts and `n_new` new accounts, kept apart from the
    world and the oracle (the block is rejected)."""
    picks = [int(i) for i in rng.choice(
        np.arange(len(world.storage), len(world.addrs)), n_old,
        replace=False)]
    vals = [(int(rng.integers(1, 1 << 62)), int(rng.integers(1, 1 << 20)))
            for _ in picks]
    new = [rng.bytes(20) for _ in range(n_new)]

    def ops(sdb):
        for i, (bal, nonce) in zip(picks, vals):
            sdb.set_balance(world.addrs[i], bal)
            sdb.set_nonce(world.addrs[i], nonce)
        for a in new:
            sdb.add_balance(a, 1)
        sdb.finalise(True)
    return ops


def phase_mirror(dev, world: World, oracle: Oracle, diskdb, gen_block,
                 block1, want1, n_blocks, rejected_at, seed):
    """The mirror phase (module docstring, phase 9). Returns (MirrorRun, K1
    launches, of them cooperative, the recorders' genesis record counts)."""
    t0 = time.perf_counter()
    items = list(iterate_leaves(TrieDatabase(diskdb).open_trie(
        gen_block.root)))
    log(f"mirror boot: one ordered leaf scan (iterate_leaves) of the planned "
        f"genesis' persisted account trie: {len(items)} items in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    check(len(items) == len(world.addrs),
          f"mirror boot: {len(items)} leaves for {len(world.addrs)} accounts")
    warm_up_resident(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    keccak_cuda.reset_counts()
    planned_mod.planned_fallbacks = 0
    loud = loud_counts()
    t_phase = time.perf_counter()
    run = MirrorRun(dev, diskdb, items, timeout=60.0)
    del items
    n_genesis = {k: len(r.records) for k, r in run.rec.items()}
    for name in ("A", "B", "C"):
        root, wall, win, plan, export = run.genesis[name]
        check(root == gen_block.root, f"mirror {name}: genesis root "
              f"{root.hex()} != oracle {gen_block.root.hex()}")
        log(f"mirror {name} genesis: root == oracle; construction and genesis "
            f"commit wall {wall:.1f} ms (native plan {plan:.1f} ms, export "
            f"{export:.1f} ms), device window (first upload to store scatter, "
            f"CUDA events) {fmt_window(win)}")
    ex = run.m["A"].ex
    log(f"mirror A genesis: h2d {ex.h2d_bytes} B, lean rows "
        f"{ex.last_lean_rows}; store + arenas on the device "
        f"{ex.device_bytes()} B")

    addrs = world.addrs
    parent_root, parent_h, number = gen_block.root, gen_block.hash(), 0
    written = defaultdict(set)  # contract -> slot keys the blocks wrote
    pending = []  # (number, root, hash) verified, not yet accepted
    lag = 2  # blocks verified ahead of the accepted one
    last_touched = ()
    rng = np.random.default_rng(seed)
    spans.tracer.clear()
    spans.set_enabled(True)
    with _GcPauses() as pauses:
        for number in range(1, n_blocks + 2):
            h = block_hash(number)
            if number == 1:
                accounts, writes, transfers = block1
                want = want1
            else:
                accounts, writes, transfers = make_block(world)
                oracle.apply(accounts, writes)
                want = oracle.root()

            def ops(sdb, transfers=transfers, writes=writes):
                apply_block(sdb, addrs, transfers, writes)
            for name in run.NAMES:
                expected = want if name == "A" and number > 1 else None
                root = run.commit(name, parent_root, parent_h, h, number, ops,
                                  expected)
                check(root == want, f"mirror {name} block {number}: root "
                      f"{root.hex()} != oracle {want.hex()}")
            if number == rejected_at:
                sib_h = keccak256(b"sibling %d" % number)
                sib_ops = sibling_ops(world, rng)
                roots = {name: run.commit(name, parent_root, parent_h, sib_h,
                                          number, sib_ops)
                         for name in run.NAMES}
                check(len(set(roots.values())) == 1
                      and roots["C"] not in (parent_root, want),
                      f"mirror sibling {number}: roots {roots}")
                run.reject(number, roots["C"], sib_h)
                log(f"mirror block {number}: sibling verified on A, B and C "
                    f"(root {roots['C'].hex()}, equal) and rejected through "
                    f"ResidentTrieWriter.reject_trie")
            for c, w in writes.items():
                written[c].update(w)
            last_touched = accounts
            pending.append((number, want, h))
            while len(pending) > lag:
                run.accept(*pending.pop(0))
            parent_root, parent_h = want, h
        for p in pending:
            run.accept(*p)
        t0 = time.perf_counter()
        run.writer["A"].shutdown()
        shutdown_ms = (time.perf_counter() - t0) * 1e3
    phase_s = time.perf_counter() - t_phase
    spans.set_enabled(False)
    span_ms = defaultdict(list)
    for sp in spans.tracer.snapshot(clear=True):
        where = " (host)" if sp.attrs.get("host_mode") else ""
        span_ms[sp.name + where].append(sp.duration() * 1e3)
    check(span_ms["resident/commit"] and span_ms["state/hash_plan/storage"],
          f"mirror: spans recorded {sorted(span_ms)}")
    launches, coop = keccak_cuda.launches, keccak_cuda.launches_coop
    counts = {k: len(r.records) for k, r in run.rec.items()}
    check(dev.type != "cuda" or launches == sum(counts.values()),
          f"mirror: {launches} K1 launches, {counts} recorded")
    check(planned_mod.planned_fallbacks == 0, "mirror: planned fallback")
    want_exports = (n_blocks + 1) // run.INTERVAL + 1  # intervals, shutdown
    check(len(run.exports) == want_exports,
          f"mirror A: {len(run.exports)} exports, not {want_exports}")
    log(f"mirror blocks 1-{n_blocks + 1}: every root of A, B and C == the "
        f"oracle's (A pipelined at depth 2 from block 2, accepted {lag} "
        f"blocks behind; B template; C native host; a sibling at block "
        f"{rejected_at} rejected); phase {phase_s:.1f} s")
    log(f"mirror: garbage collector pauses during the blocks ({pauses})")
    log("mirror spans (host wall, serial commits only: A's pipelined "
        "dispatches open none): " + "; ".join(
            f"{name} {stats(ms)}" for name, ms in sorted(span_ms.items())))
    for name in run.NAMES:
        ms = run.ms[name]
        log(f"mirror {name} per block: StateDB operations {stats(ms['ops'])}; "
            f"StateDB.commit {stats(ms['commit'])}; ResidentTrieWriter "
            f"(insert, accept, reject) {stats(ms['writer'])}")
    windows = [w for w in (window_ms(dev, e) for e in run.events[1:])
               if w is not None]
    log(f"mirror A per commit: h2d {stats(run.h2d, 'B')}; device window "
        f"(first upload to store scatter, CUDA events) "
        f"{stats([w[1] for w in windows])}, of which upload "
        f"{stats([w[0] for w in windows])}; last_overlap_fraction "
        f"{run.m['A'].last_overlap_fraction:.4f}")
    log(f"mirror A exports (commit_interval {run.INTERVAL}, then shutdown "
        f"{shutdown_ms:.1f} ms): " + "; ".join(
            f"{n} nodes in {ms:.1f} ms" for n, ms in run.exports))
    read_back(world, diskdb, parent_root, last_touched, written, seed + 7,
              "mirror A export")
    t0 = time.perf_counter()
    check(run.m["A"].spot_check(), "mirror A: spot_check failed")
    log(f"mirror A: spot_check passed in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    for name in ("A", "B"):
        check(not run.m[name].host_mode, f"mirror {name} ended in host mode")
    now = loud_counts()
    for name in LOUD:
        check(now[name] == loud[name], f"mirror: {name} counted "
              f"{now[name] - loud[name]}")
    peak = ("not measured (cpu)" if dev.type != "cuda" else
            f"{torch.cuda.max_memory_allocated(dev)} B")
    log(f"mirror: K1 launches {launches} (cooperative {coop}): A's executor "
        f"{counts['A']}, B's {counts['B']}, the storage programs "
        f"{counts['storage']}; no wedge, takeover, fallback or divergence "
        f"counted; peak device memory allocated {peak}")
    return run, launches, coop, n_genesis


class _Wedgeable:
    """A ResidentExecutor stand-in for the watchdog drill: forwards to a
    real executor, and once armed its next run waits on an event that the
    drill sets only after the watchdog has given up."""

    def __init__(self, ex):
        self._ex = ex
        self.armed = False
        self.release = threading.Event()

    def run(self, export):
        if self.armed:
            self.armed = False
            self.release.wait()
        return self._ex.run(export)

    def __getattr__(self, name):
        return getattr(self._ex, name)


def phase_watchdog_drill(dev, seed: int, timeout: float = 2.0) -> None:
    """A 2,000-key mirror on the device whose executor hangs once: the
    watchdog gives up after `timeout` and the commit raises
    DeviceWedgedError, the applied stack unchanged and nothing moved to the
    host. The drill then asks for the host (take_over_host), and that block
    and the rest verify with the host twin's roots: one wedge and one
    takeover counted. The released worker then finishes its run on the
    device from its own thread."""
    rng = np.random.default_rng(seed)
    items = [(rng.bytes(32), rng.bytes(int(n)))
             for n in rng.integers(1, 120, 2000)]
    wedge = _Wedgeable(ResidentExecutor(device=dev))
    d = ResidentAccountMirror(items, executor=wedge, device_timeout=timeout)
    twin = ResidentAccountMirror(items, prefer_host=True)
    before = loud_counts()
    parent = d.GENESIS
    t0 = time.perf_counter()
    for i in range(4):
        h = bytes([i + 1]) * 32
        batch = [(k, rng.bytes(40)) for k, _ in items[50 * i:50 * i + 50]]
        want = twin.verify(parent, h, batch)
        if i == 1:
            wedge.armed = True
            try:
                d.verify(parent, h, batch)
                raised = False
            except DeviceWedgedError:
                raised = True
            check(raised and d.head == parent and d.root_of(h) is None
                  and not d.host_mode,
                  f"watchdog drill: raised {raised}, head moved "
                  f"{d.head != parent}, host_mode {d.host_mode}")
            d.take_over_host("watchdog drill")
        check(d.verify(parent, h, batch) == want,
              f"watchdog drill block {i}: root != the host twin's")
        d.accept(h)
        twin.accept(h)
        parent = h
    wall = (time.perf_counter() - t0) * 1e3
    wedge.release.set()
    for t in threading.enumerate():
        if t.name.startswith("wd-"):
            t.join(60)
            check(not t.is_alive(), f"watchdog drill: {t.name} still runs")
    now = loud_counts()
    counted = {name: now[name] - before[name] for name in LOUD}
    check(counted == {LOUD[0]: 1, LOUD[1]: 1, LOUD[2]: 0, LOUD[3]: 0}
          and d.host_mode, f"watchdog drill: counted {counted}, host_mode "
          f"{d.host_mode}")
    log(f"watchdog drill: one hang of {timeout:g} s on the executor's run: "
        f"DeviceWedgedError with the stack unchanged, then take_over_host "
        f"(1 wedge, 1 takeover counted), 4 roots == the host twin's "
        f"({wall:.1f} ms)")


# ------------------------------------------------------------ the EVM phase

class _EvmTx:
    """One signed transaction of the EVM phase and what it must do: the
    sender's and receiver's account indices, the value and, for a contract
    call, the slots its calldata writes."""

    __slots__ = ("blob", "sender", "to", "value", "writes")

    def __init__(self, blob, sender, to, value, writes):
        self.blob, self.sender, self.to = blob, sender, to
        self.value, self.writes = value, writes


def evm_transactions(world: World, n_blocks: int, seed: int,
                     n_calls: int = EVM_CALLS, n_transfers=None):
    """Signed transactions of `n_blocks` blocks on TEST_CHAIN_CONFIG (type 2,
    tip 0, fee cap EVM_MAX_FEE), planned against `world` as it stands: per
    block `n_calls` calls to distinct seeded contracts, each writing
    EVM_WRITES slots (half existing, half new) and logging once, spread
    evenly among transfers of seeded values from keyed senders to seeded
    plain accounts; by default the transfers fill the block to EVM_FILL of
    its gas limit. The keyed senders sign in turn, each at its next nonce.
    Returns [[_EvmTx]] per block."""
    cfg = params.TEST_CHAIN_CONFIG
    signer = Signer(cfg.chain_id)
    rng = np.random.default_rng(seed)
    n, n_contracts = len(world.addrs), len(world.storage)
    lo = n_contracts + len(world.keyed)
    receivers = np.arange(lo if lo < n else n_contracts, n)
    nonces = {i: world.nonce[i] for i, _ in world.keyed}
    n_calls = min(n_calls, n_contracts)
    if n_transfers is None:
        n_transfers = (int(EVM_FILL * params.CORTINA_GAS_LIMIT)
                       - n_calls * EVM_CALL_PLAN) // 21000
    total = n_calls + n_transfers
    blocks = []
    for _ in range(n_blocks):
        contracts = rng.choice(n_contracts, n_calls, replace=False)
        call_at = {round(j * total / n_calls): int(c)
                   for j, c in enumerate(contracts)}
        txs = []
        for pos in range(total):
            i, key = world.keyed[(len(blocks) * total + pos)
                                 % len(world.keyed)]
            writes, data, value, gas = None, b"", 0, 21000
            if pos in call_at:
                to = call_at[pos]
                old = list(world.storage[to])
                writes = {old[int(k)]: b"\x04" + rng.bytes(31)
                          for k in rng.choice(len(old), min(
                              EVM_WRITES // 2, len(old)), replace=False)}
                while len(writes) < EVM_WRITES:
                    k = normalize_state_key(rng.bytes(32))
                    if k not in world.storage[to]:
                        writes[k] = b"\x05" + rng.bytes(31)
                data = b"".join(k + v for k, v in writes.items())
                gas = EVM_CALL_GAS
            else:
                to = int(rng.choice(receivers))
                value = int(rng.integers(1, 10**15))
            tx = Transaction(type=2, chain_id=cfg.chain_id, nonce=nonces[i],
                             max_priority_fee=0, max_fee=EVM_MAX_FEE,
                             gas=gas, to=world.addrs[to], value=value,
                             data=data)
            nonces[i] += 1
            txs.append(_EvmTx(signer.sign(tx, key).encode(), i, to, value,
                              writes))
        blocks.append(txs)
    return blocks


def evm_oracle_block(world: World, oracle: Oracle, txs, receipts, base_fee,
                     coinbase: list, coinbase_addr: bytes = EVM_COINBASE):
    """The block's post-state root from its transaction list, each
    receipt's gas_used and the header's base fee, with no EVM: the sender
    pays value + gas_used x price (tip 0: the price is the base fee) and
    its nonce goes up by one, the receiver gets the value, the coinbase
    (`coinbase_addr`) the fees (coinbase[0], updated), the contract's slots
    take the calldata's values. Applied to `world` and `oracle`. Returns
    (root, accounts touched, {contract: writes})."""
    price = min(EVM_MAX_FEE, base_fee)
    touched, writes = set(), defaultdict(dict)
    for tx, r in zip(txs, receipts):
        fee = r.gas_used * price
        world.balance[tx.sender] -= tx.value + fee
        world.nonce[tx.sender] += 1
        world.balance[tx.to] += tx.value
        if tx.writes:
            writes[tx.to].update(tx.writes)
        touched.update((tx.sender, tx.to))
        coinbase[0] += fee
    for c, w in writes.items():
        world.storage[c].update(w)
    oracle.apply(sorted(touched), writes)
    oracle.trie.update(keccak256(coinbase_addr),
                       Account(balance=coinbase[0]).encode())
    return oracle.root(), touched, writes


class _K2Recorder(_BlocksRecorder):
    """_BlocksRecorder that also keeps the variant each launch ran (none on
    the CPU)."""

    def __init__(self, launch=None):
        super().__init__(launch)
        self.ran = []

    def __call__(self, words, nblocks):
        coop = keccak_cuda.blocks_launches_coop
        out = super().__call__(words, nblocks)
        if words.is_cuda:
            self.ran.append(keccak_cuda.COOP
                            if keccak_cuda.blocks_launches_coop > coop
                            else keccak_cuda.THREAD)
        return out


def check_variants_k2(rec: _K2Recorder, label) -> dict:
    """check_variants for K2: each launch ran the variant its lane count
    calls for (cooperative up to K2's kCoopMaxLanes)."""
    check(len(rec.records) > 0, f"{label}: no K2 launch recorded")
    limit = keccak_cuda.K2.coop_max_lanes
    ran = defaultdict(int)
    for (words, _n, _out), v in zip(rec.records, rec.ran):
        want = (keccak_cuda.COOP if words.shape[0] <= limit
                else keccak_cuda.THREAD)
        check(v == want, f"{label}: B={words.shape[0]} ran variant {v}, "
              f"the shape calls for {want}")
        ran[v] += 1
    return dict(ran)


class _EvmTimed(_Timed):
    """_Timed with DeriveSha (Block.assemble's transaction and receipt
    roots) wrapped too."""

    METHODS = _Timed.METHODS + ((types_mod, "derive_sha"),)
    DERIVE_SHA = f"{types_mod.__name__}.derive_sha"


class _TimedEngine:
    """The dummy engine, its finalize_and_assemble timed: wall ms, the
    StateDB.intermediate_root ms inside it and the K1 and K2 launches it
    made."""

    def __init__(self, timed: _Timed):
        self.engine = new_dummy_engine()
        self.timed = timed
        self.ms = self.root_ms = 0.0
        self.k1 = self.k2 = 0

    def finalize_and_assemble(self, *a, **kw):
        ir = self.timed.ms["StateDB.intermediate_root"]
        k1, k2 = keccak_cuda.launches, keccak_cuda.blocks_launches
        t0 = time.perf_counter()
        block = self.engine.finalize_and_assemble(*a, **kw)
        self.ms = (time.perf_counter() - t0) * 1e3
        self.root_ms = self.timed.ms["StateDB.intermediate_root"] - ir
        self.k1 = keccak_cuda.launches - k1
        self.k2 = keccak_cuda.blocks_launches - k2
        return block


class EvmRun:
    """One mode's chain: the blocks, their receipts, its TrieDatabase, the
    kernel recorder (planned: K1, batched: K2) and the run's launches."""

    def __init__(self, mode, tdb, rec):
        self.mode, self.tdb, self.rec = mode, tdb, rec
        self.blocks, self.receipts = [], []
        self.k1 = self.k1_coop = self.k2 = self.k2_coop = self.pad = 0


def evm_mode_run(dev, mode, world: World, diskdb, gen_block, signed, card):
    """`signed` through generate_chain, one block a call, from the planned
    genesis on a TrieDatabase of the mode's own over `diskdb`: "off" (no
    marker: the CPU Hasher), "batched" (get_batch_keccak("batched"), its
    BatchedKeccak's impl a recorder that launches K2) or "planned" (the
    planned marker over a PlannedCommit whose seg_impl launches K1 and
    records). Each block decodes its transactions anew, recovers their
    senders in one native batch (Signer.sender_batch, the sender cacher's
    seam) and adds them through BlockGen.add_tx. Counts are zeroed before
    the run and read after it. Logs each block's split."""
    cfg = params.TEST_CHAIN_CONFIG
    rec, marker = None, None
    if mode == "planned":
        rec = _K1Recorder()
        marker = PlannedMode(PlannedCommit(seg_impl=rec, device=dev))
    elif mode == "batched":
        rec = _K2Recorder()
        marker = get_batch_keccak("batched", dev)
        marker.batched.impl = rec
    tdb = TrieDatabase(diskdb, batch_keccak=marker)
    db = Database(tdb)
    run = EvmRun(mode, tdb, rec)
    signer = Signer(cfg.chain_id)
    keccak_cuda.reset_counts()
    planned_mod.planned_fallbacks = 0
    parent = gen_block
    for txs in signed:
        ms = {}
        if mode == "batched":
            marker.batched.reset_totals()

        def gen(_i, bg, txs=txs, ms=ms):
            t0 = time.perf_counter()
            decoded = [Transaction.decode(t.blob) for t in txs]
            t1 = time.perf_counter()
            signer.sender_batch(decoded)
            t2 = time.perf_counter()
            check([signer.sender(tx) for tx in decoded]
                  == [world.addrs[t.sender] for t in txs],
                  f"evm {mode}: a recovered sender differs")
            t3 = time.perf_counter()
            for tx in decoded:
                bg.add_tx(tx)
            ms.update(decode=(t1 - t0) * 1e3, recover=(t2 - t1) * 1e3,
                      evm=(time.perf_counter() - t3) * 1e3)

        k1, k2 = keccak_cuda.launches, keccak_cuda.blocks_launches
        k1c, k2c = keccak_cuda.launches_coop, keccak_cuda.blocks_launches_coop
        with _EvmTimed() as timed, _GcPauses() as pauses:
            engine = _TimedEngine(timed)
            t0 = time.perf_counter()
            (block,), (receipts,) = generate_chain(cfg, parent, engine, db, 1,
                                                   gen=gen)
            wall = (time.perf_counter() - t0) * 1e3
        k1 = keccak_cuda.launches - k1
        k2 = keccak_cuda.blocks_launches - k2
        run.k1, run.k2 = run.k1 + k1, run.k2 + k2
        run.k1_coop += keccak_cuda.launches_coop - k1c
        run.k2_coop += keccak_cuda.blocks_launches_coop - k2c
        commit_ms = timed.ms["StateDB.commit"]
        win = "host (CPU Hasher)"
        if mode == "planned":
            pc = marker.commit
            win = ("not measured (cpu)" if pc.last_device_ms is None else
                   f"{pc.last_device_ms:.3f} ms (upload "
                   f"{pc.last_upload_ms:.3f} ms), last planned program")
        elif mode == "batched":
            bk = marker.batched
            run.pad += bk.padded_lanes - bk.lanes
            win = ("not measured (cpu)" if bk.device_ms is None else
                   f"{bk.device_ms:.3f} ms over {bk.calls} level batches")
        timed_ms = ms["recover"] + ms["evm"] + engine.ms + commit_ms
        gas = block.header.gas_used
        log(f"evm {mode} block {block.number}: {len(txs)} transactions, gas "
            f"used {gas} of {block.header.gas_limit} "
            f"({100 * gas / block.header.gas_limit:.1f}%); decode "
            f"{ms['decode']:.1f} ms, sender recovery (native batch) "
            f"{ms['recover']:.1f} ms, EVM execution {ms['evm']:.1f} ms, "
            f"finalize_and_assemble {engine.ms:.1f} ms (intermediate_root "
            f"{engine.root_ms:.1f} ms, derive_sha "
            f"{timed.ms[_EvmTimed.DERIVE_SHA]:.1f} ms; K1 launches "
            f"{engine.k1}, K2 launches {engine.k2}), StateDB.commit "
            f"{commit_ms:.1f} ms (K1 launches {k1 - engine.k1}, K2 launches "
            f"{k2 - engine.k2}); device window {win}; "
            f"{gas / timed_ms / 1e3:.3f} Mgas/s over recovery + EVM + "
            f"finalize_and_assemble + commit; generate_chain wall "
            f"{wall:.1f} ms; garbage collector pauses ({pauses}); {card}")
        run.blocks.append(block)
        run.receipts.append(receipts)
        parent = block
    if mode == "batched":
        marker.batched.impl = keccak_cuda.keccak256_blocks
    check(planned_mod.planned_fallbacks == 0, f"evm {mode}: planned fallback")
    cuda = dev.type == "cuda"
    if mode == "off":
        check(run.k1 == run.k2 == 0, f"evm off: K1 {run.k1}, K2 {run.k2}")
    elif mode == "planned":
        check(run.k2 == 0, f"evm planned: K2 launched {run.k2} times")
        check(not cuda or run.k1 == len(rec.records) > 0,
              f"evm planned: {run.k1} K1 launches, {len(rec.records)} "
              f"recorded")
    else:
        check(run.k1 == 0, f"evm batched: K1 launched {run.k1} times")
        check(not cuda or run.k2 == len(rec.records) > 0,
              f"evm batched: {run.k2} K2 launches, {len(rec.records)} "
              f"recorded")
    return run


def _block_summary(block, receipts):
    return (block.hash(), block.header.root, block.header.receipt_hash,
            block.header.bloom, block.header.gas_used, block.header.tx_hash,
            [r.encode() for r in receipts])


class _Overlay(KeyValueStore):
    """A store that reads through to `base` and keeps its own writes (and
    deletes) apart: the EVM phase's chains run over the genesis store
    without writing into it, so what the chain phase reads back there is
    what the chain itself wrote."""

    def __init__(self, base):
        self.base, self.top, self.gone = base, MemoryDB(), set()

    def get(self, key):
        if key in self.gone:
            return None
        v = self.top.get(key)
        return v if v is not None else self.base.get(key)

    def put(self, key, value):
        self.gone.discard(bytes(key))
        self.top.put(key, value)

    def delete(self, key):
        self.gone.add(bytes(key))
        self.top.delete(key)

    def write_batch(self, writes):
        for k, v in writes:
            if v is None:
                self.delete(k)
            else:
                self.put(k, v)

    def iterate(self, prefix=b"", start=b""):
        merged = dict(self.base.iterate(prefix, start))
        merged.update(self.top.iterate(prefix, start))
        for k in self.gone:
            merged.pop(k, None)
        yield from sorted(merged.items())


def phase_evm(dev, world: World, oracle: Oracle, diskdb, gen_block,
              n_blocks, n_option, seed, card):
    """The EVM phase (module docstring, phase 7b), over an _Overlay of the
    genesis store: `n_blocks` blocks in the three modes, and `n_option`
    more in planned mode alone (the chain phase's options blocks). `world`
    and `oracle` are genesis snapshots, which the phase advances. Returns
    the planned and batched EvmRuns, the world indices of every account
    the blocks touched, {contract: slot keys written} and the coinbase's
    fees."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    signed = evm_transactions(world, n_blocks + n_option, seed)
    log(f"evm: {sum(len(b) for b in signed)} transactions of "
        f"{n_blocks + n_option} blocks signed in "
        f"{time.perf_counter() - t0:.1f} s")
    store = _Overlay(diskdb)
    runs = {mode: evm_mode_run(
        dev, mode, world, store, gen_block,
        signed if mode == "planned" else signed[:n_blocks], card)
        for mode in ("off", "batched", "planned")}
    coinbase = [0]
    touched_all, written = set(), defaultdict(set)
    t0 = time.perf_counter()
    for b, txs in enumerate(signed):
        held = runs if b < n_blocks else {"planned": runs["planned"]}
        first = next(iter(held.values()))
        block, receipts = first.blocks[b], first.receipts[b]
        check(all(r.status == 1 for r in receipts),
              f"evm block {block.number}: a transaction failed")
        for tx, r in zip(txs, receipts):
            want_logs = []
            if tx.writes:
                k, v = next(iter(tx.writes.items()))
                want_logs = [(world.addrs[tx.to],
                              [b"\x00" * 12 + world.addrs[tx.sender]], k + v)]
            check([(lg.address, lg.topics, lg.data) for lg in r.logs]
                  == want_logs,
                  f"evm block {block.number}: logs of a transaction")
        gas = block.header.gas_used
        check(gas >= 0.9 * block.header.gas_limit,
              f"evm block {block.number}: gas used {gas} below 90% of "
              f"{block.header.gas_limit}")
        want, touched, writes = evm_oracle_block(
            world, oracle, txs, receipts, block.header.base_fee, coinbase)
        touched_all |= touched
        for c, w in writes.items():
            written[c].update(w)
        summary = _block_summary(block, receipts)
        for mode, run in held.items():
            got = _block_summary(run.blocks[b], run.receipts[b])
            check(got == summary, f"evm {mode} block {block.number}: block "
                  f"hash, roots, bloom, gas used or receipts differ from off")
            check(run.blocks[b].header.root == want,
                  f"evm {mode} block {block.number}: root "
                  f"{run.blocks[b].header.root.hex()} != oracle {want.hex()}")
        log(f"evm block {block.number}: {', '.join(held)} give block "
            f"{block.hash().hex()}, root {want.hex()} == the EVM-independent "
            f"oracle's, {len(txs)} receipts, gas used {gas}, base fee "
            f"{block.header.base_fee}")
    log(f"evm: oracle over {n_blocks + n_option} blocks in "
        f"{time.perf_counter() - t0:.1f} s")
    planned = runs["planned"]
    last = planned.blocks[-1].header.root
    t0 = time.perf_counter()
    planned.tdb.commit(last)
    log(f"evm planned: TrieDatabase.commit of the last root "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    read_back(world, store, last, sorted(touched_all), written, seed + 1,
              "evm planned")
    back = StateDB(last, Database(TrieDatabase(store)))
    check(back.get_balance(EVM_COINBASE) == coinbase[0],
          "evm planned: read-back of the coinbase's fees")
    if dev.type == "cuda":
        k1_ran = check_variants(planned.rec, "evm planned")
        k2_ran = check_variants_k2(runs["batched"].rec, "evm batched")
        log(f"evm: every K1 launch (planned) and K2 launch (batched) ran the "
            f"variant its shape calls for: K1 " + ", ".join(
                f"{VARIANT_NAME[v]} {n}" for v, n in k1_ran.items())
            + "; K2 " + ", ".join(f"{VARIANT_NAME[v]} {n}"
                                  for v, n in k2_ran.items()))
    log(f"evm: K1 launches (planned) {planned.k1} (cooperative "
        f"{planned.k1_coop}), K2 launches (batched) {runs['batched'].k2} "
        f"(cooperative {runs['batched'].k2_coop}); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return planned, runs["batched"], sorted(touched_all), written, coinbase[0]


LOUD_CHAIN = LOUD + ("chain/mirror/quarantines",)
# a speculative mode that quietly ran serial: each must stay 0
OPTION_FALLBACKS = ("exec/parallel/fallbacks", "exec/shard/fallbacks",
                    "chain/pipeline/serial_fallbacks",
                    "chain/pipeline/spec_aborts")
SERIAL_PHASES = {"recover", "verify", "execute", "validate", "commit",
                 "write"}


def _env_knob(name, value):
    """While open: one environment override of an execution option (the
    reference reads them per block)."""
    return mock.patch.dict(os.environ, {name: str(value)})


def _fmt_parallel(stats) -> str:
    keys = ("workers", "shards", "conflicts", "reexecs", "deps", "fallback")
    return f"mode {stats.get('mode')} (" + ", ".join(
        f"{k} {stats[k]}" for k in keys if k in stats) + ")"


def _fmt_workers(per_worker) -> str:
    return "; ".join(
        f"worker {w}: {row['txs']} txs, {row['spec_failures']} speculative "
        f"failures, {row['pipe_reads']} pipe reads, execute "
        f"{row['execute_seconds'] * 1e3:.1f} ms (pipe wait "
        f"{row['pipe_wait_seconds'] * 1e3:.1f} ms)"
        for w, row in sorted(per_worker.items()))


def phase_chain(dev, chain, evm_blocks, n_serial, card):
    """The chain phase (module docstring, phase 7c): the EVM phase's blocks,
    decoded anew, into the chain built with insert_pipeline_depth=2. The
    first `n_serial` through insert_block_manual(writes=True), the serial
    path (sender recovery, StateProcessor.process, validate_state,
    StateDB.commit: the storage tries in one planned program on K1, the
    account trie on the resident mirror's executor on K1); then the
    options blocks: one with CORETH_TPU_EVM_PARALLEL=4 and one with
    CORETH_TPU_EVM_EXEC_SHARDS=2 through insert_block_manual, and the rest
    through insert_block, so through the pipeline, back to back with the
    shards on (the submit stage speculates through the shard pool; the
    commit thread launches K1). Then set_preference, accept and the
    acceptor queue drained (the VM phase follows on the same chain, and
    finish_chain stops it). The chain's planned marker and its executor
    launch K1 through recorders. Returns (the storage programs' recorder,
    the executor's, K1 launches, of them cooperative, the mirror's exports
    as (nodes, ms), its shutdown export appended at vm.shutdown())."""
    t_phase = time.perf_counter()
    rec_storage, rec_resident = _K1Recorder(), _K1Recorder()
    tdb = chain.state_database.triedb
    tdb.batch_keccak = PlannedMode(PlannedCommit(seg_impl=rec_storage,
                                                 device=dev))
    mirror = chain.mirror
    mirror.ex.seg_impl = rec_resident
    exports = []
    export = mirror.export_to

    def timed_export(*a, **kw):
        t0 = time.perf_counter()
        n = export(*a, **kw)
        exports.append((n, (time.perf_counter() - t0) * 1e3))
        return n
    mirror.export_to = timed_export
    # the pipeline's commit stage, tapped: its wall, the mirror's events and
    # the K1 launches it made, per block (only the commit thread launches)
    taps = {}
    commit_entry = chain.pipeline._commit_entry

    def tapped(entry):
        ns, nr = len(rec_storage.records), len(rec_resident.records)
        t0 = time.perf_counter()
        try:
            return commit_entry(entry)
        finally:
            taps[entry.hash] = (time.perf_counter() - t0,
                                mirror.ex.last_events,
                                len(rec_storage.records) - ns,
                                len(rec_resident.records) - nr)
    chain.pipeline._commit_entry = tapped
    blocks = [Block.decode(b.encode()) for b in evm_blocks]
    check(len(blocks) >= n_serial + 4,
          f"chain: {len(blocks)} blocks for {n_serial} serial ones, one "
          f"thread-parallel, one sharded and at least two pipelined")
    loud = {n: default_registry.counter(n).count()
            for n in LOUD_CHAIN + OPTION_FALLBACKS}
    keccak_cuda.reset_counts()
    planned_mod.planned_fallbacks = 0
    insert_s = gas_all = 0.0
    asked = {}
    with _GcPauses() as pauses:
        # blocks 1..n_serial, then one thread-parallel and one sharded:
        # the serial path, back to back, as a validator inserts (block k's
        # insert tail, its rawdb writes and snapshot attach on the tail
        # thread, overlaps block k+1's insert; the flight records' `write`
        # phase is stamped when each tail lands, so they are read after
        # one join_tail())
        done = []
        for i, b in enumerate(blocks[:n_serial + 2]):
            knob = (None if i < n_serial else
                    ("CORETH_TPU_EVM_PARALLEL", OPTION_WORKERS)
                    if i == n_serial else
                    ("CORETH_TPU_EVM_EXEC_SHARDS", OPTION_SHARDS))
            asked[b.hash()] = ("serial" if knob is None else
                               "parallel" if i == n_serial else "shards")
            ns, nr = len(rec_storage.records), len(rec_resident.records)
            with (_env_knob(*knob) if knob else contextlib.nullcontext()):
                t0 = time.perf_counter()
                chain.insert_block_manual(b, writes=True)
                wall = time.perf_counter() - t0
            win = window_ms(dev, mirror.ex.last_events)
            chain.set_preference(b)
            check(chain.current_block.hash() == b.hash(),
                  f"chain block {b.number}: not the head after its insert")
            check(mirror.root_of(b.hash()) == b.header.root,
                  f"chain block {b.number}: mirror root != header root")
            done.append((b, wall, win, len(rec_storage.records) - ns,
                         len(rec_resident.records) - nr))
        # the rest through the pipeline, back to back, shards on: each
        # submit recovers, verifies and speculates (through the shard
        # pool) while the commit thread lands the block before it
        piped = blocks[n_serial + 2:]
        submits = []
        with _env_knob("CORETH_TPU_EVM_EXEC_SHARDS", OPTION_SHARDS):
            t_pipe = time.perf_counter()
            for b in piped:
                asked[b.hash()] = "spec"
                t0 = time.perf_counter()
                chain.insert_block(b)
                submits.append(time.perf_counter() - t0)
            chain.pipeline.drain()
            pipe_s = time.perf_counter() - t_pipe
            pool = chain.processor.shard_pool()
            pongs = pool.ping()
        chain.set_preference(piped[-1])
        check(chain.current_block.hash() == piped[-1].hash(),
              "chain: the last pipelined block is not the head")
        for b in piped:
            check(mirror.root_of(b.hash()) == b.header.root,
                  f"chain block {b.number}: mirror root != header root")
        t0 = time.perf_counter()
        chain.join_tail()
        tail_ms = (time.perf_counter() - t0) * 1e3
        log(f"chain: the last insert tail landed {tail_ms:.1f} ms after the "
            f"last insert returned")
        for b, wall, win, n_storage, n_resident in done:
            rec = chain.flight_recorder.find(b.hash())
            phases = rec["phases"]
            check(set(phases) == SERIAL_PHASES,
                  f"chain block {b.number}: flight record phases "
                  f"{sorted(phases)}")
            want = asked[b.hash()]
            check(rec["parallel"].get("mode") == want
                  and not rec["parallel"].get("fallback"),
                  f"chain block {b.number}: asked for {want}, ran "
                  f"{rec['parallel']}")
            gas = b.header.gas_used
            insert_s += wall
            gas_all += gas
            extra = ""
            if want != "serial":
                extra = (f"mode asked {want}, run "
                         f"{_fmt_parallel(rec['parallel'])}"
                         + (f"; {_fmt_workers(rec['parallel']['per_worker'])}"
                            if "per_worker" in rec["parallel"] else "")
                         + "; ")
            log(f"chain block {b.number}: {extra}insert_block_manual "
                f"{wall * 1e3:.1f} ms ({len(b.transactions)} transactions, "
                f"gas used {gas}; {gas / wall / 1e6:.3f} Mgas/s over the "
                f"insert); flight record phases (ms) " + ", ".join(
                    f"{k} {v * 1e3:.1f}" for k, v in phases.items())
                + f"; resident timers (ms) " + ", ".join(
                    f"{k} {v * 1e3:.1f}" for k, v in rec["resident"].items()
                    if k != "shards")
                + f"; mirror device window {fmt_window(win)}; K1 launches: "
                f"storage programs {n_storage}, resident executor "
                f"{n_resident}; snapshot hits/misses "
                f"{rec['counters']['state/snap/hits']}/"
                f"{rec['counters']['state/snap/misses']}; {card}")
        pipe_gas = 0
        for b, submit in zip(piped, submits):
            rec = chain.flight_recorder.find(b.hash())
            phases, par, pipe = rec["phases"], rec["parallel"], rec["pipeline"]
            check(set(phases) == SERIAL_PHASES | {"fold"},
                  f"chain block {b.number}: flight record phases "
                  f"{sorted(phases)}")
            check(pipe["mode"] == "spec" and pipe["depth"] == PIPELINE_DEPTH
                  and par["mode"] == "pipeline-spec"
                  and par["shards"] == OPTION_SHARDS,
                  f"chain block {b.number}: asked for the pipeline's spec "
                  f"mode through {OPTION_SHARDS} shards, ran {pipe}, {par}")
            commit_s, events, n_storage, n_resident = taps[b.hash()]
            gas = b.header.gas_used
            pipe_gas += gas
            log(f"chain block {b.number}: mode asked spec (pipeline depth "
                f"{PIPELINE_DEPTH}, CORETH_TPU_EVM_EXEC_SHARDS="
                f"{OPTION_SHARDS}), run {pipe['mode']} (submit stage "
                f"through {par['shards']} shards), overlap_fraction "
                f"{pipe['overlap_fraction']}; "
                f"{_fmt_workers(par['per_worker'])}; submit {submit * 1e3:.1f}"
                f" ms, commit stage {commit_s * 1e3:.1f} ms "
                f"({len(b.transactions)} transactions, gas used {gas}; "
                f"{gas / commit_s / 1e6:.3f} Mgas/s over the commit stage); "
                f"flight record phases (ms) " + ", ".join(
                    f"{k} {v * 1e3:.1f}" for k, v in phases.items())
                + f"; mirror device window "
                f"{fmt_window(window_ms(dev, events))}; K1 launches from "
                f"the commit thread: storage programs {n_storage}, resident "
                f"executor {n_resident}; {card}")
        log(f"chain: {len(piped)} pipelined blocks from the first submit to "
            f"the drain {pipe_s * 1e3:.1f} ms ({pipe_gas / pipe_s / 1e6:.3f}"
            f" Mgas/s over it)")
        for p in pongs:
            check(p[4] is False and p[5] == [],
                  f"chain: shard worker {p[1]} (pid {p[2]}) initialised CUDA "
                  f"({p[4]}) or loaded {p[5]}")
        log("chain: shard workers " + ", ".join(
            f"{p[1]} (pid {p[2]}, inherited threads {p[3]})" for p in pongs)
            + ": no CUDA context, no jax, jaxlib or coreth_tpu module")
        # a respawn, as the pool makes one after a crash: the new worker is
        # forked from the forkserver, which has this script imported
        killed = pool.pids()[0]
        os.kill(killed, signal.SIGKILL)
        pool.workers[0].proc.join(10)
        t0 = time.perf_counter()
        respawned = pool.respawn_failed()
        pongs = pool.ping()
        respawn_ms = (time.perf_counter() - t0) * 1e3
        check(respawned == 1 and pool.pids()[0] != killed
              and all(p[4] is False and p[5] == [] for p in pongs),
              f"chain: shard respawn after a SIGKILL: {respawned} replaced, "
              f"pongs {pongs}")
        log(f"chain: shard respawn: worker 0 (pid {killed}) SIGKILLed, "
            f"respawn_failed and ping {respawn_ms:.1f} ms, new pid "
            f"{pool.pids()[0]}, clean; {card}")
        t0 = time.perf_counter()
        for b in blocks:
            chain.accept(b)
        chain.drain_acceptor_queue()
        accept_ms = (time.perf_counter() - t0) * 1e3
        check(chain.acceptor_error is None,
              f"chain: acceptor error {chain.acceptor_error}")
        check(chain.last_accepted.hash() == blocks[-1].hash(),
              "chain: the last accepted block is not the last block")
        check(not chain.bad_blocks, f"chain: bad blocks {chain.bad_blocks}")
        check(chain.snaps.disk_layer.root == blocks[-1].header.root,
              "chain: the snapshot's disk layer is not at the last root")
    launches, coop = keccak_cuda.launches, keccak_cuda.launches_coop
    check(planned_mod.planned_fallbacks == 0, "chain: planned fallback")
    check(keccak_cuda.blocks_launches == 0, "chain: K2 launched")
    cuda = dev.type == "cuda"
    check(not cuda or launches == len(rec_storage.records)
          + len(rec_resident.records) > 0,
          f"chain: {launches} K1 launches, {len(rec_storage.records)} + "
          f"{len(rec_resident.records)} recorded")
    check(rec_storage.records and rec_resident.records,
          "chain: K1 not launched by both the planned programs and the "
          "resident executor")
    if cuda:
        ran_s = check_variants(rec_storage, "chain storage programs")
        ran_r = check_variants(rec_resident, "chain resident executor")
        log("chain: every K1 launch ran the variant its shape calls for: "
            "storage programs " + ", ".join(
                f"{VARIANT_NAME[v]} {n}" for v, n in ran_s.items())
            + "; resident executor " + ", ".join(
                f"{VARIANT_NAME[v]} {n}" for v, n in ran_r.items()))
    now = {n: default_registry.counter(n).count()
           for n in LOUD_CHAIN + OPTION_FALLBACKS}
    for name in LOUD_CHAIN + OPTION_FALLBACKS:
        check(now[name] == loud[name], f"chain: {name} counted "
              f"{now[name] - loud[name]}")
    check(not mirror.host_mode, "chain: the mirror ended in host mode")
    log(f"chain: {len(done)} blocks through insert_block_manual in "
        f"{insert_s * 1e3:.1f} ms ({gas_all / insert_s / 1e6:.3f} Mgas/s), "
        f"{len(blocks)} accepted and the acceptor drained in "
        f"{accept_ms:.1f} ms; garbage collector pauses ({pauses}); no bad "
        f"block, no wedge, takeover, fallback, divergence or quarantine "
        f"counted; phase {time.perf_counter() - t_phase:.1f} s; {card}")
    return rec_storage, rec_resident, launches, coop, exports


def finish_chain(dev, vm, world: World, touched, written, coinbase_fee,
                 vm_coinbase_fee, exports, seed, card):
    """After the VM phase: vm.shutdown() (the block builder's timer, the
    chain's stop(): the pipeline, the shard pool, the acceptor, the insert
    tail, the ladder listener and the shutdown export), then the
    forkserver and the resource tracker (exec_shards.stop_servers), and no
    process the run started may be left; then the last accepted root reads
    back through a fresh TrieDatabase (every account and slot the EVM and
    VM blocks touched, the coinbase and 1,000 others) and the snapshot's
    accounts equal the trie's."""
    chain = vm.blockchain
    mirror = chain.mirror
    last = chain.last_accepted.header.root
    t0 = time.perf_counter()
    vm.shutdown()
    stop_ms = (time.perf_counter() - t0) * 1e3
    # the shard workers went with the chain; the forkserver they came
    # from and the resource tracker go now, and nothing is left
    t0 = time.perf_counter()
    exec_shards.stop_servers()
    servers_ms = (time.perf_counter() - t0) * 1e3
    left = descendants()
    check(not left, f"chain: processes left after vm.shutdown(): {left}")
    check(not mirror.host_mode, "chain: the mirror ended in host mode")
    check(exports and exports[-1][0] > 0, f"chain: shutdown export {exports}")
    log(f"chain: vm.shutdown() {stop_ms:.1f} ms, of it the shutdown export "
        + "; ".join(f"{n} nodes in {ms:.1f} ms" for n, ms in exports)
        + f"; the forkserver and the resource tracker stopped in "
        f"{servers_ms:.1f} ms, no process left")
    # the acknowledged writes: the last root through a fresh TrieDatabase
    with _GcPauses() as pauses:
        read_back(world, chain.diskdb, last, touched, written, seed, "chain")
    log(f"chain: garbage collector pauses during the read-back ({pauses})")
    back = StateDB(last, Database(TrieDatabase(chain.diskdb)))
    check(back.get_balance(EVM_COINBASE) == coinbase_fee
          and back.get_balance(VM_COINBASE) == vm_coinbase_fee,
          "chain: read-back of the coinbases' fees")
    # the snapshot's flat accounts against the trie's, every touched one
    trie = TrieDatabase(chain.diskdb).open_state_trie(last)
    addrs = [world.addrs[i] for i in touched] + [EVM_COINBASE, VM_COINBASE]
    for a in addrs:
        slim = chain.snaps.disk_layer.account(keccak256(a))
        blob = trie.get(a)
        check((_slim_to_account(slim) if slim else None)
              == (Account.decode(blob) if blob else None),
              f"chain: snapshot account {a.hex()} != the trie's")
    log(f"chain: the snapshot's accounts of the {len(addrs)} touched "
        f"addresses equal the trie's at the last root; {card}")


# the VM phase's atomic transactions (nAVAX): the UTXO the import consumes,
# what the export sends to the X chain, and what each burns (above its
# dynamic fee at these blocks' base fee)
VM_IMPORT = 5 * 10**9
VM_EXPORT = 3 * 10**9
VM_BURN = 10**9
VM_COINBASE = b"\x01" + b"\x00" * 19  # the miner's (miner/worker.py)
# the ladder's counters: each must stay 0 outside the ladder drill
LOUD_DEVICE = tuple(f"ops/device/{c}" for c in (
    "dispatch_errors", "demotions", "promotions", "probe_errors",
    "resolve_fail"))


class _AtomicPair:
    """One signed ImportTx and one signed ExportTx on the VM's chain and
    what they do: the import consumes a UTXO the X chain exported to this
    chain (seeded into the shared memory here), owned by the last keyed
    account, and credits VM_IMPORT - VM_BURN to the first plain account
    after the keyed ones; the export debits VM_EXPORT + VM_BURN and one
    nonce from the second-to-last keyed account (which sends no transfer
    in the VM blocks) and exports a UTXO of VM_EXPORT to the X chain."""

    def __init__(self, vm, mem: Memory, world: World):
        ctx = vm.ctx
        imp_i, imp_key = world.keyed[-1]
        self.exp_i, exp_key = world.keyed[-2]
        self.dest = len(world.storage) + len(world.keyed)
        self.utxo = atomic_tx.UTXO(
            tx_id=keccak256(b"chip_smoke x-chain export"), output_index=0,
            asset_id=ctx.avax_asset_id, amount=VM_IMPORT,
            address=world.addrs[imp_i])
        mem.new_shared_memory(ctx.x_chain_id).apply({ctx.chain_id: Requests(
            put_requests=[Element(self.utxo.utxo_id(), self.utxo.encode(),
                                  [self.utxo.address])])})
        self.imp = atomic_tx.Tx(atomic_tx.ImportTx(
            network_id=ctx.network_id, blockchain_id=ctx.chain_id,
            source_chain=ctx.x_chain_id, imported_inputs=[self.utxo],
            outs=[atomic_tx.EVMOutput(world.addrs[self.dest],
                                      VM_IMPORT - VM_BURN,
                                      ctx.avax_asset_id)]))
        self.imp.sign([imp_key])
        self.out = atomic_tx.UTXO(
            tx_id=b"\x00" * 32, output_index=0, asset_id=ctx.avax_asset_id,
            amount=VM_EXPORT, address=b"\x99" * 20)
        self.exp = atomic_tx.Tx(atomic_tx.ExportTx(
            network_id=ctx.network_id, blockchain_id=ctx.chain_id,
            destination_chain=ctx.x_chain_id,
            ins=[atomic_tx.EVMInput(world.addrs[self.exp_i],
                                    VM_EXPORT + VM_BURN, ctx.avax_asset_id,
                                    world.nonce[self.exp_i])],
            exported_outputs=[self.out]))
        self.exp.sign([exp_key])

    def apply(self, world: World, oracle: Oracle) -> None:
        """Their balance and nonce changes, applied to `world` and
        `oracle` (an atomic tx has no receipt)."""
        world.balance[self.dest] += (VM_IMPORT - VM_BURN) * atomic_tx.X2C_RATE
        world.balance[self.exp_i] -= ((VM_EXPORT + VM_BURN)
                                      * atomic_tx.X2C_RATE)
        world.nonce[self.exp_i] += 1
        oracle.apply([self.dest, self.exp_i], {})


def vm_block(vm, world: World, oracle: Oracle, txs, coinbase: list,
             recs, atomic=None, label="vm", dev=None, issued=False):
    """One block through the VM: `txs` (and `atomic`'s two txs) issued
    through vm.issue_tx and vm.issue_atomic_tx (unless `issued`: already
    in the tx pool from a build that failed), then vm.build_block() →
    vmb.verify() → vm.set_preference(vmb.id()) → vmb.accept() and the
    acceptor drained. Its header root must equal the EVM-independent
    oracle's (evm_oracle_block over the block's own transaction order,
    plus `atomic`'s changes), the head and the last accepted block must be
    it. `recs`: the storage programs' and the executor's K1 recorders.
    Returns (block, receipts, touched, writes, stats)."""
    chain = vm.blockchain
    decoded = [Transaction.decode(t.blob) for t in txs]
    by_hash = {tx.hash(): t for tx, t in zip(decoded, txs)}
    t0 = time.perf_counter()
    for tx in decoded if not issued else ():
        vm.issue_tx(tx)
    if atomic is not None:
        vm.issue_atomic_tx(atomic.imp)
        vm.issue_atomic_tx(atomic.exp)
    issue_ms = (time.perf_counter() - t0) * 1e3
    check(vm.txpool.stats()[0] == len(txs),
          f"{label}: the tx pool holds {vm.txpool.stats()}, not "
          f"{len(txs)} pending")
    n0 = [len(r.records) for r in recs]
    t0 = time.perf_counter()
    vmb = vm.build_block()
    build_ms = (time.perf_counter() - t0) * 1e3
    n1 = [len(r.records) for r in recs]
    t0 = time.perf_counter()
    vmb.verify()
    verify_ms = (time.perf_counter() - t0) * 1e3
    n2 = [len(r.records) for r in recs]
    mirror = chain.mirror
    win = (window_ms(dev, mirror.ex.last_events)
           if dev is not None and mirror is not None and not
           mirror.host_mode else None)
    vm.set_preference(vmb.id())
    t0 = time.perf_counter()
    vmb.accept()
    chain.drain_acceptor_queue()
    accept_ms = (time.perf_counter() - t0) * 1e3
    eth = vmb.eth_block
    check(len(eth.transactions) == len(txs),
          f"{label} block {eth.number}: {len(eth.transactions)} of "
          f"{len(txs)} transactions included")
    check(len(vmb.atomic_txs) == (2 if atomic is not None else 0),
          f"{label} block {eth.number}: {len(vmb.atomic_txs)} atomic txs")
    ordered = [by_hash[tx.hash()] for tx in eth.transactions]
    receipts = chain.get_receipts(eth.hash())
    check(all(r.status == 1 for r in receipts),
          f"{label} block {eth.number}: a transaction failed")
    want, touched, writes = evm_oracle_block(
        world, oracle, ordered, receipts, eth.header.base_fee, coinbase,
        VM_COINBASE)
    if atomic is not None:
        atomic.apply(world, oracle)
        want = oracle.root()
        touched |= {atomic.dest, atomic.exp_i}
    check(eth.header.root == want,
          f"{label} block {eth.number}: root {eth.header.root.hex()} != "
          f"oracle {want.hex()}")
    check(vm.last_accepted().id() == vmb.id()
          and chain.current_block.hash() == vmb.id()
          and chain.last_accepted.hash() == vmb.id(),
          f"{label} block {eth.number}: not the head and last accepted")
    stats = dict(issue=issue_ms, build=build_ms, verify=verify_ms,
                 accept=accept_ms, window=win,
                 build_k1=[b - a for a, b in zip(n0, n1)],
                 verify_k1=[b - a for a, b in zip(n1, n2)])
    return vmb, receipts, touched, writes, stats


def phase_vm(dev, vm, mem: Memory, world: World, oracle: Oracle, n_blocks,
             coinbase: list, seed, card):
    """The VM phase (module docstring, phase 7d): `n_blocks` blocks of the
    EVM phase's mix (evm_transactions from the keyed accounts' next
    nonces) through the VM on the chain the chain phase left, the first
    with one ImportTx and one ExportTx (_AtomicPair). Each block through
    vm_block: issue, build (the miner from the tx pool and the atomic
    mempool, finalize_and_assemble's intermediate_root: the storage
    programs on K1 under the ladder, the account trie on the mirror's
    executor on K1; then insert_block_manual(writes=False)), verify
    (insert_block_manual(writes=True) and the atomic backend), preference,
    accept. Then the mempool and the tx pool are empty, and the shared
    memory holds the export's UTXO and not the import's. The storage
    programs and the executor launch K1 through recorders. Returns (the
    storage recorder, the executor's, K1 launches, of them cooperative,
    accounts touched, {contract: keys written})."""
    t_phase = time.perf_counter()
    chain = vm.blockchain
    mirror = chain.mirror
    rec_storage, rec_resident = _K1Recorder(), _K1Recorder()
    chain.state_database.triedb.batch_keccak = PlannedMode(
        PlannedCommit(seg_impl=rec_storage, device=dev))
    mirror.ex.seg_impl = rec_resident
    t0 = time.perf_counter()
    signed = evm_transactions(world, n_blocks, seed)
    atomic = _AtomicPair(vm, mem, world)
    log(f"vm: {sum(len(b) for b in signed)} transactions of {n_blocks} "
        f"blocks and 2 atomic txs signed in {time.perf_counter() - t0:.1f} "
        f"s; a UTXO of {VM_IMPORT} nAVAX seeded into the shared memory")
    loud_names = LOUD_CHAIN + OPTION_FALLBACKS + LOUD_DEVICE
    loud = {n: default_registry.counter(n).count() for n in loud_names}
    keccak_cuda.reset_counts()
    planned_mod.planned_fallbacks = 0
    touched_all, written = set(), defaultdict(set)
    gas_all = wall_all = 0.0
    with _GcPauses() as pauses:
        for b, txs in enumerate(signed):
            vmb, _r, touched, writes, st = vm_block(
                vm, world, oracle, txs, coinbase, (rec_storage, rec_resident),
                atomic=atomic if b == 0 else None, dev=dev)
            touched_all |= touched
            for c, w in writes.items():
                written[c].update(w)
            eth = vmb.eth_block
            gas = eth.header.gas_used
            wall = (st["build"] + st["verify"]) / 1e3
            gas_all += gas
            wall_all += wall
            rec = chain.flight_recorder.find(eth.hash())
            log(f"vm block {eth.number}: {len(eth.transactions)} "
                f"transactions, {len(vmb.atomic_txs)} atomic, gas used {gas}"
                f"; issue {st['issue']:.1f} ms, build_block "
                f"{st['build']:.1f} ms (K1 launches: storage programs "
                f"{st['build_k1'][0]}, resident executor "
                f"{st['build_k1'][1]}), verify {st['verify']:.1f} ms (K1 "
                f"launches: storage programs {st['verify_k1'][0]}, resident "
                f"executor {st['verify_k1'][1]}; flight record phases (ms) "
                + ", ".join(f"{k} {v * 1e3:.1f}"
                            for k, v in rec["phases"].items())
                + f"), accept and drain {st['accept']:.1f} ms; mirror device"
                f" window {fmt_window(st['window'])}; {gas / wall / 1e6:.3f}"
                f" Mgas/s over build + verify; root {eth.header.root.hex()}"
                f" == the EVM-independent oracle's; {card}")
    launches, coop = keccak_cuda.launches, keccak_cuda.launches_coop
    check(len(vm.mempool) == 0 and not vm.mempool.issued
          and vm.txpool.stats() == (0, 0),
          f"vm: mempool {len(vm.mempool)} (issued {len(vm.mempool.issued)}"
          f"), tx pool {vm.txpool.stats()} after the last accept")
    ctx = vm.ctx
    out = mem.new_shared_memory(ctx.x_chain_id).get(
        ctx.chain_id, [atomic.out.utxo_id()])
    check(atomic_tx.UTXO.decode(out[0]) == atomic.out,
          "vm: the export's UTXO is not in the X chain's shared memory")
    try:
        mem.new_shared_memory(ctx.chain_id).get(ctx.x_chain_id,
                                                [atomic.utxo.utxo_id()])
        check(False, "vm: the imported UTXO is still in the shared memory")
    except KeyError:
        pass
    last = chain.last_accepted.header.root
    check(chain.snaps.disk_layer.root == last,
          "vm: the snapshot's disk layer is not at the last root")
    check(planned_mod.planned_fallbacks == 0, "vm: planned fallback")
    check(keccak_cuda.blocks_launches == 0, "vm: K2 launched")
    cuda = dev.type == "cuda"
    check(not cuda or launches == len(rec_storage.records)
          + len(rec_resident.records) > 0,
          f"vm: {launches} K1 launches, {len(rec_storage.records)} + "
          f"{len(rec_resident.records)} recorded")
    check(rec_storage.records and rec_resident.records,
          "vm: K1 not launched by both the storage programs and the "
          "resident executor")
    if cuda:
        ran_s = check_variants(rec_storage, "vm storage programs")
        ran_r = check_variants(rec_resident, "vm resident executor")
        log("vm: every K1 launch ran the variant its shape calls for: "
            "storage programs " + ", ".join(
                f"{VARIANT_NAME[v]} {n}" for v, n in ran_s.items())
            + "; resident executor " + ", ".join(
                f"{VARIANT_NAME[v]} {n}" for v, n in ran_r.items()))
    for name in loud_names:
        now = default_registry.counter(name).count()
        check(now == loud[name], f"vm: {name} counted {now - loud[name]}")
    check(default_ladder().healthy and not mirror.host_mode,
          "vm: the ladder is not healthy or the mirror is on the host")
    log(f"vm: {n_blocks} blocks built, verified and accepted through the VM"
        f" in {wall_all * 1e3:.1f} ms of build + verify "
        f"({gas_all / wall_all / 1e6:.3f} Mgas/s); head == "
        f"vm.last_accepted(); mempool and tx pool empty; the shared memory "
        f"holds the export's UTXO and not the import's; K1 launches "
        f"{launches} (storage programs {len(rec_storage.records)}, resident "
        f"executor {len(rec_resident.records)}); garbage collector pauses "
        f"({pauses}); phase {time.perf_counter() - t_phase:.1f} s; {card}")
    return (rec_storage, rec_resident, launches, coop, sorted(touched_all),
            written)


# the ladder drill's VM config (phase 8b): a watchdog of 1 s a dispatch,
# probes every 50 ms, re-promotion after two healthy probes; every
# accepted block exported, so a reboot's leaf scan finds its state
DRILL_CONFIG = {"device-call-timeout": 1.0, "device-probe-interval": 0.05,
                "device-promote-after": 2, "commit-interval": 1}
DRILL_CALLS = 6       # contract calls a drill block: 120 slot writes, so
DRILL_TRANSFERS = 10  # the storage program engages (BATCH_THRESHOLD 100)


def _wait(cond, seconds: float) -> bool:
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def phase_ladder_drill(dev, n_accounts, seed, card):
    """The ladder drill (module docstring, phase 8b) on a VM of its own
    over `n_accounts` accounts (24 contracts of 20 slots, 64 keyed), booted
    from DRILL_CONFIG. Blocks of DRILL_CALLS contract calls and
    DRILL_TRANSFERS transfers through vm_block, each root held against the
    oracle: raise (ops/device/dispatch `raise*1`: the error reaches
    build_block, the head stays and nothing is demoted; the block then
    builds with storage K1 launches), hang (the dispatch hangs: the
    watchdog's DeviceWedgedError reaches build_block within its deadline,
    the head stays, nothing is demoted; released, the abandoned call never
    runs and the block builds on K1), takeover (the probes failing,
    chain.take_over_host() demotes the ladder: a block on the host with 0
    K1 launches, storage programs and executor), recover (cleared: the
    probes, K2 on the card, re-promote, the listener reboots the mirror on
    the device, and the next block launches K1 in both). The ladder is
    then reset to its defaults. Returns (K1 recorders of the storage
    programs and the executors, K1 launches, of them cooperative, the
    probes' K2 recorder, K2 launches, of them cooperative, K2's padding
    lanes)."""
    t_phase = time.perf_counter()
    names = LOUD + LOUD_DEVICE
    moved = {n: default_registry.counter(n).count() for n in names}
    check(not any(moved.values()),
          f"ladder drill: the main paths counted {moved}")
    lad = default_ladder()
    world = World(n_accounts, 24, 20, seed, n_keyed=64)
    oracle = Oracle(world)
    cfg = dict(DRILL_CONFIG)
    if dev.type != "cuda":
        cfg["resident-account-trie"] = True
    vm = VM()
    t0 = time.perf_counter()
    vm.initialize(SnowContext(shared_memory=Memory()), MemoryDB(),
                  genesis_alloc(world), config_bytes=json.dumps(cfg).encode(),
                  device=dev)
    boot_ms = (time.perf_counter() - t0) * 1e3
    vm.miner.clock = chain_clock(vm)
    chain = vm.blockchain
    check(chain.genesis_block.root == oracle.root(),
          "ladder drill: genesis root != the oracle's")
    st = lad.status()
    check((st["call_timeout"], st["probe_interval"], st["promote_after"])
          == (1.0, 0.05, 2),
          f"ladder drill: the chain configured the ladder as {st}")
    rec_storage, rec_resident, rec_k2 = _K1Recorder(), _K1Recorder(), \
        _K2Recorder()
    chain.state_database.triedb.batch_keccak = PlannedMode(
        PlannedCommit(seg_impl=rec_storage, device=dev))
    chain.mirror.ex.seg_impl = rec_resident
    probe = device_mod._cached["fn"].__self__
    check(probe is chain.state_database.triedb.batch_keccak.batched,
          "ladder drill: the probe is not the chain device's K2 seam")
    probe.impl = rec_k2
    probe.reset_totals()
    signed = evm_transactions(world, 5, seed + 1, n_calls=DRILL_CALLS,
                              n_transfers=DRILL_TRANSFERS)
    coinbase = [0]
    keccak_cuda.reset_counts()
    recs = (rec_storage, rec_resident)
    before = {n: default_registry.counter(n).count() for n in LOUD_DEVICE}

    def counted(name):
        return default_registry.counter(name).count() - before[name]

    def events():
        return [e["event"] for e in chain.flight_recorder.events()]

    def step(label, txs, issued=False):
        vmb, _r, _t, _w, st = vm_block(vm, world, oracle, txs, coinbase,
                                       recs, label=f"ladder drill {label}",
                                       dev=dev, issued=issued)
        n = [a + b for a, b in zip(st["build_k1"], st["verify_k1"])]
        log(f"ladder drill {label}: block {vmb.height()} root == the "
            f"oracle's; build_block {st['build']:.1f} ms, verify "
            f"{st['verify']:.1f} ms; K1 launches: storage programs {n[0]}, "
            f"resident executor {n[1]}; ladder {lad.state}; {card}")
        return n

    def failed_build(label, txs, want):
        """Issue `txs`, then a build_block whose dispatch fails: the error
        (a `want`) reaches it, the head stays, nothing is demoted."""
        for t in txs:
            vm.issue_tx(Transaction.decode(t.blob))
        head = chain.current_block.hash()
        t0 = time.perf_counter()
        try:
            vm.build_block()
            err = None
        except Exception as e:  # noqa: BLE001 — checked below
            err = e
        ms = (time.perf_counter() - t0) * 1e3
        check(isinstance(err, want) and chain.current_block.hash() == head
              and vm.last_accepted().id() == head and lad.healthy
              and counted("ops/device/demotions") == 0
              and "device/demote" not in events(),
              f"ladder drill {label}: build_block gave {err!r}, head "
              f"moved {chain.current_block.hash() != head}, ladder "
              f"{lad.state}, demotions {counted('ops/device/demotions')}")
        log(f"ladder drill {label}: build_block raised {type(err).__name__}"
            f" after {ms:.1f} ms, the head unchanged, no demotion; {card}")
        return ms

    # raise: the first dispatch fails; its error reaches build_block
    fault.set_failpoint("ops/device/dispatch", "raise*1")
    failed_build("raise", signed[0], fault.FailpointError)
    n = step("raise", signed[0], issued=True)
    check(n[0] > 0, "ladder drill raise: no storage K1 launch after it")
    # hang: the watchdog's deadline reaches build_block
    fault.set_failpoint("ops/device/dispatch", "hang")
    hang_ms = failed_build("hang", signed[1], DeviceWedgedError)
    budget_ms = (DRILL_CONFIG["device-call-timeout"] + 2.0) * 1e3
    check(hang_ms < budget_ms,
          f"ladder drill hang: build_block took {hang_ms:.1f} ms")
    fault.clear_all()  # releases the abandoned call, which never runs
    n = step("hang", signed[1], issued=True)
    check(n[0] > 0, "ladder drill hang: no storage K1 launch after it")
    # takeover: the caller demotes the ladder; the probes fail, so the
    # next block is hashed on the host
    fault.set_failpoint("ops/device/probe", "raise")
    old = chain.mirror
    chain.take_over_host("ladder drill")
    check(old.host_mode and not lad.healthy and "device/demote" in events()
          and counted("ops/device/demotions") == 1,
          "ladder drill: take_over_host did not demote the ladder")
    check(_wait(lambda: counted("ops/device/probe_errors") > 0, 5)
          and not lad.healthy,
          "ladder drill: no probe failed while the probes' failpoint held")
    n = step("takeover", signed[2])
    check(n == [0, 0] and not lad.healthy,
          f"ladder drill takeover: K1 launches {n} while demoted")
    # recover: the probes (K2 on the card) re-promote; the listener
    # reboots the mirror on the device (its executor takes the module's
    # segment_keccak at construction: a recorder while the reboot runs)
    rec_boot = _K1Recorder(keccak_cuda.segment_keccak)
    keccak_cuda.segment_keccak = rec_boot
    fault.clear_all()
    t0 = time.perf_counter()
    rebooted = _wait(lambda: "mirror/reboot" in events(), 30)
    keccak_cuda.segment_keccak = rec_boot.launch
    check(rebooted,
          f"ladder drill: no mirror reboot after the promotion: {events()}")
    reboot_ms = (time.perf_counter() - t0) * 1e3
    check(lad.healthy and chain.mirror is not old
          and not chain.mirror.host_mode,
          "ladder drill: the rebooted mirror is not on the device")
    chain.mirror.ex.seg_impl = rec_resident
    n = step("recover", signed[3])
    check(n[0] > 0 and n[1] > 0 and not chain.mirror.host_mode,
          f"ladder drill recover: K1 launches {n} after the promotion")
    moved = {name: counted(name) for name in LOUD_DEVICE}
    check(moved["ops/device/demotions"] == 1
          and moved["ops/device/promotions"] == 1
          and moved["ops/device/dispatch_errors"] == 2
          and moved["ops/device/probe_errors"] > 0
          and moved["ops/device/resolve_fail"] == 0,
          f"ladder drill: counters {moved}")
    kinds = [k for k in events() if k.startswith(("device/", "mirror/"))]
    k1, k1_coop = keccak_cuda.launches, keccak_cuda.launches_coop
    k2, k2_coop = keccak_cuda.blocks_launches, keccak_cuda.blocks_launches_coop
    pad = probe.padded_lanes - probe.lanes
    probe.impl = keccak_cuda.keccak256_blocks
    cuda = dev.type == "cuda"
    rec_resident.records += rec_boot.records
    check(not cuda or (k1 == len(rec_storage.records)
                       + len(rec_resident.records) > 0
                       and k2 == len(rec_k2.records) > 0),
          f"ladder drill: K1 {k1} launches, {len(rec_storage.records)} + "
          f"{len(rec_resident.records)} recorded (the reboot's "
          f"{len(rec_boot.records)}); K2 {k2}, {len(rec_k2.records)} "
          f"recorded")
    check(rec_k2.records, "ladder drill: no probe reached K2")
    lad.reset()
    vm.shutdown()
    log(f"ladder drill: VM of {n_accounts} accounts booted in "
        f"{boot_ms:.1f} ms; the hang reached build_block after "
        f"{hang_ms:.1f} ms (budget {budget_ms:.1f} ms); after the "
        f"takeover the mirror rebooted on the device {reboot_ms:.1f} ms "
        f"after the probes' failpoint cleared; counters {moved}; flight "
        f"events {kinds}; K1 launches {k1}, probes' K2 launches {k2}; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return (rec_storage, rec_resident, k1, k1_coop, rec_k2, k2, k2_coop,
            pad)


# ------------------------------------------------- the commitment VM phase

# the commitment VM's JSON config (phase 8c): the dual-root shadow beside
# the MPT, its canonical-rebuild check every second commit
SHADOW_CONFIG = {"state-backend": "bintrie-shadow",
                 "shadow-check-interval": 2}
# BASELINE config 5's call: keccak256Batch(bytes[]) over 128 messages of
# 512 bytes (64 KiB), about 1.2M gas, mostly calldata
SHADOW_CALLS = 2
SHADOW_MSGS = 128
SHADOW_MSG_BYTES = 512
SHADOW_CALL_GAS = 1_400_000
SHADOW_CALL_PLAN = 1_300_000
# the forwarder contracts' one genesis slot (their code never touches it)
FWD_GENESIS_SLOT = b"\xff" * 32


def forwarder_code(target: bytes) -> bytes:
    """Hand-assembled: STATICCALL `target` with the calldata, revert if it
    fails, else n = sload(0) + 1, sstore(0, n), sstore(n,
    keccak256(returndata)): each call's digests reach the state root in a
    slot of their own."""
    return bytes.fromhex(
        "366000600037"                  # calldatacopy(0, 0, calldatasize)
        "60006000366000"                # retSize retOff argsSize argsOff
        "73") + target + bytes.fromhex(
        "5afa"                          # gas staticcall
        "15603e57"                      # iszero -> 62 (revert)
        "3d600060003e"                  # returndatacopy(0, 0, rds)
        "3d600020"                      # keccak256(0, rds)
        "600054600101"                  # sload(0) + 1
        "8060005555"                    # sstore(0, n); sstore(n, h)
        "00"                            # stop
        "5b60006000fd")                 # 62: revert(0, 0)


def batch_calldata(msgs) -> bytes:
    """keccak256Batch(bytes[]) calldata: the selector, then the ABI
    encoding of `bytes[]` (offset, count, one offset a message relative to
    the array's content, then each length and its bytes zero-padded)."""
    heads, tail = [], []
    pos = 32 * len(msgs)
    for m in msgs:
        heads.append(pos.to_bytes(32, "big"))
        chunk = len(m).to_bytes(32, "big") + m + bytes(-len(m) % 32)
        tail.append(chunk)
        pos += len(chunk)
    return (function_selector("keccak256Batch(bytes[])")
            + (32).to_bytes(32, "big") + len(msgs).to_bytes(32, "big")
            + b"".join(heads) + b"".join(tail))


def add_account(world: World, addr, nonce=0, code=b"", storage=None) -> int:
    """Append an account to `world` (before its Oracle is built); returns
    its index."""
    world.addrs.append(addr)
    world.nonce.append(nonce)
    world.balance.append(0)
    world.code_hash.append(keccak256(code))
    i = len(world.addrs) - 1
    if code:
        world.code[i] = code
    if storage:
        world.storage[i] = dict(storage)
    return i


def shadow_content(world: World, coinbase=None) -> dict:
    """The bintrie shadow's key -> value-hash map of `world` (and the
    miner's coinbase once it holds fees), built apart from the port's
    tries: each account
    under keccak256(address) with its fixed-width payload
    (shadow.encode_account), each slot under shadow.storage_key(keccak256
    (address), keccak256(slot key)) with the hash of its 32-byte value."""
    keys = keccak256_batch(world.addrs, threads=8)
    payloads = [shadow_mod.encode_account(world.nonce[i], world.balance[i],
                                          world.code_hash[i], False)
                for i in range(len(world.addrs))]
    content = dict(zip(keys, keccak256_batch(payloads, threads=8)))
    if coinbase is not None:
        content[keccak256(VM_COINBASE)] = keccak256(
            shadow_mod.encode_account(0, coinbase, EMPTY_CODE_HASH, False))
    for c, slots in world.storage.items():
        for k, v in slots.items():
            content[shadow_mod.storage_key(keys[c], keccak256(k))] = \
                keccak256(v)
    return content


def precompile_transactions(world: World, n_blocks, callers, fwds, seed):
    """Per block SHADOW_CALLS signed calls of keccak256Batch through the
    forwarders (caller j -> forwarder j), each over SHADOW_MSGS seeded
    messages of SHADOW_MSG_BYTES: [[_EvmTx]] whose `writes` are the
    forwarder's slots (the counter, then keccak256 of the ABI-encoded host
    digests at slot n). Returns (blocks, [[messages]] per call)."""
    cfg = params.TEST_CHAIN_CONFIG
    signer = Signer(cfg.chain_id)
    rng = np.random.default_rng(seed)
    blocks, msgs_all = [], []
    for b in range(n_blocks):
        txs = []
        for j, ((i, key), f) in enumerate(zip(callers, fwds)):
            raw = rng.bytes(SHADOW_MSGS * SHADOW_MSG_BYTES)
            msgs = [raw[k * SHADOW_MSG_BYTES:(k + 1) * SHADOW_MSG_BYTES]
                    for k in range(SHADOW_MSGS)]
            msgs_all.append(msgs)
            ret = tpu_keccak.encode_bytes32_array(
                keccak256_batch(msgs, threads=8))
            n = b + 1
            writes = {normalize_state_key(bytes(32)): n.to_bytes(32, "big"),
                      normalize_state_key(n.to_bytes(32, "big")):
                          keccak256(ret)}
            tx = Transaction(type=2, chain_id=cfg.chain_id,
                             nonce=world.nonce[i] + b, max_priority_fee=0,
                             max_fee=EVM_MAX_FEE, gas=SHADOW_CALL_GAS,
                             to=world.addrs[f], value=0,
                             data=batch_calldata(msgs))
            txs.append(_EvmTx(signer.sign(tx, key).encode(), i, f, 0,
                              writes))
        blocks.append(txs)
    return blocks, msgs_all


def _timer(name):
    t = default_registry.timer(name)
    return t.count(), t.total()


def phase_commitment(dev, n_accounts, n_blocks, seed, card):
    """The commitment VM (module docstring, phase 8c): a VM of its own over
    `n_accounts` accounts booted from SHADOW_CONFIG on a genesis whose
    config enables TpuKeccakConfig(timestamp=0); `n_blocks` blocks of the
    EVM phase's mix, trimmed for two keccak256Batch calls, through
    vm_block. Returns (the shadow's K1 records, the phase's other K1
    records: the MPT genesis, the mirror boot, the storage programs and
    the resident executor; K1 launches, of them cooperative, the
    precompile's K2 recorder, K2 launches, of them cooperative, K2's
    padding lanes)."""
    t_phase = time.perf_counter()
    lad = default_ladder()
    names = LOUD + LOUD_DEVICE + OPTION_FALLBACKS + (
        "chain/commit/bintrie/quarantines", "chain/commit/bintrie/unanchored",
        "state/shadow/error", "chain/mirror/quarantines")
    before = {n: default_registry.counter(n).count() for n in names}
    check(lad.healthy and lad.status()["call_timeout"] is None,
          f"commitment: the ladder is not at its defaults: {lad.status()}")
    t0 = time.perf_counter()
    world = World(n_accounts, max(1, n_accounts // 1000), 100, seed,
                  n_keyed=EVM_KEYED)
    n_calls = min(EVM_CALLS, len(world.storage))
    n_transfers = (int(EVM_FILL * params.CORTINA_GAS_LIMIT)
                   - n_calls * EVM_CALL_PLAN
                   - SHADOW_CALLS * SHADOW_CALL_PLAN) // 21000
    check((n_calls + n_transfers) * n_blocks + SHADOW_CALLS
          <= len(world.keyed), "commitment: too few keyed senders")
    mix = evm_transactions(world, n_blocks, seed + 1,
                           n_transfers=n_transfers)
    # the precompile's account as the genesis commit leaves it, and the
    # forwarders (added after the mix was planned: never a transfer's
    # receiver or a store-and-log call's contract)
    add_account(world, TPU_KECCAK_ADDR, nonce=1, code=b"\x01")
    fwd_code = forwarder_code(TPU_KECCAK_ADDR)
    fwds = [add_account(world, b"\xfd" * 19 + bytes([j + 1]), code=fwd_code,
                        storage={normalize_state_key(FWD_GENESIS_SLOT):
                                 b"\x01" * 32})
            for j in range(SHADOW_CALLS)]
    callers = world.keyed[-SHADOW_CALLS:]
    calls, msgs_all = precompile_transactions(world, n_blocks, callers,
                                              fwds, seed + 2)
    signed = [m + c for m, c in zip(mix, calls)]
    oracle = Oracle(world)
    setup_s = time.perf_counter() - t0
    log(f"commitment: world of {len(world.addrs)} accounts "
        f"({len(world.storage) - SHADOW_CALLS} contracts x 100 slots, "
        f"{len(world.keyed)} keyed, the precompile's account and "
        f"{SHADOW_CALLS} forwarders), the oracle and {n_blocks} blocks of "
        f"{len(signed[0])} transactions ({n_calls} store-and-log calls, "
        f"{n_transfers} transfers, {SHADOW_CALLS} keccak256Batch calls of "
        f"{SHADOW_MSGS} x {SHADOW_MSG_BYTES} B) in {setup_s:.1f} s")

    genesis = genesis_alloc(world)
    genesis.config = dataclasses.replace(
        params.TEST_CHAIN_CONFIG,
        precompile_upgrades=(TpuKeccakConfig(timestamp=0),))
    cfg = dict(SHADOW_CONFIG)
    if dev.type != "cuda":
        cfg["resident-account-trie"] = True
    rec_shadow, rec_gmpt = _K1Recorder(), _K1Recorder()
    shadow_init = shadow_mod.ShadowCommitment.__init__

    def init(self, *a, **kw):
        kw["executor"] = PlannedCommit(seg_impl=rec_shadow, device=dev)
        shadow_init(self, *a, **kw)

    pc = default_planned_commit(dev)
    pc_impl = pc._impl
    pc._impl = rec_gmpt
    keccak_cuda.reset_counts()
    lanes0 = default_registry.counter("bintrie/planned/lanes").count()
    commits0 = default_registry.counter("bintrie/planned/commits").count()
    mpt0, bin0 = _timer("chain/commit/mpt"), _timer("chain/commit/bintrie")
    vm = VM()
    t0 = time.perf_counter()
    try:
        with _ChainBoot() as boot, mock.patch.object(
                shadow_mod.ShadowCommitment, "__init__", init):
            vm.initialize(SnowContext(shared_memory=Memory()), MemoryDB(),
                          genesis, config_bytes=json.dumps(cfg).encode(),
                          device=dev)
    finally:
        pc._impl = pc_impl
    boot_ms = (time.perf_counter() - t0) * 1e3
    vm.miner.clock = chain_clock(vm)
    chain = vm.blockchain
    shadow = chain.state_database.shadow
    mirror = chain.mirror
    mpt1, bin1 = _timer("chain/commit/mpt"), _timer("chain/commit/bintrie")
    g_shadow = len(rec_shadow.records)
    g_lanes = (default_registry.counter("bintrie/planned/lanes").count()
               - lanes0)
    check(chain.genesis_block.root == oracle.root(),
          "commitment: genesis root != the oracle's")
    check(mirror is not None and not mirror.host_mode,
          "commitment: the mirror is not on the device")
    content = shadow_content(world)
    t0 = time.perf_counter()
    want = reference_root(content, hashed_values=True)
    ref_ms = (time.perf_counter() - t0) * 1e3
    check(shadow is not None and not shadow.quarantined
          and shadow.root_for(chain.genesis_block.root) == want,
          "commitment: the genesis shadow root != reference_root of the "
          "oracle's content")
    check(g_shadow > 0, "commitment: the genesis shadow launched no K1")
    log(f"commitment genesis: VM.initialize(config_bytes="
        f"{json.dumps(cfg)}, device={dev.type}) {boot_ms:.1f} ms; "
        f"chain/commit/mpt {(mpt1[1] - mpt0[1]) * 1e3:.1f} ms, "
        f"chain/commit/bintrie {(bin1[1] - bin0[1]) * 1e3:.1f} ms "
        f"(ratio {(bin1[1] - bin0[1]) / (mpt1[1] - mpt0[1]):.3f}); the "
        f"shadow's planned commit: {g_shadow} K1 launches over {g_lanes} "
        f"lanes; MPT genesis K1 launches {len(rec_gmpt.records)}, mirror "
        f"boot {len(boot.rec.records)}; the shadow root "
        f"{want.hex()} == reference_root of the oracle's content "
        f"({len(content)} keys, {ref_ms:.1f} ms); {card}")

    rec_storage, rec_resident, rec_k2 = (_K1Recorder(), _K1Recorder(),
                                         _K2Recorder())
    mode = PlannedMode(PlannedCommit(seg_impl=rec_storage, device=dev))
    chain.state_database.triedb.batch_keccak = mode
    mirror.ex.seg_impl = rec_resident
    bk = mode.batched
    bk_impl = bk.impl
    bk.impl = rec_k2
    bk.reset_totals()
    planned_mod.planned_fallbacks = 0
    coinbase = [0]
    recs = (rec_storage, rec_resident, rec_shadow)
    per_block = []
    try:
        for b, txs in enumerate(signed):
            c0 = shadow.status()["commits"]
            k2a = len(rec_k2.records)
            m0 = _timer("chain/commit/mpt")
            b0 = _timer("chain/commit/bintrie")
            vmb, _r, _t, _w, st = vm_block(
                vm, world, oracle, txs, coinbase, recs,
                label=f"commitment block {b + 1}", dev=dev)
            m1 = _timer("chain/commit/mpt")
            b1 = _timer("chain/commit/bintrie")
            eth = vmb.eth_block
            t0 = time.perf_counter()
            want = reference_root(shadow_content(world, coinbase[0]),
                                  hashed_values=True)
            ref_ms = (time.perf_counter() - t0) * 1e3
            got = shadow.root_for(eth.header.root)
            check(got == want and not shadow.quarantined,
                  f"commitment block {eth.number}: shadow root "
                  f"{got.hex() if got else None} != reference_root "
                  f"{want.hex()} of the oracle's content")
            commits = shadow.status()["commits"] - c0
            check(commits == 2, f"commitment block {eth.number}: the shadow "
                  f"committed {commits} times over build and verify")
            k2 = len(rec_k2.records) - k2a
            mpt_ms = (m1[1] - m0[1]) * 1e3
            bin_ms = (b1[1] - b0[1]) * 1e3
            per_block.append((mpt_ms, bin_ms))
            log(f"commitment block {eth.number}: {len(eth.transactions)} "
                f"transactions, gas used {eth.header.gas_used}; build_block "
                f"{st['build']:.1f} ms, verify {st['verify']:.1f} ms; K1 "
                f"launches (storage programs, resident executor, shadow): "
                f"build {st['build_k1']}, verify {st['verify_k1']}; the "
                f"precompile's K2 launches {k2}; shadow commits {commits} "
                f"(build and verify: one transition, the same bintrie "
                f"root); chain/commit/mpt "
                f"{mpt_ms:.1f} ms over {m1[0] - m0[0]} commits, "
                f"chain/commit/bintrie {bin_ms:.1f} ms over {b1[0] - b0[0]}"
                f" (ratio {bin_ms / mpt_ms:.3f}); root == the oracle's, "
                f"shadow root {want.hex()} == reference_root "
                f"({ref_ms:.1f} ms); {card}")
        # one direct call of the contract on the head state: the same
        # messages, the seam of the state's TrieDatabase (K2)
        head = chain.state()
        k2a = len(rec_k2.records)
        # the contract reads only the EVM's statedb (for the device seam)
        ret, left = TpuKeccakConfig(timestamp=0).contract().run(
            argparse.Namespace(statedb=head), world.addrs[callers[0][0]],
            TPU_KECCAK_ADDR, batch_calldata(msgs_all[0]), 10**7, True)
        check(ret == tpu_keccak.encode_bytes32_array(
            keccak256_batch(msgs_all[0], threads=8))
              and len(rec_k2.records) == k2a + 1
              and left == 10**7 - tpu_keccak.batch_gas(msgs_all[0]),
              "commitment: contract.run != the host batch keccak")
    finally:
        bk.impl = bk_impl
    k1, k1_coop = keccak_cuda.launches, keccak_cuda.launches_coop
    k2, k2_coop = keccak_cuda.blocks_launches, keccak_cuda.blocks_launches_coop
    pad = bk.padded_lanes - bk.lanes
    status = shadow.status()
    check(status["commits"] >= 2 and not status["quarantined"],
          f"commitment: shadow status {status}")
    check(planned_mod.planned_fallbacks == 0, "commitment: planned fallback")
    cuda = dev.type == "cuda"
    mpt_recs = (rec_gmpt.records + boot.rec.records + rec_storage.records
                + rec_resident.records)
    check(not cuda or (k1 == len(mpt_recs) + len(rec_shadow.records)
                       and k2 == len(rec_k2.records)),
          f"commitment: K1 {k1} launches, {len(mpt_recs)} + "
          f"{len(rec_shadow.records)} recorded; K2 {k2}, "
          f"{len(rec_k2.records)} recorded")
    check(len(rec_shadow.records) > g_shadow and rec_k2.records,
          "commitment: no shadow K1 launch in the blocks, or no K2 launch "
          "by the precompile")
    check(all(w.shape[1] == 1 for w, _o, _v in rec_shadow.records),
          "commitment: a shadow segment of more than one block")
    if cuda:
        for rec, label in ((rec_shadow, "commitment shadow"),
                           (rec_storage, "commitment storage programs"),
                           (rec_resident, "commitment resident executor")):
            ran = check_variants(rec, label)
            log(f"{label}: every K1 launch ran the variant its shape calls "
                f"for (" + ", ".join(f"{VARIANT_NAME[v]} {n}"
                                     for v, n in ran.items()) + ")")
        ran = check_variants_k2(rec_k2, "commitment precompile")
        log("commitment precompile: every K2 launch ran the variant its "
            "lane count calls for (" + ", ".join(
                f"{VARIANT_NAME[v]} {n}" for v, n in ran.items()) + ")")

    # witnesses against the last shadow root; MPT proofs and a range proof
    # against the head's root
    rng = np.random.default_rng(seed + 3)
    last = chain.current_block.header.root
    broot = shadow.root_for(last)
    present = [int(i) for i in rng.choice(len(world.addrs), 100,
                                          replace=False)]
    t0 = time.perf_counter()
    for i in present:
        key = keccak256(world.addrs[i])
        w = bwitness.prove(shadow.store, broot, key)
        check(bwitness.verify_witness(broot, key, w) == (
            True, shadow_mod.encode_account(world.nonce[i], world.balance[i],
                                            world.code_hash[i], False)),
              f"commitment: witness of account {i}")
    for _ in range(100):
        key = rng.bytes(32)
        check(bwitness.verify_witness(
            broot, key, bwitness.prove(shadow.store, broot, key))
              == (False, None), "commitment: absence witness")
    wit_ms = (time.perf_counter() - t0) * 1e3
    backend = chain.state_database.backend
    t0 = time.perf_counter()
    for i in present:
        key = keccak256(world.addrs[i])
        proof = backend.prove(last, key)
        check(backend.verify(last, key, proof) == (
            True, world.account(i, oracle.root_of(i)).encode()),
              f"commitment: MPT proof of account {i}")
    proof_ms = (time.perf_counter() - t0) * 1e3
    keys = sorted(oracle.keys)
    index = {k: i for i, k in enumerate(oracle.keys)}
    start = int(rng.integers(0, len(keys) - 1000))
    rk = keys[start:start + 1000]
    rv = [world.account(index[k], oracle.root_of(index[k])).encode()
          for k in rk]
    trie = backend.walkable(last).trie
    edge = {keccak256(blob): blob for k in (rk[0], rk[-1])
            for blob in mpt_prove(trie, k)}
    t0 = time.perf_counter()
    more = verify_range_proof(last, rk[0], rk[-1], rk, rv, edge)
    range_ms = (time.perf_counter() - t0) * 1e3
    check(more is True, "commitment: the range proof was not accepted")
    try:
        verify_range_proof(last, rk[0], rk[-1], rk[:500] + rk[501:],
                           rv[:500] + rv[501:], edge)
        check(False, "commitment: a range with a leaf dropped was accepted")
    except ProofError:
        pass
    moved = {n: default_registry.counter(n).count() - before[n]
             for n in names}
    check(not any(moved.values()), f"commitment: counters moved {moved}")
    check(lad.healthy and not mirror.host_mode,
          "commitment: the ladder is demoted or the mirror on the host")
    vm.shutdown()
    lanes = default_registry.counter("bintrie/planned/lanes").count() - lanes0
    commits = (default_registry.counter("bintrie/planned/commits").count()
               - commits0)
    mpt_all = sum(m for m, _ in per_block)
    bin_all = sum(b for _, b in per_block)
    log(f"commitment: launches by source: K1 shadow genesis {g_shadow}, "
        f"shadow blocks {len(rec_shadow.records) - g_shadow}, MPT genesis "
        f"{len(rec_gmpt.records)}, mirror boot {len(boot.rec.records)}, "
        f"storage programs {len(rec_storage.records)}, resident executor "
        f"{len(rec_resident.records)}; K2 precompile {len(rec_k2.records)} "
        f"({bk.lanes} messages, {pad} padding lanes); bintrie/planned/"
        f"commits {commits}, /lanes {lanes}; blocks' chain/commit/bintrie "
        f"/ chain/commit/mpt = {bin_all:.1f} / {mpt_all:.1f} ms = "
        f"{bin_all / mpt_all:.3f}; shadow {status}; 100 witnesses present "
        f"and 100 absent verified in {wit_ms:.1f} ms, 100 MPT proofs "
        f"through MPTBackend in {proof_ms:.1f} ms, a range proof of 1,000 "
        f"leaves accepted in {range_ms:.1f} ms and refused with one leaf "
        f"dropped; no loud counter moved; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return (rec_shadow.records, mpt_recs, k1, k1_coop, rec_k2, k2, k2_coop,
            pad)


MESH_WIDTH = 4  # the virtual mesh on the one card: [cuda:0] * 4


def _mesh_blocks(rng, state: dict, n_blocks: int, n_updates: int):
    """Seeded update batches of the mesh phase: replace 60%, insert 30%,
    delete 10%; `state` follows them. Returns (batches, oracle roots), the
    roots from the native host planner over each full state."""
    batches, roots = [], []
    for _ in range(n_blocks):
        keys = list(state)
        b = []
        for _ in range(n_updates):
            r = rng.random()
            if r < 0.6:
                b.append((keys[int(rng.integers(len(keys)))],
                          rng.bytes(int(rng.integers(70, 110)))))
            elif r < 0.9:
                b.append((rng.bytes(32), rng.bytes(int(rng.integers(70,
                                                                     110)))))
            else:
                b.append((keys[int(rng.integers(len(keys)))], b""))
        for k, v in b:
            if v:
                state[k] = v
            else:
                state.pop(k, None)
        batches.append(b)
        roots.append(plan_from_items(sorted(state.items())).execute_cpu())
    return batches, roots


def phase_mesh_legacy(dev, n_accounts, seed, card):
    """The mesh and the legacy executors (module docstring, phase 8d).
    Every K1 and K2 launch goes through one recorder each (the wrappers
    keccak_cuda.segment_keccak and keccak256_blocks replaced by recorders
    that call them while the phase builds and runs its executors). Returns
    (K1 recorder, K2 recorder, K1 launches, of them cooperative, K2
    launches, of them cooperative, K2's padding lanes)."""
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    rng = np.random.default_rng(seed)
    state = {rng.bytes(32): rng.bytes(int(rng.integers(70, 110)))
             for _ in range(n_accounts)}
    items = sorted(state.items())
    boot_root = plan_from_items(items).execute_cpu()
    batches, roots = _mesh_blocks(rng, dict(state), 3, 2_000)
    rec1 = _K1Recorder(launch=keccak_cuda.segment_keccak)
    rec2 = _K2Recorder(launch=keccak_cuda.keccak256_blocks)
    # (name, the mirror's device argument: one device named gives a
    # virtual mesh on it, None the first n CUDA devices)
    meshes = [(f"width 1 on {dev}", 1, dev),
              (f"width {MESH_WIDTH} on [{dev}] * {MESH_WIDTH}", MESH_WIDTH,
               dev)]
    if cuda and torch.cuda.device_count() > 1:
        n = min(torch.cuda.device_count(), MESH_WIDTH)
        meshes.append((f"width {n} on cuda:0..{n - 1}", n, None))
    log(f"mesh: meshes {[name for name, _, _ in meshes]} (the card count "
        f"{torch.cuda.device_count() if cuda else 0})")
    msgs = [rng.bytes(int(n)) for n in rng.integers(0, 600, 4000)]
    want_digests = keccak256_batch(msgs, threads=8)
    pad = 0
    keccak_cuda.reset_counts()
    with mock.patch.object(keccak_cuda, "segment_keccak", rec1), \
            mock.patch.object(keccak_cuda, "keccak256_blocks", rec2):
        for name, width, on in meshes:
            mesh = parallel.make_mesh(width, device=on)
            t0 = time.perf_counter()
            sk = parallel.ShardedKeccak(mesh)
            check(sk.digests(msgs) == want_digests,
                  f"mesh {name}: ShardedKeccak != the host keccak")
            target = mesh.size * 8
            while target < len(msgs):
                target *= 2
            pad += target - len(msgs)
            words, nblocks = pack_messages(msgs[:1024])
            out, checksum = parallel.commit_step(mesh)(words, nblocks)
            host = int32_to_words(out)
            check(digest_words_to_bytes(host) == want_digests[:1024]
                  and int(checksum) == int(np.sum(host, dtype=np.uint32)),
                  f"mesh {name}: commit_step digests or checksum")
            plan = plan_from_items(items)
            runner = parallel.planned_commit_over_mesh(mesh)
            check(plan.execute_planned(runner) == boot_root,
                  f"mesh {name}: planned_commit_over_mesh root")
            sharded_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            m = ResidentAccountMirror(items, mesh_devices=width, device=on)
            check(m.shards == width and not m.host_mode
                  and m.root_of(m.GENESIS) == boot_root,
                  f"mesh {name}: mirror genesis root or shards")
            parent = m.GENESIS
            for i, (b, want) in enumerate(zip(batches, roots)):
                h = block_hash(900 + i)
                check(m.verify(parent, h, b) == want,
                      f"mesh {name}: mirror block {i + 1} root != oracle")
                parent = h
            lanes = list(m.ex.last_shard_lanes)
            gather = m.ex.last_gather_bytes_modeled
            mirror_ms = (time.perf_counter() - t0) * 1e3
            rungs = []
            while not m.host_mode:
                t0 = time.perf_counter()
                rungs.append((m.take_over_host("mesh phase: one rung"),
                              m.shards, (time.perf_counter() - t0) * 1e3))
                b = batches[0]
                check(m.verify(m.GENESIS, block_hash(950 + len(rungs)), b)
                      == roots[0], f"mesh {name}: root on rung {rungs[-1]}")
            check([r for r, _, _ in rungs] == (["device", "host"]
                                               if width > 1 else ["host"]),
                  f"mesh {name}: rungs {rungs}")
            log(f"mesh {name}: ShardedKeccak of {len(msgs)} messages, "
                f"commit_step of 1,024 and planned_commit_over_mesh of "
                f"{len(items)} leaves {sharded_ms:.1f} ms; mirror boot + "
                f"{len(batches)} blocks of {len(batches[0])} updates "
                f"{mirror_ms:.1f} ms (last commit's lanes per shard "
                f"{lanes}, modeled gather {gather} B); take_over_host "
                + ", ".join(f"-> {r} ({n} shard(s), {ms:.1f} ms)"
                            for r, n, ms in rungs)
                + "; every root the oracle's")

        # the legacy executors on a block's plan
        after = dict(state)
        for b in batches[:1]:
            for k, v in b:
                if v:
                    after[k] = v
                else:
                    after.pop(k, None)
        plan = plan_from_items(sorted(after.items()))
        want_root, want_dig, real = plan.execute_cpu_digests(threads=8)
        t0 = time.perf_counter()
        f_root, f_dig = plan.execute_device(device=dev)
        fused_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        s_root, s_dig = plan.execute_staged(device=dev)
        staged_ms = (time.perf_counter() - t0) * 1e3
        check(f_root == s_root == want_root == roots[0],
              "legacy: fused / staged root != the host oracle's")
        check(np.array_equal(f_dig[real], want_dig[real])
              and np.array_equal(s_dig[real], want_dig[real]),
              "legacy: a real lane's digest differs from the host's")
        n_seg = len(plan.export()[0])
        log(f"legacy: a block's plan ({len(after)} leaves, {n_seg} "
            f"segments, {plan.total_lanes} lanes): fused_commit "
            f"{fused_ms:.1f} ms, StagedCommit {staged_ms:.1f} ms; roots and "
            f"every real lane's digest the host's")

        # a chain in device-hasher "fused" (the account trie too: the
        # mirror off), its blocks made on the CPU Hasher
        world = World(2_000, 4, 20, seed + 1, n_keyed=300)
        signed = evm_transactions(world, 2, seed + 2, n_calls=4,
                                  n_transfers=150)
        maker_disk = MemoryDB()
        maker = Database(TrieDatabase(maker_disk))
        gen_block = genesis_alloc(world).commit(maker_disk, maker)
        blocks, _ = generate_chain(
            params.TEST_CHAIN_CONFIG, gen_block, new_dummy_engine(), maker,
            2, gen=lambda i, bg: [bg.add_tx(Transaction.decode(t.blob))
                                  for t in signed[i]])
        fused_before = len(rec2.records)
        t0 = time.perf_counter()
        chain = BlockChain(MemoryDB(), CacheConfig(
            device_hasher="fused", resident_account_trie=False),
            params.TEST_CHAIN_CONFIG, genesis_alloc(world),
            new_dummy_engine(), device=dev)
        check(isinstance(chain.state_database.triedb.batch_keccak,
                         device_mod.FusedModeKeccak)
              and chain.genesis_block.root == gen_block.root,
              "fused chain: marker or genesis root")
        per_block = []
        for b in blocks:
            t1 = time.perf_counter()
            pb = Block.decode(b.encode())
            chain.insert_block(pb)
            chain.accept(pb)
            check(chain.current_block.root == b.root,
                  "fused chain: root != the CPU Hasher's")
            per_block.append((time.perf_counter() - t1) * 1e3)
        chain.drain_acceptor_queue()
        chain.stop()
        chain_ms = (time.perf_counter() - t0) * 1e3
        check(len(rec2.records) > fused_before,
              "fused chain: no K2 launch by the fused commits")
        log(f"fused chain: genesis of {len(world.addrs)} accounts and "
            f"{len(blocks)} blocks of {len(signed[0])} transactions, every "
            f"root the CPU Hasher's; insert + accept "
            + ", ".join(f"{ms:.1f}" for ms in per_block)
            + f" ms; {len(rec2.records) - fused_before} K2 launches; "
            f"{chain_ms:.1f} ms in all")
    k1, k1_coop = keccak_cuda.launches, keccak_cuda.launches_coop
    k2, k2_coop = keccak_cuda.blocks_launches, keccak_cuda.blocks_launches_coop
    check(len(rec1.records) > 0 and len(rec2.records) > 0,
          "mesh: a kernel of the phase was not launched")
    check(not cuda or (k1 == len(rec1.records) and k2 == len(rec2.records)),
          f"mesh: K1 {k1} launches, {len(rec1.records)} recorded; K2 {k2}, "
          f"{len(rec2.records)} recorded")
    if cuda:
        for label, ran in (("mesh K1", check_variants(rec1, "mesh K1")),
                           ("mesh K2", check_variants_k2(rec2, "mesh K2"))):
            log(f"{label}: every launch ran the variant its shape calls for ("
                + ", ".join(f"{VARIANT_NAME[v]} {n}" for v, n in ran.items())
                + ")")
    log(f"mesh and legacy executors: phase wall "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    log(f"mesh and legacy executors: launches K1 {len(rec1.records)}, K2 "
        f"{len(rec2.records)} (of them ShardedKeccak padding lanes {pad})")
    return rec1, rec2, k1, k1_coop, k2, k2_coop, pad


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
    ap.add_argument("--blocks", type=int, default=4,
                    help="resident blocks after the first, one rejected")
    ap.add_argument("--evm-blocks", type=int, default=4,
                    help="blocks of signed transactions through the EVM")
    ap.add_argument("--option-blocks", type=int, default=6,
                    help="blocks after them, planned mode only, for the "
                         "chain's execution options (>= 4)")
    ap.add_argument("--vm-blocks", type=int, default=2,
                    help="blocks built, verified and accepted through the "
                         "VM after the chain phase")
    ap.add_argument("--drill-accounts", type=int, default=2_000,
                    help="accounts of the ladder drill's own VM")
    ap.add_argument("--shadow-accounts", type=int, default=50_000,
                    help="accounts of the commitment VM (the bintrie "
                         "shadow and the keccak precompile)")
    ap.add_argument("--shadow-blocks", type=int, default=3,
                    help="blocks through the commitment VM")
    ap.add_argument("--mesh-accounts", type=int, default=100_000,
                    help="leaves of the mesh phase's account trie")
    ap.add_argument("--device", default="cuda",
                    help="'cpu' rehearses with the plain versions")
    args = ap.parse_args()
    if args.option_blocks < 4:
        ap.error("--option-blocks must be at least 4")
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

    mark(t_start, "world and CPU oracle")
    t0 = time.perf_counter()
    world = World(args.accounts, args.contracts, args.slots, args.seed,
                  n_keyed=EVM_KEYED)
    oracle = Oracle(world)
    oracle_root = oracle.root()
    # the EVM phase's chain starts at genesis: its own snapshots
    evm_world = world.snapshot()
    evm_oracle = oracle.snapshot(evm_world)
    # the script's own world and oracle (millions of tracked objects) leave
    # the collector's view: the port's garbage-collector pauses measured
    # below then traverse the port's objects, not this harness's
    gc.freeze()
    log(f"genesis: CPU oracle (independent tries) "
        f"{time.perf_counter() - t0:.1f} s; peak RSS {rss_gib():.1f} GiB; "
        f"{gc.get_freeze_count()} objects frozen out of the collector")

    # planned path (K1): Genesis.commit inside the chain's construction,
    # which boots the resident mirror (K1) and the snapshot tree
    mark(t_start, "planned genesis")
    (vm, mem, diskdb, gen_block, g_builder, g_launches, g_coop, cb_launches,
     cb_coop, cb_rec) = phase_genesis(dev, world, oracle_root)
    g_err, g_ms, g_plain, g_shapes, g_kernel = check_and_time(
        dev, g_builder, "genesis")
    del g_builder
    if dev.type == "cuda":
        ran = check_variants(cb_rec, "chain mirror boot")
        log("chain mirror boot: every K1 launch ran the variant its shape "
            "calls for (" + ", ".join(
                f"{VARIANT_NAME[v]} {n}" for v, n in ran.items()) + ")")
    cb_err, cb_ms, cb_plain, cb_shapes, cb_kernel = time_k1(
        dev, [r[0] for r in cb_rec.records], "chain mirror boot",
        outputs=[r[1] for r in cb_rec.records])
    del cb_rec
    # batched path (K2)
    mark(t_start, "batched genesis")
    mode, b_trie, b_changed, bg_launches, bg_coop, bg_rec = \
        phase_genesis_batched(dev, world, oracle_root)
    bg_pad = mode.batched.padded_lanes - mode.batched.lanes
    bg_err, bg_ms, bg_plain, bg_inputs, bg_kernel = check_and_time_k2(
        bg_rec, "batched genesis", bg_pad, profile_reps=1)
    del bg_rec
    log(f"after the two genesis commits: peak RSS {rss_gib():.1f} GiB")

    # one block, made once, applied to the oracle and to every state
    mark(t_start, "block")
    accounts, writes, transfers = make_block(world)
    log(f"block: {len(accounts)} account updates, {len(writes)} contracts, "
        f"{sum(len(w) for w in writes.values())} slot writes")
    t0 = time.perf_counter()
    oracle.apply(accounts, writes)
    want = oracle.root()
    log(f"block: CPU oracle {time.perf_counter() - t0:.1f} s")
    b_builder, b_launches, b_coop = phase_block(
        dev, world, diskdb,
        TrieDatabase(diskdb, batch_keccak=get_batch_keccak("planned", dev)),
        gen_block.root,
        (accounts, writes, transfers), want, args.seed + 1)
    b_err, b_ms, b_plain, b_shapes, b_kernel = check_and_time(
        dev, b_builder, "block")
    del b_builder  # the genesis store stays: the mirrors boot from it
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

    # signed transactions through the EVM and generate_chain, from the
    # planned genesis, in the three modes (K1 planned, K2 batched)
    mark(t_start, "evm")
    evm_planned, evm_batched, touched, written, coinbase_fee = phase_evm(
        dev, evm_world, evm_oracle, diskdb, gen_block, args.evm_blocks,
        args.option_blocks, args.seed + 5, card)
    # the same blocks through the chain booted at genesis (K1: storage
    # programs and the resident executor), the last ones through the
    # execution options
    mark(t_start, "chain")
    c_storage, c_resident, c_launches, c_coop, c_exports = phase_chain(
        dev, vm.blockchain, evm_planned.blocks, args.evm_blocks, card)
    # then blocks built, verified and accepted through the VM on the same
    # chain (K1: storage programs and the resident executor), and the
    # chain's stop through vm.shutdown()
    mark(t_start, "vm")
    vm_coinbase = [0]
    (v_storage, v_resident, v_launches, v_coop, v_touched,
     v_written) = phase_vm(dev, vm, mem, evm_world, evm_oracle,
                           args.vm_blocks, vm_coinbase, args.seed + 7, card)
    for c, keys in v_written.items():
        written[c] = set(written.get(c, ())) | keys
    finish_chain(dev, vm, evm_world, sorted(set(touched) | set(v_touched)),
                 written, coinbase_fee, vm_coinbase[0], c_exports,
                 args.seed + 6, card)
    del vm, mem, evm_world, evm_oracle
    cs_err, cs_ms, cs_plain, cs_shapes, cs_kernel = time_k1(
        dev, [r[0] for r in c_storage.records], "chain storage programs",
        per_segment=False, outputs=[r[1] for r in c_storage.records])
    cr_err, cr_ms, cr_plain, cr_shapes, cr_kernel = time_k1(
        dev, [r[0] for r in c_resident.records], "chain resident executor",
        per_segment=False, outputs=[r[1] for r in c_resident.records])
    del c_storage, c_resident
    vs_err, vs_ms, vs_plain, vs_shapes, vs_kernel = time_k1(
        dev, [r[0] for r in v_storage.records], "vm storage programs",
        per_segment=False, outputs=[r[1] for r in v_storage.records])
    vr_err, vr_ms, vr_plain, vr_shapes, vr_kernel = time_k1(
        dev, [r[0] for r in v_resident.records], "vm resident executor",
        per_segment=False, outputs=[r[1] for r in v_resident.records])
    del v_storage, v_resident
    e1_err, e1_ms, e1_plain, e1_shapes, e1_kernel = time_k1(
        dev, [r[0] for r in evm_planned.rec.records], "evm planned",
        per_segment=False, outputs=[r[1] for r in evm_planned.rec.records])
    e2_err, e2_ms, e2_plain, e2_inputs, e2_kernel = check_and_time_k2(
        evm_batched.rec, "evm batched", evm_batched.pad, profile_reps=10)
    e2_pad = evm_batched.pad
    del evm_planned.rec, evm_batched.rec

    # resident path (K1): the mirrors inside StateDB
    mark(t_start, "mirror")
    run, m_launches, m_coop, n_genesis = phase_mirror(
        dev, world, oracle, diskdb, gen_block, (accounts, writes, transfers),
        want, args.blocks, rejected_at=2 + args.blocks // 2,
        seed=args.seed + 3)
    del diskdb
    log(f"after the mirror phase: peak RSS {rss_gib():.1f} GiB")
    # the degradation ladder drilled on a small VM of its own, after the
    # main paths (their loud counters, ops/device/* among them, must not
    # have moved)
    mark(t_start, "ladder drill")
    (d_storage, d_resident, d_launches, d_coop, d_k2rec, d_k2, d_k2_coop,
     d_pad) = phase_ladder_drill(dev, args.drill_accounts, args.seed + 8,
                                 card)
    ds_err, ds_ms, ds_plain, ds_shapes, ds_kernel = time_k1(
        dev, [r[0] for r in d_storage.records + d_resident.records],
        "ladder drill", per_segment=False,
        outputs=[r[1] for r in d_storage.records + d_resident.records])
    dk_err, dk_ms, dk_plain, dk_inputs, dk_kernel = check_and_time_k2(
        d_k2rec, "ladder drill probes", d_pad, profile_reps=10)
    del d_storage, d_resident, d_k2rec
    # the commitment VM: the bintrie shadow's planned commits (K1) and the
    # keccak precompile (K2) on a VM of its own
    mark(t_start, "commitment")
    (cm_shadow, cm_mpt, cm_k1, cm_k1_coop, cm_k2rec, cm_k2, cm_k2_coop,
     cm_pad) = phase_commitment(dev, args.shadow_accounts,
                                args.shadow_blocks, args.seed + 9, card)
    sh_err, sh_ms, sh_plain, sh_shapes, sh_kernel = time_k1(
        dev, [r[0] for r in cm_shadow], "commitment shadow",
        per_segment=False, outputs=[r[1] for r in cm_shadow])
    sh_bound, sh_by = k1_bound_ms(sh_shapes)
    log(f"commitment shadow: {len(sh_shapes)} K1 launches over "
        f"{sum(p for p, _ in sh_shapes)} lanes, bound {sh_bound:.4f} ms "
        f"({sh_by})")
    cm_err, cm_ms, cm_plain, cm_shapes, cm_kernel = time_k1(
        dev, [r[0] for r in cm_mpt], "commitment MPT", per_segment=False,
        outputs=[r[1] for r in cm_mpt])
    del cm_shadow, cm_mpt
    ck_err, ck_ms, ck_plain, ck_inputs, ck_kernel = check_and_time_k2(
        cm_k2rec, "commitment precompile", cm_pad, profile_reps=10)
    del cm_k2rec
    # the mesh (sharded K1/K2 launches, the mirror's mesh rung) and the
    # legacy executors (fused: K2, staged: K1) on a world of their own
    mark(t_start, "mesh and legacy executors")
    ml_rec1, ml_rec2, ml_k1, ml_k1_coop, ml_k2, ml_k2_coop, ml_pad = \
        phase_mesh_legacy(dev, args.mesh_accounts, args.seed + 10, card)
    ml_err, ml_ms, ml_plain, ml_shapes, ml_kernel = time_k1(
        dev, [r[0] for r in ml_rec1.records], "mesh and legacy K1",
        per_segment=False, outputs=[r[1] for r in ml_rec1.records])
    mk_err, mk_ms, mk_plain, mk_inputs, mk_kernel = check_and_time_k2(
        ml_rec2, "mesh and legacy K2", ml_pad, profile_reps=10)
    del ml_rec1, ml_rec2
    mark(t_start, "watchdog drill")
    phase_watchdog_drill(dev, args.seed + 4)
    ran = defaultdict(int)
    if dev.type == "cuda":
        for rec in run.rec.values():
            for v, n in check_variants(rec, "mirror").items():
                ran[v] += n
        log(f"mirror: every K1 launch ran the variant its shape calls for "
            f"({', '.join(f'{VARIANT_NAME[v]} {n}' for v, n in ran.items())})")
    genesis_rec, block_rec = [], []
    for name, rec in run.rec.items():
        genesis_rec += rec.records[:n_genesis[name]]
        block_rec += rec.records[n_genesis[name]:]
    del run
    rg_err, rg_ms, rg_plain, rg_shapes, rg_kernel = time_k1(
        dev, [r[0] for r in genesis_rec], "mirror genesis",
        outputs=[r[1] for r in genesis_rec])
    rb_err, rb_ms, rb_plain, rb_shapes, rb_kernel = time_k1(
        dev, [r[0] for r in block_rec], "mirror blocks", per_segment=False,
        outputs=[r[1] for r in block_rec])
    del genesis_rec, block_rec

    mark(t_start, "fallback")
    phase_fallback(dev, args.seed)

    k1_shapes = (g_shapes + cb_shapes + b_shapes + e1_shapes + cs_shapes
                 + cr_shapes + vs_shapes + vr_shapes + rg_shapes + rb_shapes
                 + ds_shapes + sh_shapes + cm_shapes + ml_shapes)
    k1_bound, k1_by = k1_bound_ms(k1_shapes)
    rk_bound, rk_by = k1_bound_ms(rg_shapes + rb_shapes)
    log(f"K1 bound over the mirror's inputs {rk_bound:.4f} ms ({rk_by}; "
        f"genesis {k1_bound_ms(rg_shapes)[0]:.4f} ms, blocks "
        f"{k1_bound_ms(rb_shapes)[0]:.4f} ms); K1 events {rg_ms:.4f} / "
        f"{rb_ms:.4f} ms")
    k1_launches = (g_launches + cb_launches + b_launches + evm_planned.k1
                   + c_launches + v_launches + m_launches + d_launches
                   + cm_k1 + ml_k1)
    k1_coop = (g_coop + cb_coop + b_coop + evm_planned.k1_coop + c_coop
               + v_coop + m_coop + d_coop + cm_k1_coop + ml_k1_coop)
    k2_inputs = (bg_inputs + bb_inputs + e2_inputs + dk_inputs + ck_inputs
                 + mk_inputs)
    k2_bound, k2_by = k2_bound_ms(k2_inputs)
    k2_real, _ = k2_bound_ms(k2_inputs, bg_pad + bb_pad + e2_pad + d_pad
                             + cm_pad + ml_pad)
    log(f"K2 bound over the batched commits {k2_bound:.4f} ms ({k2_by}), "
        f"over their real lanes alone {k2_real:.4f} ms")
    log(f"launches on the main paths: K1 genesis {g_launches}, the chain's "
        f"mirror boot {cb_launches}, block {b_launches}, evm planned "
        f"{evm_planned.k1}, chain inserts {c_launches}, vm blocks "
        f"{v_launches}, mirrors {m_launches}, ladder drill {d_launches}, "
        f"commitment VM {cm_k1} (of them the shadow {len(sh_shapes)}), "
        f"mesh and legacy executors {ml_k1}; K2 batched genesis "
        f"{bg_launches}, batched block {bb_launches}, evm batched "
        f"{evm_batched.k2}, ladder drill probes {d_k2}, the keccak "
        f"precompile {cm_k2}, mesh and legacy executors {ml_k2}")
    log(f"peak RSS {rss_gib():.1f} GiB")
    left = descendants()
    check(not left, f"processes left at the end: {left}")
    log(f"card {card}; total {time.perf_counter() - t_start:.1f} s; no "
        f"process left")
    print(json.dumps({"kernels": [{
        "name": "segment_keccak",
        "route": "cuda",
        "source": "coreth_tpu_torch/ops/csrc/segment_keccak.cu",
        "replaces": "coreth_tpu/ops/keccak_pallas.py:211",
        "launches": k1_launches,
        "max_abs_err": max(grid_err, g_err, cb_err, b_err, e1_err, cs_err,
                           cr_err, vs_err, vr_err, rg_err, rb_err, ds_err,
                           sh_err, cm_err, ml_err),
        "ms": (g_ms + cb_ms + b_ms + e1_ms + cs_ms + cr_ms + vs_ms + vr_ms
               + rg_ms + rb_ms + ds_ms + sh_ms + cm_ms + ml_ms),
        "plain_ms": (g_plain + cb_plain + b_plain + e1_plain + cs_plain
                     + cr_plain + vs_plain + vr_plain + rg_plain + rb_plain
                     + ds_plain + sh_plain + cm_plain + ml_plain),
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
        "variants": variants_json(k1_launches, k1_coop, g_kernel,
                                  cb_kernel, b_kernel, e1_kernel, cs_kernel,
                                  cr_kernel, vs_kernel, vr_kernel,
                                  rg_kernel, rb_kernel, ds_kernel,
                                  sh_kernel, cm_kernel, ml_kernel),
    }, {
        "name": "keccak_blocks",
        "route": "cuda",
        "source": "coreth_tpu_torch/ops/csrc/keccak_blocks.cu",
        "replaces": "coreth_tpu/ops/keccak_pallas.py:126",
        "launches": bg_launches + bb_launches + evm_batched.k2 + d_k2
        + cm_k2 + ml_k2,
        "max_abs_err": max(grid2_err, bg_err, bb_err, e2_err, dk_err,
                           ck_err, mk_err),
        "ms": bg_ms + bb_ms + e2_ms + dk_ms + ck_ms + mk_ms,
        "plain_ms": (bg_plain + bb_plain + e2_plain + dk_plain + ck_plain
                     + mk_plain),
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
        "variants": variants_json(
            bg_launches + bb_launches + evm_batched.k2 + d_k2 + cm_k2
            + ml_k2,
            bg_coop + bb_coop + evm_batched.k2_coop + d_k2_coop + cm_k2_coop
            + ml_k2_coop,
            bg_kernel, bb_kernel, e2_kernel, dk_kernel, ck_kernel,
            mk_kernel),
    }]}), flush=True)
    if dev.type != "cuda":
        return 0  # a rehearsal prints no result line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
