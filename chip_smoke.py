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
  6. batched genesis commit: a world of its own, the main world's shape
     at --batched-accounts (100,000) with its own CPU oracle, in fresh
     tries committed by intermediate_root on get_batch_keccak("batched"):
     every trie above the threshold hashed level by level through K2; its
     oracle's root, and every K2 lane's digest equal to the plain
     version's
  7. block: 700 transfers plus 50 contracts x 20 slot writes, made once
     and applied to every state: on the planned state as StateDB
     operations and StateDB.commit, then TrieDatabase.commit, and a fresh
     TrieDatabase and StateDB over the same MemoryDB read back every
     account the block touched, 1,000 others and every slot written; on
     the batched state (its own world: a block of the same make applied
     to it and to its oracle) through intermediate_root. Every root
     checked against its oracle
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
     that store 20 slots and log) through the VM on that chain, fed over
     JSON-RPC: create_handlers(vm) (eth-apis plus debug and txpool)
     serves HTTP on a free loopback port, each transaction goes in as
     eth_sendRawTransaction in batches of RPC_BATCH (100), and in the
     first block one ImportTx (consuming a UTXO seeded into the shared
     memory from the X chain) and one ExportTx go in as avax.issueTx
     (the second block's wallet path follows); then, once the pools hold
     them, the engine drives the block across a process boundary: the VM
     is served by plugin.VMServer on a unix socket in a temporary
     directory (its listener and connection threads in this process,
     where the VM holds the card) and an engine child, started with
     subprocess, importing the plugin client alone under an import guard
     that refuses torch too (_ENGINE_CHILD), calls buildBlock (the miner
     from the tx pool and the atomic mempool; finalize_and_assemble's
     intermediate_root: the storage programs on K1 under the degradation
     ladder, the account trie on the mirror's executor on K1;
     insert_block_manual(writes=False)), blockVerify
     (insert_block_manual(writes=True), the atomic backend),
     setPreference and blockAccept (the acceptor drained) through
     RemoteVM, each call's round trip printed beside its time on the VM's
     side. After the last block `shutdown` over the socket stops the
     server (not the VM), its threads joined, and the child exits 0. The
     VM's
     config also names a keystore directory under the run's temporary
     directory, opts the personal namespace in and sets
     ws-notify-queue-size 64: serve_ws(vm, rpc_server=server) serves
     WebSocket beside HTTP (one backend, one filter stack), and before
     the first block a WSEthClient (ethclient.ws_connect) subscribes to
     newHeads, to logs of the called contracts' addresses and to
     newPendingTransactions. Before the second block, over that
     connection, personal_importRawKey and personal_unlockAccount
     (duration 0) of two keyed senders; 16 of that block's transfers are
     theirs and go in as eth_sendTransaction with every field given, each
     answer the hash of the transaction the harness signs itself; and
     that block's ImportTx (of a UTXO seeded from the X chain) and
     ExportTx are built by the node's wallet: avax.importKey of a third
     key, avax.import and avax.export (vm/tx_builder.py, dynamic fees).
     Every header root equals the EVM-independent oracle's
     (evm_oracle_block over the block's own transaction order, the fees
     to the miner's coinbase, plus the atomic txs' balance and nonce
     changes, the wallet's read from the block's atomic txs); the head is
     vm.last_accepted(); the mempool and the tx pool end empty; after
     each block with atomic txs the shared memory holds its export's UTXO
     and not its import's; no loud, fallback or ops/device/* counter
     moves. Each block's WS pushes match it: one newHeads push with its
     hash, number and state root, one logs push per receipt log (address,
     topics, data, transaction, block), one newPendingTransactions push
     per transaction it carries (the wallet's included), no other push;
     no notify drop or slow disconnect is counted. Push latencies are
     taken from the accept (heads, logs) and from each
     eth_sendTransaction (the wallet's pending pushes). After each block, reads over
     RPC held against the block and the oracle's world (rpc_block_reads:
     the block, receipts, every touched balance and written slot, logs,
     eth_call and eth_estimateGas of a contract call, fee history, the
     atomic txs' status, health.check, debug_deviceStatus, and /metrics
     and /healthz of the metrics endpoint the VM's config starts); after
     the first, 16 eth_getProof at the resident head, each verified
     against the header root (rpc_proofs), so that the second block's
     delta is still on the card for the shutdown export. Any error object
     fails the run. Per block it prints issue,
     build, verify and accept ms, the K1 launches of build and verify
     (storage programs, resident executor), the flight record's phases,
     the mirror's window and Mgas/s over build + verify; the K1 launches
     are recorded and held against the plain version. Then the
     WSEthClient closes and ws.stop() joins the WebSocket server's
     threads; the keystore's light scrypt is timed on one keyfile; the
     engine child and the plugin server end as above. Then
     vm.shutdown() (the RPC server's drain and stop, the metrics endpoint,
     the keystore's close, the chain's stop() and its shutdown export), the forkserver and the resource
     tracker stopped (exec_shards.stop_servers), and no process the run
     started may be left, here and again at the end, nor a thread the
     phase started; the last accepted root reads back through a fresh
     TrieDatabase
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
     chain/commit/bintrie timers. Over JSON-RPC after the last block
     (rpc_commitment): the eth_call of keccak256Batch over 128 seeded
     512-byte messages through BoundContract(...).call (accounts/abi.py's
     ABI) over ethclient.Client(url), then again as eth_call over a WS
     connection to the same server (serve_ws); each one K2 launch on the
     server's expensive lane, the digests native keccak256's;
     debug_stateWitness of 16 touched accounts verified against the
     returned bintrieRoot, and debug_commitmentStatus unquarantined. The
     VM's commit-interval and state-sync-commit-interval are
     --shadow-blocks, so its last block is a syncable summary for 8f,
     which runs before the VM shuts down
  8f. state sync (phase_state_sync): StateSyncServer(the commitment VM's
     chain, its state-sync-commit-interval) gives the summary at its
     head; a client VM from the same genesis boots on a SQLiteDB in a
     temporary directory (its resident mirror on the card) and syncs
     through StateSyncClient(vm, SyncClient.from_config(net, ...)) over
     the TCP transport (TransportServer on 127.0.0.1, dial()) from the
     VM's sync_handler, a second peer on its own connection wrapped in
     FaultyTransport(script=["corrupt", "drop"]) (its corrupt answer is
     refused by the range proof, its drop rotated past). The client's
     head must be the summary, its mirror rebooted on the device over the
     synced root (K1), 200 accounts, every contract's code and 5 slots
     each the oracle's. The transport serves the server VM's own
     peer.Network (its request handler the sync handler), so sync, gossip
     and requests share one route. Then the cross-chain eth_call both
     ways: VM.cross_chain_eth_call of 8c's keccak256Batch call (128 x 512
     B), the client asking the server's chain and the server asking the
     client's synced head over their Networks' cross-chain registries,
     each answer the host Keccak's and 8c's over HTTP, each with a K2
     launch. Then the faulty peer is dropped and each VM gets a
     vm/gossiper.Gossiper over its Network: the first post-sync block's
     transactions are issued to the client's pool alone, and reach the
     server's pool by gossip over the TCP transport (every one of them
     there before build_block, no gossip/drops/* or gossip timeout
     counted); the server builds and accepts that block and one more
     through vm_block and the client parses, verifies and accepts each,
     every root the server's and the oracle's, both pools empty after.
     Prints the sync wall, leaves, requests, bytes, retries and
     rejections, peers by state, the reboot's K1 launches, the cross-
     chain calls' ms and K2 launches, the gossip messages sent and
     transactions heard, and each verify's ms and launches. Every K1 and
     K2 launch of the phase goes through a recorder and is held against
     the plain versions
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
  8e. chaos (phase_chaos): fault.chaos.Conductor(seed 7, --chaos-steps
     (64), kill drill on, device=cuda).run(): the conductor's node (the
     staged insert pipeline at depth 2 with the resident mirror on the
     card, two exec shards, RPC traffic through RPCServer, the lock
     witness and the sampling profiler) under the 19 catalogued
     failpoints, the degraded-rung storage drill and the SIGKILL drill,
     whose child chain runs on the card in a subprocess; the ladder's
     re-promotion probes hash on K2. Passes with 0 violations, 0
     watchdog trips, all five subsystems covered, the child's SQLite
     store repaired to exactly the head it reported, the child's chain on
     the card with K1 launched, no thread or process left. Prints the
     failpoints fired by subsystem, the steps/s, the final counters, the
     kill drill and the phase's K1 and K2 launches, each held against the
     plain versions
  8g. prune (phase_prune): a world of its own at --prune-accounts
     (20,000; the main world's shape) with its own oracle, and a resident
     BlockChain on the card at commit interval 2 over a SQLiteDB in a
     temporary directory (the genesis commit and the mirror boot on K1).
     Six blocks of 4 contract calls and 150 transfers are made up front
     by generate_chain over an overlay of its store, every root the
     oracle's. The chain inserts and accepts four (K1), stop() writes the
     shutdown export, core/pruner.Pruner.prune(tip root, genesis root)
     mark-sweeps the store on the host; the prune must delete nodes and
     keep the tip and genesis roots; a reopened resident chain reboots
     its mirror over the pruned store on K1 (launches > 0), its head the
     tip and a sample of 200 accounts and 5 slots a contract the
     oracle's, and takes the last two blocks, every root the oracle's;
     recover_pruning() is then False. Prints nodes deleted and kept,
     prune ms, the store's entries and bytes before and after
     (SQLiteDB.stat), the reboot's K1 launches and the phase's wall.
     Every K1 launch goes through a recorder and is held against the
     plain version
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
The closing "rpc:" line holds the run's HTTP and WS requests and their
walls apart, the WS pushes by kind, p50 / p99 per method and the push
latencies, beside the card's name and power limit.
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
import queue
import resource
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from collections import defaultdict
from unittest import mock

import numpy as np
import torch

from coreth_tpu_torch import fault, params, parallel, rlp
from coreth_tpu_torch.accounts.abi import ABI
from coreth_tpu_torch.accounts.bind import BoundContract
from coreth_tpu_torch.accounts.keystore import decrypt_key
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
from coreth_tpu_torch.ethclient import Client, ClientError, ws_connect
from coreth_tpu_torch.ethclient.ws import WSSubscriptionError
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
from coreth_tpu_torch.plugin import VMServer
from coreth_tpu_torch.ops.keccak_staged import segment_keccak_plain
from coreth_tpu_torch.ops.keccak_torch import RATE, BatchedKeccak, \
    default_batched_keccak, digest_words_to_bytes, int32_to_words, \
    keccak256_blocks_plain, pack_messages, words_to_int32
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
from coreth_tpu_torch.trie.proof import verify_proof
from coreth_tpu_torch.trie.proof_range import verify_range_proof
from coreth_tpu_torch.trie.planned import PlannedGraphBuilder
from coreth_tpu_torch.trie.resident_mirror import ResidentAccountMirror
from coreth_tpu_torch.trie.secure import StateTrie
from coreth_tpu_torch.trie.trie import trie_from_items
from coreth_tpu_torch.trie.triedb import TrieDatabase
from coreth_tpu_torch.vm import atomic_tx
from coreth_tpu_torch.vm.api import create_handlers, serve_ws
from coreth_tpu_torch.vm.config import DEFAULT_ETH_APIS
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
# the RPC tier (phases 7d and 8c): the reference's default eth-apis plus
# the debug and txpool namespaces, as a node operator opts them in; the
# transactions go in JSON-RPC batches of at most rpc-batch-limit
RPC_APIS = DEFAULT_ETH_APIS + ["debug", "txpool"]
RPC_BATCH = 100
RPC_PROOFS = 16       # eth_getProof accounts after the first VM block
RPC_PROOF_SLOTS = 4   # slots each
RPC_WITNESSES = 16    # debug_stateWitness accounts on the commitment VM
# the wallet (phase 7d): the main VM's keystore under the run's temporary
# directory, the personal namespace opted in, WebSocket pushes through a
# notify queue of WS_NOTIFY_QUEUE; before the second VM block two keyed
# senders' keys are imported and unlocked, and WALLET_TXS of that block's
# transfers are theirs, sent as eth_sendTransaction over WS; a third key,
# under a password of its own, builds the block's ImportTx (of a UTXO of
# WALLET_IMPORT nAVAX from the X chain) and its ExportTx (WALLET_EXPORT
# nAVAX) through avax.importKey, avax.import and avax.export
WS_NOTIFY_QUEUE = 64
WALLET_TXS = 16
WALLET_PASSWORD = "chip-smoke wallet"
AVAX_PASSWORD = "chip-smoke avax"
WALLET_IMPORT = 4 * 10**9
WALLET_EXPORT = 2 * 10**9
KECCAK_BATCH_ABI = [{
    "type": "function", "name": "keccak256Batch", "stateMutability": "view",
    "inputs": [{"name": "data", "type": "bytes[]"}],
    "outputs": [{"name": "", "type": "bytes32[]"}]}]


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


def _p50_p99(v) -> str:
    return (f"{np.percentile(v, 50):.3f} / {np.percentile(v, 99):.3f} "
            f"(n={len(v)})")


class RpcStats:
    """The run's requests: latencies by method (a batch under "<method>
    batch", its requests counted one by one; a WebSocket request under
    "WS <method>"), the HTTP and the WS requests' counts and walls apart,
    and the WS pushes by kind with their latencies."""

    def __init__(self):
        self.lat = defaultdict(list)  # method -> [ms]
        self.requests = 0
        self.wall = 0.0
        self.ws_requests = 0
        self.ws_wall = 0.0
        self.pushes = defaultdict(int)  # kind -> count
        self.push_lat = defaultdict(list)  # kind -> [ms]

    def summary(self) -> str:
        return (f"HTTP {self.requests} requests in {self.wall:.3f} s, WS "
                f"{self.ws_requests} requests in {self.ws_wall:.3f} s and "
                f"{sum(self.pushes.values())} pushes ("
                + ", ".join(f"{k} {n}" for k, n in sorted(self.pushes.items()))
                + "); per method p50 / p99 ms: " + ", ".join(
                    f"{m} {_p50_p99(v)}" for m, v in sorted(self.lat.items()))
                + "; push latency p50 / p99 ms: " + (", ".join(
                    f"{k} {_p50_p99(v)}"
                    for k, v in sorted(self.push_lat.items())) or "none"))


class RpcRun:
    """A JSON-RPC client of one of the port's servers over HTTP
    (ethclient.Client against the port's create_handlers server), timing
    every request into `stats`; an error object in any answer fails the
    run."""

    def __init__(self, url: str, stats: RpcStats):
        self.url = url
        self.client = Client(url)
        self.stats = stats

    def _timed(self, key, n, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
        except ClientError as e:
            check(False, f"rpc {key}: error object {e.code} {e} {e.data}")
        dt = time.perf_counter() - t0
        self.stats.lat[key].append(dt * 1e3)
        self.stats.requests += n
        self.stats.wall += dt
        return out

    def call(self, method, *params):
        return self._timed(method, 1,
                           lambda: self.client.call_raw(method, *params))

    def batch(self, method, params_list):
        """One request of `method` per params, RPC_BATCH to a batch."""
        out = []
        for i in range(0, len(params_list), RPC_BATCH):
            chunk = params_list[i:i + RPC_BATCH]
            out += self._timed(
                f"{method} batch", len(chunk), lambda: self.client.batch_raw(
                    [(method, p) for p in chunk]))
        return out

    def get(self, base: str, path: str):
        """(status, body) of a GET on another endpoint (the metrics one)."""
        def fetch():
            try:
                with urllib.request.urlopen(base + path, timeout=30) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, e.read()
        return self._timed(f"GET {path}", 1, fetch)


class _StampedQueue(queue.Queue):
    """A subscription's queue that stamps each push as it arrives (on the
    client's reader thread): Subscription.next returns (t, item)."""

    def put(self, item, block=True, timeout=None):
        super().put((time.perf_counter(), item), block, timeout)


class WsRun:
    """A WebSocket client of one of the port's servers
    (ethclient.ws_connect: ethclient/ws.py's WSEthClient), timing every
    request into `stats`; an error object fails the run. Its
    subscriptions stamp their pushes (_StampedQueue)."""

    def __init__(self, port: int, stats: RpcStats):
        self.client = ws_connect("127.0.0.1", port)
        self.stats = stats

    def call(self, method, *params):
        t0 = time.perf_counter()
        try:
            out = self.client.request(method, list(params), timeout=60)
        except WSSubscriptionError as e:
            check(False, f"ws {method}: {e}")
        dt = time.perf_counter() - t0
        self.stats.lat[f"WS {method}"].append(dt * 1e3)
        self.stats.ws_requests += 1
        self.stats.ws_wall += dt
        return out

    def subscribe(self, kind, *params):
        t0 = time.perf_counter()
        sub = self.client.subscribe(kind, *params)
        dt = time.perf_counter() - t0
        self.stats.lat["WS eth_subscribe"].append(dt * 1e3)
        self.stats.ws_requests += 1
        self.stats.ws_wall += dt
        stamped = _StampedQueue()
        with self.client._lock:  # the reader routes pushes under it
            while not sub._q.empty():
                stamped.put(sub._q.get())
            sub._q = stamped
        sub.kind = kind
        return sub

    def pushes(self, sub, n: int, t_ref=None, timeout: float = 60.0):
        """The next `n` pushes of `sub` as (arrival time, item), counted
        (and their latencies since `t_ref`, a perf_counter time, when
        given)."""
        out = []
        for _ in range(n):
            try:
                t, item = sub.next(timeout=timeout)
            except WSSubscriptionError as e:
                check(False, f"ws {sub.kind}: push {len(out) + 1} of {n}: "
                      f"{e}")
            check(isinstance(item, (dict, str)),
                  f"ws {sub.kind}: the connection closed ({item})")
            self.stats.pushes[sub.kind] += 1
            if t_ref is not None:
                self.stats.push_lat[sub.kind].append((t - t_ref) * 1e3)
            out.append((t, item))
        return out

    def close(self):
        self.client.close()


def threads_left(before: set, seconds: float = 5.0,
                 servers: bool = True) -> list:
    """The threads alive now that were not in `before` (a set of
    threading.enumerate() taken before a VM and its RPC server started),
    and with `servers` any RPC server's, its lanes' and the metrics
    endpoint's, after waiting up to `seconds` for them to end. A
    process-wide executor that was already running (the sender cacher's)
    may have grown a worker meanwhile: that is not a thread the VM
    left."""
    pools = {t.name.rsplit("_", 1)[0] for t in before
             if t.name.startswith("ThreadPoolExecutor-")}
    named = ("rpc-", "metrics-http") if servers else ()
    deadline = time.monotonic() + seconds
    while True:
        left = sorted(t.name for t in threading.enumerate()
                      if (t not in before
                          and t.name.rsplit("_", 1)[0] not in pools)
                      or (named and t.name.startswith(named)))
        if not left or time.monotonic() > deadline:
            return left
        time.sleep(0.02)


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


def vm_config(dev, keystore_dir: str) -> dict:
    """The VM's JSON config, as AvalancheGo hands it over: the defaults but
    for the insert pipeline at depth 2 (the one execution option read only
    at construction), the debug, txpool and personal namespaces opted in
    (RPC_APIS + personal), the /metrics + /healthz endpoint on a free
    loopback port, the node keystore in `keystore_dir` and a WebSocket
    notify queue of WS_NOTIFY_QUEUE; "auto" boots the resident mirror on
    CUDA. The CPU rehearsal asks for the mirror, which "auto" leaves off
    there."""
    cfg = {"insert-pipeline-depth": PIPELINE_DEPTH,
           "eth-apis": RPC_APIS + ["personal"],
           "metrics-http-enabled": True, "metrics-http-port": 0,
           "keystore-directory": keystore_dir,
           "ws-notify-queue-size": WS_NOTIFY_QUEUE}
    if dev.type != "cuda":
        cfg["resident-account-trie"] = True
    return cfg


def chain_clock(vm, gap: int = 10):
    """The VM's block clock: each block `gap` seconds of chain time after
    its parent (as generate_chain's blocks), so tip-0 blocks owe no block
    gas cost."""
    return lambda: vm.blockchain.current_block.time + gap


def phase_genesis(dev, world: World, oracle_root: bytes, keystore_dir: str):
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
    cfg = json.dumps(vm_config(dev, keystore_dir))
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
                 vm_coinbase_fee, exports, threads_before, seed, card):
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
    # the exports before shutdown: eth_getProof's on the resident head
    # (phase 7d), each of the delta since the previous export
    earlier = list(exports)
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
    threads = threads_left(threads_before)
    check(vm.rpc_server is None and not threads,
          f"chain: threads left after vm.shutdown(): {threads}")
    check(not mirror.host_mode, "chain: the mirror ended in host mode")
    shutdown = exports[len(earlier):]
    check(len(shutdown) == 1 and shutdown[0][0] > 0,
          f"chain: shutdown export {shutdown}")
    log("chain: the exports before shutdown (eth_getProof's): "
        + ("; ".join(f"{n} nodes in {ms:.1f} ms" for n, ms in earlier)
           or "none"))
    log(f"chain: vm.shutdown() {stop_ms:.1f} ms, of it the shutdown export "
        f"{shutdown[0][0]} nodes in {shutdown[0][1]:.1f} ms"
        + f"; the forkserver and the resource tracker stopped in "
        f"{servers_ms:.1f} ms, no process left; the RPC server, its lanes "
        f"and the metrics endpoint stopped, no thread the VM phase started "
        f"left")
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
        self.touched = {self.dest, self.exp_i}

    def issue(self, vm, rpc, label) -> None:
        """Into the atomic mempool: through vm.issue_atomic_tx, or with
        `rpc` as avax.issueTx over HTTP."""
        for atx in (self.imp, self.exp):
            if rpc is None:
                vm.issue_atomic_tx(atx)
                continue
            check(rpc.call("avax_issueTx", "0x" + atx.encode().hex())
                  == {"txID": "0x" + atx.id().hex()},
                  f"{label}: avax.issueTx answered another id")

    def apply(self, world: World, oracle: Oracle, atomic_txs) -> None:
        """Their balance and nonce changes, applied to `world` and
        `oracle` (an atomic tx has no receipt); `atomic_txs` are the
        block's, which must be these two."""
        check(sorted(t.id() for t in atomic_txs)
              == sorted((self.imp.id(), self.exp.id())),
              "vm: the block's atomic txs are not the pair issued")
        world.balance[self.dest] += (VM_IMPORT - VM_BURN) * atomic_tx.X2C_RATE
        world.balance[self.exp_i] -= ((VM_EXPORT + VM_BURN)
                                      * atomic_tx.X2C_RATE)
        world.nonce[self.exp_i] += 1
        oracle.apply([self.dest, self.exp_i], {})

    def check_shared_memory(self, mem: Memory, ctx) -> None:
        """After the accept: the X chain's shared memory holds the
        export's UTXO, and this chain's no longer holds the import's."""
        out = mem.new_shared_memory(ctx.x_chain_id).get(
            ctx.chain_id, [self.out.utxo_id()])
        check(atomic_tx.UTXO.decode(out[0]) == self.out,
              "vm: the export's UTXO is not in the X chain's shared memory")
        try:
            mem.new_shared_memory(ctx.chain_id).get(ctx.x_chain_id,
                                                    [self.utxo.utxo_id()])
            check(False, "vm: the imported UTXO is still in the shared "
                  "memory")
        except KeyError:
            pass


class _Wallet:
    """The wallet of the second VM block (phase 7d), over one WebSocket
    connection (`ws`, a WsRun). Two keyed senders (WALLET_SENDERS from the
    end of the keyed list, clear of the VM blocks' senders and the atomic
    pair's accounts) are imported with personal_importRawKey and unlocked
    with personal_unlockAccount (duration 0: until locked); WALLET_TXS of
    the block's transfers, whose senders send nothing else in the phase,
    are replaced by transfers of theirs (the same receiver and value, at
    their next nonces), signed here with Signer.sign (deterministic) so
    each eth_sendTransaction answer can be held to the harness's hash.
    Returns from send() the hashes, in order."""

    def __init__(self, ws: "WsRun", world: World, blocks, b: int):
        self.ws = ws
        senders = [world.keyed[-3], world.keyed[-4]]
        idx = {i for i, _ in senders}
        used = defaultdict(int)
        for blk in blocks:
            for t in blk:
                used[t.sender] += 1
        check(not idx & set(used), "wallet: a wallet key already sends in "
              "the VM blocks")
        signer = Signer(params.TEST_CHAIN_CONFIG.chain_id)
        nonces = {i: world.nonce[i] for i in idx}
        self.objs = {}  # _EvmTx -> the eth_sendTransaction object
        txs = blocks[b]
        slots = [k for k, t in enumerate(txs)
                 if t.writes is None and used[t.sender] == 1][:WALLET_TXS]
        check(len(slots) == WALLET_TXS, "wallet: too few transfers to take")
        t0 = time.perf_counter()
        self.key_ms = []
        for i, key in senders:
            ta = time.perf_counter()
            addr = ws.call("personal_importRawKey", "0x" + key.hex(),
                           WALLET_PASSWORD)
            tb = time.perf_counter()
            check(addr == "0x" + world.addrs[i].hex(),
                  f"wallet: personal_importRawKey answered {addr}")
            check(ws.call("personal_unlockAccount", addr, WALLET_PASSWORD, 0)
                  is True, "wallet: personal_unlockAccount")
            self.key_ms.append(((tb - ta) * 1e3,
                                (time.perf_counter() - tb) * 1e3))
        for n, k in enumerate(slots):
            old = txs[k]
            i, key = senders[n % 2]
            tx = Transaction(type=2, chain_id=signer.chain_id,
                             nonce=nonces[i], max_priority_fee=0,
                             max_fee=EVM_MAX_FEE, gas=21000,
                             to=world.addrs[old.to], value=old.value)
            nonces[i] += 1
            new = _EvmTx(signer.sign(tx, key).encode(), i, old.to, old.value,
                         None)
            txs[k] = new
            self.objs[new] = {
                "from": "0x" + world.addrs[i].hex(),
                "to": "0x" + world.addrs[old.to].hex(),
                "value": hex(old.value), "gas": hex(21000),
                "maxFeePerGas": hex(EVM_MAX_FEE),
                "maxPriorityFeePerGas": hex(0), "nonce": hex(tx.nonce)}
        self.setup_ms = (time.perf_counter() - t0) * 1e3
        self.sent = []  # (hash, perf_counter time sent)

    def send(self, label) -> None:
        """Each wallet transfer as eth_sendTransaction over WS; each answer
        must be the hash of the transaction the harness signed."""
        for t, obj in self.objs.items():
            want = "0x" + Transaction.decode(t.blob).hash().hex()
            t0 = time.perf_counter()
            got = self.ws.call("eth_sendTransaction", obj)
            check(got == want, f"{label}: eth_sendTransaction answered {got}"
                  f", the harness signed {want}")
            self.sent.append((got, t0))


class _WalletAtomic:
    """The second VM block's atomic txs, built by the node's wallet over
    WS: avax.importKey of a third keyed account's key under AVAX_PASSWORD,
    a UTXO of WALLET_IMPORT nAVAX seeded from the X chain to its address;
    then avax.import (tx_builder.new_import_tx: every UTXO the password's
    keys own, less the dynamic fee, to a plain account) and avax.export
    (tx_builder.new_export_tx: WALLET_EXPORT nAVAX plus the fee from that
    account, to an X-chain address). The oracle counts both from the
    block's txs: each output credits its address, each input debits its
    address and sets its nonce."""

    def __init__(self, ws: "WsRun", vm, mem: Memory, world: World):
        self.ws = ws
        ctx = vm.ctx
        self.src_i, self.key = world.keyed[-5]
        self.dest = len(world.storage) + len(world.keyed) + 1
        self.x_addr = b"\x98" * 20
        self.utxo = atomic_tx.UTXO(
            tx_id=keccak256(b"chip_smoke wallet x-chain export"),
            output_index=0, asset_id=ctx.avax_asset_id, amount=WALLET_IMPORT,
            address=world.addrs[self.src_i])
        mem.new_shared_memory(ctx.x_chain_id).apply({ctx.chain_id: Requests(
            put_requests=[Element(self.utxo.utxo_id(), self.utxo.encode(),
                                  [self.utxo.address])])})
        self.dest_addr = world.addrs[self.dest]
        self.index = {world.addrs[self.src_i]: self.src_i,
                      self.dest_addr: self.dest}
        self.touched = {self.src_i, self.dest}
        self.imp = self.exp = None

    def issue(self, vm, rpc, label) -> None:
        ctx = vm.ctx
        addr = "0x" + self.utxo.address.hex()
        check(self.ws.call("avax_importKey", AVAX_PASSWORD,
                           "0x" + self.key.hex()) == {"address": addr},
              f"{label}: avax.importKey")
        x_chain = "0x" + ctx.x_chain_id.hex()
        self.imp_id = self.ws.call(
            "avax_import", AVAX_PASSWORD,
            "0x" + self.dest_addr.hex(), x_chain)["txID"]
        self.exp_id = self.ws.call(
            "avax_export", AVAX_PASSWORD, WALLET_EXPORT,
            "0x" + self.x_addr.hex(), x_chain)["txID"]

    def apply(self, world: World, oracle: Oracle, atomic_txs) -> None:
        by_id = {"0x" + t.id().hex(): t for t in atomic_txs}
        check(sorted(by_id) == sorted((self.imp_id, self.exp_id)),
              "vm: the block's atomic txs are not the wallet's")
        self.imp, self.exp = by_id[self.imp_id], by_id[self.exp_id]
        outs, ins = self.imp.unsigned.outs, self.exp.unsigned.ins
        credited = sum(o.amount for o in outs)
        check(self.imp.unsigned.imported_inputs == [self.utxo]
              and 0 < credited < WALLET_IMPORT
              and [o.address for o in outs] == [world.addrs[self.dest]],
              f"vm: the wallet's ImportTx ({credited} of {WALLET_IMPORT} "
              f"nAVAX credited)")
        check([(u.amount, u.address)
               for u in self.exp.unsigned.exported_outputs]
              == [(WALLET_EXPORT, self.x_addr)]
              and all(i.address == world.addrs[self.src_i]
                      and i.nonce == world.nonce[self.src_i] for i in ins),
              "vm: the wallet's ExportTx")
        for o in outs:
            world.balance[self.index[o.address]] += o.amount * atomic_tx.X2C_RATE
        for i in ins:
            world.balance[self.index[i.address]] -= i.amount * atomic_tx.X2C_RATE
            world.nonce[self.index[i.address]] = i.nonce + 1
        self.fees = (WALLET_IMPORT - credited,
                     sum(i.amount for i in ins) - WALLET_EXPORT)
        oracle.apply(sorted(self.touched), {})

    def check_shared_memory(self, mem: Memory, ctx) -> None:
        out = self.exp.unsigned.exported_outputs[0]
        got = mem.new_shared_memory(ctx.x_chain_id).get(
            ctx.chain_id, [out.utxo_id()])
        check(atomic_tx.UTXO.decode(got[0]) == out,
              "vm: the wallet export's UTXO is not in the X chain's shared "
              "memory")
        try:
            mem.new_shared_memory(ctx.chain_id).get(ctx.x_chain_id,
                                                    [self.utxo.utxo_id()])
            check(False, "vm: the wallet's imported UTXO is still in the "
                  "shared memory")
        except KeyError:
            pass


# Phase 7d's engine process (the other side of plugin/main.go): it imports
# the port's plugin client alone, under an import guard that refuses jax,
# jaxlib, coreth_tpu, cryptography and torch (so it holds no CUDA context),
# and for each "block" line on its stdin drives buildBlock -> blockVerify ->
# setPreference -> blockAccept over the VM's unix socket, printing one JSON
# line a block with each call's round trip; "shutdown" asks the server to
# stop, and the child ends with 0. Started with subprocess, never fork.
_ENGINE_CHILD = r"""
import json, sys, time

FORBIDDEN = ("jax", "jaxlib", "coreth_tpu", "cryptography", "torch")


def refused(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if refused(name):
            raise ImportError(f"the engine must not import {name}")
        return None


sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[2])
from coreth_tpu_torch.plugin.client import RemoteVM, RemoteVMError


def timed(rt, name, fn, *a):
    t0 = time.perf_counter()
    out = fn(*a)
    rt[name] = (time.perf_counter() - t0) * 1e3
    return out


rt = {}
remote = timed(rt, "connect", RemoteVM, sys.argv[1], 30.0)
last = timed(rt, "handshake", remote.handshake)
print("READY " + json.dumps({"last": last.hex(), "rt": rt}), flush=True)
for line in sys.stdin:
    cmd = line.strip()
    if cmd == "block":
        rt = {}
        try:
            blk = timed(rt, "buildBlock", remote.build_block)
            timed(rt, "blockVerify", remote.block_verify, blk.id)
            timed(rt, "setPreference", remote.set_preference, blk.id)
            timed(rt, "blockAccept", remote.block_accept, blk.id)
            head = timed(rt, "lastAccepted", remote.last_accepted)
        except RemoteVMError as e:
            print("ERROR " + json.dumps(str(e)), flush=True)
            sys.exit(1)
        print("BLOCK " + json.dumps({
            "id": blk.id.hex(), "parent": blk.parent_id.hex(),
            "height": blk.height, "bytes": len(blk.bytes),
            "head": head.id.hex(), "rt": rt}), flush=True)
    elif cmd == "shutdown":
        rt = {}
        timed(rt, "shutdown", remote.shutdown)
        print("DONE " + json.dumps({
            "leaked": sorted(m for m in sys.modules if refused(m)),
            "rt": rt}), flush=True)
        sys.exit(0)
sys.exit(2)
"""
ENGINE_CALLS = ("buildBlock", "blockVerify", "setPreference", "blockAccept")


class _EngineServer(VMServer):
    """The port's VMServer, each dispatch timed on the VM's side: its ms,
    the K1 launches each of `recs` recorded in it, its start on this
    process's clock, and after a blockVerify the mirror's device window
    (`window`)."""

    def __init__(self, vm, sock_path, recs, dev):
        super().__init__(vm, sock_path)
        self.recs, self.dev = recs, dev
        self.calls = []  # (method, ms, [K1 launches by recorder], t0)
        self.window = None

    def dispatch(self, method, params):
        n0 = [len(r.records) for r in self.recs]
        t0 = time.perf_counter()
        out = super().dispatch(method, params)
        ms = (time.perf_counter() - t0) * 1e3
        if method == "blockVerify":
            mirror = self.vm.blockchain.mirror
            self.window = (window_ms(self.dev, mirror.ex.last_events)
                           if mirror is not None and not mirror.host_mode
                           else None)
        self.calls.append((method, ms, [len(r.records) - a for a, r in
                                        zip(n0, self.recs)], t0))
        return out


class _Engine:
    """Phase 7d's lifecycle across a process boundary: `vm` served by an
    _EngineServer on a unix socket in `sock_dir` (its thread in this
    process, where the VM holds the card) and the engine child
    (_ENGINE_CHILD) started with subprocess, which drives each block.
    close() asks for the shutdown over the socket: the server stops (the
    VM does not), its connection threads joined, and the child ends 0."""

    def __init__(self, vm, sock_dir, recs, dev):
        sock = os.path.join(sock_dir, "vm.sock")
        if len(sock.encode()) > 100:  # AF_UNIX paths end at 108 bytes
            sock = os.path.relpath(sock)
        check(len(sock.encode()) <= 100,
              f"vm plugin: socket path {sock!r} too long for AF_UNIX")
        self.sock = sock
        self.server = _EngineServer(vm, sock, recs, dev)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="plugin-server", daemon=True)
        self.proc = self.reader = None
        self.lines = queue.Queue()
        t0 = time.perf_counter()
        self.thread.start()
        check(_wait(lambda: os.path.exists(sock), 10),
              "vm plugin: the server never opened its socket")
        self.errf = open(os.path.join(sock_dir, "engine.err"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _ENGINE_CHILD, sock,
             os.path.dirname(os.path.abspath(__file__))],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.errf,
            text=True)
        self.reader = threading.Thread(target=self._read, name="engine-out",
                                       daemon=True)
        self.reader.start()
        ready = self._expect("READY")
        self.start_ms = (time.perf_counter() - t0) * 1e3
        self.start_rt = ready["rt"]
        check(bytes.fromhex(ready["last"]) == vm.last_accepted().id(),
              "vm plugin: the engine's handshake is not the VM's last "
              "accepted block")
        self.rts = []     # per block: {call: round-trip ms}
        self.vm_side = []  # per block: {call: VM-side ms}

    def _read(self):
        for line in self.proc.stdout:
            self.lines.put(line.rstrip("\n"))
        self.lines.put(None)

    def _expect(self, tag, seconds=600.0):
        try:
            line = self.lines.get(timeout=seconds)
        except queue.Empty:
            line = None
        if line is None or not line.startswith(tag + " "):
            self.errf.seek(0)
            check(False, f"vm plugin: the engine child said {line!r}, not "
                  f"{tag}; its stderr: {self.errf.read()[-2000:]}")
        return json.loads(line[len(tag) + 1:])

    def block(self, vm):
        """One block driven by the child. Returns (the accepted VMBlock,
        the VM side: {call: (ms, K1 launches by recorder, t0)})."""
        k = len(self.server.calls)
        self.proc.stdin.write("block\n")
        self.proc.stdin.flush()
        out = self._expect("BLOCK")
        calls = {m: (ms, k1, t0) for m, ms, k1, t0 in self.server.calls[k:]}
        check(set(ENGINE_CALLS) <= set(calls),
              f"vm plugin: the server saw {sorted(calls)}")
        vmb = vm.last_accepted()
        check(vmb.id().hex() == out["id"] == out["head"],
              "vm plugin: the engine's block is not the VM's last accepted")
        self.rts.append(out["rt"])
        self.vm_side.append({m: calls[m][0] for m in ENGINE_CALLS})
        return vmb, calls

    def close(self) -> str:
        """The shutdown over the socket; checks the child's exit and the
        server's joins. Returns a summary."""
        self.proc.stdin.write("shutdown\n")
        self.proc.stdin.flush()
        done = self._expect("DONE")
        rc = self.proc.wait(timeout=30)
        self.proc.stdin.close()
        self.reader.join(timeout=10)
        self.thread.join(timeout=10)
        self.errf.close()
        check(rc == 0 and not done["leaked"],
              f"vm plugin: the engine child exited {rc}, loaded "
              f"{done['leaked']}")
        check(not self.thread.is_alive() and not self.server.threads_left
              and not os.path.exists(self.sock),
              f"vm plugin: the server's threads {self.server.threads_left} "
              f"(listener alive {self.thread.is_alive()})")
        return (f"the engine child exited 0 after shutdown over the socket "
                f"({done['rt']['shutdown']:.2f} ms) holding no torch, jax "
                f"or coreth_tpu module; the server's listener and "
                f"connection threads joined, its socket removed")

    def kill(self) -> None:
        """After a failure: stop the child and the server, whatever their
        state."""
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)
        self.server.dispatch("shutdown", {})
        self.thread.join(timeout=10)
        if self.reader is not None:
            self.reader.join(timeout=10)


def vm_block(vm, world: World, oracle: Oracle, txs, coinbase: list,
             recs, atomic=None, label="vm", dev=None, issued=False,
             rpc=None, wallet=None, engine=None):
    """One block through the VM: `txs` (and `atomic`'s two txs) issued
    through vm.issue_tx and vm.issue_atomic_tx (unless `issued`: already
    in the tx pool from a build that failed), or with `rpc` (an RpcRun)
    sent over HTTP as eth_sendRawTransaction in batches and
    avax.issueTx, but `wallet`'s transactions (a _Wallet) as
    eth_sendTransaction over WS and `atomic`'s as its own issue() builds
    them (a _WalletAtomic: the node's wallet); then vm.build_block() →
    vmb.verify() → vm.set_preference(vmb.id()) → vmb.accept() and the
    acceptor drained, or with `engine` (an _Engine) the same four calls
    made by the engine child over the plugin socket (the times and K1
    launches then taken on the VM's side of it). Its header root must
    equal the EVM-independent oracle's (evm_oracle_block over the block's
    own transaction order, plus `atomic`'s changes), the head and the last
    accepted block must be it. `recs`: the storage programs' and the
    executor's K1 recorders.
    Returns (block, receipts, touched, writes, stats)."""
    chain = vm.blockchain
    decoded = [Transaction.decode(t.blob) for t in txs]
    by_hash = {tx.hash(): t for tx, t in zip(decoded, txs)}
    t0 = time.perf_counter()
    if rpc is not None:
        raw = [(t, tx) for t, tx in zip(txs, decoded)
               if wallet is None or t not in wallet.objs]
        got = rpc.batch("eth_sendRawTransaction",
                        [["0x" + t.blob.hex()] for t, _ in raw])
        check(got == ["0x" + tx.hash().hex() for _, tx in raw],
              f"{label}: eth_sendRawTransaction answered other hashes")
        if wallet is not None:
            wallet.send(label)
    else:
        for tx in decoded if not issued else ():
            vm.issue_tx(tx)
    if atomic is not None:
        atomic.issue(vm, rpc, label)
    issue_ms = (time.perf_counter() - t0) * 1e3
    check(vm.txpool.stats()[0] == len(txs),
          f"{label}: the tx pool holds {vm.txpool.stats()}, not "
          f"{len(txs)} pending")
    if engine is not None:
        vmb, calls = engine.block(vm)
        build_ms, build_k1, _t = calls["buildBlock"]
        verify_ms, verify_k1, _t = calls["blockVerify"]
        accept_ms, _k, t_accept = calls["blockAccept"]
        win = engine.server.window if dev is not None else None
    else:
        n0 = [len(r.records) for r in recs]
        t0 = time.perf_counter()
        vmb = vm.build_block()
        build_ms = (time.perf_counter() - t0) * 1e3
        n1 = [len(r.records) for r in recs]
        t0 = time.perf_counter()
        vmb.verify()
        verify_ms = (time.perf_counter() - t0) * 1e3
        n2 = [len(r.records) for r in recs]
        build_k1 = [b - a for a, b in zip(n0, n1)]
        verify_k1 = [b - a for a, b in zip(n1, n2)]
        mirror = chain.mirror
        win = (window_ms(dev, mirror.ex.last_events)
               if dev is not None and mirror is not None and not
               mirror.host_mode else None)
        vm.set_preference(vmb.id())
        t_accept = time.perf_counter()
        vmb.accept()
        chain.drain_acceptor_queue()
        accept_ms = (time.perf_counter() - t_accept) * 1e3
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
        atomic.apply(world, oracle, vmb.atomic_txs)
        want = oracle.root()
        touched |= atomic.touched
    check(eth.header.root == want,
          f"{label} block {eth.number}: root {eth.header.root.hex()} != "
          f"oracle {want.hex()}")
    check(vm.last_accepted().id() == vmb.id()
          and chain.current_block.hash() == vmb.id()
          and chain.last_accepted.hash() == vmb.id(),
          f"{label} block {eth.number}: not the head and last accepted")
    stats = dict(issue=issue_ms, build=build_ms, verify=verify_ms,
                 accept=accept_ms, t_accept=t_accept, window=win,
                 build_k1=build_k1, verify_k1=verify_k1)
    return vmb, receipts, touched, writes, stats


def rpc_block_reads(rpc: RpcRun, metrics_url: str, vm, vmb, txs, receipts,
                    world: World, touched, writes, atomic=None) -> str:
    """Reads of the block just accepted over RPC, each held against the
    block and the oracle's world: eth_blockNumber, eth_getBlockByNumber
    (the hash is vmb.id()), the receipts of a sample (status 1), the
    balance of every account the block touched and every slot it wrote
    (batches), eth_getLogs over the block (the receipts' logs), eth_call
    and eth_estimateGas of one of its contract calls, eth_feeHistory,
    avax.getAtomicTxStatus of `atomic`'s txs, health.check,
    debug_deviceStatus, and /metrics and /healthz of the metrics
    endpoint. Returns a summary."""
    eth = vmb.eth_block
    n = eth.number
    check(int(rpc.call("eth_blockNumber"), 16) == n,
          f"rpc: eth_blockNumber != {n}")
    blk = rpc.call("eth_getBlockByNumber", hex(n), False)
    check(blk["hash"] == "0x" + vmb.id().hex()
          and blk["stateRoot"] == "0x" + eth.header.root.hex()
          and len(blk["transactions"]) == len(eth.transactions),
          f"rpc: eth_getBlockByNumber({n}) != the block")
    sample = eth.transactions[::max(1, len(eth.transactions) // 16)]
    for tx in sample:
        r = rpc.call("eth_getTransactionReceipt", "0x" + tx.hash().hex())
        check(r["status"] == "0x1" and r["blockHash"] == blk["hash"],
              f"rpc: receipt of {tx.hash().hex()}: {r}")
    accts = sorted(touched)
    bals = rpc.batch("eth_getBalance", [["0x" + world.addrs[i].hex(),
                                         "latest"] for i in accts])
    check(bals == [hex(world.balance[i]) for i in accts],
          f"rpc block {n}: a balance != the oracle world's")
    slots = [(c, k) for c, w in sorted(writes.items()) for k in sorted(w)]
    vals = rpc.batch("eth_getStorageAt", [
        ["0x" + world.addrs[c].hex(), "0x" + k.hex(), "latest"]
        for c, k in slots])
    check(vals == ["0x" + world.storage[c][k].hex() for c, k in slots],
          f"rpc block {n}: a slot != the oracle world's")
    logs = rpc.call("eth_getLogs", {"fromBlock": hex(n), "toBlock": hex(n)})
    check(len(logs) == sum(len(r.logs) for r in receipts) > 0,
          f"rpc block {n}: eth_getLogs {len(logs)} logs")
    call_tx = next(t for t in txs if t.writes)
    call = {"from": "0x" + world.addrs[call_tx.sender].hex(),
            "to": "0x" + world.addrs[call_tx.to].hex(),
            "data": "0x" + Transaction.decode(call_tx.blob).data.hex()}
    check(rpc.call("eth_call", call, "latest") == "0x",
          f"rpc block {n}: eth_call of a store-and-log call")
    gas = int(rpc.call("eth_estimateGas", call), 16)
    check(21000 < gas <= EVM_CALL_GAS,
          f"rpc block {n}: eth_estimateGas {gas}")
    fh = rpc.call("eth_feeHistory", 1, "latest", [50])
    check(fh["baseFeePerGas"][0] == hex(eth.header.base_fee)
          and fh["oldestBlock"] == hex(n),
          f"rpc block {n}: eth_feeHistory {fh}")
    for atx in (atomic.imp, atomic.exp) if atomic is not None else ():
        st = rpc.call("avax_getAtomicTxStatus", "0x" + atx.id().hex())
        check(st == {"status": "Accepted", "blockHeight": hex(n)},
              f"rpc block {n}: avax.getAtomicTxStatus {st}")
    check(rpc.call("health_check")["healthy"] is True,
          f"rpc block {n}: health.check not healthy")
    dev_st = rpc.call("debug_deviceStatus")
    check(dev_st["state"] == "healthy" and dev_st["last_error"] is None,
          f"rpc block {n}: debug_deviceStatus {dev_st}")
    code, body = rpc.get(metrics_url, "/healthz")
    check(code == 200 and json.loads(body)["healthy"] is True,
          f"rpc block {n}: /healthz {code} {body[:200]}")
    code, body = rpc.get(metrics_url, "/metrics")
    check(code == 200 and b"# TYPE" in body,
          f"rpc block {n}: /metrics {code}")
    return (f"{len(sample)} receipts, {len(accts)} balances, {len(slots)} "
            f"slots, {len(logs)} logs, eth_call and eth_estimateGas "
            f"({gas} gas), eth_feeHistory, "
            f"{2 if atomic is not None else 0} atomic statuses, health, "
            f"the ladder, /metrics ({len(body)} B) and /healthz")


def rpc_proofs(rpc: RpcRun, vmb, world: World, oracle: Oracle, touched,
               writes, seed) -> str:
    """eth_getProof at "latest" (the resident head: the account trie's
    delta read back from the card first) for RPC_PROOFS accounts the block
    touched, the contracts it wrote first, with RPC_PROOF_SLOTS slots each
    (written ones for a contract); every proof verified with
    trie/proof.verify_proof against the header root, every value against
    the oracle's world. Returns a summary."""
    root = vmb.eth_block.header.root
    rng = np.random.default_rng(seed)
    contracts = sorted(writes)[:RPC_PROOFS // 2]
    others = sorted(set(touched) - set(contracts))
    picks = contracts + [others[int(j)] for j in rng.choice(
        len(others), RPC_PROOFS - len(contracts), replace=False)]
    t0 = time.perf_counter()
    nodes = 0
    for i in picks:
        keys = (sorted(writes[i])[:RPC_PROOF_SLOTS] if i in writes else
                [rng.bytes(32) for _ in range(RPC_PROOF_SLOTS)])
        p = rpc.call("eth_getProof", "0x" + world.addrs[i].hex(),
                     ["0x" + k.hex() for k in keys], "latest")
        blobs = [bytes.fromhex(x[2:]) for x in p["accountProof"]]
        nodes += len(blobs)
        got = verify_proof(root, keccak256(world.addrs[i]),
                           {keccak256(b): b for b in blobs})
        check(got == world.account(i, oracle.root_of(i)).encode(),
              f"rpc: eth_getProof of account {i} does not verify to the "
              f"oracle's account")
        check(p["balance"] == hex(world.balance[i])
              and p["nonce"] == hex(world.nonce[i])
              and p["storageHash"] == "0x" + oracle.root_of(i).hex(),
              f"rpc: eth_getProof fields of account {i}")
        for k, sp in zip(keys, p["storageProof"]):
            want = world.storage.get(i, {}).get(k)
            check(sp["value"] == hex(int.from_bytes(want, "big")
                                     if want else 0),
                  f"rpc: eth_getProof slot value of account {i}")
            if oracle.root_of(i) == EMPTY_ROOT:
                check(sp["proof"] == [], "rpc: a proof in an empty trie")
                continue
            sblobs = [bytes.fromhex(x[2:]) for x in sp["proof"]]
            nodes += len(sblobs)
            val = verify_proof(oracle.root_of(i), keccak256(k),
                               {keccak256(b): b for b in sblobs})
            check(val == (slot_value(want) if want else None),
                  f"rpc: storage proof of account {i} does not verify")
    return (f"{len(picks)} eth_getProof ({len(contracts)} contracts) with "
            f"{RPC_PROOF_SLOTS} slots each, {nodes} proof nodes, verified "
            f"against the header root in "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")


def ws_block_pushes(wsc: WsRun, subs, vmb, receipts, txs, wallet, st) -> str:
    """The WS pushes of the block just accepted, held against it: one
    newHeads push with the block's hash, number and state root; one logs
    push per log of the receipts (each the receipt's address, topics,
    data, transaction and block); one newPendingTransactions push per
    transaction the block carries, each hash once (the wallet's among
    them). Head and log latencies from the accept; the wallet's pending
    latencies from its eth_sendTransaction. Returns a summary."""
    eth = vmb.eth_block
    (_, head), = wsc.pushes(subs["heads"], 1, st["t_accept"])
    check((head["hash"], int(head["number"], 16), head["stateRoot"]) == (
        "0x" + vmb.id().hex(), eth.number, "0x" + eth.header.root.hex()),
        f"ws: the newHeads push {head} != block {eth.number}")
    want = [("0x" + l.address.hex(), ["0x" + t.hex() for t in l.topics],
             "0x" + l.data.hex(), "0x" + tx.hash().hex(), "0x" + vmb.id().hex())
            for tx, r in zip(eth.transactions, receipts) for l in r.logs]
    got = [(p["address"], p["topics"], p["data"], p["transactionHash"],
            p["blockHash"]) for _, p in wsc.pushes(
                subs["logs"], len(want), st["t_accept"])]
    check(got == want, f"ws block {eth.number}: the logs pushes != the "
          f"receipts' logs")
    pending = wsc.pushes(subs["pending"], len(txs))
    hashes = sorted(h for _, h in pending)
    check(hashes == sorted("0x" + tx.hash().hex() for tx in eth.transactions),
          f"ws block {eth.number}: the pending pushes != the block's "
          f"transactions, each once")
    if wallet is not None:
        arrived = {h: t for t, h in pending}
        for h, t_sent in wallet.sent:
            wsc.stats.push_lat["newPendingTransactions"].append(
                (arrived[h] - t_sent) * 1e3)
    for s in subs.values():
        check(s._q.qsize() == 0, f"ws block {eth.number}: an extra "
              f"{s.kind} push")
    mine = (f", the wallet's {len(wallet.sent)} among them"
            if wallet is not None else "")
    return (f"1 newHeads push (the block's hash, number and root), "
            f"{len(got)} logs pushes (the receipts' logs), {len(pending)} "
            f"newPendingTransactions pushes (the block's transactions, each "
            f"once{mine})")


def phase_vm(dev, vm, mem: Memory, world: World, oracle: Oracle, n_blocks,
             coinbase: list, rpc_stats: RpcStats, seed, card):
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
    # the RPC tier: create_handlers(vm) on HTTP (vm.shutdown() stops it),
    # the metrics endpoint the VM started from its config (threads_before:
    # what may still run after vm.shutdown(), the endpoint's thread aside)
    threads_before = {t for t in threading.enumerate()
                      if t.name != "metrics-http"}
    t0 = time.perf_counter()
    server = create_handlers(vm)
    rpc = RpcRun(f"http://127.0.0.1:{server.serve_http('127.0.0.1', 0)}",
                 rpc_stats)
    metrics_url = f"http://127.0.0.1:{vm.metrics_http.port}"
    # WebSocket beside HTTP on the same server (one backend, one filter
    # stack), and a wallet user's connection subscribed before block 1
    ws, ws_port = serve_ws(vm, rpc_server=server)
    check(ws.notify_queue_size == WS_NOTIFY_QUEUE,
          f"vm: serve_ws notify queue {ws.notify_queue_size}")
    wsc = WsRun(ws_port, rpc_stats)
    called = sorted({t.to for blk in signed for t in blk if t.writes})
    subs = {"heads": wsc.subscribe("newHeads"),
            "logs": wsc.subscribe("logs", {"address": [
                "0x" + world.addrs[c].hex() for c in called]}),
            "pending": wsc.subscribe("newPendingTransactions")}
    log(f"vm: create_handlers(vm) with eth-apis {vm.full_config.eth_apis}, "
        f"serving HTTP at {rpc.url}, the metrics endpoint at {metrics_url},"
        f" serve_ws(vm, rpc_server=server) at ws://127.0.0.1:{ws_port} "
        f"(notify queue {ws.notify_queue_size}), a WSEthClient subscribed "
        f"to newHeads, logs of the {len(called)} called contracts and "
        f"newPendingTransactions, in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    req0, wall0 = rpc_stats.requests, rpc_stats.wall
    ws0, wsw0 = rpc_stats.ws_requests, rpc_stats.ws_wall
    ws_names = ("rpc/ws/notify_drops", "rpc/ws/slow_disconnects",
                "rpc/ws/notify_errors", "rpc/body_oversize")
    ws_moved = {n: default_registry.counter(n).count() for n in ws_names}
    loud_names = LOUD_CHAIN + OPTION_FALLBACKS + LOUD_DEVICE
    loud = {n: default_registry.counter(n).count() for n in loud_names}
    # the engine: the VM served on a unix socket (VMServer, its thread in
    # this process, where the VM holds the card) and the child that drives
    # each block's lifecycle over it
    engine = _Engine(vm, tempfile.mkdtemp(prefix="plugin_"),
                     (rec_storage, rec_resident), dev)
    log(f"vm plugin: VMServer(vm) serving the unix socket {engine.sock}; "
        f"the engine child (subprocess, the plugin client alone) started "
        f"and shook hands in {engine.start_ms:.1f} ms (connect "
        f"{engine.start_rt['connect']:.2f} ms, handshake round trip "
        f"{engine.start_rt['handshake']:.2f} ms)")
    keccak_cuda.reset_counts()
    planned_mod.planned_fallbacks = 0
    touched_all, written = set(), defaultdict(set)
    gas_all = wall_all = 0.0
    wallet = watomic = None
    try:
        with _GcPauses() as pauses:
            for b, txs in enumerate(signed):
                if b == 1:  # the wallet's block
                    wallet = _Wallet(wsc, world, signed, b)
                    watomic = _WalletAtomic(wsc, vm, mem, world)
                    log(f"vm: wallet keys imported and unlocked over WS "
                        f"(personal_importRawKey / personal_unlockAccount ms: "
                        + ", ".join(f"{a:.1f} / {u:.1f}"
                                    for a, u in wallet.key_ms)
                        + f"), {len(wallet.objs)} of the block's transfers "
                        f"re-signed from them, a UTXO of {WALLET_IMPORT} "
                        f"nAVAX seeded for the avax key; "
                        f"{wallet.setup_ms:.1f} ms")
                blk_atomic = atomic if b == 0 else watomic if b == 1 else None
                vmb, receipts, touched, writes, st = vm_block(
                    vm, world, oracle, txs, coinbase,
                    (rec_storage, rec_resident), atomic=blk_atomic, dev=dev,
                    rpc=rpc, wallet=wallet if b == 1 else None,
                    engine=engine)
                pushed = ws_block_pushes(wsc, subs, vmb, receipts, txs,
                                         wallet if b == 1 else None, st)
                if blk_atomic is not None:
                    blk_atomic.check_shared_memory(mem, vm.ctx)
                t0 = time.perf_counter()
                reads = rpc_block_reads(rpc, metrics_url, vm, vmb, txs,
                                        receipts, world, touched, writes,
                                        blk_atomic)
                if b == 0:  # the next block's delta stays on the card
                    reads += "; " + rpc_proofs(rpc, vmb, world, oracle,
                                               touched, writes, seed + b)
                reads_ms = (time.perf_counter() - t0) * 1e3
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
                    f"transactions, {len(vmb.atomic_txs)} atomic, gas used "
                    f"{gas}; issue {st['issue']:.1f} ms, build_block "
                    f"{st['build']:.1f} ms (K1 launches: storage programs "
                    f"{st['build_k1'][0]}, resident executor "
                    f"{st['build_k1'][1]}), verify {st['verify']:.1f} ms (K1 "
                    f"launches: storage programs {st['verify_k1'][0]}, "
                    f"resident executor {st['verify_k1'][1]}; flight record "
                    f"phases (ms) " + ", ".join(
                        f"{k} {v * 1e3:.1f}"
                        for k, v in rec["phases"].items())
                    + f"), accept and drain {st['accept']:.1f} ms; mirror "
                    f"device window {fmt_window(st['window'])}; "
                    f"{gas / wall / 1e6:.3f} Mgas/s over build + verify; "
                    f"root {eth.header.root.hex()} == the EVM-independent "
                    f"oracle's; {card}")
                log(f"vm block {eth.number}: over RPC {reads}, all equal to "
                    f"the block and the oracle's world, in {reads_ms:.1f} ms;"
                    f" over WS {pushed}")
                rt, side = engine.rts[-1], engine.vm_side[-1]
                log(f"vm block {eth.number}: built, verified, preferred and "
                    f"accepted by the engine child over the plugin socket; "
                    f"round trip / VM side (ms): " + ", ".join(
                        f"{m} {rt[m]:.1f} / {side[m]:.1f}"
                        for m in ENGINE_CALLS)
                    + f", lastAccepted {rt['lastAccepted']:.2f}; {card}")
                if b == 1:
                    log(f"vm block {eth.number}: the wallet's "
                        f"{len(wallet.objs)} eth_sendTransaction over WS "
                        f"answered the harness's hashes; avax.import "
                        f"{watomic.imp_id} (fee {watomic.fees[0]} nAVAX) and "
                        f"avax.export {watomic.exp_id} (fee "
                        f"{watomic.fees[1]} nAVAX), built by the node's tx "
                        f"builder, counted by the oracle; the shared memory "
                        f"holds the export's UTXO and not the import's")
        plugin = engine.close()
    except BaseException:
        engine.kill()
        raise
    shutil.rmtree(os.path.dirname(os.path.abspath(engine.sock)),
                  ignore_errors=True)
    over = {m: [rt[m] - side[m] for rt, side in zip(engine.rts,
                                                    engine.vm_side)]
            for m in ENGINE_CALLS}
    log("vm plugin: " + plugin + "; per call the engine's round trip / the "
        "VM side (ms): " + "; ".join(
            f"block {b + 1} " + ", ".join(
                f"{m} {rt[m]:.1f} / {side[m]:.1f}" for m in ENGINE_CALLS)
            for b, (rt, side) in enumerate(zip(engine.rts, engine.vm_side)))
        + "; the boundary's own share (round trip less the VM side), mean "
        + ", ".join(f"{m} {np.mean(v):.2f}" for m, v in over.items())
        + f" ms; {card}")
    launches, coop = keccak_cuda.launches, keccak_cuda.launches_coop
    check(len(vm.mempool) == 0 and not vm.mempool.issued
          and vm.txpool.stats() == (0, 0),
          f"vm: mempool {len(vm.mempool)} (issued {len(vm.mempool.issued)}"
          f"), tx pool {vm.txpool.stats()} after the last accept")
    # the keystore's KDF alone: the avax key's light-scrypt keyfile
    kdir = vm.keystore.keydir
    kfile, = [f for f in os.listdir(kdir)
              if f.endswith(watomic.utxo.address.hex())]
    with open(os.path.join(kdir, kfile)) as f:
        kj = json.load(f)
    t0 = time.perf_counter()
    check(decrypt_key(kj, AVAX_PASSWORD) == watomic.key,
          "vm: the avax keyfile does not decrypt to its key")
    scrypt_ms = (time.perf_counter() - t0) * 1e3
    wsc.close()
    ws.stop()
    for name in ws_names:
        now = default_registry.counter(name).count()
        check(now == ws_moved[name], f"vm: {name} counted "
              f"{now - ws_moved[name]}")
    log(f"vm ws: {rpc_stats.ws_requests - ws0} requests in "
        f"{rpc_stats.ws_wall - wsw0:.3f} s of request wall, "
        f"{sum(rpc_stats.pushes.values())} pushes, no error object, no "
        f"notify drop or slow disconnect; the keystore's scrypt (n "
        f"{kj['crypto']['kdfparams']['n']}, p {kj['crypto']['kdfparams']['p']}"
        f") decrypts a keyfile in {scrypt_ms:.1f} ms; the WSEthClient "
        f"closed and ws.stop() joined the server's threads; {card}")
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
    log(f"vm rpc: {rpc_stats.requests - req0} requests in "
        f"{rpc_stats.wall - wall0:.3f} s of request wall, no error object; "
        f"the run's so far: {rpc_stats.summary()}; {card}")
    log(f"vm: {n_blocks} blocks built, verified and accepted through the VM"
        f" in {wall_all * 1e3:.1f} ms of build + verify "
        f"({gas_all / wall_all / 1e6:.3f} Mgas/s); head == "
        f"vm.last_accepted(); mempool and tx pool empty; the shared memory "
        f"holds the export's UTXO and not the import's; K1 launches "
        f"{launches} (storage programs {len(rec_storage.records)}, resident "
        f"executor {len(rec_resident.records)}); garbage collector pauses "
        f"({pauses}); phase {time.perf_counter() - t_phase:.1f} s; {card}")
    return (rec_storage, rec_resident, launches, coop, sorted(touched_all),
            written, threads_before)


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


def rpc_commitment(vm, rec_k2, world: World, touched, rpc_stats: RpcStats,
                   seed) -> str:
    """The commitment VM over RPC after its last block: create_handlers(vm)
    on HTTP and serve_ws beside it; the eth_call of keccak256Batch over
    SHADOW_MSGS seeded messages of SHADOW_MSG_BYTES (the precompile hashes
    them on K2 through the head state's device seam, on the server's
    expensive lane) made twice: through BoundContract(...).call (its ABI
    by accounts/abi.py) over ethclient.Client(url), and as eth_call over a
    WS connection to the same server; each time the returned digests
    equal native.keccak256 of each and rec_k2 counts one launch (then the
    WS server stops, joining its threads); debug_stateWitness of
    RPC_WITNESSES touched accounts, each
    verified with bintrie/witness.verify_witness against the returned
    bintrieRoot (the shadow's root of the head) to the oracle's account;
    debug_commitmentStatus with the shadow unquarantined. Returns (the
    messages, the digests the HTTP call answered, a summary)."""
    server = create_handlers(vm)
    rpc = RpcRun(f"http://127.0.0.1:{server.serve_http('127.0.0.1', 0)}",
                 rpc_stats)
    req0, wall0 = rpc_stats.requests, rpc_stats.wall
    rng = np.random.default_rng(seed)
    raw = rng.bytes(SHADOW_MSGS * SHADOW_MSG_BYTES)
    msgs = [raw[k * SHADOW_MSG_BYTES:(k + 1) * SHADOW_MSG_BYTES]
            for k in range(SHADOW_MSGS)]
    want = [keccak256(m) for m in msgs]
    abi = ABI(KECCAK_BATCH_ABI)
    check(abi.pack("keccak256Batch", msgs) == batch_calldata(msgs),
          "commitment rpc: the ABI's calldata != the precompile's layout")
    bound = BoundContract(TPU_KECCAK_ADDR, abi, rpc.client)
    k2a = len(rec_k2.records)
    got, = rpc._timed("eth_call (BoundContract)", 1,
                      lambda: bound.call("keccak256Batch", msgs))
    check(got == want, "commitment rpc: BoundContract.call of "
          "keccak256Batch != native keccak256")
    http_got = got
    check(len(rec_k2.records) == k2a + 1,
          f"commitment rpc: the BoundContract call made "
          f"{len(rec_k2.records) - k2a} K2 launches, not 1")
    ws, ws_port = serve_ws(vm, rpc_server=server)
    wsc = WsRun(ws_port, rpc_stats)
    out = wsc.call("eth_call", {
        "to": "0x" + TPU_KECCAK_ADDR.hex(),
        "data": "0x" + abi.pack("keccak256Batch", msgs).hex()}, "latest")
    got, = abi.unpack("keccak256Batch", bytes.fromhex(out[2:]))
    check(got == want, "commitment ws: eth_call of keccak256Batch != "
          "native keccak256")
    check(len(rec_k2.records) == k2a + 2,
          f"commitment ws: the eth_call made "
          f"{len(rec_k2.records) - k2a - 1} K2 launches, not 1")
    wsc.close()
    ws.stop()
    chain = vm.blockchain
    last = chain.last_accepted.header.root
    broot = chain.state_database.shadow.root_for(last)
    picks = [touched[int(j)] for j in rng.choice(
        len(touched), min(RPC_WITNESSES, len(touched)), replace=False)]
    for i in picks:
        w = rpc.call("debug_stateWitness", "0x" + world.addrs[i].hex(),
                     "latest")
        check(w["stateRoot"] == "0x" + last.hex()
              and w["bintrieRoot"] == "0x" + broot.hex(),
              f"commitment rpc: debug_stateWitness roots {w}")
        check(bwitness.verify_witness(
            broot, keccak256(world.addrs[i]), bytes.fromhex(w["witness"][2:]))
              == (True, shadow_mod.encode_account(
                  world.nonce[i], world.balance[i], world.code_hash[i],
                  False)),
              f"commitment rpc: the witness of account {i} does not verify")
    st = rpc.call("debug_commitmentStatus")
    check(st["backend"] == "bintrie-shadow"
          and st["shadow"]["quarantined"] is False,
          f"commitment rpc: debug_commitmentStatus {st}")
    return msgs, http_got, (
            f"eth_call of keccak256Batch over {SHADOW_MSGS} x "
            f"{SHADOW_MSG_BYTES} B through BoundContract over HTTP and again "
            f"over WS: 1 K2 launch each, the digests native keccak256's; "
            f"{len(picks)} debug_stateWitness verified against "
            f"bintrieRoot {broot.hex()}; debug_commitmentStatus unquarantined"
            f"; {rpc_stats.requests - req0} HTTP requests in "
            f"{rpc_stats.wall - wall0:.3f} s of request wall, 1 over WS, no "
            f"error object")


def phase_commitment(dev, n_accounts, n_blocks, rpc_stats: RpcStats, seed,
                     card):
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
    # the blocks of this phase and, after them, those of the state-sync
    # phase (8f) on the same VM
    total = n_blocks + SYNC_BLOCKS
    check((n_calls + n_transfers) * total + SHADOW_CALLS
          <= len(world.keyed), "commitment: too few keyed senders")
    mix = evm_transactions(world, total, seed + 1, n_transfers=n_transfers)
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
    calls, msgs_all = precompile_transactions(world, total, callers,
                                              fwds, seed + 2)
    signed = [m + c for m, c in zip(mix, calls)]
    signed, sync_txs = signed[:n_blocks], signed[n_blocks:]
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
    # the state-sync client's genesis: the same, before any block moves
    # the world
    client_genesis = copy.deepcopy(genesis)
    # the last block of this phase is a syncable summary for phase 8f
    cfg = dict(SHADOW_CONFIG, **{"eth-apis": RPC_APIS,
                                 "commit-interval": n_blocks,
                                 "state-sync-commit-interval": n_blocks})
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
    threads_before = set(threading.enumerate())
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
    touched_all = set()
    try:
        for b, txs in enumerate(signed):
            c0 = shadow.status()["commits"]
            k2a = len(rec_k2.records)
            m0 = _timer("chain/commit/mpt")
            b0 = _timer("chain/commit/bintrie")
            vmb, _r, touched, _w, st = vm_block(
                vm, world, oracle, txs, coinbase, recs,
                label=f"commitment block {b + 1}", dev=dev)
            touched_all |= touched
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
        xmsgs, xhttp, rpc_summary = rpc_commitment(
            vm, rec_k2, world, sorted(touched_all), rpc_stats, seed + 4)
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
    log(f"commitment: phase before the state sync "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    sync = phase_state_sync(dev, vm, world, oracle, client_genesis,
                            sync_txs, coinbase, (xmsgs, xhttp), card)
    vm.shutdown()
    threads = threads_left(threads_before)
    check(not threads, f"commitment: threads left after vm.shutdown(): "
          f"{threads}")
    log(f"commitment rpc: {rpc_summary}; vm.shutdown() stopped the server, "
        f"no thread the phase started left; {card}")
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
            pad, sync)



# ----------------------------------------------------- the state-sync phase

# blocks the commitment VM builds after the client synced (phase 8f)
SYNC_BLOCKS = 2
# the client VM's sync knobs: few attempts and a short back-off
SYNC_CONFIG = {"sync-max-attempts": 8, "sync-backoff-base": 0.005,
               "sync-backoff-cap": 0.05}


class _LeafCount:
    """Wraps a SyncClient's get_leafs: requests and leaves received."""

    def __init__(self, client):
        self.inner = client.get_leafs
        self.requests = self.leaves = 0
        self._mu = threading.Lock()
        client.get_leafs = self

    def __call__(self, *a, **kw):
        resp = self.inner(*a, **kw)
        with self._mu:
            self.requests += 1
            self.leaves += len(resp.keys)
        return resp


def phase_state_sync(dev, server, world: World, oracle: Oracle,
                     genesis: Genesis, txs, coinbase: list, xcall, card):
    """State sync on the card (module docstring, phase 8f), served by the
    commitment VM `server` (phase 8c), whose commit-interval and
    state-sync-commit-interval make its last block a syncable summary. A
    client VM from the same genesis on a SQLiteDB in a temporary
    directory syncs through StateSyncClient(vm, SyncClient.from_config(
    net, ...)) over the TCP transport (TransportServer on 127.0.0.1 and
    dial()), with a second peer on its own connection wrapped in
    FaultyTransport(script=["corrupt", "drop"]); _finish reboots the
    client's resident mirror over the synced trie on the card (K1). Then
    the server builds and accepts SYNC_BLOCKS blocks of `txs` through
    vm_block (each root the oracle's), and the client parses, verifies and
    accepts each: every root the server's. The transport serves the
    server's own Network (its request handler the sync handler), so sync
    and gossip share the one route: after the sync the faulty peer is
    dropped, each VM gets a Gossiper over its Network, and the first
    block's transactions are issued to the client's pool alone; they reach
    the server's pool only by gossip, which must hold every one of them
    before build_block, with no gossip drop or timeout counted. Then the
    cross-chain eth_call both ways of 8c's keccak256Batch call (`xcall`:
    its messages and the digests it answered over HTTP): the client asks
    the server's chain, the server asks the client's synced head, each
    answer those digests and the host Keccak's, each with a K2 launch.
    Every K1 and K2 launch goes through a recorder. Returns (the K1
    recorder, K1 launches, of them cooperative, the K2 recorder, K2
    launches, of them cooperative, K2's padding lanes)."""
    from coreth_tpu_torch.ethdb.sqlitedb import SQLiteDB
    from coreth_tpu_torch.peer.network import Network
    from coreth_tpu_torch.peer.testing import FaultyTransport
    from coreth_tpu_torch.peer.transport import TransportServer, dial
    from coreth_tpu_torch.sync.client import SyncClient
    from coreth_tpu_torch.vm.api import DebugMetricsAPI
    from coreth_tpu_torch.vm.gossiper import GOSSIP_ETH_TXS, Gossiper
    from coreth_tpu_torch.vm.syncervm import StateSyncClient, \
        StateSyncServer

    t_phase = time.perf_counter()
    threads_before = set(threading.enumerate())
    schain = server.blockchain
    interval = server.full_config.state_sync_commit_interval
    summary = StateSyncServer(schain, syncable_interval=interval,
                              vm=server).get_last_state_summary()
    head = schain.last_accepted
    check(summary is not None and summary.block_hash == head.hash()
          and summary.block_root == head.root == oracle.root(),
          f"state sync: no summary at the server's head {head.number} "
          f"(state-sync-commit-interval {interval})")
    rec, rec_k2 = _K1Recorder(keccak_cuda.segment_keccak), _K2Recorder()
    pc = default_planned_commit(dev)
    pc_impl, seg = pc._impl, keccak_cuda.segment_keccak
    bk = default_batched_keccak(dev)
    bk_impl = bk.impl
    bk.reset_totals()
    tmp = tempfile.mkdtemp(prefix="state_sync_")
    db = tcp = good = other = net = snet = cvm = None
    gossipers = []
    keccak_cuda.reset_counts()
    pc._impl = keccak_cuda.segment_keccak = rec
    bk.impl = rec_k2
    # the server's own seams feed the same recorders from here on
    schain.state_database.triedb.batch_keccak = PlannedMode(
        PlannedCommit(seg_impl=rec, device=dev))
    schain.mirror.ex.seg_impl = rec
    schain.state_database.shadow.executor._impl = rec
    try:
        db = SQLiteDB(os.path.join(tmp, "client.db"), sync=False)
        cfg = dict(SYNC_CONFIG)
        if dev.type != "cuda":
            cfg["resident-account-trie"] = True
        cvm = VM()
        t0 = time.perf_counter()
        cvm.initialize(SnowContext(shared_memory=Memory()), db, genesis,
                       config_bytes=json.dumps(cfg).encode(), device=dev)
        boot_ms = (time.perf_counter() - t0) * 1e3
        cchain = cvm.blockchain
        check(cchain.genesis_block.hash() == schain.genesis_block.hash(),
              "state sync: the client's genesis != the server's")
        old_mirror = cchain.mirror
        check(old_mirror is not None and not old_mirror.host_mode,
              "state sync: the client's mirror is not on the device")
        n_boot = len(rec.records)
        # the server's Network: its request handler the sync handler, its
        # app_request the transport's handler (gossip rides the same route)
        snet = Network(self_id=b"server")
        snet.set_request_handler(server.sync_handler.handle)
        tcp = TransportServer(snet.app_request)
        port = tcp.serve("127.0.0.1", 0)
        good, other = dial("127.0.0.1", port), dial("127.0.0.1", port)
        faulty = FaultyTransport(other, script=["corrupt", "drop"])
        net = Network(self_id=b"client")
        net.connect(b"server", good)
        net.connect(b"faulty", faulty)
        client = SyncClient.from_config(net, cvm.full_config)
        count = _LeafCount(client)
        names = ("sync/retries", "sync/failures/validation",
                 "sync/failures/decode", "sync/drain_disagreements",
                 "peer/ladder/quarantines", "peer/ladder/suspects")
        c0 = {n: default_registry.counter(n).count() for n in names}
        ssc = StateSyncClient(cvm, client)
        t0 = time.perf_counter()
        ssc.accept_summary(summary)
        sync_s = time.perf_counter() - t0
        n_sync = len(rec.records) - n_boot
        moved = {n: default_registry.counter(n).count() - c0[n]
                 for n in names}
        peers = net.tracker.status()
        nbytes = sum(st.total_bytes for st in net.tracker.peers.values())
        status = DebugMetricsAPI(cvm).syncStatus()
        check(cchain.last_accepted.hash() == summary.block_hash
              and cchain.current_block.hash() == summary.block_hash
              and cvm.last_accepted().id() == summary.block_hash
              and ssc.ongoing_summary() is None,
              "state sync: the client's head is not the summary")
        mirror = cchain.mirror
        check(mirror is not old_mirror and not mirror.host_mode
              and mirror.root_of(summary.block_hash) == summary.block_root,
              "state sync: the client's mirror was not rebooted on the "
              "device over the synced root")
        check(dev.type != "cuda" or n_sync > 0,
              "state sync: the mirror reboot launched no K1")
        check(faulty.faults_injected == 2
              and moved["sync/failures/validation"]
              + moved["sync/failures/decode"] >= 1,
              f"state sync: the faulty peer injected "
              f"{faulty.faults_injected} faults; counters {moved}")
        check(status["syncing"] and status["trie"]["phase"] == "done",
              f"state sync: debug_syncStatus {status}")
        # the synced world, spot-checked against the oracle's
        rng = np.random.default_rng(len(world.addrs))
        cst = cchain.state()
        picks = sorted(set(int(i) for i in rng.choice(
            len(world.addrs), 200, replace=False)) | set(world.storage))
        for i in picks:
            a = world.addrs[i]
            check(cst.get_balance(a) == world.balance[i]
                  and cst.get_nonce(a) == world.nonce[i]
                  and keccak256(cst.get_code(a)) == world.code_hash[i],
                  f"state sync: account {i} differs from the oracle's")
        for c in world.storage:
            for k in list(world.storage[c])[:5]:
                check(cst.get_state(world.addrs[c], k)
                      == world.storage[c][k],
                      f"state sync: slot of contract {c} differs")
        log(f"state sync: client VM booted in {boot_ms:.1f} ms on SQLite "
            f"(its mirror's genesis {n_boot} K1 launches); synced block "
            f"{summary.block_number} ({summary.block_root.hex()[:16]}..) "
            f"over TCP in {sync_s:.2f} s: {count.leaves} leaves in "
            f"{count.requests} leafs requests ({count.leaves / sync_s:.0f} "
            f"leaves/s), {nbytes} bytes received, retries "
            f"{moved['sync/retries']}, rejected responses "
            f"{moved['sync/failures/validation']} (range proof) + "
            f"{moved['sync/failures/decode']} (decode), drain "
            f"disagreements {moved['sync/drain_disagreements']}; the faulty"
            f" peer injected {faulty.faults_injected} faults, peers by "
            f"state {status['peersByState']}, quarantined "
            f"{sum(1 for p in peers.values() if p['state'] == 'quarantined')}"
            f"; the mirror reboot on the synced trie launched {n_sync} K1; "
            f"{len(picks)} accounts and {5 * len(world.storage)} slots "
            f"equal the oracle's; {card}")

        # the cross-chain eth_call both ways: 8c's keccak256Batch call
        msgs, http_digests = xcall
        net.register_cross_chain_handler(server.chain_id_bytes,
                                         server.handle_cross_chain_request)
        snet.register_cross_chain_handler(cvm.chain_id_bytes,
                                          cvm.handle_cross_chain_request)
        call = {"to": "0x" + TPU_KECCAK_ADDR.hex(),
                "data": "0x" + batch_calldata(msgs).hex()}
        abi = ABI(KECCAK_BATCH_ABI)
        want = [keccak256(m) for m in msgs]
        check(want == http_digests, "state sync: 8c's HTTP answer != the "
              "host Keccak")
        xcalls = []
        for who, caller, network, callee in (
                ("client -> server", cvm, net, server),
                ("server -> client", server, snet, cvm)):
            k2a = len(rec_k2.records)
            t0 = time.perf_counter()
            out = caller.cross_chain_eth_call(network, callee.chain_id_bytes,
                                              call)
            ms = (time.perf_counter() - t0) * 1e3
            got, = abi.unpack("keccak256Batch", out)
            n2 = len(rec_k2.records) - k2a
            check(got == want, f"state sync: the cross-chain eth_call "
                  f"{who} != the host Keccak and 8c's HTTP answer")
            check(dev.type != "cuda" or n2 >= 1,
                  f"state sync: the cross-chain eth_call {who} launched no "
                  f"K2")
            xcalls.append(f"{who} {ms:.1f} ms, {n2} K2 launch"
                          f"{'es' if n2 != 1 else ''}")
        log(f"state sync cross-chain: eth_call of keccak256Batch over "
            f"{len(msgs)} x {len(msgs[0])} B through "
            f"VM.cross_chain_eth_call / handle_cross_chain_request both ways"
            f" ({'; '.join(xcalls)}); each answer the host Keccak's and 8c's"
            f" over HTTP; {card}")

        # gossip: the faulty peer has served the sync and is dropped, so
        # each gossip takes one route; a Gossiper a VM over its Network
        net.disconnect(b"faulty")
        gossipers += [Gossiper(server, snet), Gossiper(cvm, net)]
        heard, sent = set(), []

        def heard_on_server(_sender, payload):
            if payload[:1] == bytes([GOSSIP_ETH_TXS]):
                for blob in rlp.decode(payload[1:]):
                    heard.add(keccak256(bytes(blob)))

        snet.subscribe_gossip(heard_on_server)
        net_gossip = net.gossip

        def counted(payload):
            sent.append(len(payload))
            net_gossip(payload)

        net.gossip = counted
        g_names = ("gossip/drops/empty", "gossip/drops/unknown_kind",
                   "gossip/drops/malformed", "gossip/drops/eth_tx_rejected",
                   "gossip/drops/atomic_tx_rejected", "peer/gossip_timeouts",
                   "peer/drops/gossip_send_failure",
                   "peer/drops/gossip_handler_error")
        g0 = {n: default_registry.counter(n).count() for n in g_names}

        # the server's next blocks, parsed, verified and accepted by the
        # client; the first one's transactions issued to the client alone
        per = []
        for b, block_txs in enumerate(txs[:SYNC_BLOCKS]):
            gossip_note = ""
            if b == 0:
                t0 = time.perf_counter()
                for t in block_txs:
                    cvm.issue_tx(Transaction.decode(t.blob))
                g_ms = (time.perf_counter() - t0) * 1e3
                hashes = {keccak256(t.blob) for t in block_txs}
                check(cvm.txpool.stats()[0] == len(block_txs),
                      f"state sync: the client's pool holds "
                      f"{cvm.txpool.stats()}, not {len(block_txs)} pending")
                check(server.txpool.stats()[0] == len(block_txs)
                      and all(server.txpool.has(h) for h in hashes)
                      and heard == hashes,
                      f"state sync: the server's pool holds "
                      f"{server.txpool.stats()} after gossip ({len(heard)} "
                      f"heard), not the {len(block_txs)} issued to the "
                      f"client")
                moved = {n: default_registry.counter(n).count() - g0[n]
                         for n in g_names}
                check(not any(moved.values()),
                      f"state sync: gossip counters moved {moved}")
            vmb, _r, _t, _w, st = vm_block(
                server, world, oracle, block_txs, coinbase, (rec,),
                label=f"state sync server block {b + 1}", dev=dev,
                issued=b == 0)
            if b == 0:
                origin = {keccak256(tx.encode()) in heard
                          for tx in vmb.eth_block.transactions}
                check(origin == {True}, "state sync: the gossip-fed block "
                      "holds a transaction the server did not hear")
                gossip_note = (
                    f"; its {len(block_txs)} transactions issued to the "
                    f"client's pool in {g_ms:.1f} ms reached the server by "
                    f"gossip alone ({len(sent)} messages sent, "
                    f"{sum(sent)} bytes, {len(heard)} transactions heard), "
                    f"all {len(vmb.eth_block.transactions)} of the block by "
                    f"gossip, 0 by the server's own issue; no gossip drop "
                    f"or timeout")
            k1a, k2a = len(rec.records), len(rec_k2.records)
            t0 = time.perf_counter()
            parsed = cvm.parse_block(vmb.bytes())
            parsed.verify()
            verify_ms = (time.perf_counter() - t0) * 1e3
            cvm.set_preference(parsed.id())
            parsed.accept()
            cchain.drain_acceptor_queue()
            got = cchain.last_accepted
            check(got.hash() == vmb.id() and got.root == vmb.eth_block.root
                  == oracle.root(),
                  f"state sync: client block {got.number} root "
                  f"{got.root.hex()} != the server's and the oracle's")
            n1, n2 = len(rec.records) - k1a, len(rec_k2.records) - k2a
            per.append((verify_ms, n1, n2))
            log(f"state sync block {got.number}: server build_block "
                f"{st['build']:.1f} ms; client parse + verify "
                f"{verify_ms:.1f} ms with {n1} K1 and {n2} K2 launches, "
                f"accepted; root {got.root.hex()[:16]}.. == the server's "
                f"== the oracle's{gossip_note}; {card}")
        check(dev.type != "cuda" or all(n1 > 0 for _v, n1, _n2 in per),
              "state sync: a client verify launched no K1")
        check(cvm.txpool.stats() == (0, 0) and server.txpool.stats()
              == (0, 0), f"state sync: pools after the blocks: client "
              f"{cvm.txpool.stats()}, server {server.txpool.stats()}")
    finally:
        for g in gossipers:
            g.stop()
        pc._impl, keccak_cuda.segment_keccak = pc_impl, seg
        bk.impl = bk_impl
        for c in (good, other):
            if c is not None:
                c.close()
        if net is not None:
            net.close()
        stopped = tcp.stop() if tcp is not None else []
        if snet is not None:
            snet.close()
        if cvm is not None:
            cvm.shutdown()
        if db is not None:
            db.close()
        shutil.rmtree(tmp, ignore_errors=True)
    check(stopped == [], f"state sync: transport threads left {stopped}")
    k1, k1_coop = keccak_cuda.launches, keccak_cuda.launches_coop
    k2, k2_coop = keccak_cuda.blocks_launches, keccak_cuda.blocks_launches_coop
    cuda = dev.type == "cuda"
    check(not cuda or (k1 == len(rec.records) > 0
                       and k2 == len(rec_k2.records) > 0),
          f"state sync: K1 {k1} launches, {len(rec.records)} recorded; K2 "
          f"{k2}, {len(rec_k2.records)} recorded")
    # the server's RPC server runs on until phase 8c's vm.shutdown()
    threads = threads_left(threads_before, servers=False)
    check(not threads, f"state sync: threads left: {threads}")
    log(f"state sync: {SYNC_BLOCKS} blocks verified after the sync "
        f"({sum(v for v, _a, _b in per):.1f} ms of parse + verify, "
        f"{sum(a for _v, a, _b in per)} K1 launches); K1 launches in the "
        f"phase {k1} (cooperative {k1_coop}), K2 {k2} (cooperative "
        f"{k2_coop}); the transport, the client VM and its store closed, "
        f"no thread left; phase {time.perf_counter() - t_phase:.1f} s; "
        f"{card}")
    return (rec, k1, k1_coop, rec_k2, k2, k2_coop,
            bk.padded_lanes - bk.lanes)


# ------------------------------------------------------ the prune phase

# phase 8g: blocks before the prune and after the reopen, each of
# PRUNE_CALLS contract calls and PRUNE_TRANSFERS transfers
PRUNE_BLOCKS = 4
PRUNE_MORE = 2
PRUNE_CALLS = 4
PRUNE_TRANSFERS = 150
PRUNE_INTERVAL = 2  # the chain's commit interval


def _key_stats(db) -> tuple:
    """(entries, 32-byte keys) of a store."""
    n = n32 = 0
    for k, _v in db.iterate():
        n += 1
        n32 += len(k) == 32
    return n, n32


def phase_prune(dev, n_accounts, seed, card):
    """The offline prune under a resident chain (module docstring, phase
    8g): a world of its own at `n_accounts` (the main world's shape) with
    its own oracle; a resident BlockChain on the device, commit interval
    PRUNE_INTERVAL, over a SQLiteDB in a temporary directory (its genesis
    commit and mirror boot on K1). PRUNE_BLOCKS + PRUNE_MORE blocks are
    made up front by generate_chain over an overlay of that store (the CPU
    Hasher; each root the oracle's). The chain takes the first
    PRUNE_BLOCKS (insert, accept: the storage programs and the resident
    executor on K1), stop() writes the shutdown export, then
    Pruner.prune(tip root, genesis root) sweeps the store on the host; a
    reopened resident chain reboots its mirror over the pruned store on
    K1, its head the tip, a sample of accounts and slots the oracle's, and
    takes the last PRUNE_MORE blocks, each root the oracle's;
    recover_pruning() is then False. Every K1 launch goes through a
    recorder. Returns (the K1 recorder, K1 launches, of them
    cooperative)."""
    from coreth_tpu_torch.core.pruner import PRUNING_IN_PROGRESS_KEY, Pruner
    from coreth_tpu_torch.ethdb.sqlitedb import SQLiteDB

    t_phase = time.perf_counter()
    threads_before = set(threading.enumerate())
    cuda = dev.type == "cuda"
    cfg = params.TEST_CHAIN_CONFIG
    t0 = time.perf_counter()
    world = World(n_accounts, max(1, n_accounts // 1000), 100, seed,
                  n_keyed=EVM_KEYED)
    oracle = Oracle(world)
    genesis_root = oracle.root()
    # the genesis over copies of the world's lists and slot maps, which
    # the oracle's blocks update in place
    genesis = genesis_alloc(world.snapshot())
    signed = evm_transactions(world, PRUNE_BLOCKS + PRUNE_MORE, seed + 1,
                              n_calls=PRUNE_CALLS,
                              n_transfers=PRUNE_TRANSFERS)
    world_s = time.perf_counter() - t0
    rec = _K1Recorder(keccak_cuda.segment_keccak)
    pc = default_planned_commit(dev)
    pc_impl, seg = pc._impl, keccak_cuda.segment_keccak
    tmp = tempfile.mkdtemp(prefix="prune_")
    db = chain = None
    names = LOUD + LOUD_DEVICE + ("core/pruner/account_node_decode_error",)
    before = {n: default_registry.counter(n).count() for n in names}
    # counted by both packages' pruners for every extension node whose
    # child is a hash (ROADMAP Queue 3): read, not held at 0
    ext_name = "core/pruner/account_leaf_decode_error"
    ext0 = default_registry.counter(ext_name).count()
    keccak_cuda.reset_counts()
    pc._impl = keccak_cuda.segment_keccak = rec
    ccfg = CacheConfig(resident_account_trie=True,
                       commit_interval=PRUNE_INTERVAL)
    try:
        db = SQLiteDB(os.path.join(tmp, "chain.db"), sync=False)
        t0 = time.perf_counter()
        chain = BlockChain(db, ccfg, cfg, genesis, new_dummy_engine(),
                           device=dev)
        boot_ms = (time.perf_counter() - t0) * 1e3
        n_boot = len(rec.records)
        gen_block = chain.genesis_block
        check(gen_block.root == genesis_root and chain.mirror is not None
              and not chain.mirror.host_mode,
              "prune: the genesis root is not the oracle's or the mirror "
              "is not on the device")
        # the blocks, made once over an overlay of the genesis store
        t0 = time.perf_counter()
        maker = Database(TrieDatabase(_Overlay(db)))
        blocks, receipts = generate_chain(
            cfg, gen_block, new_dummy_engine(), maker, len(signed),
            gen=lambda i, bg: [bg.add_tx(Transaction.decode(t.blob))
                               for t in signed[i]])
        coinbase, roots = [0], []
        for txs, b, r in zip(signed, blocks, receipts):
            want, _t, _w = evm_oracle_block(world, oracle, txs, r,
                                            b.header.base_fee, coinbase)
            roots.append(want)
            check(b.root == want, f"prune: made block {b.number} root != "
                  f"the oracle's")
            if len(roots) == PRUNE_BLOCKS:
                tip_world = world.snapshot()
        make_ms = (time.perf_counter() - t0) * 1e3
        del maker

        def take(ch, bs):
            per = []
            for b in bs:
                t1 = time.perf_counter()
                pb = Block.decode(b.encode())
                ch.insert_block(pb)
                ch.set_preference(pb)
                ch.accept(pb)
                per.append((time.perf_counter() - t1) * 1e3)
            ch.drain_acceptor_queue()
            check(ch.acceptor_error is None and not ch.bad_blocks,
                  f"prune: acceptor error {ch.acceptor_error}")
            return per

        n0 = len(rec.records)
        first = take(chain, blocks[:PRUNE_BLOCKS])
        tip = blocks[PRUNE_BLOCKS - 1]
        check(chain.last_accepted.hash() == tip.hash()
              and chain.mirror.root_of(tip.hash()) == roots[PRUNE_BLOCKS - 1],
              "prune: the chain's head is not the tip or its mirror root "
              "not the oracle's")
        n_first = len(rec.records) - n0
        t0 = time.perf_counter()
        chain.stop()  # the shutdown export: the tip's image on disk
        stop_ms = (time.perf_counter() - t0) * 1e3
        chain = None
        st0 = db.stat()
        n_all, n32 = _key_stats(db)
        pruner = Pruner(db, TrieDatabase(db))
        t0 = time.perf_counter()
        deleted = pruner.prune(tip.root, gen_block.root)
        prune_ms = (time.perf_counter() - t0) * 1e3
        st1 = db.stat()
        n_all1, n32_1 = _key_stats(db)
        check(deleted > 0 and n32 - n32_1 == deleted
              and n_all - n_all1 == deleted,
              f"prune: {deleted} deleted, 32-byte keys {n32} -> {n32_1}")
        check(db.get(tip.root) is not None
              and db.get(gen_block.root) is not None
              and db.get(PRUNING_IN_PROGRESS_KEY) is None,
              "prune: the tip or genesis root is gone, or the marker stayed")

        # reopen: the mirror reboots over the pruned store on the device
        n0 = len(rec.records)
        t0 = time.perf_counter()
        chain = BlockChain(db, ccfg, cfg, genesis, new_dummy_engine(),
                           device=dev)
        reopen_ms = (time.perf_counter() - t0) * 1e3
        n_reboot = len(rec.records) - n0
        check(chain.last_accepted.hash() == tip.hash()
              and chain.current_block.hash() == tip.hash()
              and chain.mirror is not None and not chain.mirror.host_mode
              and chain.mirror.root_of(tip.hash()) == tip.root,
              "prune: the reopened chain's head is not the tip, or its "
              "mirror is not on the device over the tip's root")
        check(not cuda or n_reboot > 0,
              "prune: the mirror reboot launched no K1")
        rng = np.random.default_rng(seed)
        picks = sorted(set(int(i) for i in rng.choice(
            len(world.addrs), 200, replace=False)))

        def sample(w: World, label) -> int:
            """The picked accounts and 5 slots a contract read from the
            chain's head state against `w`; returns the slots read."""
            cst = chain.state()
            for i in picks:
                a = w.addrs[i]
                check(cst.get_balance(a) == w.balance[i]
                      and cst.get_nonce(a) == w.nonce[i],
                      f"prune: {label}: account {i} differs from the "
                      f"oracle's")
            n = 0
            for c in w.storage:
                for key in list(w.storage[c])[:5]:
                    check(cst.get_state(w.addrs[c], key)
                          == w.storage[c][key],
                          f"prune: {label}: a slot of contract {c} differs")
                    n += 1
            return n

        n_slots = sample(tip_world, "the reopened tip")
        n0 = len(rec.records)
        more = take(chain, blocks[PRUNE_BLOCKS:])
        n_more = len(rec.records) - n0
        head = chain.last_accepted
        check(head.hash() == blocks[-1].hash() and head.root == roots[-1]
              and chain.mirror.root_of(head.hash()) == roots[-1],
              "prune: the reopened chain's blocks did not land on the "
              "oracle's roots")
        sample(world, "the last block")
        check(Pruner(db, TrieDatabase(db)).recover_pruning(gen_block.root)
              is False, "prune: recover_pruning() ran a prune")
        chain.stop()
        chain = None
    finally:
        pc._impl, keccak_cuda.segment_keccak = pc_impl, seg
        if chain is not None:
            chain.stop()
        if db is not None:
            db.close()
        shutil.rmtree(tmp, ignore_errors=True)
    k1, k1_coop = keccak_cuda.launches, keccak_cuda.launches_coop
    check(not cuda or k1 == len(rec.records) > 0,
          f"prune: K1 {k1} launches, {len(rec.records)} recorded")
    check(keccak_cuda.blocks_launches == 0, "prune: K2 launched")
    moved = {n: default_registry.counter(n).count() - before[n]
             for n in names}
    check(not any(moved.values()), f"prune: counters moved {moved}")
    threads = threads_left(threads_before, servers=False)
    check(not threads, f"prune: threads left: {threads}")
    if cuda:
        ran = check_variants(rec, "prune")
        log("prune: every K1 launch ran the variant its shape calls for ("
            + ", ".join(f"{VARIANT_NAME[v]} {n}" for v, n in ran.items())
            + ")")
    log(f"prune: world and oracle of {n_accounts} accounts "
        f"({len(world.storage)} contracts x 100 slots) and "
        f"{len(signed)} blocks signed in {world_s:.1f} s; a resident "
        f"BlockChain (commit interval {PRUNE_INTERVAL}) on SQLite booted in "
        f"{boot_ms:.1f} ms ({n_boot} K1 launches: the genesis commit and "
        f"the mirror boot); {len(signed)} blocks of "
        f"{PRUNE_CALLS + PRUNE_TRANSFERS} transactions made over an overlay"
        f" in {make_ms:.1f} ms, every root the oracle's; {PRUNE_BLOCKS} "
        f"inserted and accepted (ms " + ", ".join(f"{x:.1f}" for x in first)
        + f"; {n_first} K1 launches), stop() with the shutdown export "
        f"{stop_ms:.1f} ms; {card}")
    ext = default_registry.counter(ext_name).count() - ext0
    log(f"prune: Pruner.prune(tip, genesis) on the host in {prune_ms:.1f} "
        f"ms: {n32} 32-byte keys of {n_all} entries, {deleted} deleted, "
        f"{n32_1} kept (the marked nodes on disk; {ext_name} counted {ext}"
        f", one an extension node over a hash, as in the reference); the "
        f"store "
        f"{st0['entries']} -> {st1['entries']} entries, {st0['bytes']} -> "
        f"{st1['bytes']} bytes (SQLiteDB.stat: pages, no VACUUM); the tip "
        f"and genesis roots on disk; {card}")
    log(f"prune: reopened in {reopen_ms:.1f} ms, its mirror rebooted over "
        f"the pruned store with {n_reboot} K1 launches, head the tip, "
        f"{len(picks)} accounts and {n_slots} slots of it the oracle's; "
        f"{PRUNE_MORE} more blocks (ms " + ", ".join(f"{x:.1f}" for x in more)
        + f"; {n_more} K1 launches), every root and the same sample the "
        f"oracle's; recover_pruning() False; K1 launches in the phase {k1} "
        f"(cooperative {k1_coop}); no thread left; phase "
        f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return rec, k1, k1_coop


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


# ------------------------------------------------------- the chaos phase

CHAOS_SEED = 7


def phase_chaos(dev, steps: int, card):
    """The chaos conductor on the card (module docstring, phase 8e):
    fault.chaos.Conductor(seed=CHAOS_SEED, steps, kill_drill=True,
    device=dev).run(), the node's resident mirror and storage programs on
    K1 and the ladder's re-promotion probes on K2 of this device, the kill
    drill's child chain on the same device in a subprocess. Every K1 and
    K2 launch of the parent goes through a recorder (the module's
    segment_keccak and the planned commit's, the probe seam's K2 impl).
    Passes with 0 violations and 0 watchdog trips, every catalogue
    subsystem covered, the child's store repaired to exactly the head it
    reported, its chain on the device with K1 launched, and no thread or
    process of the phase left. Returns (the K1 recorder, K1 launches, of
    them cooperative, the K2 recorder, K2 launches, of them cooperative,
    K2's padding lanes)."""
    from coreth_tpu_torch.fault import chaos

    t_phase = time.perf_counter()
    threads_before = set(threading.enumerate())
    lad = default_ladder()
    lad.reset()
    rec = _K1Recorder(keccak_cuda.segment_keccak)
    rec_k2 = _K2Recorder()
    pc = default_planned_commit(dev)
    pc_impl, seg = pc._impl, keccak_cuda.segment_keccak
    get_batch_keccak("batched", dev)  # the probes' seam on this device
    probe = device_mod._cached["fn"].__self__
    probe_impl = probe.impl
    probe.impl = rec_k2
    probe.reset_totals()
    keccak_cuda.reset_counts()
    pc._impl = keccak_cuda.segment_keccak = rec
    conductor = chaos.Conductor(CHAOS_SEED, steps, kill_drill=True,
                                device=dev)
    t0 = time.perf_counter()
    try:
        result = conductor.run()
    finally:
        pc._impl, keccak_cuda.segment_keccak = pc_impl, seg
        probe.impl = probe_impl
    wall = time.perf_counter() - t0
    k1, k1_coop = keccak_cuda.launches, keccak_cuda.launches_coop
    k2, k2_coop = keccak_cuda.blocks_launches, keccak_cuda.blocks_launches_coop
    pad = probe.padded_lanes - probe.lanes
    lad.reset()
    t0 = time.perf_counter()
    exec_shards.stop_servers()
    stop_ms = (time.perf_counter() - t0) * 1e3
    by_sub = defaultdict(int)
    for fp, sub, _a, _s in chaos.CATALOGUE:
        by_sub[sub] += result["fired"].get(fp, 0)
    check(result["violations"] == [] and not conductor.watchdog.tripped,
          f"chaos: violations {result['violations']}, watchdog trips "
          f"{conductor.watchdog.tripped}")
    subsystems = sorted({e[1] for e in chaos.CATALOGUE})
    check(result["coverage"]["subsystems"] == subsystems,
          f"chaos: subsystems covered {result['coverage']['subsystems']} "
          f"of {subsystems}")
    kd = result["kill_drill"] or {}
    child = dict(ln.split(None, 1) for ln in conductor.kill_child_lines
                 if " " in ln)
    check(kd.get("ok") and kd.get("torn_on_disk")
          and kd.get("repaired_head") == kd.get("expected_head")
          and kd.get("repaired_number") == 2,
          f"chaos: kill drill {kd}")
    child_k1 = int(child.get("K1", "0"))
    check(child.get("DEVICE", "").startswith(
        f"{dev} mirror {dev.type == 'cuda'}"),
          f"chaos: the kill child reported {child.get('DEVICE')!r}")
    cuda = dev.type == "cuda"
    check(not cuda or (child_k1 > 0 and k1 == len(rec.records) > 0
                       and k2 == len(rec_k2.records) > 0),
          f"chaos: K1 {k1} launches, {len(rec.records)} recorded; K2 {k2}, "
          f"{len(rec_k2.records)} recorded; the child's K1 {child_k1}")
    check(rec_k2.records or not cuda, "chaos: no probe reached K2")
    left = descendants()
    check(not left, f"chaos: processes left: {left}")
    threads = threads_left(threads_before)
    check(not threads, f"chaos: threads left: {threads}")
    final = result["final"]
    log(f"chaos: seed {CHAOS_SEED}, {steps} steps in {wall:.1f} s "
        f"({steps / wall:.2f} steps/s); 0 violations, 0 watchdog trips; "
        f"failpoints fired by subsystem {dict(sorted(by_sub.items()))} "
        f"({result['coverage']['failpoints_fired']} of "
        f"{len(chaos.CATALOGUE)} failpoints); height {final['height']}, "
        f"accepted {final['accepted']}; degraded entries "
        f"{final['degraded_entries']} / recoveries "
        f"{final['degraded_recoveries']}, db retries {final['db_retries']}, "
        f"verify failures {final['db_verify_failures']}, demotions "
        f"{final['device_demotions']}, mirror quarantines "
        f"{final['mirror_quarantines']}, shard crashes "
        f"{final['shard_crashes']} / respawns {final['shard_respawns']} / "
        f"fallbacks {final['shard_fallbacks']}; {card}")
    log(f"chaos kill drill: the child (subprocess, {child.get('DEVICE')}) "
        f"tore block 3's tail, K1 launches in the child {child_k1}; SIGKILL, "
        f"its SQLite store rebooted to block {kd['repaired_number']} "
        f"{kd['repaired_head'][:16]}.. == the head it reported")
    log(f"chaos: K1 launches in the phase {k1} (cooperative {k1_coop}), "
        f"K2 launches (the ladder's re-promotion probes) {k2} (cooperative "
        f"{k2_coop}); the forkserver stopped in {stop_ms:.1f} ms, no thread "
        f"or process left; phase {time.perf_counter() - t_phase:.1f} s; "
        f"{card}")
    return rec, k1, k1_coop, rec_k2, k2, k2_coop, pad


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
    ap.add_argument("--batched-accounts", type=int, default=100_000,
                    help="accounts of the batched path's own world (phase "
                         "6 and the batched block of phase 7)")
    ap.add_argument("--chaos-steps", type=int, default=64,
                    help="steps of the chaos conductor on the card (phase "
                         "8e, seed 7, kill drill on)")
    ap.add_argument("--prune-accounts", type=int, default=20_000,
                    help="accounts of the prune phase's own world (phase "
                         "8g)")
    ap.add_argument("--device", default="cuda",
                    help="'cpu' rehearses with the plain versions")
    args = ap.parse_args()
    if args.option_blocks < 4:
        ap.error("--option-blocks must be at least 4")
    if args.vm_blocks < 2:
        ap.error("--vm-blocks must be at least 2 (the second is the "
                 "wallet's)")
    if args.device != "cpu" and not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = resolve(args.device)
    t_start = time.perf_counter()
    run_dir = tempfile.mkdtemp(prefix="chip_smoke_")

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
    # the batched path (K2) on a world of its own, the main world's shape
    # at --batched-accounts, with its own oracle
    b_world = World(args.batched_accounts,
                    max(1, args.batched_accounts // 1000), args.slots,
                    args.seed + 11)
    b_oracle = Oracle(b_world)
    b_oracle_root = b_oracle.root()
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
     cb_coop, cb_rec) = phase_genesis(dev, world, oracle_root,
                                      os.path.join(run_dir, "keystore"))
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
        phase_genesis_batched(dev, b_world, b_oracle_root)
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
    b_accounts, b_writes, _ = make_block(b_world)
    b_oracle.apply(b_accounts, b_writes)
    b_want = b_oracle.root()
    del b_oracle
    root, bb_launches, bb_coop, bb_rec = commit_batched(
        dev, mode, b_trie,
        block_changes(b_world, b_changed, b_accounts, b_writes),
        "batched block")
    check(root == b_want, f"batched block root {root.hex()} != CPU oracle "
          f"{b_want.hex()}")
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
    rpc_stats = RpcStats()
    (v_storage, v_resident, v_launches, v_coop, v_touched, v_written,
     v_threads) = phase_vm(dev, vm, mem, evm_world, evm_oracle,
                           args.vm_blocks, vm_coinbase, rpc_stats,
                           args.seed + 7, card)
    for c, keys in v_written.items():
        written[c] = set(written.get(c, ())) | keys
    finish_chain(dev, vm, evm_world, sorted(set(touched) | set(v_touched)),
                 written, coinbase_fee, vm_coinbase[0], c_exports, v_threads,
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
     cm_pad, sync) = phase_commitment(dev, args.shadow_accounts,
                                      args.shadow_blocks, rpc_stats,
                                      args.seed + 9, card)
    (sy_rec1, sy_k1, sy_k1_coop, sy_rec2, sy_k2, sy_k2_coop,
     sy_pad) = sync
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
    sy_err, sy_ms, sy_plain, sy_shapes, sy_kernel = time_k1(
        dev, [r[0] for r in sy_rec1.records], "state sync",
        per_segment=False, outputs=[r[1] for r in sy_rec1.records])
    sk_err, sk_ms, sk_plain, sk_inputs, sk_kernel = check_and_time_k2(
        sy_rec2, "state sync", sy_pad, profile_reps=10)
    del sy_rec1, sy_rec2, sync
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
    # the chaos conductor over the port's node on the card
    mark(t_start, "chaos")
    ch_rec1, ch_k1, ch_k1_coop, ch_rec2, ch_k2, ch_k2_coop, ch_pad = \
        phase_chaos(dev, args.chaos_steps, card)
    ch_err, ch_ms, ch_plain, ch_shapes, ch_kernel = time_k1(
        dev, [r[0] for r in ch_rec1.records], "chaos", per_segment=False,
        outputs=[r[1] for r in ch_rec1.records])
    cx_err, cx_ms, cx_plain, cx_inputs, cx_kernel = check_and_time_k2(
        ch_rec2, "chaos probes", ch_pad, profile_reps=10)
    del ch_rec1, ch_rec2
    # the offline prune under a resident chain, and its reopen
    mark(t_start, "prune")
    pr_rec, pr_k1, pr_k1_coop = phase_prune(dev, args.prune_accounts,
                                            args.seed + 12, card)
    pr_err, pr_ms, pr_plain, pr_shapes, pr_kernel = time_k1(
        dev, [r[0] for r in pr_rec.records], "prune", per_segment=False,
        outputs=[r[1] for r in pr_rec.records])
    del pr_rec
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
                 + ds_shapes + sh_shapes + cm_shapes + ml_shapes + sy_shapes
                 + ch_shapes + pr_shapes)
    k1_bound, k1_by = k1_bound_ms(k1_shapes)
    rk_bound, rk_by = k1_bound_ms(rg_shapes + rb_shapes)
    log(f"K1 bound over the mirror's inputs {rk_bound:.4f} ms ({rk_by}; "
        f"genesis {k1_bound_ms(rg_shapes)[0]:.4f} ms, blocks "
        f"{k1_bound_ms(rb_shapes)[0]:.4f} ms); K1 events {rg_ms:.4f} / "
        f"{rb_ms:.4f} ms")
    k1_launches = (g_launches + cb_launches + b_launches + evm_planned.k1
                   + c_launches + v_launches + m_launches + d_launches
                   + cm_k1 + ml_k1 + sy_k1 + ch_k1 + pr_k1)
    k1_coop = (g_coop + cb_coop + b_coop + evm_planned.k1_coop + c_coop
               + v_coop + m_coop + d_coop + cm_k1_coop + ml_k1_coop
               + sy_k1_coop + ch_k1_coop + pr_k1_coop)
    k2_inputs = (bg_inputs + bb_inputs + e2_inputs + dk_inputs + ck_inputs
                 + mk_inputs + sk_inputs + cx_inputs)
    k2_bound, k2_by = k2_bound_ms(k2_inputs)
    k2_real, _ = k2_bound_ms(k2_inputs, bg_pad + bb_pad + e2_pad + d_pad
                             + cm_pad + ml_pad + sy_pad + ch_pad)
    log(f"K2 bound over the batched commits {k2_bound:.4f} ms ({k2_by}), "
        f"over their real lanes alone {k2_real:.4f} ms")
    log(f"launches on the main paths: K1 genesis {g_launches}, the chain's "
        f"mirror boot {cb_launches}, block {b_launches}, evm planned "
        f"{evm_planned.k1}, chain inserts {c_launches}, vm blocks "
        f"{v_launches}, mirrors {m_launches}, ladder drill {d_launches}, "
        f"commitment VM {cm_k1} (of them the shadow {len(sh_shapes)}), "
        f"mesh and legacy executors {ml_k1}, state sync {sy_k1} (its "
        f"gossip-fed block among them), chaos {ch_k1}, prune and reopen "
        f"{pr_k1}; K2 batched genesis "
        f"{bg_launches}, batched block {bb_launches}, evm batched "
        f"{evm_batched.k2}, ladder drill probes {d_k2}, the keccak "
        f"precompile {cm_k2}, mesh and legacy executors {ml_k2}, state "
        f"sync {sy_k2} (the cross-chain calls among them), chaos probes "
        f"{ch_k2}")
    log(f"rpc: the VM blocks' transactions entered by eth_sendRawTransaction"
        f" and avax.issueTx over HTTP, the wallet's by eth_sendTransaction, "
        f"avax.import and avax.export over WS, the blocks built, verified "
        f"and accepted by the engine child over the plugin socket (their K1"
        f" launches {v_launches}); the commitment VM's keccak256Batch "
        f"eth_call through BoundContract over HTTP and over WS, 1 K2 "
        f"launch each; "
        f"{rpc_stats.summary()}; {card}")
    log(f"peak RSS {rss_gib():.1f} GiB")
    left = descendants()
    check(not left, f"processes left at the end: {left}")
    shutil.rmtree(run_dir)
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
                           sh_err, cm_err, ml_err, sy_err, ch_err, pr_err),
        "ms": (g_ms + cb_ms + b_ms + e1_ms + cs_ms + cr_ms + vs_ms + vr_ms
               + rg_ms + rb_ms + ds_ms + sh_ms + cm_ms + ml_ms + sy_ms
               + ch_ms + pr_ms),
        "plain_ms": (g_plain + cb_plain + b_plain + e1_plain + cs_plain
                     + cr_plain + vs_plain + vr_plain + rg_plain + rb_plain
                     + ds_plain + sh_plain + cm_plain + ml_plain + sy_plain
                     + ch_plain + pr_plain),
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
        "variants": variants_json(k1_launches, k1_coop, g_kernel,
                                  cb_kernel, b_kernel, e1_kernel, cs_kernel,
                                  cr_kernel, vs_kernel, vr_kernel,
                                  rg_kernel, rb_kernel, ds_kernel,
                                  sh_kernel, cm_kernel, ml_kernel,
                                  sy_kernel, ch_kernel, pr_kernel),
    }, {
        "name": "keccak_blocks",
        "route": "cuda",
        "source": "coreth_tpu_torch/ops/csrc/keccak_blocks.cu",
        "replaces": "coreth_tpu/ops/keccak_pallas.py:126",
        "launches": bg_launches + bb_launches + evm_batched.k2 + d_k2
        + cm_k2 + ml_k2 + sy_k2 + ch_k2,
        "max_abs_err": max(grid2_err, bg_err, bb_err, e2_err, dk_err,
                           ck_err, mk_err, sk_err, cx_err),
        "ms": bg_ms + bb_ms + e2_ms + dk_ms + ck_ms + mk_ms + sk_ms + cx_ms,
        "plain_ms": (bg_plain + bb_plain + e2_plain + dk_plain + ck_plain
                     + mk_plain + sk_plain + cx_plain),
        "bound_ms": k2_bound,
        "bound_by": k2_by,
        "library_ms": None,
        "variants": variants_json(
            bg_launches + bb_launches + evm_batched.k2 + d_k2 + cm_k2
            + ml_k2 + sy_k2 + ch_k2,
            bg_coop + bb_coop + evm_batched.k2_coop + d_k2_coop + cm_k2_coop
            + ml_k2_coop + sy_k2_coop + ch_k2_coop,
            bg_kernel, bb_kernel, e2_kernel, dk_kernel, ck_kernel,
            mk_kernel, sk_kernel, cx_kernel),
    }]}), flush=True)
    if dev.type != "cuda":
        return 0  # a rehearsal prints no result line
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
