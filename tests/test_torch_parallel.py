"""The port's mesh parallelism (coreth_tpu_torch/parallel) against the
JAX package's, on the CPU.

The reference runs on its own virtual CPU mesh (tests/conftest.py forces
8 host devices): its ShardedKeccak and commit_step at width 8, its
sharded planned and resident programs at width 4 with its host Keccak-f
at their seg_impl seams (tests/torch_jax_planned.py; at width 8 a host
callback inside the resident program stalls XLA's CPU all-reduce
rendezvous). The port's meshes are virtual too, n positions on the CPU
(make_mesh(n, device="cpu")), where every shard runs K1's and K2's plain
versions. Digests, checksums, roots and digest matrices must be equal at
every width (tolerance zero); the sharded resident executor's per-shard
accounting must equal the reference's at the width both ran."""

import random

import numpy as np
import pytest
import torch

from coreth_tpu import parallel as jparallel
from coreth_tpu.native import mpt as jmpt
from coreth_tpu.ops import keccak_planned as jkeccak_planned
from coreth_tpu.ops.keccak_jax import pack_messages as j_pack_messages
from coreth_tpu.ops.keccak_ref import keccak256 as ref_keccak
from coreth_tpu.ops.keccak_resident import \
    ResidentExecutor as JResidentExecutor
from coreth_tpu.trie.encoding import key_to_hex as j_key_to_hex
from coreth_tpu.trie.planned import PlannedGraphBuilder as JBuilder
from coreth_tpu_torch.native import mpt
from coreth_tpu_torch.ops import keccak_cuda
from coreth_tpu_torch.ops.keccak_planned import plan_from_export
from coreth_tpu_torch.ops.keccak_torch import pack_messages
from coreth_tpu_torch.parallel import (LANE_BUCKET, Mesh, MeshConfigError,
                                       ShardedKeccak, commit_step,
                                       make_mesh, make_mesh_2d,
                                       mesh_spans_processes,
                                       planned_commit_over_mesh,
                                       process_count,
                                       resident_executor_over_mesh,
                                       shard_devices, sharded_seg_impl)

import torch_jax_planned as jhost
from test_torch_planned import _graph, _jax_trie

WIDTHS = (1, 2, 4, 8)
CPU = torch.device("cpu")


def _mesh(width):
    return make_mesh(width, device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    return jparallel.make_mesh(8)


MSGS = [bytes([i % 256]) * (1 + 11 * i) for i in range(50)]


@pytest.fixture(scope="module")
def ref_digests(jmesh):
    """The reference's ShardedKeccak on its 8-device mesh."""
    return jparallel.ShardedKeccak(jmesh).digests(MSGS)


@pytest.mark.parametrize("width", WIDTHS)
def test_sharded_keccak_matches_reference(width, ref_digests):
    sk = ShardedKeccak(_mesh(width))
    assert sk.n_devices == width and len(sk.devices) == width
    assert sk.digests(MSGS) == ref_digests == [ref_keccak(m) for m in MSGS]
    assert sk.digests([]) == []
    assert sk.digests([b""]) == [ref_keccak(b"")]
    # 13 lanes: the mesh divides the padded batch, not the real one
    odd = [b"x" * (140 * i + 1) for i in range(13)]
    assert sk.digests(odd) == [ref_keccak(m) for m in odd]


def test_sharded_keccak_runs_one_k2_call_per_shard():
    shapes = []

    def recording(words, nblocks):
        shapes.append((tuple(words.shape), words.device))
        return keccak_cuda.keccak256_blocks(words, nblocks)

    sk = ShardedKeccak(_mesh(4), impl=recording)
    sk.digests(MSGS)  # 50 lanes pad to 64: 16 a shard
    assert [s[0][0] for s in shapes] == [16] * 4
    assert all(d == CPU for _, d in shapes)


@pytest.fixture(scope="module")
def ref_step(jmesh):
    """The reference's commit_step on its 8-device mesh: digests and
    checksum of 32 lanes."""
    msgs = [bytes([i]) * (1 + 7 * i) for i in range(32)]
    words, nblocks = j_pack_messages(msgs)
    out, checksum = jparallel.commit_step(jmesh)(words, nblocks)
    return msgs, np.asarray(out), int(np.asarray(checksum))


@pytest.mark.parametrize("width", WIDTHS)
def test_commit_step_matches_reference(width, ref_step):
    msgs, want_out, want_sum = ref_step
    words, nblocks = pack_messages(msgs)
    out, checksum = commit_step(_mesh(width))(words, nblocks)
    np.testing.assert_array_equal(out.numpy().view(np.uint32), want_out)
    assert int(checksum) == want_sum == int(
        np.sum(want_out, dtype=np.uint32))
    # a batch the mesh does not divide: short last shards
    w13, nb13 = pack_messages(msgs[:13])
    out13, sum13 = commit_step(_mesh(width))(w13, nb13)
    np.testing.assert_array_equal(out13.numpy().view(np.uint32),
                                  want_out[:13])
    assert int(sum13) == int(np.sum(want_out[:13], dtype=np.uint32))


# ---- the mesh errors of tests/test_parallel.py:74-110, both packages -------


def test_width_past_visible_devices_names_the_fix(monkeypatch):
    n = 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    with pytest.raises(MeshConfigError) as ei:
        make_mesh(4)
    msg = str(ei.value)
    assert f"only {n} CUDA device(s) are visible" in msg
    assert "resident-mesh-devices" in msg and "device=" in msg
    with pytest.raises(jparallel.MeshConfigError, match="resident-mesh"):
        jparallel.make_mesh(16)


def test_width_must_divide_lane_bucket():
    for make in (jparallel.make_mesh, lambda n: _mesh(n)):
        with pytest.raises(ValueError) as ei:
            make(3)
        assert "does not divide the 16-lane planner bucket" in str(ei.value)
    with pytest.raises(MeshConfigError):
        _mesh(32)  # past the bucket: shards would be uneven too
    assert LANE_BUCKET == jparallel.LANE_BUCKET


@pytest.mark.parametrize("bad", [0, -1])
def test_width_must_be_positive(bad):
    with pytest.raises(MeshConfigError, match="positive device count"):
        _mesh(bad)
    with pytest.raises(jparallel.MeshConfigError,
                       match="positive device count"):
        jparallel.make_mesh(bad)


def test_2d_mesh_extents_must_be_positive():
    with pytest.raises(MeshConfigError, match="positive"):
        make_mesh_2d(0, 2, device="cpu")
    with pytest.raises(jparallel.MeshConfigError, match="positive"):
        jparallel.make_mesh_2d(0, 2)


def test_mesh_config_error_is_a_value_error():
    assert issubclass(MeshConfigError, ValueError)


def test_single_controller_mesh():
    """One process drives every position: process_count is 1 without a
    process group, and no mesh built here spans processes (the forced
    case is in test_torch_resident_mesh.py)."""
    assert process_count() == jparallel.process_count() == 1
    m = _mesh(4)
    assert not mesh_spans_processes(m)
    assert not jparallel.mesh_spans_processes(jparallel.make_mesh(4))
    explicit = Mesh(["cpu"] * 4, ("batch",))
    assert shard_devices(explicit) == [CPU] * 4 == shard_devices(m)
    with pytest.raises(MeshConfigError, match="axis"):
        shard_devices(m, "host")


# ---- the 2-D (host, chip) mesh ---------------------------------------------


def test_2d_mesh_shards_over_both_axes():
    m2 = make_mesh_2d(2, 4, device="cpu")
    assert m2.devices.shape == (2, 4) and m2.axis_names == ("host", "batch")
    assert len(shard_devices(m2, ("host", "batch"))) == 8
    assert len(shard_devices(m2, "batch")) == 4
    msgs = [bytes([i % 251]) * (1 + 7 * i) for i in range(64)]
    sk = ShardedKeccak(m2, axis=("host", "batch"))
    assert sk.digests(msgs) == [ref_keccak(m) for m in msgs]
    step = commit_step(m2, axis=("host", "batch"))
    words, nblocks = pack_messages(msgs[:32])
    out, checksum = step(words, nblocks)
    assert int(checksum) == int(np.sum(out.numpy().view(np.uint32),
                                       dtype=np.uint32))
    assert [bytes(r) for r in out.numpy().view(np.uint8).reshape(-1, 32)] \
        == [ref_keccak(m) for m in msgs[:32]]


# ---- planned_commit_over_mesh ------------------------------------------------


REF_WIDTH = 4  # the reference's sharded programs with a host callback


@pytest.fixture(scope="module")
def jmesh4():
    return jparallel.make_mesh(REF_WIDTH)


@pytest.fixture(scope="module")
def jax_mesh_plan(jmesh4):
    """One export of the reference's planned builder and the reference's
    planned commit over its mesh (sharded_seg_impl on its host
    Keccak-f)."""
    specs, flat, dst, child, shift, root_pos, _ = _graph(
        _jax_trie, j_key_to_hex, JBuilder).build()
    runner = jkeccak_planned.PlannedCommit(
        seg_impl=jparallel.sharded_seg_impl(jmesh4,
                                            seg_impl=jhost.seg_impl),
        fused=False)
    root, dig = runner.run(specs, flat, dst, child, shift, root_pos,
                           want_digests=True)
    export = ([tuple(s) for s in specs], np.asarray(flat), np.asarray(dst),
              np.asarray(child), np.asarray(shift), root_pos)
    return export, root, np.asarray(dig)


@pytest.mark.parametrize("width", WIDTHS)
def test_planned_commit_over_mesh_matches_reference(width, jax_mesh_plan):
    export, want_root, want_dig = jax_mesh_plan
    mesh = _mesh(width)
    runner = planned_commit_over_mesh(mesh)
    assert runner is planned_commit_over_mesh(mesh)  # one per mesh
    root, dig = runner.run(*plan_from_export(*export), want_digests=True)
    assert root == want_root
    np.testing.assert_array_equal(dig, want_dig)


def test_sharded_seg_impl_splits_lanes_per_shard():
    seen = []

    def recording(words):
        seen.append(words.shape[0])
        return keccak_cuda.segment_keccak(words)

    impl = sharded_seg_impl(_mesh(4), seg_impl=recording)
    words = torch.from_numpy(np.random.default_rng(0).integers(
        -2**31, 2**31, size=(32, 2, 34), dtype=np.int64).astype(np.int32))
    out = impl(words)
    assert seen == [8, 8, 8, 8]
    assert torch.equal(out, keccak_cuda.segment_keccak(words))


# ---- resident_executor_over_mesh over a churn sequence ---------------------


class _JaxRecording(JResidentExecutor):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.digs = []

    def run(self, export):
        root = super().run(export)
        self.digs.append(np.asarray(self.last_dig))
        return root


def _churn(seed=32, n=1200, rounds=2, churn=60):
    rng = random.Random(seed)
    state = {rng.randbytes(32): rng.randbytes(rng.randint(1, 90))
             for _ in range(n)}
    items = sorted(state.items())
    keys = [k for k, _ in items]
    batches = []
    for _ in range(rounds):
        b = []
        for _ in range(churn):
            r = rng.random()
            if r < 0.5:
                b.append((rng.choice(keys), rng.randbytes(60)))
            elif r < 0.85:
                k = rng.randbytes(32)
                keys.append(k)
                b.append((k, rng.randbytes(40)))
            else:
                b.append((rng.choice(keys), b""))
        batches.append(b)
    return items, batches


@pytest.fixture(scope="module")
def jax_resident(jmesh4):
    """The reference's resident executor sharded over its mesh (its host
    Keccak-f at seg_impl) over a churn sequence: each commit's root,
    digest matrix, lanes per shard and gather bytes (modeled, measured).
    A template commit runs the same plan, so the port's template commits
    answer to the same rows."""
    from jax.sharding import NamedSharding, PartitionSpec

    items, batches = _churn()
    ex = _JaxRecording(seg_impl=jhost.seg_impl, sharding=NamedSharding(
        jmesh4, PartitionSpec("batch", None)))
    t = jmpt.IncrementalTrie(items)
    rows = []
    for batch in [()] + batches:
        t.update(batch)
        root = ex.root_bytes(t.commit_resident(ex))
        rows.append((root, list(ex.last_shard_lanes),
                     ex.last_gather_bytes_modeled, ex.last_gather_bytes))
    return items, batches, rows, ex.digs


@pytest.mark.parametrize("mode", ["resident", "template"])
@pytest.mark.parametrize("width", WIDTHS)
def test_resident_executor_over_mesh_matches_reference(width, mode,
                                                       jax_resident):
    items, batches, want_rows, want_digs = jax_resident
    ex = resident_executor_over_mesh(_mesh(width))
    assert ex.shards == width and ex.device == CPU
    digs = []
    real_run = ex.run

    def recording(export):
        root = real_run(export)
        digs.append(ex.last_dig.numpy().view(np.uint32).copy())
        return root

    ex.run = recording
    t = mpt.IncrementalTrie(items)
    for batch, want, want_dig in zip([()] + batches, want_rows, want_digs):
        t.update(batch)
        if mode == "resident":
            root = ex.root_bytes(t.commit_resident(ex))
        else:
            root = t.commit_template(ex)
        assert root == want[0]
        np.testing.assert_array_equal(digs[-1], want_dig)
        assert ex.last_gather_bytes == want[3] == 0
        assert sum(ex.last_shard_lanes) == sum(want[1])
        if width == REF_WIDTH:
            assert ex.last_shard_lanes == want[1]
            assert ex.last_gather_bytes_modeled == want[2]
        elif width == 1:
            assert ex.last_gather_bytes_modeled == 0
    if width >= REF_WIDTH:
        # the store really spreads over several shards (at width 2 this
        # world's slots all fall in the first half of the store)
        assert sum(1 for _, _, p in ex.store_parts() if p.any()) > 1


# ---- on the card: the sharded K1/K2 launches ---------------------------------


@pytest.mark.cuda
def test_mesh_on_the_card_equals_the_cpu_mesh():
    """A width-4 mesh on [cuda:0] * 4 (and on the real devices when the
    machine has several): ShardedKeccak and commit_step launch K2 once a
    shard, the mesh-planned and resident commits K1 once a shard and
    segment; every digest and root equals the CPU mesh's."""
    from coreth_tpu_torch.device import hopper_available

    if not hopper_available():
        pytest.skip("needs a CUDA device with compute capability >= 9.0")
    cpu, card = _mesh(4), make_mesh(4, device="cuda:0")
    keccak_cuda.reset_counts()
    assert ShardedKeccak(card).digests(MSGS) == \
        ShardedKeccak(cpu).digests(MSGS)
    assert keccak_cuda.blocks_launches == 4
    words, nblocks = pack_messages(MSGS[:32])
    out, checksum = commit_step(card)(words, nblocks)
    want_out, want_sum = commit_step(cpu)(words, nblocks)
    assert torch.equal(out.cpu(), want_out) and int(checksum) == \
        int(want_sum)
    items, batches = _churn(n=600, rounds=2)
    tc, tg = mpt.IncrementalTrie(items), mpt.IncrementalTrie(items)
    exc = resident_executor_over_mesh(cpu)
    exg = resident_executor_over_mesh(card)
    before = keccak_cuda.launches
    for batch in [()] + batches:
        tc.update(batch)
        tg.update(batch)
        assert exg.root_bytes(tg.commit_resident(exg)) == \
            exc.root_bytes(tc.commit_resident(exc))
    assert keccak_cuda.launches > before
