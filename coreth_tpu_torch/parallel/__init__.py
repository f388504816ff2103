"""Device-mesh parallelism for the state-commitment path: the counterpart
of coreth_tpu/parallel/__init__.py.

The reference's mesh is a single-controller jax.sharding.Mesh: one
process drives every device, and Keccak lanes are pure data parallelism,
so a batch is split into contiguous lane blocks, one per mesh position,
and the only collectives are the digest gather and a checksum sum.

The port keeps that shape in torch. A `Mesh` is an array of
torch.devices with axis names (("batch",), or ("host", "batch") for the
2-D layout). One process drives it: each shard's kernel (K2 for
ShardedKeccak and commit_step, K1 for sharded_seg_impl) is launched on
the current stream of its own device, digests come back by device copies
(`.to()`, which orders the two devices' current streams), and the
checksum is summed on the first device modulo 2**32.

make_mesh(n) takes the first n CUDA devices. A mesh may also repeat one
device, make_mesh(n, device=d) or Mesh([d] * n): the counterpart of the
reference's virtual CPU mesh (tests/conftest.py forces 8 host devices),
which is how the CPU tests run widths 2, 4 and 8 on [cpu] * n and a
single card runs width 4 on [cuda:0] * 4.

No torch.distributed: process_count() is the world size when a process
group is initialised, else 1, and every position of a Mesh belongs to the
process that built it, so mesh_spans_processes is False for every mesh
built here.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve
from ..ops.keccak_torch import MASK32, digest_words_to_bytes, \
    pack_messages, words_to_int32

Axis = Union[str, Tuple[str, ...]]


class MeshConfigError(ValueError):
    """A mesh request that can never produce a working sharded commit,
    raised at mesh construction with a message that says what to change
    (the resident-mesh-devices knob's fail-fast)."""


# the planner buckets every segment's lane count to a multiple of this
# (ops/keccak_resident._pow2_bucket floor; mpt_inc.cpp round_lanes), so a
# mesh width must divide it for lanes to split evenly across shards
LANE_BUCKET = 16


class Mesh:
    """Devices in an array with named axes; a device may repeat. Every
    position belongs to this process (process_indices)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        # a list for one axis, a nested list or object array for more
        arr = np.frompyfunc(torch.device, 1, 1)(np.array(devices,
                                                         dtype=object))
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise MeshConfigError(
                f"mesh of shape {arr.shape} needs {arr.ndim} axis names, "
                f"got {self.axis_names}")
        self.devices = arr
        rank = (torch.distributed.get_rank()
                if process_count() > 1 else 0)
        self.process_indices = np.full(arr.shape, rank)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices.flat]}, "
                f"shape={self.devices.shape}, axes={self.axis_names})")


def shard_devices(mesh: Mesh, axis: Axis = "batch") -> List[torch.device]:
    """The device of each lane shard, in lane order, for a split over the
    named axis or axes (a tuple shards over several, the first named
    outermost). Positions along the other axes would hold replicas; the
    single controller computes a shard once, on the first of them."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    for a in names:
        if a not in mesh.axis_names:
            raise MeshConfigError(
                f"axis {a!r} is not an axis of the mesh {mesh.axis_names}")
    order = [mesh.axis_names.index(a) for a in names]
    order += [i for i in range(mesh.devices.ndim) if i not in order]
    arr = np.transpose(mesh.devices, order)
    n = int(np.prod(arr.shape[:len(names)]))
    return list(arr.reshape(n, -1)[:, 0])


def _check_width(n: int, what: str, visible: Optional[int]) -> None:
    """visible: the CUDA devices a mesh of distinct devices may take, or
    None for a mesh that repeats one device."""
    if n <= 0:
        raise MeshConfigError(
            f"{what} must be a positive device count (got {n})")
    if visible is not None and n > visible:
        raise MeshConfigError(
            f"{what} requests {n} devices but only {visible} CUDA "
            f"device(s) are visible; lower the width (e.g. the "
            f"resident-mesh-devices knob) or, for a virtual mesh that "
            f"repeats one device, pass device= that device "
            f"(device='cpu' on the CPU)")
    if LANE_BUCKET % n != 0:
        raise MeshConfigError(
            f"{what} of {n} does not divide the {LANE_BUCKET}-lane "
            f"planner bucket: segment lane counts are multiples of "
            f"{LANE_BUCKET}, so shards would be uneven; use a "
            f"power-of-two width <= {LANE_BUCKET}")


def _pool(n: int, what: str, device: DeviceLike) -> List[torch.device]:
    """n mesh positions: the first n CUDA devices (device None), or n
    times the one device named."""
    if device is not None:
        _check_width(n, what, None)
        return [resolve(device)] * n
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    _check_width(n, what, visible)
    return [resolve(f"cuda:{i}") for i in range(n)]


def process_count() -> int:
    """Processes of the torch.distributed group when one is initialised,
    else 1 (a single controller)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def mesh_spans_processes(mesh: Mesh) -> bool:
    """True when the mesh's positions belong to more than one process.
    A mesh that spans processes would run one program per process, so a
    unilateral local action on the resident state (the mirror's
    single-device rung) would desync the others: callers take the
    host rung instead. False for every mesh built here."""
    return len(set(mesh.process_indices.flat)) > 1


def make_mesh(n_devices: Optional[int] = None, axis: str = "batch",
              device: DeviceLike = None) -> Mesh:
    """1-D mesh of n positions: the first n CUDA devices (all of them when
    n is None), or, with `device`, n times that one device.

    Raises MeshConfigError when n is not positive, is past the visible
    CUDA devices, or does not divide the planner's lane bucket."""
    if n_devices is None:
        if device is not None:
            n_devices = 1
        else:
            n_devices = (torch.cuda.device_count()
                         if torch.cuda.is_available() else 0)
    return Mesh(_pool(int(n_devices), "mesh width", device), (axis,))


def make_mesh_2d(n_hosts: int, chips_per_host: int,
                 axes=("host", "batch"), device: DeviceLike = None) -> Mesh:
    """2-D (host, chip) mesh, the multi-host deployment shape: the outer
    axis is the host boundary. Lanes shard over both axes
    (axis=("host", "batch")), host-major, so each host owns a contiguous
    block. Devices fill the array row by row (the reference's fallback
    for virtual meshes)."""
    if n_hosts <= 0 or chips_per_host <= 0:
        raise MeshConfigError(
            f"2-D mesh extents must be positive (got {n_hosts} hosts x "
            f"{chips_per_host} chips/host)")
    want = n_hosts * chips_per_host
    devs = _pool(want, f"2-D mesh ({n_hosts} hosts x {chips_per_host} "
                       f"chips/host)", device)
    return Mesh([devs[h * chips_per_host:(h + 1) * chips_per_host]
                 for h in range(n_hosts)], axes)


def _bounds(b: int, n: int) -> List[Tuple[int, int]]:
    """Contiguous lane blocks, one per shard (the last ones may be short
    or empty when n does not divide b)."""
    per = -(-b // n) if b else 0
    return [(min(k * per, b), min((k + 1) * per, b)) for k in range(n)]


def _launch_shards(devices, impl, words: np.ndarray,
                   nblocks: np.ndarray) -> List[torch.Tensor]:
    """One upload and one K2 launch per shard, each on its own device's
    current stream; returns each shard's int32[b_k, 8] on its device."""
    w32 = words_to_int32(words)
    nb = np.ascontiguousarray(nblocks, dtype=np.int32)
    outs = []
    for (lo, hi), dev in zip(_bounds(w32.shape[0], len(devices)), devices):
        if hi > lo:
            outs.append(impl(torch.from_numpy(w32[lo:hi]).to(dev),
                             torch.from_numpy(nb[lo:hi]).to(dev)))
    return outs


def _k2():
    from ..ops.keccak_cuda import keccak256_blocks

    return keccak256_blocks


def _k1():
    from ..ops.keccak_cuda import segment_keccak

    return segment_keccak


class ShardedKeccak:
    """Batched keccak sharded across a mesh (data-parallel lanes): the
    host API of ops/keccak_torch.BatchedKeccak (list[bytes] ->
    list[digest]). The batch is padded to a power-of-two multiple of
    (mesh size x 8) lanes (pad lanes carry one block), split into
    contiguous blocks, and each block hashed by K2 (`impl`) on its own
    device; the digests come back to the host."""

    def __init__(self, mesh: Mesh, axis: Axis = "batch", impl=None):
        self.mesh = mesh
        self.axis = axis
        self.devices = shard_devices(mesh, axis)
        self.impl = impl if impl is not None else _k2()

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def digests(self, msgs: Sequence[bytes]) -> List[bytes]:
        n = len(msgs)
        if n == 0:
            return []
        words, nblocks = pack_messages(msgs)
        # power-of-two bucket (a multiple of devices x 8) so the set of
        # shapes stays logarithmic in batch size
        mult = self.n_devices * 8
        target = mult
        while target < n:
            target *= 2
        pad = target - n
        if pad:
            words = np.concatenate(
                [words, np.zeros((pad,) + words.shape[1:], words.dtype)])
            nblocks = np.concatenate([nblocks, np.ones(pad, nblocks.dtype)])
        outs = _launch_shards(self.devices, self.impl, words, nblocks)
        out = np.concatenate([o.cpu().numpy() for o in outs]).view(np.uint32)
        return digest_words_to_bytes(out[:n])


def commit_step(mesh: Mesh, axis: Axis = "batch", impl=None):
    """The sharded state-commitment step of the multi-device dry run:
    hash every lane (K2 per shard), then reduce a 32-bit checksum of the
    digests across the shards. run(words uint32[B, L, 34], nblocks
    int32[B]) -> (digests int32[B, 8] gathered on the first device,
    checksum int64 in [0, 2**32) on the first device)."""
    devices = shard_devices(mesh, axis)
    impl = impl if impl is not None else _k2()
    home = devices[0]

    def run(words: np.ndarray, nblocks: np.ndarray):
        outs = _launch_shards(devices, impl, words, nblocks)
        if not outs:
            return (torch.zeros((0, 8), dtype=torch.int32, device=home),
                    torch.zeros((), dtype=torch.int64, device=home))
        # each shard sums its own digests; the partial sums meet on the
        # first device
        partial = [(o.long() & MASK32).sum().to(home) for o in outs]
        checksum = torch.stack(partial).sum() & MASK32
        return torch.cat([o.to(home) for o in outs]), checksum

    return run


def sharded_seg_impl(mesh: Mesh, axis: Axis = "batch", seg_impl=None):
    """Per-segment keccak for ops/keccak_planned.PlannedCommit with the
    lane dimension sharded across the mesh: int32[P, L, 34] on the
    commit's device -> int32[P, 8] there. Each contiguous lane block is
    copied to its shard's device, hashed there by `seg_impl` (default K1,
    ops/keccak_cuda.segment_keccak), and gathered back. The executor's
    patch gathers and scatters stay on its device; only the Keccak
    shards. Lanes are a multiple of 16, so every width up to 16
    divides them."""
    devices = shard_devices(mesh, axis)
    impl = seg_impl if seg_impl is not None else _k1()

    def run(words: torch.Tensor) -> torch.Tensor:
        home = words.device
        outs = [impl(words[lo:hi].to(dev)).to(home)
                for (lo, hi), dev in zip(_bounds(words.shape[0],
                                                 len(devices)), devices)
                if hi > lo]
        if not outs:
            return words.new_empty((0, 8))
        return torch.cat(outs)

    return run


_planned_by_mesh: dict = {}


def _mesh_key(mesh: Mesh, axis: Axis):
    return (tuple(str(d) for d in mesh.devices.flat), mesh.devices.shape,
            axis)


def planned_commit_over_mesh(mesh: Mesh, axis: Axis = "batch"):
    """A PlannedCommit on the mesh's first shard device whose hashing
    shards across the mesh; one per (mesh, axis)."""
    key = _mesh_key(mesh, axis)
    runner = _planned_by_mesh.get(key)
    if runner is None:
        from ..ops.keccak_planned import PlannedCommit

        runner = PlannedCommit(seg_impl=sharded_seg_impl(mesh, axis),
                               device=shard_devices(mesh, axis)[0])
        _planned_by_mesh[key] = runner
    return runner


class RowSharding(NamedTuple):
    """The resident state split by rows over a mesh axis (or axes): one
    contiguous row block of the digest store and of each arena per
    shard device, in shard_devices order."""

    mesh: Mesh
    axis: Axis = "batch"

    @property
    def devices(self) -> List[torch.device]:
        return shard_devices(self.mesh, self.axis)


def resident_executor_over_mesh(mesh: Mesh, axis: Axis = "batch",
                                seg_impl=None):
    """A ResidentExecutor whose device-resident state (digest store and
    row arenas) is split across the mesh by rows: each shard device holds
    1/N of every arena class and of the store, so resident memory and
    fresh-row uploads scale with the mesh. The per-commit digest matrix
    stays on the first shard device (every later segment's patches may
    read any earlier lane). On a 2-D mesh, axis=("host", "batch") gives
    each host a contiguous row block."""
    from ..ops.keccak_resident import ResidentExecutor

    return ResidentExecutor(seg_impl=seg_impl,
                            sharding=RowSharding(mesh, axis))
