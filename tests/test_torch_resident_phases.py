"""The resident commit's phase clocks (the resident/phase/* timers of
metrics.phase_timer and metrics.PhaseSeq), on the CPU executor
(device="cpu") with a small mirror: each phase moves where its work runs,
the phases tile a verify, every flight-record timer is fed, spans nest
under resident/commit (the pipelined dispatch's too), a profiler session
sees the watchdog worker's phases on the caller's thread, nothing builds a
profiler range when no session runs, and the watchdog's deadline holds
with a session on.

The sessions are torch.autograd.profiler's: the one torch.profiler builds
on, with the same per-thread recording, and no second-long start on the
CPU."""

import threading
import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from coreth_tpu_torch import metrics
from coreth_tpu_torch.core.blockchain import _FLIGHT_TIMERS
from coreth_tpu_torch.device import DeviceWedgedError
from coreth_tpu_torch.metrics import phase_timer, spans
from coreth_tpu_torch.native.mpt import _run_with_watchdog
from coreth_tpu_torch.trie.resident_mirror import ResidentAccountMirror

P = "resident/phase/"
# the phases of a depth-0 verify, in order; `commit` is their parent
TILES = ("update", "plan", "export", "handoff", "stage", "scatter", "patch",
         "hash", "store", "readback", "record")
WORKER = ("stage", "scatter", "patch", "hash", "store", "readback")


@pytest.fixture(autouse=True)
def _no_overrides(monkeypatch):
    monkeypatch.delenv("CORETH_TPU_RESIDENT_HOST", raising=False)
    monkeypatch.delenv("CORETH_TPU_RESIDENT_TIMEOUT", raising=False)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(20)
    items = [(rng.bytes(32), rng.bytes(70)) for _ in range(200)]
    mirror = ResidentAccountMirror(items, device="cpu", device_timeout=30.0)
    return rng, items, mirror


def _totals(names):
    reg = metrics.default_registry
    return {n: reg.timer(P + n).total() for n in names}


def _block(world, n=12):
    """The next block on the mirror's head: (parent, hash, batch)."""
    rng, items, mirror = world
    batch = [(items[j][0], rng.bytes(70))
             for j in rng.choice(len(items), n, replace=False)]
    return mirror.head, rng.bytes(32), batch


def test_verify_moves_each_phase_and_they_tile_it(world):
    mirror = world[2]
    names = TILES + ("commit",)
    parent, h, batch = _block(world)
    before = _totals(names)
    t0 = time.monotonic()
    mirror.verify(parent, h, batch)
    wall = time.monotonic() - t0
    moved = {n: _totals(names)[n] - before[n] for n in names}
    assert all(v > 0 for v in moved.values()), moved
    tiled = sum(moved[n] for n in TILES)
    assert abs(tiled - wall) <= 0.2 * wall, (tiled, wall, moved)
    assert moved["commit"] <= wall


def test_every_flight_timer_moves(world):
    """Each name the flight recorder reads moves in a resident commit (the
    watchdog on) or a host commit."""
    before = _totals(n.rsplit("/", 1)[1] for n in _FLIGHT_TIMERS)
    world[2].verify(*_block(world))
    rng, items = world[0], world[1][:50]
    host = ResidentAccountMirror(items, prefer_host=True)
    host.verify(host.GENESIS, b"\x07" * 32,
                [(items[0][0], rng.bytes(70))])
    after = _totals(n.rsplit("/", 1)[1] for n in _FLIGHT_TIMERS)
    assert [n for n in after if after[n] <= before[n]] == []


def _ancestors(span_, by_id):
    while span_.parent_id is not None and span_.parent_id in by_id:
        span_ = by_id[span_.parent_id]
        yield span_.name


def test_spans_nest_under_commit_and_pipelined_dispatch_opens_them(world):
    rng, items = world[0], world[1][:60]
    piped = ResidentAccountMirror(items, device="cpu", device_timeout=30.0,
                                  pipeline_depth=1)
    host = ResidentAccountMirror(items, prefer_host=True)
    batch = [(items[1][0], rng.bytes(70))]
    want = host.verify(host.GENESIS, b"\x08" * 32, batch)
    spans.tracer.clear()
    spans.set_enabled(True)
    try:
        world[2].verify(*_block(world))
        got = {s.span_id: s for s in spans.tracer.snapshot(clear=True)}
        assert piped.verify(piped.GENESIS, b"\x08" * 32, batch,
                            expected_root=want) == want
        piped_spans = spans.tracer.snapshot(clear=True)
        piped.accept(b"\x08" * 32)  # the drain compares the device root
    finally:
        spans.set_enabled(False)
        spans.tracer.clear()
    commit = [s for s in got.values() if s.name == "resident/commit"]
    assert len(commit) == 1
    for s in got.values():
        if s.name.startswith(P) and s.name not in (P + "update",
                                                   P + "record"):
            assert "resident/commit" in set(_ancestors(s, got)), s.name
    names = {s.name for s in got.values()}
    assert {P + n for n in TILES} <= names
    by_id = {s.span_id: s for s in piped_spans}
    dispatch = [s for s in piped_spans if s.name == "resident/commit"]
    assert len(dispatch) == 1 and dispatch[0].attrs["pipelined"]
    under = {s.name for s in piped_spans
             if "resident/commit" in set(_ancestors(s, by_id))}
    assert {P + n for n in ("plan", "export", "handoff", "stage", "scatter",
                            "hash", "store")} <= under


def test_profiler_sees_the_worker_phases_on_the_callers_thread(world):
    with autograd_profiler.profile() as prof:
        with autograd_profiler.record_function("caller"):
            world[2].verify(*_block(world))
    events = prof.function_events
    caller = {e.thread for e in events if e.name == "caller"}
    assert len(caller) == 1
    for n in TILES:
        threads = {e.thread for e in events if e.name == P + n}
        assert threads == caller, (n, threads, caller)


def test_no_range_is_built_without_a_profiler(world, monkeypatch):
    built = []
    real = autograd_profiler.record_function

    class Counting(real):
        def __init__(self, *a, **kw):
            built.append(a[0] if a else kw.get("name"))
            super().__init__(*a, **kw)

    monkeypatch.setattr(autograd_profiler, "record_function", Counting)
    world[2].verify(*_block(world))
    assert built == []
    with autograd_profiler.profile():
        world[2].verify(*_block(world))
    assert set(P + n for n in WORKER) <= set(built)


def test_deadline_holds_with_a_profiler_on():
    """A worker that stalls inside a phase: the caller still raises at
    start + timeout, and closes the ranges it opened for the worker."""
    release = threading.Event()

    def stall():
        with phase_timer(P + "stage"):
            release.wait(10)

    try:
        with autograd_profiler.profile() as prof:
            t0 = time.monotonic()
            with pytest.raises(DeviceWedgedError, match="within 0.3s"):
                _run_with_watchdog(stall, 0.3, "stalled commit",
                                   handoff=P + "handoff")
            waited = time.monotonic() - t0
    finally:
        release.set()
    assert 0.3 <= waited < 2.0
    assert any(e.name == P + "stage" for e in prof.function_events)
    assert torch.ones(1).item() == 1.0  # the session closed cleanly


def test_timer_loses_no_update_under_threads():
    """Timer.update appends without a lock and reads fold: 16 threads
    updating one timer while another reads it lose no count and no
    second."""
    import sys

    timer = metrics.Timer()
    stop = threading.Event()
    seen = []

    def update():
        for _ in range(2000):
            timer.update(1.0)

    def read():
        while not stop.is_set():
            seen.append(timer.total())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reader = threading.Thread(target=read)
        reader.start()
        workers = [threading.Thread(target=update) for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30)
        stop.set()
        reader.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not reader.is_alive() and not any(w.is_alive() for w in workers)
    assert timer.count() == 32000 and timer.total() == 32000.0
    assert seen == sorted(seen)
