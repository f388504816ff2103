"""The port's degradation ladder (coreth_tpu_torch/ops/device.py) against
the JAX package's (coreth_tpu/ops/device.py), on the CPU.

Every case of tests/test_device_ladder.py runs on both ladders with the
same script (dispatch, the watchdog, the host rung, the planned marker
flipping, probes, resolution). Where the packages agree the outcomes
(state, event kinds, results) must be equal; where the port's device rule
departs (ROADMAP Queue 3: only a caller demotes, and an error of a
dispatched call, a hang past the watchdog's deadline included, reaches
the caller with no retry and no demotion, where the reference retries,
demotes and finishes on the host) each case states both outcomes. The
port's device function is the plain version of K2 (BatchedKeccak on the
CPU), the reference's the native batch keccak its own tests use. Then: a
twin case driving both ladders through one demotion and probe failpoint
script, comparing their state, event and counter sequences; the chain
drill of test_chaos_drill_hang_demote_bitexact_repromote on both
packages' chains over the same blocks (the port's hang reaches
insert_block, its caller demotes; equal roots, equal device/* flight
events); commits while a caller has the ladder demoted (the planned
account trie, the resident chain's storage program) whose roots equal
the reference's; a kernel launch error that reaches insert_block with the
head unchanged; and the port's rules that every error, a BuildError too,
passes through dispatch, that a call the watchdog abandoned is waited for
before the next starts, and that resolution never degrades quietly.

Both ladders and both failpoint registries are process-global: every case
resets both (the port's reset restores its knobs' defaults).
"""

import threading
import time

import numpy as np
import pytest

from coreth_tpu import fault as jfault
from coreth_tpu import params as jparams
from coreth_tpu.consensus.dummy import new_dummy_engine as j_new_dummy_engine
from coreth_tpu.core.blockchain import BlockChain as JBlockChain
from coreth_tpu.core.blockchain import CacheConfig as JCacheConfig
from coreth_tpu.core.chain_makers import generate_chain as j_generate_chain
from coreth_tpu.core.genesis import Genesis as JGenesis
from coreth_tpu.core.genesis import GenesisAccount as JGenesisAccount
from coreth_tpu.core.types import Signer as JSigner
from coreth_tpu.core.types import Transaction as JTransaction
from coreth_tpu.crypto.secp256k1 import priv_to_address
from coreth_tpu.ethdb import MemoryDB as JMemoryDB
from coreth_tpu.metrics import default_registry as jregistry
from coreth_tpu.native import keccak256_batch as j_keccak256_batch
from coreth_tpu.ops import device as jdevice
from coreth_tpu.state import statedb as jstatedb
from coreth_tpu.state.database import Database as JDatabase
from coreth_tpu.trie.triedb import TrieDatabase as JTrieDatabase
from coreth_tpu_torch import fault, params
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
from coreth_tpu_torch.core.types import Block
from coreth_tpu_torch.device import DeviceWedgedError, KernelLaunchError
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.metrics import default_registry
from coreth_tpu_torch.native import keccak256_batch
from coreth_tpu_torch.native._build import BuildError
from coreth_tpu_torch.ops import device as pdevice
from coreth_tpu_torch.ops.keccak_planned import PlannedCommit, PlannedMode
from coreth_tpu_torch.ops.keccak_torch import default_batched_keccak
from coreth_tpu_torch.state.database import Database
from coreth_tpu_torch.state.statedb import StateDB
from coreth_tpu_torch.trie import planned
from coreth_tpu_torch.trie.triedb import TrieDatabase

PKG = {"jax": (jdevice, jfault, jregistry), "port": (pdevice, fault,
                                                     default_registry)}
COUNTERS = ("dispatch_errors", "demotions", "promotions", "probe_errors",
            "resolve_fail")


def plain_device_fn(msgs):
    """K2's plain version: the port's device function on the CPU."""
    return default_batched_keccak("cpu").digests(msgs)


def jax_device_fn(msgs):
    """The reference's stand-in device function (its own tests')."""
    return j_keccak256_batch([bytes(m) for m in msgs])


DEVICE_FN = {"jax": jax_device_fn, "port": plain_device_fn}


@pytest.fixture(autouse=True)
def _both_ladders(monkeypatch):
    """Reset both process ladders and failpoint registries around each
    case and give each package's probe its device function."""
    monkeypatch.setitem(jdevice._cached, "fn", jax_device_fn)
    monkeypatch.setitem(pdevice._cached, "fn", plain_device_fn)
    yield
    for dev, flt, _reg in PKG.values():
        flt.clear_all()
        dev.default_ladder().reset()


def counts(pkg):
    reg = PKG[pkg][2]
    return {c: reg.counter(f"ops/device/{c}").count() for c in COUNTERS}


def delta(after, before):
    return {k: after[k] - before[k] for k in after}


def collect(events):
    def listener(kind, fields):
        events.append((kind, fields))
    return listener


def wait_healthy(lad, seconds=15.0):
    deadline = time.monotonic() + seconds
    while not lad.healthy and time.monotonic() < deadline:
        time.sleep(0.01)
    return lad.healthy


def both(case):
    """Run case(pkg) on both packages; return {pkg: result}."""
    return {pkg: case(pkg) for pkg in PKG}


# ------------------------------------------------------------- dispatch


def test_passthrough():
    def case(pkg):
        lad = PKG[pkg][0].DeviceLadder()
        return lad.dispatch(lambda a, b: a + b, "add", 40, 2), lad.healthy
    got = both(case)
    assert got["port"] == got["jax"] == (42, True)


def test_transient_error_retried():
    """The reference retries a failed call and answers; the port's
    dispatch hands the first error to the caller: no retry, no event, the
    ladder healthy, the error counted."""
    def case(pkg):
        lad = PKG[pkg][0].DeviceLadder()
        if pkg == "jax":
            lad.configure(max_retries=2)
            lad.retry_base = 0.001
        events = []
        lad.add_listener(collect(events))
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("transient")
            return "ok"
        before = counts(pkg)
        try:
            out = lad.dispatch(flaky, "flaky op")
        except RuntimeError as e:
            out = repr(e)
        return (out, lad.healthy, [(k, f["what"]) for k, f in events],
                calls["n"], delta(counts(pkg), before)["dispatch_errors"])
    got = both(case)
    assert got["jax"] == ("ok", True, [("retry", "flaky op")], 2, 1)
    assert got["port"] == ("RuntimeError('transient')", True, [], 1, 1)


def test_exhaustion_demotes():
    """The reference demotes once its retries are spent; the port has no
    retries to spend and never demotes on an error: the caller gets the
    error itself and the ladder stays healthy."""
    def case(pkg):
        dev = PKG[pkg][0]
        lad = dev.DeviceLadder()
        lad.configure(probe_interval=0)
        if pkg == "jax":
            lad.configure(max_retries=1)
            lad.retry_base = 0.001
        events = []
        lad.add_listener(collect(events))

        def broken():
            raise RuntimeError("device on fire")
        with pytest.raises(RuntimeError, match="device on fire") as ei:
            lad.dispatch(broken, "broken op")
        return (type(ei.value).__name__, lad.state, lad.last_error,
                [k for k, _ in events])
    got = both(case)
    assert got["jax"][0] == "DeviceDegradedError"
    assert got["jax"][1:3] == ("demoted", "broken op: RuntimeError('device "
                               "on fire')")
    assert got["jax"][3] == ["retry", "demote"]
    assert got["port"] == ("RuntimeError", "healthy", None, [])


def test_demote_is_idempotent():
    def case(pkg):
        lad = PKG[pkg][0].DeviceLadder()
        lad.configure(probe_interval=0)
        events = []
        lad.add_listener(collect(events))
        lad.demote("first")
        lad.demote("second")
        return [k for k, _ in events], lad.last_error
    got = both(case)
    assert got["port"] == got["jax"] == (["demote"], "second")


def test_watchdog_deadline_demotes_a_hung_call():
    """A call that blocks past the deadline: the reference demotes and
    answers DeviceDegradedError; the port raises DeviceWedgedError to the
    caller and stays healthy. While the abandoned call still runs, the
    port's next dispatch waits out its deadline and raises without
    starting; once it ended, the next call runs."""
    def case(pkg):
        dev = PKG[pkg][0]
        lad = dev.DeviceLadder()
        lad.configure(call_timeout=0.3, probe_interval=0)
        if pkg == "jax":
            lad.configure(max_retries=0)
        parked = threading.Event()
        t0 = time.monotonic()
        with pytest.raises(RuntimeError) as ei:
            lad.dispatch(lambda: parked.wait(10), "wedged op")
        took = time.monotonic() - t0
        out = [type(ei.value).__name__, lad.state, took < 5]
        if pkg == "port":
            ran = []
            with pytest.raises(DeviceWedgedError, match="still running"):
                lad.dispatch(lambda: ran.append(1), "next op")
            parked.set()
            out += [ran, lad.dispatch(lambda: "pong", "next op")]
        parked.set()
        return out
    got = both(case)
    assert got["jax"] == ["DeviceDegradedError", "demoted", True]
    assert got["port"] == ["DeviceWedgedError", "healthy", True, [], "pong"]


def test_failpoint_hang_trips_the_watchdog():
    """The dispatch failpoint runs on the watchdog worker thread, so
    `hang` exercises the deadline exactly like a wedged device: the
    reference demotes, the port raises DeviceWedgedError to the caller;
    in the port the abandoned call never runs once the hang is released,
    and the next dispatch runs."""
    ran = []

    def case(pkg):
        dev, flt, _ = PKG[pkg]
        lad = dev.DeviceLadder()
        lad.configure(call_timeout=0.3, probe_interval=0)
        if pkg == "jax":
            lad.configure(max_retries=0)
        flt.set_failpoint("ops/device/dispatch", "hang")
        with pytest.raises(RuntimeError) as ei:
            lad.dispatch(lambda: ran.append(pkg), "hung by failpoint")
        state = lad.state
        flt.clear_all()  # release the parked worker
        if pkg == "port":
            assert lad.dispatch(lambda: "pong", "next op") == "pong"
        return type(ei.value).__name__, state
    got = both(case)
    assert got["jax"] == ("DeviceDegradedError", "demoted")
    assert got["port"] == ("DeviceWedgedError", "healthy")
    time.sleep(0.1)
    assert "port" not in ran


@pytest.mark.parametrize("fault_kind", ["wedged", "launch", "oom", "bug",
                                        "failpoint"])
@pytest.mark.parametrize("watchdog", [False, True])
def test_every_error_reaches_the_caller(fault_kind, watchdog):
    """The port's rule (ROADMAP Queue 3): a device fault
    (device.DEVICE_FAULTS), a bug in the call and an armed dispatch
    failpoint all reach the caller as they are, inline or under the
    watchdog: one call, no retry, no demotion, no event, one dispatch
    error counted."""
    import torch

    errors = {"wedged": DeviceWedgedError("no answer"),
              "launch": KernelLaunchError("K1 launch failed"),
              "oom": torch.OutOfMemoryError("out of memory"),
              "bug": TypeError("bad argument")}
    lad = pdevice.DeviceLadder()
    lad.configure(call_timeout=2.0 if watchdog else 0, probe_interval=0)
    events = []
    lad.add_listener(collect(events))
    calls = []

    def call():
        calls.append(1)
        raise errors[fault_kind]
    if fault_kind == "failpoint":
        fault.set_failpoint("ops/device/dispatch", "raise:injected")
    before = counts("port")
    with pytest.raises(Exception) as ei:
        lad.dispatch(call, "planned device commit")
    if fault_kind == "failpoint":
        assert isinstance(ei.value, fault.FailpointError) and calls == []
    else:
        assert ei.value is errors[fault_kind] and calls == [1]
    assert lad.healthy and events == []
    assert delta(counts("port"), before) == {
        "dispatch_errors": 1, "demotions": 0, "promotions": 0,
        "probe_errors": 0, "resolve_fail": 0}


def test_demoted_dispatch_is_refused():
    """While a caller has the port's ladder demoted, dispatch refuses the
    call with DeviceDegradedError (the callers' cue for their host path)
    and never starts it."""
    lad = pdevice.DeviceLadder()
    lad.configure(probe_interval=0)
    lad.demote("the caller took the host")
    ran = []
    with pytest.raises(pdevice.DeviceDegradedError, match="took the host"):
        lad.dispatch(lambda: ran.append(1), "planned device commit")
    assert ran == []
    lad.promote()
    assert lad.dispatch(lambda: "pong", "planned device commit") == "pong"


def test_reset_restores_the_knobs():
    lad = pdevice.DeviceLadder()
    lad.configure(call_timeout=1.0, probe_interval=0.05, promote_after=2)
    lad.reset()
    st = lad.status()
    assert {k: st[k] for k in pdevice.DeviceLadder.DEFAULTS} == \
        pdevice.DeviceLadder.DEFAULTS


# --------------------------------------------------------- host fallback

MSGS = [b"a", b"bb" * 40, b"", b"\x00" * 137]


def test_demoted_seam_is_bit_exact():
    jlad = jdevice.DeviceLadder()
    jlk = jdevice.LadderedKeccak(jax_device_fn, ladder=jlad)
    plad = pdevice.DeviceLadder()
    plk = pdevice.LadderedKeccak(default_batched_keccak("cpu"), ladder=plad)
    healthy = plk(MSGS)
    assert healthy == jlk(MSGS) == keccak256_batch(MSGS)
    for lad in (jlad, plad):
        lad.configure(probe_interval=0)
        lad.demote("test")
    assert plk(MSGS) == jlk(MSGS) == healthy


def test_mid_call_demotion_falls_back():
    """A device error inside the call itself: the reference's dispatch
    demotes and its seam answers from the host batch keccak, the caller
    never sees the error; the port's seam hands the error to its caller
    and the ladder stays healthy (a K2 failure is never a host digest)."""
    def broken(msgs):
        raise KernelLaunchError("device wedged")

    class Broken:
        digests = staticmethod(broken)

    jlad = jdevice.DeviceLadder()
    plad = pdevice.DeviceLadder()
    for lad in (jlad, plad):
        lad.configure(probe_interval=0)
    jlad.configure(max_retries=0)
    jout = jdevice.LadderedKeccak(broken, ladder=jlad)(MSGS)
    assert jout == keccak256_batch(MSGS) and jlad.state == "demoted"
    with pytest.raises(KernelLaunchError, match="device wedged"):
        pdevice.LadderedKeccak(Broken(), ladder=plad)(MSGS)
    assert plad.state == "healthy"


def test_planned_marker_flips_with_ladder():
    jlad = jdevice.DeviceLadder()
    plad = pdevice.DeviceLadder()
    jpm = jdevice.PlannedModeKeccak(jax_device_fn, ladder=jlad)
    ppm = PlannedMode(PlannedCommit(device="cpu"), ladder=plad)
    seen = []
    for lad in (jlad, plad):
        lad.configure(probe_interval=0)
    seen.append((jpm.planned, ppm.planned))
    jlad.demote("test")
    plad.demote("test")
    seen.append((jpm.planned, ppm.planned))
    jlad.promote()
    plad.promote()
    seen.append((jpm.planned, ppm.planned))
    assert seen == [(True, True), (False, False), (True, True)]
    # still a plain callable either way
    assert ppm(MSGS) == jpm(MSGS) == keccak256_batch(MSGS)


# ---------------------------------------------------------------- probes


def test_repromotion_after_consecutive_healthy_probes():
    def case(pkg):
        lad = PKG[pkg][0].DeviceLadder()
        lad.configure(probe_interval=0.02, promote_after=2)
        events = []
        lad.add_listener(collect(events))
        lad.demote("test")
        ok = wait_healthy(lad)
        lad.reset()
        kinds = [k for k, _ in events]
        return ok, kinds[0], "probation" in kinds, kinds[-1]
    got = both(case)
    assert got["port"] == got["jax"] == (True, "demote", True, "promote")


def test_failing_probes_keep_it_demoted():
    def case(pkg):
        dev, flt, _ = PKG[pkg]
        lad = dev.DeviceLadder()
        lad.configure(probe_interval=0.02, promote_after=1)
        flt.set_failpoint("ops/device/probe", "raise")
        lad.demote("test")
        time.sleep(0.3)  # many probe intervals
        held = not lad.healthy
        flt.clear_all()  # the road back opens when the fault clears
        ok = wait_healthy(lad)
        lad.reset()
        return held, ok
    got = both(case)
    assert got["port"] == got["jax"] == (True, True)


def test_no_probe_fn_means_permanent_demotion(monkeypatch):
    monkeypatch.setitem(jdevice._cached, "fn", None)
    monkeypatch.setitem(pdevice._cached, "fn", None)

    def case(pkg):
        lad = PKG[pkg][0].DeviceLadder()
        lad.configure(probe_interval=0.01, promote_after=1)
        lad.demote("test")
        time.sleep(0.1)
        return lad.state
    got = both(case)
    assert got["port"] == got["jax"] == "demoted"


# ------------------------------------------------------------ resolution


def test_resolve_failure_is_counted_kept_and_raised(monkeypatch):
    """Both packages count ops/device/resolve_fail and keep the cause for
    resolution_error(); the reference's "auto" then runs CPU-only, the
    port's raises (its device rule: nothing degrades quietly)."""
    monkeypatch.setattr(jdevice, "_cached", {})
    monkeypatch.setattr(pdevice, "_cached", {})
    before = {pkg: counts(pkg) for pkg in PKG}
    for flt in (jfault, fault):
        flt.set_failpoint("ops/device/resolve", "raise:no backend")
    assert jdevice.get_batch_keccak("auto") is None
    with pytest.raises(fault.FailpointError, match="no backend"):
        pdevice.get_batch_keccak("auto", "cpu")
    for pkg, dev, in (("jax", jdevice), ("port", pdevice)):
        assert delta(counts(pkg), before[pkg])["resolve_fail"] == 1
        assert "no backend" in dev.resolution_error()
    # forced modes refuse to degrade quietly in both
    with pytest.raises(RuntimeError, match="forced"):
        jdevice.get_batch_keccak("planned")
    with pytest.raises(fault.FailpointError):
        pdevice.get_batch_keccak("planned", "cpu")
    fault.clear_all()
    seam = pdevice.get_batch_keccak("batched", "cpu")
    assert isinstance(seam, pdevice.LadderedKeccak)
    assert pdevice._cached["fn"] == seam.batched.digests


def test_auto_without_cuda_raises_and_counts(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(pdevice, "_cached", {})
    before = counts("port")["resolve_fail"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pdevice.get_batch_keccak("auto")
    assert counts("port")["resolve_fail"] == before + 1
    assert "CUDA is not available" in pdevice.resolution_error()


# ------------------------------------------------------- the port's rule


def test_build_error_passes_through_dispatch():
    """ROADMAP Queue 3: a kernel that did not build is not a device that
    wedged. The reference's dispatch catches every Exception (and
    demotes); the port's lets BuildError through at once: no retry, no
    demotion, no counter, no event."""
    lad = pdevice.DeviceLadder()
    lad.configure(probe_interval=0)
    events = []
    lad.add_listener(collect(events))
    before = counts("port")
    calls = []

    def unbuilt():
        calls.append(1)
        raise BuildError("nvcc: not found")
    with pytest.raises(BuildError, match="nvcc"):
        lad.dispatch(unbuilt, "planned device commit")
    assert calls == [1] and lad.healthy and events == []
    assert delta(counts("port"), before)["dispatch_errors"] == 0
    # under the watchdog too
    lad.configure(call_timeout=2.0)
    with pytest.raises(BuildError):
        lad.dispatch(unbuilt, "planned device commit")
    assert lad.healthy and events == []


# ------------------------------------------------------------ twin script


def test_one_failpoint_script_drives_both_ladders_alike():
    """A caller's demotion, raise*1 on the probe: each ladder fails a
    probe, enters probation, re-promotes and dispatches again, with the
    same state, event and counter sequences. Then raise*1 on the
    dispatch: the reference retries and answers, the port hands the
    failpoint's error to the caller (ROADMAP Queue 3)."""
    def case(pkg):
        dev, flt, _ = PKG[pkg]
        lad = dev.DeviceLadder()
        lad.configure(probe_interval=0.02, promote_after=2)
        events, states = [], []
        lad.add_listener(collect(events))
        before = counts(pkg)
        flt.set_failpoint("ops/device/probe", "raise*1")
        lad.demote("operator")
        states.append(lad.state)
        assert wait_healthy(lad)
        states.append(lad.state)
        states.append(lad.dispatch(lambda: "pong", "twin drill"))
        twin = [k for k, _ in events], delta(counts(pkg), before)
        if pkg == "jax":
            lad.configure(max_retries=1)
            lad.retry_base = 0.001
        flt.set_failpoint("ops/device/dispatch", "raise*1")
        try:
            states.append(lad.dispatch(lambda: "pong", "twin drill"))
        except flt.FailpointError:
            states.append("FailpointError")
        states.append(lad.state)
        lad.reset()
        return states, twin, [k for k, _ in events][len(twin[0]):]
    got = both(case)
    assert got["port"][1] == got["jax"][1]
    kinds, moved = got["port"][1]
    assert kinds == ["demote", "probation", "promote"]
    assert moved == {"dispatch_errors": 0, "demotions": 1, "promotions": 1,
                     "probe_errors": 1, "resolve_fail": 0}
    assert got["jax"][0] == ["demoted", "healthy", "pong", "pong", "healthy"]
    assert got["port"][0] == ["demoted", "healthy", "pong", "FailpointError",
                              "healthy"]
    assert got["jax"][2] == ["retry"] and got["port"][2] == []


# -------------------------------------------------- demoted commits' roots


def _alloc(rng, n, contracts=3, slots=40):
    alloc = {}
    for i in range(n):
        storage = ({rng.bytes(32): b"\x07" + rng.bytes(31)
                    for _ in range(slots)} if i < contracts else {})
        alloc[rng.bytes(20)] = dict(balance=10**18 + i, storage=storage)
    return alloc


@pytest.mark.parametrize("resident", [False, True])
def test_demoted_commit_roots_equal_the_reference(resident):
    """A block commit while a caller has the ladder demoted lands on the
    host and gives the reference's root: without a mirror the whole
    planned program (account trie and storage tries) takes the
    host-routed paths; on a resident mirror (device="cpu") the storage
    program is the one demoted. Nothing is dispatched."""
    rng = np.random.default_rng(9)
    alloc = _alloc(rng, 130)
    jdisk = JMemoryDB()
    jtdb = JTrieDatabase(jdisk)
    gen = JGenesis(config=jparams.TEST_CHAIN_CONFIG,
                   alloc={a: JGenesisAccount(**v) for a, v in alloc.items()})
    groot = gen.commit(jdisk, JDatabase(jtdb)).root
    disk = MemoryDB()
    tdb = TrieDatabase(disk, batch_keccak=PlannedMode(
        PlannedCommit(device="cpu")))
    pgen = Genesis(config=params.TEST_CHAIN_CONFIG,
                   alloc={a: GenesisAccount(**v) for a, v in alloc.items()})
    assert pgen.commit(disk, Database(tdb)).root == groot
    db = Database(tdb)
    if resident:
        from coreth_tpu_torch.trie.iterator import iterate_leaves
        from coreth_tpu_torch.trie.resident_mirror import \
            ResidentAccountMirror

        db.mirror = ResidentAccountMirror(
            list(iterate_leaves(tdb.open_trie(groot))), device="cpu")
    j = jstatedb.StateDB(groot, JDatabase(jtdb))
    p = StateDB(groot, db)
    assert getattr(p.trie, "resident", False) == resident
    contracts = list(alloc)[:3]
    for i, a in enumerate(alloc):
        for s in (j, p):
            s.add_balance(a, i + 1)
    for c in contracts:
        for k in [rng.bytes(32) for _ in range(40)]:
            v = b"\x09" + rng.bytes(31)
            for s in (j, p):
                s.set_state(c, k, v)
    lad = pdevice.default_ladder()
    lad.configure(probe_interval=0)
    before = counts("port")
    runs = planned.planned_fallbacks
    fault.set_failpoint("ops/device/dispatch", "raise")  # never reached
    lad.demote("the caller took the host")
    want = j.commit(True)
    got = p.commit(True, block_hash=b"\x01" * 32, parent_block_hash=b"\x00"
                   * 32) if resident else p.commit(True)
    assert got == want
    assert not lad.healthy
    moved = delta(counts("port"), before)
    assert moved["demotions"] == 1 and moved["dispatch_errors"] == 0
    assert planned.planned_fallbacks == runs  # not a TooManySegments
    fault.clear_all()
    if not resident:
        tdb.commit(got)
        back = StateDB(got, Database(TrieDatabase(disk)))
        for c in contracts:
            assert back.get_balance(c) == j.get_balance(c)


# ------------------------------------------------------------- chain drill

N_SENDERS = 120  # >= BATCH_THRESHOLD dirty accounts: the seam engages
KEYS = [i.to_bytes(1, "big") * 32 for i in range(1, N_SENDERS + 1)]
ADDRS = [priv_to_address(k) for k in KEYS]
DRILL_KNOBS = dict(device_call_timeout=0.5, device_probe_interval=0.05,
                   device_promote_after=2)


def transfer_tx(nonce, to, key, base_fee):
    tx = JTransaction(type=2, chain_id=43112, nonce=nonce,
                      max_fee=base_fee * 2, max_priority_fee=0, gas=21000,
                      to=to, value=1000)
    return JSigner(43112).sign(tx, key)


def _jgenesis():
    return JGenesis(config=jparams.TEST_CHAIN_CONFIG,
                    gas_limit=jparams.CORTINA_GAS_LIMIT,
                    alloc={a: JGenesisAccount(balance=10**21) for a in ADDRS})


def _pgenesis():
    return Genesis(config=params.TEST_CHAIN_CONFIG,
                   gas_limit=params.CORTINA_GAS_LIMIT,
                   alloc={a: GenesisAccount(balance=10**21) for a in ADDRS})


def _blocks(n):
    """A clean reference chain and `n` blocks of N_SENDERS transfers."""
    jdisk = JMemoryDB()
    clean = JBlockChain(jdisk, JCacheConfig(pruning=True),
                        jparams.TEST_CHAIN_CONFIG, _jgenesis(),
                        j_new_dummy_engine(),
                        state_database=JDatabase(JTrieDatabase(jdisk)))
    base_fee = jparams.APRICOT_PHASE3_INITIAL_BASE_FEE

    def gen(i, bg):
        bf = bg.base_fee() or base_fee
        for j, key in enumerate(KEYS):
            to = (0x7000 + i * N_SENDERS + j).to_bytes(20, "big")
            bg.add_tx(transfer_tx(i, to, key, bf))

    blocks, _ = j_generate_chain(clean.config, clean.current_block,
                                 clean.engine, clean.state_database, n,
                                 gen=gen)
    return clean, blocks


def test_kernel_launch_error_reaches_insert_block(monkeypatch):
    """The port's device rule at the chain: a KernelLaunchError from the
    planned program (PlannedCommit.run) reaches insert_block with the
    head unchanged, the ladder healthy and 0 demotions (the reference
    would demote and finish the root on the host). With the kernel back,
    the same block inserts with the reference's root."""
    clean, blocks = _blocks(1)
    lad = pdevice.default_ladder()
    chain = BlockChain(MemoryDB(), CacheConfig(pruning=True),
                       params.TEST_CHAIN_CONFIG, _pgenesis(),
                       new_dummy_engine(), device="cpu")
    assert getattr(chain.state_database.triedb.batch_keccak, "planned")
    genesis = chain.current_block.hash()
    before = counts("port")
    real = PlannedCommit.run

    def launch_fails(self, *a, **kw):
        raise KernelLaunchError("segment_keccak launch failed: CUDA error 719")
    monkeypatch.setattr(PlannedCommit, "run", launch_fails)
    pb = Block.decode(blocks[0].encode())
    with pytest.raises(KernelLaunchError, match="CUDA error 719"):
        chain.insert_block(pb)
    assert chain.current_block.hash() == genesis and not chain.bad_blocks
    assert lad.healthy
    moved = delta(counts("port"), before)
    assert moved["demotions"] == 0 and moved["dispatch_errors"] == 1
    monkeypatch.setattr(PlannedCommit, "run", real)
    chain.insert_block(Block.decode(blocks[0].encode()))
    clean.insert_block(blocks[0])
    assert chain.current_block.root == clean.current_block.root
    for c in (chain, clean):
        c.stop()


def test_chain_drill_hang_demote_bitexact_repromote():
    """test_chaos_drill_hang_demote_bitexact_repromote on both packages'
    chains over the same blocks, `hang` armed on the dispatch and the
    probe in both registries. The reference's watchdog demotes within its
    deadline and its drill chain inserts and accepts the three blocks of
    120 transfers on the host. The port's hang reaches insert_block as
    DeviceWedgedError within the deadline, the head unchanged and no
    demotion; its caller then demotes the ladder and the same blocks land
    on the host. The roots equal a no-fault reference chain's block for
    block, and after the faults clear both ladders re-promote with the
    same device/* flight events."""
    jlad, plad = jdevice.default_ladder(), pdevice.default_ladder()
    clean, blocks = _blocks(3)
    ddisk = JMemoryDB()
    jdrill = JBlockChain(
        ddisk,
        JCacheConfig(pruning=True, device_max_retries=0, **DRILL_KNOBS),
        jparams.TEST_CHAIN_CONFIG, _jgenesis(), j_new_dummy_engine(),
        state_database=JDatabase(JTrieDatabase(
            ddisk, batch_keccak=jdevice.LadderedKeccak(jax_device_fn,
                                                       ladder=jlad))))
    pdisk = MemoryDB()
    pdrill = BlockChain(
        pdisk, CacheConfig(pruning=True, **DRILL_KNOBS),
        params.TEST_CHAIN_CONFIG, _pgenesis(), new_dummy_engine(),
        state_database=Database(TrieDatabase(
            pdisk, batch_keccak=pdevice.LadderedKeccak(
                default_batched_keccak("cpu"), ladder=plad))),
        device="cpu")
    assert plad.status()["call_timeout"] == 0.5
    before = counts("port")
    for flt in (jfault, fault):
        flt.set_failpoint("ops/device/dispatch", "hang")
        flt.set_failpoint("ops/device/probe", "hang")
    t0 = time.monotonic()
    for b in blocks:
        jdrill.insert_block(b)
        jdrill.accept(b)
    jdrill.drain_acceptor_queue()
    assert time.monotonic() - t0 < 60
    assert not jlad.healthy
    genesis = pdrill.current_block.hash()
    t0 = time.monotonic()
    with pytest.raises(DeviceWedgedError, match="watchdog deadline"):
        pdrill.insert_block(Block.decode(blocks[0].encode()))
    assert time.monotonic() - t0 < 5
    assert pdrill.current_block.hash() == genesis and plad.healthy
    assert delta(counts("port"), before)["demotions"] == 0
    plad.demote("the caller took the host after a hang")
    for b in blocks:
        pb = Block.decode(b.encode())
        pdrill.insert_block(pb)
        pdrill.accept(pb)
    pdrill.drain_acceptor_queue()
    assert delta(counts("port"), before)["demotions"] == 1
    for b in blocks:
        clean.insert_block(b)
        clean.accept(b)
    clean.drain_acceptor_queue()
    assert (pdrill.current_block.hash() == jdrill.current_block.hash()
            == clean.current_block.hash())
    assert pdrill.current_block.root == clean.current_block.root
    for flt in (jfault, fault):
        flt.clear_all()
    assert wait_healthy(jlad, 20) and wait_healthy(plad, 20)

    def device_events(chain):
        return [e["event"] for e in chain.flight_recorder.events()
                if e["event"].startswith("device/")]
    assert device_events(pdrill) == device_events(jdrill)
    assert {"device/demote", "device/promote"} <= set(device_events(pdrill))
    for c in (jdrill, pdrill, clean):
        c.stop()
