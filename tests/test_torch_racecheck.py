"""The port's race harness and lock telemetry (coreth_tpu_torch/utils/
racecheck.py) against the JAX package's, on the CPU.

One lock script (named locks taken and released in a fixed order on
several threads, one step at a time) runs under each package's
LockOrderWitness: the inversions flagged and the edges recorded must be
the same. RaceDetector's overlap and ownership modes give the same
reports on the same call scripts. The slow-hold budget captures holds
past it, debug_lockStatus reads the port's tables, and the
lock-slow-hold-budget knob boots a VM and sets the budget.
"""

import json
import re
import threading
import time

import pytest

from coreth_tpu.utils import racecheck as jrace
from coreth_tpu_torch.utils import racecheck

# canonical names, in CANONICAL_LOCK_ORDER's order, plus one unlisted
NAMES = ("VM.lock", "BlockChain.chainmu", "BlockChain._view_mu",
         "InsertPipeline._mu", "TxPool.mu", "Tree.lock", "Unlisted.mu")


class _Owner:
    pass


def _run_lock_script(mod, script):
    """Wrap one lock per name under mod's witness, then play the script:
    (thread, "acquire"|"release", name) steps, each on its own worker
    thread, strictly one step at a time. Returns the violations (thread
    idents replaced by the script's thread index) and the edges."""
    w = mod.LockOrderWitness()
    owners = {}
    for name in NAMES:
        o = _Owner()
        o.mu = threading.RLock() if name == "BlockChain.chainmu" \
            else threading.Lock()
        w.wrap(o, "mu", name)
        owners[name] = o
    nthreads = 1 + max(t for t, _, _ in script)
    inbox = [[] for _ in range(nthreads)]
    go = [threading.Event() for _ in range(nthreads)]
    done = threading.Event()
    idents = {}

    def worker(i):
        idents[threading.get_ident()] = i
        while True:
            go[i].wait()
            go[i].clear()
            step = inbox[i].pop(0)
            if step is None:
                return
            op, name = step
            getattr(owners[name].mu, op)()
            done.set()

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(nthreads)]
    for t in threads:
        t.start()
    for t, op, name in script:
        done.clear()
        inbox[t].append((op, name))
        go[t].set()
        assert done.wait(5)
    for i in range(nthreads):
        inbox[i].append(None)
        go[i].set()
    for t in threads:
        t.join()
    w.unwrap_all()
    out = []
    for v in w.violations:
        m = re.match(r"thread (\d+) (.*)", v)
        out.append(f"thread #{idents[int(m.group(1))]} {m.group(2)}")
    return out, sorted(w.edges)


def _random_script(seed):
    """Per thread, a random walk of nested acquisitions (sometimes out of
    canonical order, sometimes re-entrant on chainmu) and releases."""
    import random

    rng = random.Random(seed)
    held = {0: [], 1: [], 2: []}
    owner = {}
    script = []
    for _ in range(90):
        t = rng.randrange(3)
        stack = held[t]
        free = [n for n in NAMES
                if owner.get(n) in (None, t)
                and (n == "BlockChain.chainmu" or n not in stack)]
        if stack and (rng.random() < 0.45 or not free):
            name = stack.pop(rng.randrange(len(stack)))
            if name not in stack:
                owner.pop(name, None)
            script.append((t, "release", name))
        elif free:
            name = rng.choice(free)
            stack.append(name)
            owner[name] = t
            script.append((t, "acquire", name))
    for t, stack in held.items():
        for name in reversed(stack):
            script.append((t, "release", name))
    return script


@pytest.mark.parametrize("seed", [2, 9, 31])
def test_witness_flags_the_reference_inversions(seed):
    script = _random_script(seed)
    got = _run_lock_script(racecheck, script)
    want = _run_lock_script(jrace, script)
    assert got == want
    assert got[1]  # edges were recorded


def test_witness_canonical_nesting_is_clean_and_inversion_flagged():
    script = [(0, "acquire", "BlockChain.chainmu"),
              (0, "acquire", "BlockChain.chainmu"),
              (0, "acquire", "TxPool.mu"), (0, "release", "TxPool.mu"),
              (0, "release", "BlockChain.chainmu"),
              (0, "release", "BlockChain.chainmu"),
              (1, "acquire", "TxPool.mu"),
              (1, "acquire", "BlockChain.chainmu"),
              (1, "release", "BlockChain.chainmu"),
              (1, "release", "TxPool.mu")]
    violations, edges = _run_lock_script(racecheck, script)
    assert violations == _run_lock_script(jrace, script)[0]
    assert len(violations) == 1 and violations[0].startswith("thread #1")
    assert "violates canonical order via TxPool.mu" in violations[0]
    assert ("BlockChain.chainmu", "TxPool.mu") in edges


def _detector_reports(mod):
    class Guarded:
        def __init__(self):
            self.mu = threading.Lock()

        def mutate(self):
            time.sleep(0.002)

    out = []
    obj = Guarded()
    det = mod.RaceDetector()
    det.require_lock(obj, ["mutate"], "mu")
    obj.mutate()  # no lock held
    with obj.mu:
        obj.mutate()  # the owner: clean
    with obj.mu:  # held by this thread while another enters
        t = threading.Thread(target=obj.mutate)
        t.start()
        t.join()
    out.append([re.sub(r"\d{4,}", "T", v) for v in det.violations])

    other = Guarded()
    det2 = mod.RaceDetector()
    det2.guard(other, ["mutate"])
    other.mutate()  # one thread alone never overlaps
    gate = threading.Barrier(2)

    def hammer():
        gate.wait()
        for _ in range(15):
            other.mutate()

    threads = [threading.Thread(target=hammer) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out.append(bool(det2.violations))
    out.append(all("mutate entered by thread" in v for v in det2.violations))
    return out


def test_race_detector_gives_the_reference_reports():
    got, want = _detector_reports(racecheck), _detector_reports(jrace)
    assert got == want
    assert got[0] == ["mutate entered by thread T without holding mu"] * 2
    assert got[1] is True


def test_telemetry_slow_hold_and_lock_status():
    """A witnessed lock fills its wait/hold histograms and the contention
    table; a hold past the budget is captured with its trace id, after
    the release (no spurious order edge); debug_lockStatus serves it."""
    from coreth_tpu_torch.metrics import tracectx
    from coreth_tpu_torch.vm.api import DebugMetricsAPI

    chain = _Owner()
    chain._view_mu = threading.Lock()
    w = racecheck.LockOrderWitness()
    w.wrap(chain, "_view_mu", "BlockChain._view_mu")
    events = []
    racecheck.set_slow_hold_sink(events.append)
    racecheck.set_slow_hold_budget(0.01)
    try:
        ctx = tracectx.begin("rpc")
        with tracectx.scope(ctx):
            with chain._view_mu:
                time.sleep(0.03)
        with chain._view_mu:
            pass
        status = DebugMetricsAPI(None).lockStatus()
    finally:
        racecheck.set_slow_hold_budget(0.0)
        racecheck.set_slow_hold_sink(None)
        w.unwrap_all()
    assert w.violations == [] and not w.edges
    ev = events[-1]
    assert ev["lock"] == "BlockChain._view_mu" and ev["held_seconds"] >= 0.01
    assert ev["trace_id"] == ctx.trace_id and "test_torch_racecheck" in ev[
        "stack"]
    assert status["slow_hold_budget_seconds"] == 0.01
    row = next(r for r in status["contention"]
               if r["lock"] == "BlockChain._view_mu")
    assert row["hold_count"] >= 2 and row["hold_total_seconds"] >= 0.01
    assert any(e["lock"] == "BlockChain._view_mu"
               for e in status["recent_slow_holds"])
    from coreth_tpu_torch.metrics import sanitize_metric_name

    fam = sanitize_metric_name("lock/BlockChain._view_mu/hold_seconds")
    assert racecheck.canonical_for_family(fam) == "BlockChain._view_mu"
    assert isinstance(chain._view_mu, type(threading.Lock()))


def test_lock_slow_hold_budget_boots_and_is_checked():
    """lock-slow-hold-budget, refused until the witness was ported, now
    boots the port's VM and sets the budget the proxies check, as the
    reference's VM does; a negative budget is refused by validate()."""
    from coreth_tpu_torch import params
    from coreth_tpu_torch.core.genesis import Genesis, GenesisAccount
    from coreth_tpu_torch.ethdb import MemoryDB
    from coreth_tpu_torch.vm.config import parse_config
    from coreth_tpu_torch.vm.shared_memory import Memory
    from coreth_tpu_torch.vm.vm import SnowContext, VM

    blob = json.dumps({"lock-slow-hold-budget": 0.25}).encode()
    assert parse_config(blob).lock_slow_hold_budget == 0.25
    with pytest.raises(ValueError):
        parse_config(json.dumps({"lock-slow-hold-budget": -1}).encode())
    vm = VM()
    try:
        vm.initialize(SnowContext(shared_memory=Memory()), MemoryDB(),
                      Genesis(config=params.TEST_CHAIN_CONFIG,
                              alloc={b"\x01" * 20: GenesisAccount(
                                  balance=1)}),
                      config_bytes=blob, device="cpu")
        assert racecheck.slow_hold_budget() == 0.25
    finally:
        vm.shutdown()
        racecheck.set_slow_hold_budget(0.0)
