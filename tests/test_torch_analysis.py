"""The port's static-analysis gate (coreth_tpu_torch/analysis/): the twin
of tests/test_static_analysis.py with every synthetic source placed at
the port's relpaths, plus a parity test that runs one corpus of every
rule's firing and quiet snippets through both engines.

Snippets are written with the package name as `PKG`; `at(pkg, text)`
places them in the port (`coreth_tpu_torch`) or in the reference
(`coreth_tpu`). SA012 is the one rule whose port differs: the reference
checks jax.jit shardings, the port explicit tensor placement (the port
has no jit), so it has its own torch-side firing and quiet cases and is
left out of the parity comparison.

Every test points the port's analysis cache at one temporary file of
the test run through CORETH_TPU_TORCH_ANALYSIS_CACHE (tests/
test_torch_isolation.py's guarded run of the CLI takes the same one):
the first walk of the repo is cold, the rest replay it.
"""

import subprocess
import sys
import textwrap

import pytest

from coreth_tpu_torch.analysis import run_repo
from coreth_tpu_torch.analysis.engine import BaselineError, Engine, \
    load_baseline
from coreth_tpu_torch.analysis.rules import default_rules

PORT, REF = "coreth_tpu_torch", "coreth_tpu"
CACHE_VAR = "CORETH_TPU_TORCH_ANALYSIS_CACHE"


def at(pkg, text):
    return text.replace("PKG", pkg)


@pytest.fixture(scope="module")
def _cache_file(tmp_path_factory):
    return tmp_path_factory.getbasetemp() / "coreth-tpu-torch-analysis.pkl"


@pytest.fixture(autouse=True)
def _cache_at_tmp(_cache_file, monkeypatch):
    monkeypatch.setenv(CACHE_VAR, str(_cache_file))


def findings(src, relpath="PKG/fixture.py"):
    eng = Engine(default_rules())
    return eng.check_source(textwrap.dedent(at(PORT, src)),
                            at(PORT, relpath))


def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "coreth_tpu_torch.analysis", *args],
        capture_output=True, text=True, timeout=120)


# ---------------------------------------------------------------- SA001

_SA001_SILENT = """
def fetch(db, k):
    try:
        return db[k]
    except Exception:
        return None
"""

SA001_HANDLED = [
    "raise",                                   # re-raise
    "log.warning('boom: %s', e)",              # logs
    "count_drop('fixture/fetch_error')",       # metrics counter
    "metrics.errors.inc()",                    # metrics attr
    "out['error'] = str(e)",                   # in-band error reply
    "return Resp(error=str(e))",               # error kwarg reply
]


def _sa001_handled(body):
    return f"""
def fetch(db, k, out, log, metrics, count_drop, Resp):
    try:
        return db[k]
    except Exception as e:
        {body}
"""


_SA001_NARROW = """
def fetch(db, k):
    try:
        return db[k]
    except KeyError:
        return None
"""


def test_sa001_fires_on_silent_broad_except():
    out = [f for f in findings(_SA001_SILENT) if f.rule == "SA001"]
    assert len(out) == 1
    assert out[0].qualname == "fetch"


@pytest.mark.parametrize("body", SA001_HANDLED)
def test_sa001_quiet_when_handled(body):
    assert [f for f in findings(_sa001_handled(body))
            if f.rule == "SA001"] == []


def test_sa001_quiet_on_narrow_except():
    assert [f for f in findings(_SA001_NARROW) if f.rule == "SA001"] == []


# ---------------------------------------------------------------- SA002

_SA002_ANNOTATED = """
import threading

class Pool:
    def __init__(self):
        self.mu = threading.Lock()
        self.items = []  # guarded-by: mu

    def ok(self):
        with self.mu:
            self.items.append(1)

    def bad(self):
        self.items.append(2)
"""

_SA002_INCONSISTENT = """
import threading

class Pool:
    def __init__(self):
        self.mu = threading.Lock()
        self.items = []

    def locked_write(self):
        with self.mu:
            self.items = []

    def unlocked_write(self):
        self.items = [1]
"""

_SA002_QUIET = """
import threading

class Pool:
    def __init__(self):
        self.mu = threading.Lock()
        self.items = []  # guarded-by: mu

    def add(self, x):
        with self.mu:
            self.items.append(x)

    def _drain(self):  # guarded-by: mu
        self.items = []

    def clear_locked(self):
        self.items = []
"""


def test_sa002_fires_on_annotated_attr_written_without_lock():
    out = [f for f in findings(_SA002_ANNOTATED) if f.rule == "SA002"]
    assert len(out) == 1
    assert out[0].qualname == "Pool.bad"


def test_sa002_fires_on_inconsistent_locking():
    out = [f for f in findings(_SA002_INCONSISTENT) if f.rule == "SA002"]
    assert len(out) == 1
    assert out[0].qualname == "Pool.unlocked_write"


def test_sa002_quiet_when_discipline_holds():
    assert [f for f in findings(_SA002_QUIET) if f.rule == "SA002"] == []


# ---------------------------------------------------------------- SA003

_SA003_WALLCLOCK = """
import time

def step(vm):  # hot-path
    t = time.time()
    return t
"""

_SA003_RANDOM_CTYPES = """
import ctypes
import random

def step(vm):  # hot-path
    x = random.random()
    buf = ctypes.create_string_buffer(64)
    return x, buf
"""

SA003_CONSTRUCTIONS = [
    "registry.timer('fixture/step')",
    "metrics.get_or_register_timer('fixture/step')",
    "registry.histogram('fixture/sizes')",
    "tracer.start_span('fixture/step')",
    "Span(tracer, 'fixture/step', {})",
]


def _sa003_construction(call):
    return f"""
def step(vm, registry, metrics, tracer, Span):  # hot-path
    m = {call}
    return m
"""


SA003_GATED = [
    "phase_timer('fixture/phase')",
    "expensive_timer('fixture/phase')",
    "span('fixture/step', n=1)",
    "spans.span('fixture/step')",
]


def _sa003_gated(call):
    return f"""
def step(vm, phase_timer, expensive_timer, span, spans):  # hot-path
    with {call}:
        return vm.pc + 1
"""


_SA003_OFF_HOT = """
def setup(registry):
    return registry.timer('fixture/step')
"""

_SA003_COLD = """
import time

def step(vm):
    return time.time()
"""

_SA003_HOT_CLEAN = """
def step(vm):  # hot-path
    return vm.pc + 1
"""


def test_sa003_fires_on_wallclock_in_hot_path():
    out = [f for f in findings(_SA003_WALLCLOCK) if f.rule == "SA003"]
    assert len(out) == 1


def test_sa003_fires_on_random_and_ctypes_alloc():
    out = [f for f in findings(_SA003_RANDOM_CTYPES) if f.rule == "SA003"]
    assert len(out) == 2


@pytest.mark.parametrize("call", SA003_CONSTRUCTIONS)
def test_sa003_fires_on_metric_construction_in_hot_path(call):
    out = [f for f in findings(_sa003_construction(call))
           if f.rule == "SA003"]
    assert len(out) == 1
    assert "hoist" in out[0].message


@pytest.mark.parametrize("call", SA003_GATED)
def test_sa003_quiet_on_gated_observability_helpers(call):
    assert [f for f in findings(_sa003_gated(call))
            if f.rule == "SA003"] == []


def test_sa003_quiet_on_metric_construction_off_hot_path():
    assert [f for f in findings(_SA003_OFF_HOT) if f.rule == "SA003"] == []


def test_sa003_quiet_without_marker_and_on_clean_hot_fn():
    assert [f for f in findings(_SA003_COLD) if f.rule == "SA003"] == []
    assert [f for f in findings(_SA003_HOT_CLEAN)
            if f.rule == "SA003"] == []


# ---------------------------------------------------------------- SA004

_SA004_FLOAT = """
def gas_cost(n):
    return n * 1.5
"""

_SA004_EMA = """
def ema(x, prev):
    return 0.9 * prev + 0.1 * x
"""

_SA004_INT = """
def gas_cost(n):
    return (n * 3) // 2
"""


def test_sa004_fires_on_float_arithmetic_in_consensus_path():
    out = [f for f in findings(_SA004_FLOAT, "PKG/evm/gas.py")
           if f.rule == "SA004"]
    assert out


def test_sa004_quiet_outside_consensus_paths_and_on_int_math():
    assert [f for f in findings(_SA004_EMA, "PKG/metrics/fixture.py")
            if f.rule == "SA004"] == []
    assert [f for f in findings(_SA004_INT, "PKG/evm/gas.py")
            if f.rule == "SA004"] == []


# ---------------------------------------------------------------- SA005

_SA005_SET = """
def commit(dirty):
    keys = set(dirty)
    for k in keys:
        yield k
"""

_SA005_SORTED = """
def commit(dirty):
    for k in sorted(set(dirty)):
        yield k
"""


def test_sa005_fires_on_set_iteration_in_hashing_path():
    out = [f for f in findings(_SA005_SET, "PKG/trie/fixture.py")
           if f.rule == "SA005"]
    assert out


def test_sa005_quiet_on_sorted_iteration():
    assert [f for f in findings(_SA005_SORTED, "PKG/trie/fixture.py")
            if f.rule == "SA005"] == []


# ---------------------------------------------------------------- SA006

def _check_many(srcs):
    """Run several fixture files through ONE engine (SA006 keeps
    cross-file registration state) and include the finalize() pass."""
    eng = Engine(default_rules())
    out = []
    for src, relpath in srcs:
        out.extend(eng.check_source(textwrap.dedent(at(PORT, src)),
                                    at(PORT, relpath)))
    for rule in eng.rules:
        out.extend(rule.finalize())
    return [f for f in out if f.rule == "SA006"]


_SA006_COMPUTED = """
from PKG.fault import failpoint

def tick(name):
    failpoint("prefix/" + name)
"""

_SA006_FN_SCOPE = """
from PKG.fault import register

def setup():
    register("x/inside", "late")
"""

_SA006_DUP_A = """
from PKG.fault import register
register("x/dup", "first")
"""

_SA006_DUP_B = """
from PKG.fault import register
register("x/dup", "second")
"""

_SA006_GHOST = """
from PKG.fault import failpoint

def tick():
    failpoint("x/ghost")
"""

_SA006_REG_OK = """
from PKG.fault import register
register("x/ok", "docs")
"""

_SA006_FIRE_OK = """
from PKG import fault as flt

def tick():
    flt.failpoint("x/ok")
"""

SA006_SLEEPS = ["time.sleep(0.1)", "sleep(0.1)"]


def _sa006_sleep(body):
    return f"""
import time
from time import sleep

def retry():
    {body}
"""


_SA006_FAULT_SLEEP = """
import time

def _pace(self):
    time.sleep(0.1)
"""


def test_sa006_fires_on_computed_failpoint_name():
    out = _check_many([(_SA006_COMPUTED, "PKG/fixture.py")])
    assert any("literal string name" in f.message for f in out)


def test_sa006_fires_on_function_scope_registration():
    out = _check_many([(_SA006_FN_SCOPE, "PKG/fixture.py")])
    assert any("module scope" in f.message for f in out)


def test_sa006_fires_on_cross_file_duplicate_registration():
    out = _check_many([(_SA006_DUP_A, "PKG/a.py"),
                       (_SA006_DUP_B, "PKG/b.py")])
    assert len(out) == 1
    assert "already registered at coreth_tpu_torch/a.py" in out[0].message


def test_sa006_finalize_fires_on_never_registered_name():
    out = _check_many([(_SA006_GHOST, "PKG/fixture.py")])
    assert any("no module registers" in f.message for f in out)


def test_sa006_quiet_on_registered_literal_round_trip():
    """Module-scope register + literal fire (even across files, even
    through a module alias) is the sanctioned shape."""
    assert _check_many([(_SA006_REG_OK, "PKG/a.py"),
                        (_SA006_FIRE_OK, "PKG/b.py")]) == []


@pytest.mark.parametrize("body", SA006_SLEEPS)
def test_sa006_fires_on_naked_sleep(body):
    out = _check_many([(_sa006_sleep(body), "PKG/peer/fixture.py")])
    assert any("fault.Backoff" in f.message for f in out)


def test_sa006_sleep_allowed_inside_fault_package():
    assert _check_many([(_SA006_FAULT_SLEEP,
                         "PKG/fault/__init__.py")]) == []


# ---------------------------------------------------------------- SA007

_SA007_BAD = """
import queue
from queue import Queue as Q, SimpleQueue
from concurrent.futures import ThreadPoolExecutor


def build():
    a = queue.Queue()                     # no maxsize
    b = Q(maxsize=0)                      # 0 = unbounded for queue.Queue
    c = SimpleQueue()                     # always unbounded
    d = ThreadPoolExecutor()              # host-sized, not budget-sized
    return a, b, c, d
"""

SA007_SERVING = [
    "PKG/rpc/fixture.py",
    "PKG/vm/api.py",
    "PKG/eth/filters.py",
    "PKG/metrics/http.py",
]

_SA007_BOUNDED = """
import queue
from concurrent.futures import ThreadPoolExecutor

def build(n):
    a = queue.Queue(maxsize=64)
    b = queue.Queue(n)          # positional bound: not statically 0
    c = ThreadPoolExecutor(max_workers=4)
    return a, b, c
"""

_SA007_NONE = """
from concurrent.futures import ThreadPoolExecutor

def build():
    return ThreadPoolExecutor(max_workers=None)
"""


@pytest.mark.parametrize("relpath", SA007_SERVING)
def test_sa007_fires_in_serving_paths(relpath):
    out = [f for f in findings(_SA007_BAD, relpath) if f.rule == "SA007"]
    assert len(out) == 4
    assert all(f.qualname == "build" for f in out)


def test_sa007_quiet_outside_serving_paths():
    # the same constructions are fine in batch/client-side modules
    out = findings(_SA007_BAD, "PKG/ethclient/fixture.py")
    assert [f for f in out if f.rule == "SA007"] == []


def test_sa007_quiet_on_bounded_construction():
    out = findings(_SA007_BOUNDED, "PKG/rpc/fixture.py")
    assert [f for f in out if f.rule == "SA007"] == []


def test_sa007_fires_on_executor_with_explicit_none():
    out = findings(_SA007_NONE, "PKG/rpc/fixture.py")
    assert [f.rule for f in out] == ["SA007"]


# ---------------------------------------------------------------- SA008

_SA008_BINTRIE_MPT = """
from PKG.trie.node import HashNode

def helper():
    return HashNode
"""

_SA008_MPT_BINTRIE = """
import PKG.bintrie.tree as bt

def helper():
    return bt.EMPTY
"""

_SA008_RELATIVE = """
from ..trie import node

def helper():
    return node
"""

_SA008_SHARED = """
from PKG.native import keccak256
from PKG.metrics import count_drop
from ..ops.keccak_planned import SegmentSpec
"""

_SA008_SEAM = """
from PKG.trie.secure import StateTrie
from PKG.bintrie.tree import BinaryTrie
"""


def test_sa008_fires_on_bintrie_importing_mpt():
    out = [f for f in findings(_SA008_BINTRIE_MPT, "PKG/bintrie/fixture.py")
           if f.rule == "SA008"]
    assert out and "coreth_tpu_torch.trie" in out[0].message


def test_sa008_fires_on_mpt_importing_bintrie():
    out = [f for f in findings(_SA008_MPT_BINTRIE, "PKG/trie/fixture.py")
           if f.rule == "SA008"]
    assert out


def test_sa008_resolves_relative_imports():
    """`from ..trie import node` inside bintrie/ is the same breach as
    the absolute spelling — the rule resolves relative levels."""
    out = [f for f in findings(_SA008_RELATIVE, "PKG/bintrie/fixture.py")
           if f.rule == "SA008"]
    assert out


def test_sa008_quiet_on_shared_deps_and_seam_module():
    # backends may share the leaf dependencies (native, metrics, ops)
    assert [f for f in findings(_SA008_SHARED, "PKG/bintrie/fixture.py")
            if f.rule == "SA008"] == []
    # and the seam (state/commitment.py) legitimately sees both sides
    assert [f for f in findings(_SA008_SEAM, "PKG/state/fixture.py")
            if f.rule == "SA008"] == []


# ---------------------------------------------------------------- SA010

_SA010_BAD = """
class EthAPI:
    def blockNumber(self):
        with self.b.chain.chainmu:
            return self.b.chain.current_block

    def forceAccept(self, blk):
        self.b.chain.accept(blk)

    def consensusHead(self):
        chain = self.b.chain
        return chain.last_consensus_accepted_block()
"""

SA010_READ_TIER = [
    "PKG/eth/api.py",
    "PKG/eth/filters.py",
    "PKG/eth/gasprice.py",
    "PKG/eth/backend.py",
]
SA010_WRITERS = ("PKG/vm/vm.py", "PKG/eth/tracers.py",
                 "PKG/core/blockchain.py")

_SA010_VIEW = """
class EthAPI:
    def blockNumber(self):
        return self.b.chain.read_view().accepted.number

    def getBalance(self, addr, tag):
        return self.b.state_at_tag(tag).get_balance(addr)

    def acceptItem(self, item):
        # non-chain receivers with colliding method names are fine
        self.queue.accept(item)
"""


@pytest.mark.parametrize("relpath", SA010_READ_TIER)
def test_sa010_fires_on_chainmu_in_read_tier(relpath):
    out = [f for f in findings(_SA010_BAD, relpath) if f.rule == "SA010"]
    assert len(out) == 3
    assert any("chainmu" in f.message for f in out)
    assert any("accept" in f.message for f in out)


def test_sa010_quiet_outside_read_tier():
    # the same code is legitimate in chain-mutating modules
    for relpath in SA010_WRITERS:
        assert [f for f in findings(_SA010_BAD, relpath)
                if f.rule == "SA010"] == []


def test_sa010_quiet_on_view_resolution():
    assert [f for f in findings(_SA010_VIEW, "PKG/eth/api.py")
            if f.rule == "SA010"] == []


# ---------------------------------------------------------------- SA011

_SA011_PATH = "PKG/core/shard_worker.py"

_SA011_BAD = """
import os
from ..metrics import default_registry
from .blockchain import BlockChain

_CACHE = {}

def handle(req):
    with chain.chainmu:
        default_registry.counter("x").inc()
"""

_SA011_LAZY = """
def handle(req):
    from ..metrics import default_registry as reg
    reg.counter("x").inc()
"""

_SA011_CLEAN = """
import os
import threading

from .. import fault

CRASH_EXIT = 13
NAMES = ("a", "b")

def handle(conn, req):
    from ..core.parallel_exec import _VersionedTable

    local = {}
    err_repr = None
    try:
        table = _VersionedTable()
    except Exception as exc:
        err_repr = repr(exc)
    conn.send(("done", err_repr))
"""

SA011_PARENT_MODULES = ("PKG/core/blockchain.py", "PKG/core/exec_shards.py")


def test_sa011_fires_on_fork_unclean_worker():
    out = [f for f in findings(_SA011_BAD, _SA011_PATH)
           if f.rule == "SA011"]
    # metrics import, blockchain import, two module-scope project
    # imports, module-level dict, chainmu attr, default_registry name
    assert len(out) >= 6
    msgs = " ".join(f.message for f in out)
    assert "metrics" in msgs
    assert "chainmu" in msgs
    assert "default_registry" in msgs
    assert "mutable" in msgs


def test_sa011_fires_on_lazy_metrics_import():
    # banned packages are banned even inside functions — laziness does
    # not make the parent's registry safe to touch from a forked child
    out = [f for f in findings(_SA011_LAZY, _SA011_PATH)
           if f.rule == "SA011"]
    assert len(out) == 1  # the aliased import itself is the finding
    assert "metrics" in out[0].message


def test_sa011_quiet_on_fork_clean_worker():
    assert [f for f in findings(_SA011_CLEAN, _SA011_PATH)
            if f.rule == "SA011"] == []


def test_sa011_quiet_outside_worker_modules():
    # the same code is fine in parent-process modules
    for relpath in SA011_PARENT_MODULES:
        assert [f for f in findings(_SA011_BAD, relpath)
                if f.rule == "SA011"] == []


def test_sa011_real_worker_module_is_clean():
    import pathlib

    import coreth_tpu_torch.core.shard_worker as sw

    src = pathlib.Path(sw.__file__).read_text()
    assert [f for f in findings(src, _SA011_PATH)
            if f.rule == "SA011"] == []


# ---------------------------------------------------------------- SA012
# The port's rule: explicit tensor placement in the mesh commit modules
# (analysis/rules.py, SA012). These cases have no reference twin.

_SA012_PATH = "PKG/ops/keccak_resident.py"

_SA012_BAD = """
import torch

def arena(n):
    return torch.zeros((n, 34), dtype=torch.int32)

def upload(x):
    return torch.as_tensor(x).cuda()

def stage(x, dev):
    return x.to("cuda", non_blocking=True)

def index(n):
    return torch.arange(n, device=torch.device("cuda"))
"""

_SA012_QUIET = """
import torch

def arena(n, dev):
    return torch.zeros((n, 34), dtype=torch.int32, device=dev)

def upload(x, dev):
    return torch.from_numpy(x).to(dev, non_blocking=True)

def cast(x):
    return x.to(torch.int32)

# sharding: a pinned host staging buffer, never a shard's
def staging(n):
    return torch.empty(n, dtype=torch.int32, pin_memory=True)

def make(shape, **kw):
    # assembled kwargs are trusted (the caller fills device=)
    return torch.full(shape, 0, **kw)

def on(x, dev):
    return x.cuda(dev), torch.tensor([1], device="cuda:0")
"""


def test_sa012_fires_on_implicit_placement():
    out = [f for f in findings(_SA012_BAD, _SA012_PATH)
           if f.rule == "SA012"]
    # zeros without device=, as_tensor without device=, bare .cuda(),
    # .to("cuda"), device=torch.device("cuda")
    assert len(out) == 5, out
    msgs = " ".join(f.message for f in out)
    assert "device=" in msgs
    assert ".cuda()" in msgs
    assert "current device" in msgs


def test_sa012_quiet_on_pinned_or_justified_sites():
    assert [f for f in findings(_SA012_QUIET, _SA012_PATH)
            if f.rule == "SA012"] == []


def test_sa012_quiet_outside_commit_path_modules():
    # the same code is fine outside the mesh commit-path modules
    for relpath in ("PKG/ops/keccak_torch.py", "PKG/core/blockchain.py"):
        assert [f for f in findings(_SA012_BAD, relpath)
                if f.rule == "SA012"] == []


def test_sa012_real_commit_path_modules_are_clean():
    import pathlib

    import coreth_tpu_torch.ops.keccak_resident as kr
    import coreth_tpu_torch.parallel as par

    for mod, rel in ((kr, "PKG/ops/keccak_resident.py"),
                     (par, "PKG/parallel/__init__.py")):
        src = pathlib.Path(mod.__file__).read_text()
        assert [f for f in findings(src, rel) if f.rule == "SA012"] == []


# ------------------------------------------------------------ repo gate

def test_repo_is_clean_modulo_baseline():
    """THE tier-1 gate: zero findings outside the port's checked-in
    allowlist, and no stale allowlist entries masking future
    regressions."""
    new, _suppressed, unused, _baseline = run_repo()
    assert new == [], "new findings:\n" + "\n".join(f.render() for f in new)
    assert unused == [], f"stale baseline entries: {unused}"


def test_baseline_requires_justifications(tmp_path):
    bad = tmp_path / "baseline.txt"
    bad.write_text("SA001 coreth_tpu_torch/x.py:f\n")
    with pytest.raises(BaselineError):
        load_baseline(bad)


def test_cli_exits_zero_on_clean_repo():
    proc = _cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------ interprocedural layer

def _check_program(srcs):
    """Full multi-file pipeline: per-file rules, cross-file finalize, and
    finalize_program over the linked call graph."""
    eng = Engine(default_rules())
    out = eng.check_program(
        [(textwrap.dedent(at(PORT, s)), at(PORT, rel)) for s, rel in srcs])
    return out, eng


_CYCLE_A = """
import threading

from .b import B


class A:
    def __init__(self):
        self.mu = threading.Lock()
        self.b = B()

    def step(self):
        with self.mu:
            self.b.poke()
"""

_CYCLE_B = """
import threading

from .c import C


class B:
    def __init__(self):
        self.mu = threading.Lock()
        self.c = C()

    def poke(self):
        with self.mu:
            self.c.kick()
"""

_CYCLE_C_BAD = """
import threading

from .a import A


class C:
    def __init__(self):
        self.mu = threading.Lock()
        self.a: A = None

    def kick(self):
        with self.mu:
            self.a.step()
"""

_CYCLE_C_GOOD = """
import threading


class C:
    def __init__(self):
        self.mu = threading.Lock()

    def kick(self):
        with self.mu:
            pass
"""


def test_sa013_fires_on_three_lock_cycle_across_three_files():
    out, _eng = _check_program([
        (_CYCLE_A, "PKG/fx/a.py"),
        (_CYCLE_B, "PKG/fx/b.py"),
        (_CYCLE_C_BAD, "PKG/fx/c.py"),
    ])
    sa13 = [f for f in out if f.rule == "SA013"]
    assert len(sa13) == 1, out
    msg = sa13[0].message
    # all three locks are entangled (the rendered concrete cycle may be
    # a transitive shortcut, but the SCC names every participant)
    for lock in ("A.mu", "B.mu", "C.mu"):
        assert lock in msg
    # the witness names every file (with line numbers) and every fn hop
    for rel in ("coreth_tpu_torch/fx/a.py", "coreth_tpu_torch/fx/b.py",
                "coreth_tpu_torch/fx/c.py"):
        assert rel in msg
    for fn in ("A.step", "B.poke", "C.kick"):
        assert fn in msg


def test_sa013_quiet_on_consistent_nesting():
    out, eng = _check_program([
        (_CYCLE_A, "PKG/fx/a.py"),
        (_CYCLE_B, "PKG/fx/b.py"),
        (_CYCLE_C_GOOD, "PKG/fx/c.py"),
    ])
    assert [f for f in out if f.rule == "SA013"] == []
    # ...while the acyclic nesting is still observed as edges
    edges = eng.program.lock_edges()
    assert ("A.mu", "B.mu") in edges
    assert ("B.mu", "C.mu") in edges


_HOT_CALLER = """
from .util import stamp


# hot-path
def step(batch):
    return stamp(batch)
"""

_UTIL_IMPURE = """
import time


def stamp(batch):
    return (time.time(), batch)
"""

_UTIL_PURE = """
def stamp(batch):
    return (len(batch), batch)
"""

_HOT_CALLER_EXEMPT = """
from ..metrics.fxutil import stamp


# hot-path
def step(batch):
    return stamp(batch)
"""


def test_sa003_promotion_fires_on_impure_transitive_callee():
    out, _eng = _check_program([
        (_HOT_CALLER, "PKG/fx/hot.py"),
        (_UTIL_IMPURE, "PKG/fx/util.py"),
    ])
    sa3 = [f for f in out if f.rule == "SA003"]
    assert len(sa3) == 1, out
    f = sa3[0]
    # the finding lands on the impure callee, with the hot chain spelled
    assert f.path == "coreth_tpu_torch/fx/util.py"
    assert "wall-clock" in f.message
    assert "step" in f.message and "stamp" in f.message


def test_sa003_promotion_quiet_on_pure_callee_and_exempt_path():
    out, _eng = _check_program([
        (_HOT_CALLER, "PKG/fx/hot.py"),
        (_UTIL_PURE, "PKG/fx/util.py"),
    ])
    assert [f for f in out if f.rule == "SA003"] == []
    # gated observability packages are exempt from the promotion
    out, _eng = _check_program([
        (_HOT_CALLER_EXEMPT, "PKG/fx/hot.py"),
        (_UTIL_IMPURE, "PKG/metrics/fxutil.py"),
    ])
    assert [f for f in out if f.rule == "SA003"] == []


_ETH_ENTRY = """
from ..core.helper import tip_sync


def blockNumber(chain):
    return tip_sync(chain)
"""

_CORE_HELPER_BAD = """
def tip_sync(chain):
    return chain.accept(None)
"""

_CORE_HELPER_GOOD = """
def tip_sync(chain):
    return chain.read_view().accepted
"""

_CORE_CHAIN_FX = """
import threading


class BlockChain:
    def __init__(self):
        self.chainmu = threading.RLock()

    def accept(self, block):
        with self.chainmu:
            return block

    def read_view(self):
        return self
"""


def test_sa010_promotion_fires_on_transitive_chainmu_reach():
    out, _eng = _check_program([
        (_ETH_ENTRY, "PKG/eth/api.py"),
        (_CORE_HELPER_BAD, "PKG/core/helper.py"),
        (_CORE_CHAIN_FX, "PKG/core/chainfx.py"),
    ])
    sa10 = [f for f in out if f.rule == "SA010"]
    assert len(sa10) == 1, out
    f = sa10[0]
    # anchored at the read-tier ENTRY (stable baseline key in eth/)
    assert f.path == "coreth_tpu_torch/eth/api.py"
    assert f.qualname == "blockNumber"
    assert "tip_sync" in f.message and "chainmu" in f.message


def test_sa010_promotion_quiet_on_view_resolving_helper():
    out, _eng = _check_program([
        (_ETH_ENTRY, "PKG/eth/api.py"),
        (_CORE_HELPER_GOOD, "PKG/core/helper.py"),
        (_CORE_CHAIN_FX, "PKG/core/chainfx.py"),
    ])
    assert [f for f in out if f.rule == "SA010"] == []


_WORKER_FX = """
def handle(req):
    from .wutil import go

    return go(req)
"""

_WUTIL_BAD = """
from ..metrics import default_registry


def go(req):
    return req
"""

_WUTIL_GOOD = """
def go(req):
    return req
"""


def test_sa011_promotion_fires_on_closure_dragging_metrics():
    out, _eng = _check_program([
        (_WORKER_FX, "PKG/core/shard_worker.py"),
        (_WUTIL_BAD, "PKG/core/wutil.py"),
    ])
    sa11 = [f for f in out if f.rule == "SA011"]
    assert len(sa11) == 1, out
    f = sa11[0]
    # anchored at the chain's root inside the worker, full module chain
    assert f.path == "coreth_tpu_torch/core/shard_worker.py"
    assert "coreth_tpu_torch.metrics" in f.message
    assert "wutil" in f.message


def test_sa011_promotion_quiet_on_clean_closure():
    out, _eng = _check_program([
        (_WORKER_FX, "PKG/core/shard_worker.py"),
        (_WUTIL_GOOD, "PKG/core/wutil.py"),
    ])
    assert [f for f in out if f.rule == "SA011"] == []


# ----------------------------- static order vs runtime witness constant

def test_canonical_lock_order_matches_static_graph():
    """Pin the port's racecheck.CANONICAL_LOCK_ORDER against the port's
    lock graph: the graph must be acyclic, every statically observed
    edge between constant members must agree with the constant's order,
    and the core chainmu nesting must actually be in the graph (so this
    test cannot silently pass on an empty analysis)."""
    from coreth_tpu_torch.utils.racecheck import CANONICAL_LOCK_ORDER

    eng = Engine(default_rules())
    run_repo(engine=eng)
    program = eng.program
    assert program is not None
    assert program.lock_cycles() == []
    edges = program.lock_edges()
    assert ("BlockChain.chainmu", "BlockChain._view_mu") in edges
    rank = {n: i for i, n in enumerate(CANONICAL_LOCK_ORDER)}
    bad = [(a, b) for (a, b) in edges
           if a in rank and b in rank and rank[a] >= rank[b]]
    assert bad == [], \
        f"static lock edges contradict CANONICAL_LOCK_ORDER: {bad}"


def test_cli_graph_mode_prints_lock_graph():
    proc = _cli("--graph", "locks")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "lock-order graph:" in proc.stdout
    assert "BlockChain.chainmu -> BlockChain._view_mu" in proc.stdout


def test_cli_graph_mode_prints_function_lock_sets():
    proc = _cli("--graph", "BlockChain.insert_block")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BlockChain.chainmu" in proc.stdout
    assert "->" in proc.stdout  # callees are listed


# ------------------------------------------------------- SA014

_SA014_BAD_LITERAL = """
def setup(registry):
    registry.counter("Chain/Blocks").inc()
    registry.timer("lock/BlockChain.chainmu/hold")
"""

_SA014_BAD_FSTRING = """
def setup(registry, i):
    registry.counter(f"exec/shard/Worker-{i}/txs").inc()
"""

_SA014_GOOD = """
def setup(registry, role, depth):
    registry.counter("exec/shard/dispatches").inc()
    registry.counter(f"profile/samples/{role}").inc()
    registry.counter("exec/shard/worker/" + role + "/txs").inc()
    registry.timer("chain/phase/verify")
    registry.histogram("slo/rpc/eth_call")
    registry.gauge(depth)  # pure variable: uncheckable, not flagged
"""

_SA014_HOSTILE = """
def setup(registry):
    registry.counter("Totally.Hostile:Name").inc()
"""

SA014_EXEMPT = ("PKG/metrics/__main__.py", "PKG/utils/racecheck.py")


def test_sa014_fires_on_bad_literal_family_name():
    out = [f for f in findings(_SA014_BAD_LITERAL) if f.rule == "SA014"]
    assert len(out) == 2
    assert "family grammar" in out[0].message
    assert "silently colliding" in out[0].message


def test_sa014_fires_on_bad_fstring_fragment():
    out = [f for f in findings(_SA014_BAD_FSTRING) if f.rule == "SA014"]
    assert len(out) == 1
    assert "fragment" in out[0].message


def test_sa014_quiet_on_grammar_conformant_names():
    assert [f for f in findings(_SA014_GOOD) if f.rule == "SA014"] == []


def test_sa014_exempts_metrics_and_racecheck_internals():
    # metrics/ registers deliberately hostile names in its own self-check
    # and racecheck derives `lock/<Owner.attr>` names from attribute
    # spellings; both are the sanitizer's own test surface
    for relpath in SA014_EXEMPT:
        assert [f for f in findings(_SA014_HOSTILE, relpath)
                if f.rule == "SA014"] == []
    assert [f for f in findings(_SA014_HOSTILE, "PKG/core/blockchain.py")
            if f.rule == "SA014"]


_SA014_DUP_A = """
def setup(reg):
    reg.counter("exec/conflicts").inc()
"""

_SA014_DUP_B = """
def setup(reg):
    reg.timer("exec/conflicts")
"""


def test_sa014_cross_file_type_collision():
    out, _eng = _check_program([
        (_SA014_DUP_A, "PKG/fx/ma.py"),
        (_SA014_DUP_B, "PKG/fx/mb.py"),
    ])
    sa14 = [f for f in out if f.rule == "SA014"]
    assert len(sa14) == 1, out
    msg = sa14[0].message
    assert "exec/conflicts" in msg
    assert "registered as counter" in msg
    assert "timer at coreth_tpu_torch/fx/mb.py" in msg


def test_sa014_quiet_on_same_type_across_files():
    out, _eng = _check_program([
        (_SA014_DUP_A, "PKG/fx/ma.py"),
        (_SA014_DUP_A, "PKG/fx/mb.py"),
    ])
    assert [f for f in out if f.rule == "SA014"] == []


# ------------------------------------------- SA011 allowlist

SA011_SHARDSTATS = [
    "from ..metrics.shardstats import ShardStats",
    "from PKG.metrics.shardstats import ShardStats",
    "import PKG.metrics.shardstats",
    "from ..metrics import shardstats",
]


def _sa011_allowlisted(imp):
    return f"""
{imp}

def handle(conn, req):
    conn.send(("done", None))
"""


_SA011_MIXED = """
from ..metrics import shardstats, tracectx

def handle(conn, req):
    pass
"""


@pytest.mark.parametrize("imp", SA011_SHARDSTATS)
def test_sa011_allowlists_shardstats_spellings(imp):
    """metrics.shardstats is fork-clean by design (stdlib-only, no
    module state) and explicitly allowlisted in every import spelling;
    the rest of the metrics package stays banned."""
    assert [f for f in findings(_sa011_allowlisted(imp), _SA011_PATH)
            if f.rule == "SA011"] == []


def test_sa011_mixed_import_with_banned_sibling_still_fires():
    out = [f for f in findings(_SA011_MIXED, _SA011_PATH)
           if f.rule == "SA011"]
    # both the banned-package check and the module-scope project-import
    # check fire on the line; the point is it is NOT silently allowlisted
    assert out
    assert any("metrics" in f.message for f in out)


# ------------------------------------------ parity with the reference

# Each case: ("source", [(src, relpath)]) runs the sources one by one
# through check_source plus the cross-file finalize (SA006's registry
# and SA014's families); ("program", ...) runs the full pipeline.
PARITY_CORPUS = (
    [("source", [(s, "PKG/fixture.py")]) for s in (
        _SA001_SILENT, _SA001_NARROW, _SA002_ANNOTATED, _SA002_INCONSISTENT,
        _SA002_QUIET, _SA003_WALLCLOCK, _SA003_RANDOM_CTYPES, _SA003_OFF_HOT,
        _SA003_COLD, _SA003_HOT_CLEAN, _SA014_BAD_LITERAL,
        _SA014_BAD_FSTRING, _SA014_GOOD, _SA006_COMPUTED, _SA006_FN_SCOPE,
        _SA006_GHOST)]
    + [("source", [(_sa001_handled(b), "PKG/fixture.py")])
       for b in SA001_HANDLED]
    + [("source", [(_sa003_construction(c), "PKG/fixture.py")])
       for c in SA003_CONSTRUCTIONS]
    + [("source", [(_sa003_gated(c), "PKG/fixture.py")])
       for c in SA003_GATED]
    + [("source", [(_SA004_FLOAT, "PKG/evm/gas.py")]),
       ("source", [(_SA004_EMA, "PKG/metrics/fixture.py")]),
       ("source", [(_SA004_INT, "PKG/evm/gas.py")]),
       ("source", [(_SA005_SET, "PKG/trie/fixture.py")]),
       ("source", [(_SA005_SORTED, "PKG/trie/fixture.py")]),
       ("source", [(_SA006_DUP_A, "PKG/a.py"), (_SA006_DUP_B, "PKG/b.py")]),
       ("source", [(_SA006_REG_OK, "PKG/a.py"),
                   (_SA006_FIRE_OK, "PKG/b.py")]),
       ("source", [(_SA006_FAULT_SLEEP, "PKG/fault/__init__.py")])]
    + [("source", [(_sa006_sleep(b), "PKG/peer/fixture.py")])
       for b in SA006_SLEEPS]
    + [("source", [(_SA007_BAD, r)]) for r in SA007_SERVING]
    + [("source", [(_SA007_BAD, "PKG/ethclient/fixture.py")]),
       ("source", [(_SA007_BOUNDED, "PKG/rpc/fixture.py")]),
       ("source", [(_SA007_NONE, "PKG/rpc/fixture.py")]),
       ("source", [(_SA008_BINTRIE_MPT, "PKG/bintrie/fixture.py")]),
       ("source", [(_SA008_MPT_BINTRIE, "PKG/trie/fixture.py")]),
       ("source", [(_SA008_RELATIVE, "PKG/bintrie/fixture.py")]),
       ("source", [(_SA008_SHARED, "PKG/bintrie/fixture.py")]),
       ("source", [(_SA008_SEAM, "PKG/state/fixture.py")]),
       ("source", [(_SA010_VIEW, "PKG/eth/api.py")])]
    + [("source", [(_SA010_BAD, r)])
       for r in SA010_READ_TIER + list(SA010_WRITERS)]
    + [("source", [(s, _SA011_PATH)]) for s in (
        _SA011_BAD, _SA011_LAZY, _SA011_CLEAN, _SA011_MIXED)]
    + [("source", [(_sa011_allowlisted(i), _SA011_PATH)])
       for i in SA011_SHARDSTATS]
    + [("source", [(_SA011_BAD, r)]) for r in SA011_PARENT_MODULES]
    + [("source", [(_SA014_HOSTILE, r)])
       for r in SA014_EXEMPT + ("PKG/core/blockchain.py",)]
    + [("program", srcs) for srcs in (
        [(_CYCLE_A, "PKG/fx/a.py"), (_CYCLE_B, "PKG/fx/b.py"),
         (_CYCLE_C_BAD, "PKG/fx/c.py")],
        [(_CYCLE_A, "PKG/fx/a.py"), (_CYCLE_B, "PKG/fx/b.py"),
         (_CYCLE_C_GOOD, "PKG/fx/c.py")],
        [(_HOT_CALLER, "PKG/fx/hot.py"), (_UTIL_IMPURE, "PKG/fx/util.py")],
        [(_HOT_CALLER, "PKG/fx/hot.py"), (_UTIL_PURE, "PKG/fx/util.py")],
        [(_HOT_CALLER_EXEMPT, "PKG/fx/hot.py"),
         (_UTIL_IMPURE, "PKG/metrics/fxutil.py")],
        [(_ETH_ENTRY, "PKG/eth/api.py"),
         (_CORE_HELPER_BAD, "PKG/core/helper.py"),
         (_CORE_CHAIN_FX, "PKG/core/chainfx.py")],
        [(_ETH_ENTRY, "PKG/eth/api.py"),
         (_CORE_HELPER_GOOD, "PKG/core/helper.py"),
         (_CORE_CHAIN_FX, "PKG/core/chainfx.py")],
        [(_WORKER_FX, "PKG/core/shard_worker.py"),
         (_WUTIL_BAD, "PKG/core/wutil.py")],
        [(_WORKER_FX, "PKG/core/shard_worker.py"),
         (_WUTIL_GOOD, "PKG/core/wutil.py")],
        [(_SA014_DUP_A, "PKG/fx/ma.py"), (_SA014_DUP_B, "PKG/fx/mb.py")],
        [(_SA014_DUP_A, "PKG/fx/ma.py"), (_SA014_DUP_A, "PKG/fx/mb.py")],
    )]
)


def _run_corpus(pkg, engine_cls, rules):
    """Every corpus case through fresh engines of one package; returns
    {(case, rule, relpath with the package named PKG, qualname, line)}
    without SA012."""
    got = set()
    for i, (kind, srcs) in enumerate(PARITY_CORPUS):
        placed = [(textwrap.dedent(at(pkg, s)), at(pkg, r)) for s, r in srcs]
        eng = engine_cls(rules())
        if kind == "program":
            out = eng.check_program(placed)
        else:
            out = []
            for text, rel in placed:
                out.extend(eng.check_source(text, rel))
            for rule in eng.rules:
                out.extend(rule.finalize())
        for f in out:
            assert f.path.startswith(pkg + "/"), f.path
            if f.rule != "SA012":
                got.add((i, f.rule, "PKG" + f.path[len(pkg):], f.qualname,
                         f.line))
    return got


def test_parity_with_the_reference_engine_on_the_shared_corpus():
    """One corpus, both engines: the reference's on coreth_tpu/ relpaths,
    the port's on coreth_tpu_torch/ ones, the same findings (rule,
    mapped relpath, qualname, line), SA012 apart."""
    from coreth_tpu.analysis.engine import Engine as RefEngine
    from coreth_tpu.analysis.rules import default_rules as ref_rules

    port = _run_corpus(PORT, Engine, default_rules)
    ref = _run_corpus(REF, RefEngine, ref_rules)
    assert port == ref, (sorted(port - ref), sorted(ref - port))
    # the corpus exercises every rule the two packages share
    assert {r for _, r, _, _, _ in port} == {
        f"SA{n:03d}" for n in range(1, 15)} - {"SA009", "SA012"}


def test_rule_table_matches_the_reference_but_sa012():
    from coreth_tpu.analysis.rules import ALL_RULES as REF_RULES

    from coreth_tpu_torch.analysis.rules import ALL_RULES

    assert [c.id for c in ALL_RULES] == [c.id for c in REF_RULES]
    for mine, ref in zip(ALL_RULES, REF_RULES):
        assert (mine.title == ref.title) == (mine.id != "SA012"), mine.id
        assert mine.__name__ == ref.__name__
    proc = _cli("--list-rules")
    assert proc.returncode == 0, proc.stderr
    assert "SA012  commit-path tensor placed without an explicit device" \
        in proc.stdout


def test_cache_takes_its_own_variable_and_stem(tmp_path, monkeypatch):
    from coreth_tpu.analysis.cache import default_cache_path as ref_path

    from coreth_tpu_torch.analysis.cache import default_cache_path

    root = tmp_path / "pkg"
    monkeypatch.delenv(CACHE_VAR)
    monkeypatch.delenv("CORETH_TPU_ANALYSIS_CACHE", raising=False)
    mine, theirs = default_cache_path(root), ref_path(root)
    assert mine.name.startswith("coreth-tpu-torch-analysis-")
    assert mine != theirs
    monkeypatch.setenv("CORETH_TPU_ANALYSIS_CACHE", str(tmp_path / "ref"))
    assert default_cache_path(root) == mine  # the reference's var is ignored
    monkeypatch.setenv(CACHE_VAR, "off")
    assert default_cache_path(root) is None
    monkeypatch.setenv(CACHE_VAR, str(tmp_path / "mine.pkl"))
    assert default_cache_path(root) == tmp_path / "mine.pkl"


def test_baseline_is_the_ports_own_and_every_entry_is_justified():
    from coreth_tpu_torch.analysis import BASELINE_PATH, PACKAGE_ROOT

    assert PACKAGE_ROOT.name == "coreth_tpu_torch"
    assert BASELINE_PATH.parent == PACKAGE_ROOT / "analysis"
    entries = load_baseline(BASELINE_PATH)
    assert entries and all(k.split(":")[1].startswith("coreth_tpu_torch/")
                           for k in entries)
    assert all(len(why) > 20 for why in entries.values())


@pytest.mark.parametrize("args,rc,needle", [
    (("--strict-baseline",), 0, "0 finding(s)"),
    (("--json", "--strict-baseline"), 0, '"unused_baseline": []'),
    (("--no-baseline",), 1, "SA006"),
])
def test_cli_flags_and_exit_codes(args, rc, needle):
    proc = _cli(*args)
    assert proc.returncode == rc, proc.stdout + proc.stderr
    assert needle in proc.stdout + proc.stderr


def test_cli_refuses_a_baseline_without_justification(tmp_path):
    bad = tmp_path / "baseline.txt"
    bad.write_text("SA001 coreth_tpu_torch/vm/api.py:AdminAPI.memoryProfile\n")
    proc = _cli("--baseline", str(bad))
    assert proc.returncode == 2
    assert "baseline error" in proc.stderr
