"""The port stands alone: it imports neither jax/jaxlib nor anything of
coreth_tpu, and without CUDA its entry points raise instead of drifting to
the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from coreth_tpu_torch import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "coreth_tpu")

_CHILD = r'''
import sys

FORBIDDEN = ("jax", "jaxlib", "coreth_tpu")


def refused(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


class Refuse:
    def find_spec(self, name, path=None, target=None):
        if refused(name):
            raise ImportError(f"the port must not import {name}")
        return None


loaded = [m for m in sys.modules if refused(m)]
assert not loaded, f"already imported before the port: {loaded}"
sys.meta_path.insert(0, Refuse())

import random

import coreth_tpu_torch
from coreth_tpu_torch.ops.keccak_planned import PlannedCommit, PlannedMode
from coreth_tpu_torch.state.account import Account
from coreth_tpu_torch.state.statedb import planned_intermediate_root
from coreth_tpu_torch.trie.hasher import Hasher
from coreth_tpu_torch.trie.node import EMPTY_ROOT
from coreth_tpu_torch.trie.secure import StateTrie
from coreth_tpu_torch.trie.trie import trie_from_items
from coreth_tpu_torch.native import keccak256
from coreth_tpu_torch import rlp

rng = random.Random(3)
commit = PlannedCommit(device="cpu")
mode = PlannedMode(commit)
acct_trie = StateTrie(batch_keccak=mode)
changed, oracle = {}, []
for i in range(150):
    addr = rng.randbytes(20)
    st, root = None, EMPTY_ROOT
    if i < 3:
        st = StateTrie(batch_keccak=mode)
        slots = [(rng.randbytes(32), rlp.encode(rng.randbytes(20)))
                 for _ in range(30)]
        for k, v in slots:
            st.update(k, v)
        t = trie_from_items((keccak256(k), v) for k, v in slots)
        root = bytes(Hasher().hash(t.root, True)[0])
    a = Account(nonce=i, balance=10**18 + i)
    changed[addr] = (a, st)
    oracle.append((keccak256(addr),
                   Account(nonce=i, balance=10**18 + i, root=root).encode()))
got = planned_intermediate_root(acct_trie, changed, planned=commit)
want = bytes(Hasher().hash(trie_from_items(oracle).root, True)[0])
assert got == want, (got.hex(), want.hex())
assert commit.last_dispatches == 1

# the same state through the level-batched ("batched") mode
from coreth_tpu_torch.ops.device import get_batch_keccak
from coreth_tpu_torch.state.statedb import intermediate_root
from coreth_tpu_torch.trie import hasher

bmode = get_batch_keccak("batched", device="cpu")
rng = random.Random(3)
acct_trie = StateTrie(batch_keccak=bmode)
changed = {}
for i in range(150):
    addr = rng.randbytes(20)
    st = None
    if i < 3:
        st = StateTrie(batch_keccak=bmode)
        for k, v in [(rng.randbytes(32), rlp.encode(rng.randbytes(20)))
                     for _ in range(30)]:
            st.update(k, v)
    changed[addr] = (Account(nonce=i, balance=10**18 + i), st)
before = hasher.keccak_batches
got = intermediate_root(acct_trie, changed, batch_keccak=bmode, device="cpu")
assert got == want, (got.hex(), want.hex())
assert hasher.keccak_batches > before and bmode.batched.launches > 0

# the native incremental trie: one resident commit and one commit_device
from coreth_tpu_torch.native.mpt import IncrementalTrie, plan_from_items
from coreth_tpu_torch.ops.keccak_resident import ResidentExecutor

items = [(rng.randbytes(32), rng.randbytes(rng.randint(1, 90)))
         for _ in range(300)]
want = plan_from_items(items).execute_cpu()
res = IncrementalTrie(items)
res.set_lean(True)
ex = ResidentExecutor(device="cpu")
assert ex.root_bytes(res.commit_resident(ex)) == want
host = IncrementalTrie(items)
assert host.commit_device(device="cpu") == want == host.commit_cpu()
leaked = [m for m in sys.modules if refused(m)]
assert not leaked, leaked
print("ISOLATED-OK")
'''


def test_port_runs_the_slice_without_jax_or_coreth_tpu():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ISOLATED-OK" in r.stdout


def _sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "coreth_tpu_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_no_source_imports_jax_or_coreth_tpu():
    bad = []
    for path in _sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                if n.split(".")[0] in FORBIDDEN:
                    bad.append(f"{os.path.relpath(path, REPO)}:{node.lineno} {n}")
    assert len(_sources()) > 10
    assert not bad, bad


def test_resolve_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve(None)
    with pytest.raises(RuntimeError):
        device.resolve("cuda")
    assert device.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        device.resolve("meta")
    assert device.hopper_available() is False


def test_entry_points_without_cuda_raise(monkeypatch):
    from coreth_tpu_torch.ops.keccak_planned import PlannedCommit, PlannedMode

    from coreth_tpu_torch.ops.device import get_batch_keccak
    from coreth_tpu_torch.ops.keccak_torch import BatchedKeccak, \
        keccak256_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        PlannedCommit()
    with pytest.raises(RuntimeError):
        PlannedMode()
    with pytest.raises(RuntimeError):
        BatchedKeccak()
    with pytest.raises(RuntimeError):
        keccak256_batch([b"abc"])
    for mode in ("batched", "planned", "auto"):
        with pytest.raises(RuntimeError):
            get_batch_keccak(mode)
    assert get_batch_keccak("off") is None


def test_resident_entry_points_without_cuda_raise(monkeypatch):
    """The resident executor, commit_device and the resident block commit
    default to CUDA and raise without it; none falls to the CPU."""
    from coreth_tpu_torch.native.mpt import IncrementalTrie
    from coreth_tpu_torch.ops.keccak_resident import ResidentExecutor
    from coreth_tpu_torch.state.account import Account
    from coreth_tpu_torch.trie.secure import StateTrie
    from coreth_tpu_torch.state.statedb import batch_storage_roots, \
        resident_intermediate_root

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResidentExecutor()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResidentExecutor(pipeline_depth=2)
    t = IncrementalTrie([(b"\x01" * 32, b"v" * 40), (b"\x02" * 32, b"w")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t.commit_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resident_intermediate_root(t, None, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resident_intermediate_root(IncrementalTrie(), None, {})
    # nothing was hashed on the way: the trie is still dirty and unpinned
    assert t.commit_cpu() == IncrementalTrie(
        [(b"\x01" * 32, b"v" * 40), (b"\x02" * 32, b"w")]).commit_cpu()
    st = StateTrie()
    for i in range(120):
        st.update(bytes([i]) * 32, b"\x01" * 20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch_storage_roots({b"\x03" * 20: (Account(), st)})
    assert st.trie.unhashed == 120  # left to the trie's own hash()
