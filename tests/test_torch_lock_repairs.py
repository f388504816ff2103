"""The port-only lock-discipline findings of the port's static-analysis
gate (SA002), repaired: each test holds the behaviour the lock buys.

- peer/network.py:Network._executor makes its pool under `self.lock`,
  the lock close() swaps it under: racing first calls leave one pool.
- core/blockchain.py:BlockChain._on_device_event tests and clears
  `_mirror_degraded` under chainmu, where take_over_host sets it: two
  promote events reboot the mirror once.
"""

import threading
import time
from concurrent import futures

from coreth_tpu_torch import params
from coreth_tpu_torch.consensus.dummy import new_dummy_engine
from coreth_tpu_torch.core.blockchain import BlockChain, CacheConfig
from coreth_tpu_torch.core.genesis import Genesis
from coreth_tpu_torch.ethdb import MemoryDB
from coreth_tpu_torch.peer.network import Network

JOIN_S = 10.0


def _run_together(n, fn):
    """fn() on n threads released at once; returns their results."""
    barrier = threading.Barrier(n)
    out = [None] * n

    def run(i):
        barrier.wait(JOIN_S)
        out[i] = fn()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
        assert not t.is_alive(), "a racing call did not return"
    return out


def test_racing_first_calls_leave_one_pool_and_close_joins_it(monkeypatch):
    class SlowPool(futures.ThreadPoolExecutor):
        """A pool slow to make, so that racing first calls overlap."""

        def __init__(self, *args, **kwargs):
            time.sleep(0.02)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(futures, "ThreadPoolExecutor", SlowPool)
    before = set(threading.enumerate())
    net = Network()
    pools = _run_together(8, net._executor)
    assert len({id(p) for p in pools}) == 1
    # the pool's workers start on demand: put each one to work
    futs = [pools[0].submit(time.sleep, 0.01) for _ in range(32)]
    for f in futs:
        f.result(JOIN_S)
    assert any(t.name.startswith("peer-net") for t in threading.enumerate())
    net.close()
    left = [t.name for t in set(threading.enumerate()) - before
            if t.name.startswith("peer-net")]
    assert left == []


def test_two_promote_events_reboot_the_mirror_once(monkeypatch):
    chain = BlockChain(MemoryDB(), CacheConfig(), params.TEST_CHAIN_CONFIG,
                       Genesis(config=params.TEST_CHAIN_CONFIG, alloc={}),
                       new_dummy_engine(), device="cpu")
    try:
        reboots = []

        def reboot():
            reboots.append(threading.get_ident())
            time.sleep(0.05)  # hold chainmu while the other event waits

        monkeypatch.setattr(chain, "reboot_mirror", reboot)
        with chain.chainmu:
            chain._mirror_degraded = True
        _run_together(2, lambda: chain._on_device_event("promote", {}))
        assert len(reboots) == 1
        assert chain._mirror_degraded is False
        kinds = [e["event"] for e in chain.flight_recorder.events()]
        assert kinds.count("device/promote") == 2
        assert kinds.count("mirror/reboot") == 1
    finally:
        chain.stop()
