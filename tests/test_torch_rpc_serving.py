"""The port's RPC admission tier (coreth_tpu_torch/rpc/admission.py and
rpc/server.py) against the JAX package's: the deterministic cases of
tests/test_rpc_overload.py — shed at capacity, cooperative deadlines, the
expensive-method circuit breaker, the eth_getLogs range guard, batch and
body caps, HTTP status codes and graceful drain.

Each scenario runs once on each package with the same inputs and
returns what a client sees (the decoded JSON answers, HTTP statuses,
drain reports, breaker states); the two records must be equal, and the
port's must hold what the reference's tests assert. Arrivals are ordered
with failpoints (`hang` parks a worker as a wedged handler would), and
waits poll through the fault package's Backoff.
"""

import importlib
import json
import re
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

PKGS = ("coreth_tpu", "coreth_tpu_torch")


class Pkg:
    """One package's serving modules."""

    def __init__(self, name):
        def m(mod):
            return importlib.import_module(f"{name}.{mod}")

        self.name = name
        self.fault = m("fault")
        self.registry = m("metrics").default_registry
        self.adm = m("rpc.admission")
        self.server = m("rpc.server")
        self.dl = m("utils.deadline")
        self.filters = m("eth.filters")
        self.config = m("vm.config")

    def count(self, name):
        return self.registry.counter(name).count()

    def fired(self, name):
        return next((a["fired"] for a in self.fault.list_armed()
                     if a["name"] == name), 0)

    def poll(self, pred, what=""):
        b = self.fault.Backoff(base=0.005, factor=1.3, cap=0.1, jitter=0.0)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if pred():
                return
            b.sleep()
        raise AssertionError(f"timed out waiting for {what or pred}")

    def srv(self, **policy_kw):
        s = self.server.RPCServer(policy=self.adm.ServingPolicy(**policy_kw))
        s.register("eth", "ping", lambda: "pong")
        s.register("eth", "getLogs", lambda *a: [])  # expensive lane
        return s


@pytest.fixture
def both():
    pkgs = [Pkg(p) for p in PKGS]
    yield pkgs
    for p in pkgs:
        p.fault.clear_all()


def req(method, params=None, rid=1):
    return json.dumps({"jsonrpc": "2.0", "id": rid, "method": method,
                       "params": params or []}).encode()


def rpc(srv, method, params=None, rid=1, meta=None):
    """The decoded answer, its trace ids (minted per process) left out."""
    return scrub(json.loads(srv.handle_raw(req(method, params, rid), meta)))


def scrub(out):
    err = out.get("error")
    if isinstance(err, dict):
        if isinstance(err.get("data"), dict):
            err["data"].pop("traceId", None)
        err["message"] = re.sub(r"\[trace rpc-[0-9a-f-]+\]", "[trace]",
                                err["message"])
    return out


def twin(both, scenario):
    """scenario(pkg) on each package; the records, equal."""
    got = [scenario(p) for p in both]
    assert got[1] == got[0], got
    return got[1]


# --- lanes, shedding, deadlines -------------------------------------------


def test_lane_classification_and_budgets(both):
    methods = ("eth_call", "eth_getLogs", "eth_estimateGas",
               "debug_traceTransaction", "eth_getProof", "eth_feeHistory",
               "eth_blockNumber", "eth_getBalance", "net_version",
               "debug_metrics", "txpool_status", "admin_importChain",
               "avax_issueTx", "eth_sendRawTransaction")

    def scenario(p):
        pol = p.adm.ServingPolicy(max_workers=0, cheap_budget=1.0,
                                  expensive_budget=2.0)
        return [(m, p.adm.is_expensive(m), pol.budget_for(m))
                for m in methods]

    rec = twin(both, scenario)
    assert ("eth_getProof", True, 2.0) in rec
    assert ("avax_issueTx", False, 0.0) in rec  # never aborted mid-mutation


def test_full_queue_sheds_minus_32005_fast(both):
    def scenario(p):
        srv = p.srv(max_workers=1, queue_size=1, expensive_workers=1,
                    expensive_queue_size=1)
        shed_before = p.count("rpc/shed/queue_full")
        p.fault.set_failpoint("rpc/before_dispatch", "hang")
        results = {}

        def call(key):
            results[key] = rpc(srv, "eth_ping", rid=key)

        t1 = threading.Thread(target=call, args=(1,), daemon=True)
        t1.start()
        p.poll(lambda: p.fired("rpc/before_dispatch") >= 1, "parked")
        t2 = threading.Thread(target=call, args=(2,), daemon=True)
        t2.start()
        p.poll(lambda: srv.policy.cheap_pool.busy() >= 2, "queued")
        t0 = time.monotonic()
        meta = {}
        shed = rpc(srv, "eth_ping", rid=3, meta=meta)
        assert time.monotonic() - t0 < 1.0, "shed must answer fast"
        p.fault.set_failpoint("rpc/before_dispatch", None)
        t1.join(5)
        t2.join(5)
        out = (shed, meta, p.count("rpc/shed/queue_full") - shed_before,
               results[1], results[2], srv.stop())
        return out

    shed, meta, sheds, r1, r2, report = twin(both, scenario)
    assert shed["error"]["code"] == -32005
    assert "capacity" in shed["error"]["message"]
    assert (meta["status"], meta["retry_after"], sheds) == (429, 1, 1)
    assert r1["result"] == r2["result"] == "pong"
    assert report["drained"] is True


def test_expensive_saturation_leaves_cheap_lane_alone(both):
    def scenario(p):
        srv = p.srv(max_workers=2, queue_size=4, expensive_workers=1,
                    expensive_queue_size=1)
        p.fault.set_failpoint("rpc/before_dispatch_expensive", "hang")
        t = threading.Thread(
            target=lambda: srv.handle_raw(req("eth_getLogs", [{}])),
            daemon=True)
        t.start()
        p.poll(lambda: p.fired("rpc/before_dispatch_expensive") >= 1,
               "expensive worker parked")
        t0 = time.monotonic()
        cheap = rpc(srv, "eth_ping")
        assert time.monotonic() - t0 < 1.0
        p.fault.set_failpoint("rpc/before_dispatch_expensive", None)
        t.join(5)
        return cheap, srv.stop()

    cheap, report = twin(both, scenario)
    assert cheap["result"] == "pong" and report["drained"] is True


def test_slow_handler_times_out_and_frees_worker(both):
    def scenario(p):
        srv = p.server.RPCServer(policy=p.adm.ServingPolicy(
            max_workers=1, queue_size=4, expensive_workers=1,
            expensive_queue_size=1, cheap_budget=0.02))

        def slow_scan():
            p.fault.Backoff(base=0.06, factor=1.0, cap=0.06,
                            jitter=0.0).sleep()
            p.dl.check()  # the cooperative checkpoint mid-"scan"
            return "never"

        srv.register("eth", "slowScan", slow_scan)
        srv.register("eth", "ping", lambda: "pong")
        before = p.count("rpc/timeout")
        out = [rpc(srv, "eth_slowScan"), p.count("rpc/timeout") - before,
               rpc(srv, "eth_ping")]
        srv.stop()
        return out

    slow, timeouts, ping = twin(both, scenario)
    assert slow["error"]["code"] == -32000 and "budget" in \
        slow["error"]["message"]
    assert timeouts == 1 and ping["result"] == "pong"


def test_queue_wait_counts_against_the_budget(both):
    def scenario(p):
        srv = p.srv(max_workers=2, queue_size=4, expensive_workers=1,
                    expensive_queue_size=2, expensive_budget=0.02)
        p.fault.set_failpoint("rpc/before_dispatch_expensive", "hang:80")
        out = rpc(srv, "eth_getLogs", [{}])
        p.fault.set_failpoint("rpc/before_dispatch_expensive", None)
        srv.stop()
        return out

    assert twin(both, scenario)["error"]["code"] == -32000


# --- the circuit breaker ---------------------------------------------------


@pytest.mark.parametrize("steps", [
    # (threshold, probe_every, close_after), then "t"/"o" = record a
    # timeout/ok (probe when the last admit said so), "a" = admit
    ((3, 2, 2), "ta" * 3 + "aa" + "o" + "aa" + "o" + "a"),
    ((1, 1, 2), "t" + "a" + "o" + "t" + "a" + "o" + "a"),
    ((0, 1, 1), "ta" * 10),
], ids=["open-probe-close", "probe-timeout-keeps-open", "threshold-zero"])
def test_breaker_unit_cycle(both, steps):
    (threshold, every, close), script = steps

    def scenario(p):
        br = p.adm.CircuitBreaker(threshold=threshold, probe_every=every,
                                  close_after=close)
        out, probe = [], False
        for s in script:
            if s == "a":
                verdict = br.admit()
                probe = verdict == "probe"
                out.append(verdict)
            else:
                br.record(timed_out=s == "t", probe=probe)
            out.append(br.is_open())
        return out, br.status()

    rec, _ = twin(both, scenario)
    if threshold == 0:
        assert "shed" not in rec and "probe" not in rec
    else:
        assert "shed" in rec or "probe" in rec


def test_breaker_in_server_open_shed_and_reclose(both):
    def scenario(p):
        srv = p.srv(max_workers=2, queue_size=4, expensive_workers=1,
                    expensive_queue_size=4, expensive_budget=0.02,
                    breaker_threshold=2, breaker_probe_every=2,
                    breaker_close_after=1)
        opens = p.count("rpc/breaker/opens")
        closes = p.count("rpc/breaker/closes")
        p.fault.set_failpoint("rpc/before_dispatch_expensive", "hang:60")
        out = [rpc(srv, "eth_getLogs", [{}], rid=r) for r in (1, 2)]
        out.append(srv.policy.breaker.is_open())
        out.append(p.registry.gauge("rpc/breaker/state").value())
        out.append(rpc(srv, "eth_getLogs", [{}], rid=3))  # shed
        p.fault.set_failpoint("rpc/before_dispatch_expensive", None)
        out.append(rpc(srv, "eth_getLogs", [{}], rid=4))  # probe
        out += [srv.policy.breaker.is_open(),
                p.count("rpc/breaker/opens") - opens,
                p.count("rpc/breaker/closes") - closes,
                p.registry.gauge("rpc/breaker/state").value()]
        srv.stop()
        return out

    t1, t2, opened, g1, shed, probe, still, opens, closes, g2 = twin(
        both, scenario)
    assert t1["error"]["code"] == t2["error"]["code"] == -32000
    assert opened and g1 == 1 and shed["error"]["code"] == -32005
    assert "breaker" in shed["error"]["message"]
    assert probe["result"] == [] and not still
    assert (opens, closes, g2) == (1, 1, 0)


# --- the eth_getLogs range guard ------------------------------------------


class _StubChain:
    bloom_indexer = None

    def subscribe_chain_accepted_event(self, cb):
        pass

    def get_block(self, h):
        return None

    def get_block_by_number(self, n):
        return None

    def get_receipts(self, h):
        return []


class _StubBackend:
    def __init__(self, api_max_blocks=0):
        self.chain = _StubChain()
        self.api_max_blocks = api_max_blocks

    def last_accepted_block(self):
        return types.SimpleNamespace(number=99)


@pytest.mark.parametrize("cap,crit,outcome", [
    (4, {"fromBlock": "0x0", "toBlock": "0x9"}, "range"),
    (4, {"fromBlock": "0x0", "toBlock": "0x3"}, "ok"),
    (0, {"fromBlock": "0x0", "toBlock": "0x40"}, "deadline"),
], ids=["oversized-range-sheds", "within-cap-scans", "scan-checks-deadline"])
def test_get_logs_range_guard(both, cap, crit, outcome):
    def scenario(p):
        fs = p.filters.FilterSystem(_StubBackend(api_max_blocks=cap))
        try:
            if outcome == "deadline":
                with p.dl.scope(p.dl.Deadline(0.0)):
                    fs.get_logs(crit)
            return fs.get_logs(crit)
        except p.server.RPCError as e:
            return ["rpc", e.code, str(e)]
        except p.dl.DeadlineExceeded:
            return ["deadline"]

    got = twin(both, scenario)
    if outcome == "range":
        assert got[:2] == ["rpc", -32005] and "range too large" in got[2]
    else:
        assert got == ([] if outcome == "ok" else ["deadline"])


# --- batch and body caps, HTTP --------------------------------------------


@pytest.mark.parametrize("n,body_limit,param", [
    (4, 0, None), (3, 0, None), (1, 64, "x" * 200),
], ids=["batch-over-limit", "batch-at-limit", "body-over-limit"])
def test_batch_and_body_caps(both, n, body_limit, param):
    def scenario(p):
        srv = p.srv(max_workers=0, batch_limit=3, body_limit=body_limit)
        meta = {}
        if param is not None:
            raw = req("eth_ping", [param])
        else:
            raw = json.dumps([json.loads(req("eth_ping", rid=i))
                              for i in range(n)]).encode()
        return json.loads(srv.handle_raw(raw, meta)), meta

    resp, meta = twin(both, scenario)
    if n == 3:
        assert [r["result"] for r in resp] == ["pong"] * 3
    else:
        assert resp["error"]["code"] == -32600
        assert ("body too large" if param else "batch too large") in \
            resp["error"]["message"]
        assert meta == ({"status": 413} if param else {})


def test_ipc_body_cap_and_roundtrip(both, tmp_path):
    import socket

    def scenario(p):
        srv = p.srv(max_workers=1, queue_size=4, expensive_workers=1,
                    expensive_queue_size=1, body_limit=128)
        path = str(tmp_path / f"{p.name}.sock")
        srv.serve_ipc(path)
        out = []
        try:
            for payload in (req("eth_ping"), req("eth_ping", ["y" * 500])):
                with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
                    c.connect(path)
                    c.sendall(payload + b"\n")
                    line = b""
                    while not line.endswith(b"\n"):
                        chunk = c.recv(4096)
                        if not chunk:
                            break
                        line += chunk
                    out.append(json.loads(line))
        finally:
            out.append(srv.stop())
        return out

    ok, big, report = twin(both, scenario)
    assert ok["result"] == "pong" and big["error"]["code"] == -32600
    assert report["drained"] is True


def test_http_200_413_and_breaker_429(both):
    def scenario(p):
        srv = p.srv(max_workers=2, queue_size=4, expensive_workers=1,
                    expensive_queue_size=2, body_limit=4096,
                    breaker_threshold=1, breaker_probe_every=2,
                    breaker_close_after=1)
        url = f"http://127.0.0.1:{srv.serve_http()}"

        def post(body):
            try:
                with urllib.request.urlopen(urllib.request.Request(
                        url, data=body,
                        headers={"Content-Type": "application/json"}),
                        timeout=10) as r:
                    return [r.status, None, json.loads(r.read())]
            except urllib.error.HTTPError as e:
                body = e.read()
                return [e.code, e.headers["Retry-After"],
                        json.loads(body) if body else None]

        try:
            out = [post(req("eth_ping")), post(req("eth_ping", ["z" * 8192]))]
            srv.policy.breaker.record(timed_out=True, probe=False)
            shed = post(req("eth_getLogs", [{}]))
            shed[2]["error"].pop("data", None)
            out.append(shed)
        finally:
            srv.stop()
        return out

    ok, big, shed = twin(both, scenario)
    assert ok[0] == 200 and ok[2]["result"] == "pong"
    assert big[0] == 413
    assert shed[:2] == [429, "1"] and shed[2]["error"]["code"] == -32005


# --- graceful drain --------------------------------------------------------


def test_drain_abandons_wedged_work_and_answers_waiters(both):
    def scenario(p):
        srv = p.srv(max_workers=1, queue_size=2, expensive_workers=1,
                    expensive_queue_size=1)
        p.fault.set_failpoint("rpc/before_dispatch", "hang")
        results = {}

        def call(rid):
            results[rid] = rpc(srv, "eth_ping", rid=rid)

        threads = [threading.Thread(target=call, args=(i,), daemon=True)
                   for i in range(3)]
        threads[0].start()
        p.poll(lambda: p.fired("rpc/before_dispatch") >= 1, "parked")
        for t in threads[1:]:
            t.start()
        p.poll(lambda: srv.policy.cheap_pool.busy() >= 3, "queue loaded")
        before = p.count("rpc/abandoned")
        t0 = time.monotonic()
        report = srv.stop(drain_timeout=0.2)
        assert time.monotonic() - t0 < 2.0, "drain must respect its bound"
        for t in threads:
            t.join(5)
        after = rpc(srv, "eth_ping", rid=9)
        p.fault.set_failpoint("rpc/before_dispatch", None)  # unpark
        return [report, p.count("rpc/abandoned") - before,
                [results[i] for i in range(3)], after]

    report, abandoned, answers, after = twin(both, scenario)
    assert report == {"drained": False, "abandoned": 3,
                      "abandoned_methods": ["eth_ping"] * 3}
    assert abandoned == 3
    for a in answers:
        assert a["error"]["code"] == -32000
        assert "shut down" in a["error"]["message"]
    assert "draining" in after["error"]["message"]


def test_drain_waits_for_inflight_and_leaves_no_worker(both):
    """A clean drain lets the in-flight request finish; the port's also
    joins its lane workers (the reference's are left to exit)."""
    def scenario(p):
        before = set(threading.enumerate())
        srv = p.srv(max_workers=1, queue_size=2, expensive_workers=1,
                    expensive_queue_size=1)
        p.fault.set_failpoint("rpc/before_dispatch", "hang:50")
        results = {}
        t = threading.Thread(
            target=lambda: results.update(ok=rpc(srv, "eth_ping")),
            daemon=True)
        t.start()
        p.poll(lambda: srv.policy.cheap_pool.busy() >= 1, "admitted")
        report = srv.stop(drain_timeout=5.0)
        t.join(5)
        if p.name == "coreth_tpu_torch":
            left = {th for th in set(threading.enumerate()) - before
                    if th.name.startswith("rpc-")}
            assert not left, left
        return [report, results["ok"], srv.stop()]

    report, ok, again = twin(both, scenario)
    assert report == again == {"drained": True, "abandoned": 0,
                               "abandoned_methods": []}
    assert ok["result"] == "pong"


# --- knobs -----------------------------------------------------------------


@pytest.mark.parametrize("blob", [
    b'{"rpc-max-workers": -1}', b'{"rpc-queue-size": 0}',
    b'{"rpc-expensive-workers": 0}', b'{"rpc-breaker-probe-every": 0}',
    b'{"rpc-breaker-close-after": 0}', b'{"rpc-drain-timeout": -1}',
    b'{"api-max-duration": -0.5}', b'{"api-max-blocks-per-request": -1}',
])
def test_bad_knobs_rejected(both, blob):
    def scenario(p):
        with pytest.raises(ValueError) as e:
            p.config.parse_config(blob)
        return str(e.value)

    twin(both, scenario)


def test_from_config_mapping_and_status(both):
    blob = json.dumps({
        "rpc-max-workers": 3, "rpc-queue-size": 7,
        "rpc-expensive-workers": 2, "rpc-expensive-queue-size": 5,
        "api-max-duration": 1.5, "rpc-expensive-duration": 2.5,
        "rpc-batch-limit": 11, "rpc-body-limit": 1024,
        "rpc-breaker-threshold": 4, "rpc-drain-timeout": 0.5}).encode()

    def scenario(p):
        pol = p.adm.ServingPolicy.from_config(p.config.parse_config(blob))
        srv = p.server.RPCServer(policy=pol)
        return [pol.status(), pol.budget_for("eth_blockNumber"),
                pol.budget_for("eth_getLogs"), srv.serving_status(),
                p.server.RPCServer().serving_status(),
                p.adm.ServingPolicy.from_config(p.config.parse_config(
                    b'{"rpc-max-workers": 0, "rpc-queue-size": 0}')
                ).cheap_pool is None]

    st, cheap, exp, srv_st, bare, off = twin(both, scenario)
    assert st["cheap"]["workers"] == 3 and st["cheap"]["queue_capacity"] == 7
    assert st["expensive"]["queue_capacity"] == 5
    assert (cheap, exp, st["batch_limit"], st["body_limit"]) == (
        1.5, 2.5, 11, 1024)
    assert srv_st == st and bare == {"pooled": False} and off
