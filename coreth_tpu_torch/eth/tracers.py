"""Transaction tracing (semantics of coreth eth/tracers/ — debug_trace*
APIs over re-executed state, the struct logger, and the native call
tracer; eth/tracers/api.go:241-674, native/call.go, logger/logger.go).

Historical state is recovered by re-executing the block's txs from the
parent root (eth/state_accessor.go pattern). Counterpart of
coreth_tpu/eth/tracers.py.
"""

from __future__ import annotations

from typing import List, Optional

from ..core.state_processor import apply_transaction, new_block_context
from ..core.state_transition import GasPool
from ..evm.evm import EVM, Config, TxContext
from ..rpc.server import RPCError
from ..utils.deadline import check as deadline_check
from .api import hb, hx, parse_bytes
from .tracer_dsl import DSLTracer


class StructLogger:
    """vm.Config.Tracer hook collecting per-op execution logs
    (eth/tracers/logger/logger.go StructLog)."""

    def __init__(self, with_memory: bool = False, with_stack: bool = True,
                 with_storage: bool = False, limit: int = 0):
        self.logs: List[dict] = []
        self.with_memory = with_memory
        self.with_stack = with_stack
        self.with_storage = with_storage
        self.limit = limit
        self.failed = False
        self.output = b""
        self.gas_used = 0

    def capture_state(self, pc, op, gas, cost, scope, return_data, depth) -> None:
        if self.limit and len(self.logs) >= self.limit:
            return
        from ..evm import opcodes as OP

        entry = {
            "pc": pc,
            "op": OP.name(op),
            "gas": gas,
            "gasCost": cost,
            "depth": depth,
        }
        if self.with_stack:
            entry["stack"] = [hex(v) for v in scope.stack.data]
        if self.with_memory:
            entry["memory"] = scope.memory.get(0, len(scope.memory)).hex()
        self.logs.append(entry)

    def result(self) -> dict:
        return {
            "gas": self.gas_used,
            "failed": self.failed,
            "returnValue": self.output.hex(),
            "structLogs": self.logs,
        }


class CallTracer:
    """Native call tracer (eth/tracers/native/call.go): nested call frames."""

    def __init__(self):
        self.frames: List[dict] = []
        self.stack: List[dict] = []

    def enter(self, typ: str, from_: bytes, to: Optional[bytes], value: int,
              gas: int, input_: bytes) -> None:
        frame = {
            "type": typ,
            "from": hb(from_),
            "to": hb(to) if to else None,
            "value": hx(value),
            "gas": hx(gas),
            "input": hb(input_),
            "calls": [],
        }
        if self.stack:
            self.stack[-1]["calls"].append(frame)
        else:
            self.frames.append(frame)
        self.stack.append(frame)

    def exit(self, output: bytes, gas_used: int, err: Optional[str]) -> None:
        frame = self.stack.pop()
        frame["output"] = hb(output)
        frame["gasUsed"] = hx(gas_used)
        if err:
            frame["error"] = err

    def capture_state(self, *a, **kw) -> None:
        pass

    def result(self) -> dict:
        return self.frames[0] if self.frames else {}


class FourByteTracer:
    """Native 4byte tracer (eth/tracers/native/4byte.go): counts
    selector/calldata-size pairs across all call frames."""

    def __init__(self):
        self.ids: dict = {}

    def enter(self, typ: str, from_: bytes, to, value: int, gas: int,
              input_: bytes) -> None:
        if typ in ("CREATE", "CREATE2") or len(input_) < 4:
            return
        key = f"0x{input_[:4].hex()}-{len(input_) - 4}"
        self.ids[key] = self.ids.get(key, 0) + 1

    def exit(self, output: bytes, gas_used: int, err) -> None:
        pass

    def capture_state(self, *a, **kw) -> None:
        pass

    def result(self) -> dict:
        return dict(self.ids)


class PrestateTracer:
    """Native prestate tracer (eth/tracers/native/prestate.go): the value
    of every account/slot BEFORE the traced transaction, captured on
    first touch through a recording StateDB proxy."""

    def __init__(self):
        self.accounts: dict = {}

    def wrap(self, statedb):
        return _PrestateProxy(statedb, self)

    def _touch_account(self, statedb, addr: bytes) -> dict:
        if addr not in self.accounts:
            self.accounts[addr] = {
                "balance": statedb.get_balance(addr),
                "nonce": statedb.get_nonce(addr),
                "code": statedb.get_code(addr),
                "storage": {},
            }
        return self.accounts[addr]

    def _touch_slot(self, statedb, addr: bytes, key: bytes) -> None:
        acct = self._touch_account(statedb, addr)
        if key not in acct["storage"]:
            acct["storage"][key] = statedb.get_state(addr, key)

    def result(self) -> dict:
        out = {}
        for addr, a in self.accounts.items():
            entry = {"balance": hx(a["balance"]), "nonce": a["nonce"]}
            if a["code"]:
                entry["code"] = hb(a["code"])
            if a["storage"]:
                entry["storage"] = {
                    hb(k): hb(v.rjust(32, b"\x00") if v else b"\x00" * 32)
                    for k, v in a["storage"].items()
                }
            out[hb(addr)] = entry
        return out


class _PrestateProxy:
    """Delegating StateDB wrapper recording first-touch values. Mutators
    record BEFORE delegating so the captured value is pre-transaction."""

    _RECORD_ACCOUNT = {
        "get_balance", "add_balance", "sub_balance", "get_nonce",
        "set_nonce", "get_code", "set_code", "get_code_hash",
        "get_code_size", "create_account", "exist", "empty", "suicide",
    }
    _RECORD_SLOT = {"get_state", "set_state", "get_committed_state"}

    def __init__(self, inner, tracer: PrestateTracer):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_tracer", tracer)

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name in self._RECORD_ACCOUNT:
            def wrapped(addr, *a, **kw):
                self._tracer._touch_account(self._inner, addr)
                return attr(addr, *a, **kw)

            return wrapped
        if name in self._RECORD_SLOT:
            def wrapped(addr, key, *a, **kw):
                self._tracer._touch_slot(self._inner, addr, key)
                return attr(addr, key, *a, **kw)

            return wrapped
        return attr

    def __setattr__(self, name, value):
        setattr(self._inner, name, value)


class DebugAPI:
    """debug namespace: traceTransaction / traceBlockByNumber /
    traceBlockByHash / traceCall (struct, call, prestate, 4byte, and
    sandboxed DSL tracers), dumpBlock / accountRange, storageRangeAt,
    getModifiedAccountsByNumber/ByHash, getBadBlocks."""

    def __init__(self, backend):
        self.b = backend

    def _attach_tracer(self, tracer, state):
        """The ONE place a tracer binds to an execution: returns
        (tx_state, cfg, finish_evm) where finish_evm wraps the EVM with
        call-frame instrumentation when the tracer wants it. Every trace
        entry point (tx re-exec, parallel worker, traceCall) goes
        through here so a new tracer type or bind step cannot silently
        miss a path."""
        tx_state = state
        if isinstance(tracer, PrestateTracer):
            tx_state = tracer.wrap(state)
        if isinstance(tracer, DSLTracer):
            tracer.bind_state(state)
        cfg = Config(tracer=tracer if isinstance(
            tracer, (StructLogger, DSLTracer)) else None)

        def finish_evm(evm):
            if isinstance(tracer, (CallTracer, FourByteTracer, DSLTracer)):
                return _instrument_call_tracer(evm, tracer)
            return evm

        return tx_state, cfg, finish_evm

    def _re_execute(self, blk, upto_index: Optional[int], tracer_factory):
        """Re-run the block's txs from the parent state; attach a fresh
        tracer to each traced tx. Returns (results, state): results is a
        list of (tx, tracer, receipt), state is the post-replay StateDB
        (storageRangeAt reads it; trace callers drop it)."""
        chain = self.b.chain
        parent = chain.get_header(blk.parent_hash)
        if parent is None:
            raise RPCError(-32000, "parent block not found")
        state = chain.state_at(parent.root)
        gp = GasPool(blk.gas_limit)
        results = []
        for i, tx in enumerate(blk.transactions):
            deadline_check()  # replay is per-tx expensive: checkpoint each
            traced = upto_index is None or i == upto_index
            tracer = tracer_factory() if traced else None
            tx_state, cfg, finish_evm = self._attach_tracer(tracer, state)
            block_ctx = new_block_context(blk.header, chain)
            evm = finish_evm(EVM(block_ctx, TxContext(), tx_state,
                                 self.b.chain_config, cfg))
            state.set_tx_context(tx.hash(), i)
            used = [0]
            receipt = apply_transaction(
                self.b.chain_config, chain, evm, gp, tx_state, blk.header, tx,
                used
            )
            if traced:
                if isinstance(tracer, StructLogger):
                    tracer.gas_used = receipt.gas_used
                    tracer.failed = receipt.status == 0
                results.append((tx, tracer, receipt))
            if upto_index is not None and i == upto_index:
                break
        return results, state

    def _trace_one(self, blk, chain, pre_state, gas_left, i, tx,
                   tracer_factory):
        """Trace tx [i] from its captured pre-state (runs on a worker)."""
        tracer = tracer_factory()
        tx_state, cfg, finish_evm = self._attach_tracer(tracer, pre_state)
        block_ctx = new_block_context(blk.header, chain)
        evm = finish_evm(EVM(block_ctx, TxContext(), tx_state,
                             self.b.chain_config, cfg))
        pre_state.set_tx_context(tx.hash(), i)
        used = [0]
        receipt = apply_transaction(
            self.b.chain_config, chain, evm, GasPool(gas_left), tx_state,
            blk.header, tx, used
        )
        if isinstance(tracer, StructLogger):
            tracer.gas_used = receipt.gas_used
            tracer.failed = receipt.status == 0
        return (tx, tracer, receipt)

    def _re_execute_parallel(self, blk, tracer_factory, workers: int = 8):
        """Parallel whole-block tracing (capability of the reference's
        eth/tracers/api.go:674 traceBlockParallel): one sequential UNTRACED
        pass captures each tx's pre-state + remaining gas pool, then every
        tx traces concurrently from its own state copy. Output is
        bit-identical to the sequential path (asserted in tests)."""
        from concurrent.futures import ThreadPoolExecutor

        chain = self.b.chain
        parent = chain.get_header(blk.parent_hash)
        if parent is None:
            raise RPCError(-32000, "parent block not found")
        state = chain.state_at(parent.root)
        gp = GasPool(blk.gas_limit)
        pre = []  # (pre_state_copy, gas_left)
        for i, tx in enumerate(blk.transactions):
            deadline_check()
            pre.append((state.copy(), gp.gas))
            block_ctx = new_block_context(blk.header, chain)
            evm = EVM(block_ctx, TxContext(), state, self.b.chain_config,
                      Config())
            state.set_tx_context(tx.hash(), i)
            apply_transaction(
                self.b.chain_config, chain, evm, gp, state, blk.header, tx,
                [0]
            )
        with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
            futures = [
                pool.submit(self._trace_one, blk, chain, ps, gl, i, tx,
                            tracer_factory)
                for i, (tx, (ps, gl)) in enumerate(
                    zip(blk.transactions, pre))
            ]
            return [f.result() for f in futures]

    def traceTransaction(self, tx_hash: str, config: dict = None) -> dict:
        config = config or {}
        found = self.b.tx_by_hash(parse_bytes(tx_hash))
        if found is None or found[1] is None:
            raise RPCError(-32000, "transaction not found")
        tx, blk, index = found
        factory = self._tracer_factory(config)
        results, _ = self._re_execute(blk, index, factory)
        if not results:
            raise RPCError(-32000, "trace produced no result")
        _, tracer, _ = results[-1]
        return tracer.result()

    def traceBlockByHash(self, block_hash: str, config: dict = None) -> list:
        """debug_traceBlockByHash (eth/tracers/api.go TraceBlockByHash):
        same as traceBlockByNumber, addressed by hash."""
        blk = self.b.chain.get_block(parse_bytes(block_hash))
        if blk is None:
            raise RPCError(-32000, "block not found")
        return self._trace_block(blk, config or {})

    def traceCall(self, call_obj: dict, tag: str = "latest",
                  config: dict = None) -> dict:
        """debug_traceCall (eth/tracers/api.go TraceCall): run an
        eth_call-shaped message against [tag]'s state with a tracer
        attached — no transaction, no state commitment."""
        from ..core.state_processor import new_block_context
        from ..core.state_transition import apply_message

        config = config or {}
        blk = self.b.block_by_tag(tag)
        if blk is None:
            raise RPCError(-32000, "block not found")
        tracer = self._tracer_factory(config)()
        state = self.b.chain.state_at(blk.root)
        tx_state, cfg, finish_evm = self._attach_tracer(tracer, state)
        cfg.no_base_fee = True  # eth_call semantics (backend.do_call)
        msg = self.b._call_msg(call_obj, blk.gas_limit)
        evm = finish_evm(EVM(
            new_block_context(blk.header, self.b.chain),
            TxContext(origin=msg.from_, gas_price=msg.gas_price),
            tx_state, self.b.chain_config, cfg))
        result = apply_message(evm, msg, GasPool(2**63))
        if isinstance(tracer, StructLogger):
            tracer.gas_used = result.used_gas
            tracer.failed = result.err is not None
            tracer.output = result.return_data or b""
        return tracer.result()

    def traceBlockByNumber(self, tag: str, config: dict = None) -> list:
        config = config or {}
        blk = self.b.block_by_tag(tag)
        if blk is None:
            raise RPCError(-32000, "block not found")
        return self._trace_block(blk, config)

    def _trace_block(self, blk, config: dict) -> list:
        factory = self._tracer_factory(config)
        workers = int(config.get("parallelWorkers", 0) or 0)
        if workers > 1 and len(blk.transactions) > 1:
            # opt-in (api.go:674 traceBlockParallel analog): the pre-state
            # capture pass costs one extra untraced execution + a StateDB
            # copy per tx, which only pays off when tracer work dominates
            # and threads can overlap (C-backed tracers / multi-core)
            results = self._re_execute_parallel(blk, factory, workers=workers)
        else:
            results, _ = self._re_execute(blk, None, factory)
        return [
            {"txHash": hb(tx.hash()), "result": tracer.result()}
            for tx, tracer, _ in results
        ]

    # --- storage/account introspection (eth/api.go StorageRangeAt /
    # GetModifiedAccounts* / GetBadBlocks) ---------------------------------

    def storageRangeAt(self, block_hash: str, tx_index: int, contract: str,
                       key_start: str, max_result: int) -> dict:
        """debug_storageRangeAt (eth/api.go StorageRangeAt): the
        contract's storage AT THE STATE BEFORE tx [tx_index] of the
        block, walked in hashed-key order from [key_start]."""
        from ..trie.iterator import iterate_leaves
        from .api import parse_addr
        from .. import rlp

        chain = self.b.chain
        blk = chain.get_block(parse_bytes(block_hash))
        if blk is None:
            raise RPCError(-32000, "block not found")
        parent = chain.get_header(blk.parent_hash)
        if parent is None:
            raise RPCError(-32000, "parent block not found")
        n = max(0, int(tx_index))
        if n > len(blk.transactions):
            # eth/api.go StorageRangeAt via stateAtTransaction: an index
            # past the block's txs is a caller error, not "replay them all"
            raise RPCError(-32000, "transaction index out of range")
        if n == 0:
            state = chain.state_at(parent.root)
        else:
            # the ONE replay recipe (_re_execute) applied to the prefix
            _, state = self._re_execute(blk, n - 1, lambda: None)
        addr = parse_addr(contract)
        # deleted objects matter: a prefix SELFDESTRUCT must yield EMPTY
        # storage, not the parent trie's stale image
        obj = state._get_deleted_state_object(addr)
        tr = None
        acct_root = None
        if obj is not None and getattr(obj, "deleted", False):
            return {"storage": {}, "nextKey": None}
        if obj is not None:
            # overlays pending storage when the replayed prefix wrote
            # any; None when untouched (lazy trie never opened)
            tr = obj.update_trie()
            acct_root = obj.data.root
        if tr is None:
            from ..native import keccak256
            from ..state.account import Account
            from ..trie.node import EMPTY_ROOT

            if acct_root is None:
                blob = self.b.walkable_state_trie(parent.root).get(addr)
                if not blob:
                    return {"storage": {}, "nextKey": None}
                acct_root = Account.decode(blob).root
            if acct_root == EMPTY_ROOT:
                return {"storage": {}, "nextKey": None}
            # untouched account with real storage: its COMMITTED trie
            tr = chain.state_database.open_storage_trie(
                keccak256(addr), acct_root)
        start = parse_bytes(key_start) if key_start else None
        storage, next_key, n = {}, None, 0
        for hk, enc in iterate_leaves(tr.trie, start=start):
            if n >= max(1, int(max_result)):
                next_key = "0x" + hk.hex()
                break
            val = bytes(rlp.decode(enc))
            storage["0x" + hk.hex()] = {
                "key": None,  # slot preimages are not recorded
                "value": "0x" + val.rjust(32, b"\x00").hex(),
            }
            n += 1
        return {"storage": storage, "nextKey": next_key}

    def _modified_accounts(self, start_blk, end_blk) -> list:
        """Hashed keys of accounts whose leaf changed between the two
        roots via the hash-pruning difference walk (the reference's
        trie.NewDifferenceIterator): O(changed subtrees), not O(total
        accounts)."""
        from ..trie.iterator import diff_leaves

        if start_blk is None or end_blk is None:
            raise RPCError(-32000, "block not found")
        ta = self.b.walkable_state_trie(start_blk.root).trie
        tb = self.b.walkable_state_trie(end_blk.root).trie
        return ["0x" + k.hex()
                for k, _va, _vb in sorted(diff_leaves(ta, tb))]

    def getModifiedAccountsByNumber(self, start: int,
                                    end: int = None) -> list:
        chain = self.b.chain
        s = chain.get_block_by_number(int(start))
        e = s if end is None else chain.get_block_by_number(int(end))
        if end is None and s is not None:
            e, s = s, chain.get_block(s.parent_hash)
        return self._modified_accounts(s, e)

    def getModifiedAccountsByHash(self, start: str, end: str = None) -> list:
        chain = self.b.chain
        s = chain.get_block(parse_bytes(start))
        e = s if end is None else chain.get_block(parse_bytes(end))
        if end is None and s is not None:
            e, s = s, chain.get_block(s.parent_hash)
        return self._modified_accounts(s, e)

    def getAccessibleState(self, from_height: int, to_height: int) -> str:
        """debug_getAccessibleState (eth/api.go GetAccessibleState,
        coreth-only): the first block number scanning from `from`
        TOWARD `to` (exclusive, reference loop semantics) whose state
        is resolvable — under pruning most historical roots are gone,
        and operators use this to find a re-executable anchor.
        Negative numbers resolve to the current head (rpc.BlockNumber
        latest/pending tags)."""
        chain = self.b.chain
        head = chain.last_accepted.number

        def resolve(v: int) -> int:
            v = int(v)
            return head if v < 0 else v

        lo, hi = resolve(from_height), resolve(to_height)
        if lo == hi:
            raise RPCError(-32000, "from and to needs to be different")
        step = 1 if hi > lo else -1
        for n in range(lo, hi, step):  # `to` exclusive, like the reference
            header = chain.get_header_by_number(n)
            if header is not None and chain.has_state(header.root):
                return hx(n)
        raise RPCError(-32000,
                       f"no accessible state in [{lo}, {hi})")

    def preimage(self, hash_: str) -> str:
        """debug_preimage (eth/api.go Preimage): hashed-key preimages.
        The repo's tries do not persist preimages (the reference also
        requires --cache.preimages), so this reports the capability gap
        explicitly instead of returning wrong data."""
        raise RPCError(
            -32000,
            "preimage recording is not enabled (preimages are not "
            "persisted; derive account keys via eth_getProof instead)")

    def getBadBlocks(self) -> list:
        """debug_getBadBlocks (eth/api.go GetBadBlocks): blocks that
        recently FAILED insertion (bad root, gas mismatch, ...)."""
        from ..metrics.flight import marshal_record

        out = []
        for blk, reason, rec in getattr(self.b.chain, "bad_blocks", []):
            out.append({
                "hash": hb(blk.hash()),
                "block": {"number": hx(blk.number),
                          "hash": hb(blk.hash()),
                          "parentHash": hb(blk.parent_hash)},
                "rlp": hb(blk.encode()),
                "reason": reason,
                # phase breakdown captured up to the failure point (None
                # when the failure preceded any instrumented phase)
                "flightRecord": marshal_record(rec) if rec else None,
            })
        return out

    # --- state dumps (core/state/dump.go:139 via eth/api.go DumpBlock /
    # AccountRange) --------------------------------------------------------

    def dumpBlock(self, tag: str, opts: dict = None) -> dict:
        """debug_dumpBlock: every account at the block's root. opts:
        {"includeStorage": bool, "includeCode": bool, "maxResults": int,
        "start": hexkey} — paged via the returned "next" key."""
        opts = opts or {}
        blk = self.b.block_by_tag(tag)
        if blk is None:
            raise RPCError(-32000, "block not found")
        from ..core.rawdb import read_code
        from ..state.dump import dump_accounts

        state_trie = self.b.walkable_state_trie(blk.root)
        start = opts.get("start")
        out = dump_accounts(
            state_trie,
            start=parse_bytes(start) if start else None,
            max_results=int(opts.get("maxResults", 0) or 0),
            include_storage=bool(opts.get("includeStorage", False)),
            include_code=bool(opts.get("includeCode", False)),
            storage_trie_opener=self.b.chain.state_database.open_storage_trie,
            code_getter=lambda h: read_code(self.b.chain.diskdb, h),
        )
        out["root"] = hb(blk.root)
        return out

    def accountRange(self, tag: str, start: str = None,
                     max_results: int = 256) -> dict:
        """debug_accountRange: the paged iterator dump (IteratorDump)."""
        return self.dumpBlock(tag, {
            "start": start,
            "maxResults": max(1, int(max_results)),
        })

    def _tracer_factory(self, config: dict):
        name = config.get("tracer")
        if name == "callTracer":
            return CallTracer
        if name == "4byteTracer":
            return FourByteTracer
        if name == "prestateTracer":
            return PrestateTracer
        if name and "def " in name:
            # operator-supplied tracer SCRIPT (the goja.go:1 capability,
            # sandboxed: own AST interpreter, no eval — eth/tracer_dsl.py)
            from .tracer_dsl import DSLError

            try:
                DSLTracer(name)  # validate once, fail at registration
            except DSLError as e:
                raise RPCError(-32000, f"bad tracer script: {e}")
            return lambda: DSLTracer(name)
        if name:
            raise RPCError(-32000, f"unknown tracer {name!r}")
        return lambda: StructLogger(
            with_memory=config.get("enableMemory", False),
            limit=config.get("limit", 0),
        )


def _instrument_call_tracer(evm: EVM, tracer: CallTracer) -> EVM:
    """Wrap the whole EVM call family to emit call frames (the interpreter
    dispatches DELEGATECALL/STATICCALL/CALLCODE/CALLEX to distinct methods)."""
    orig_call = evm.call
    orig_call_code = evm.call_code
    orig_delegate = evm.delegate_call
    orig_static = evm.static_call
    orig_expert = evm.call_expert
    orig_create = evm._create

    def call(caller, addr, input_, gas, value):
        tracer.enter("CALL", caller, addr, value, gas, input_)
        ret, left, err = orig_call(caller, addr, input_, gas, value)
        tracer.exit(ret, gas - left, str(err) if err else None)
        return ret, left, err

    def call_code(caller, addr, input_, gas, value):
        tracer.enter("CALLCODE", caller, addr, value, gas, input_)
        ret, left, err = orig_call_code(caller, addr, input_, gas, value)
        tracer.exit(ret, gas - left, str(err) if err else None)
        return ret, left, err

    def delegate_call(parent, addr, input_, gas):
        tracer.enter("DELEGATECALL", parent.address, addr, 0, gas, input_)
        ret, left, err = orig_delegate(parent, addr, input_, gas)
        tracer.exit(ret, gas - left, str(err) if err else None)
        return ret, left, err

    def static_call(caller, addr, input_, gas):
        tracer.enter("STATICCALL", caller, addr, 0, gas, input_)
        ret, left, err = orig_static(caller, addr, input_, gas)
        tracer.exit(ret, gas - left, str(err) if err else None)
        return ret, left, err

    def call_expert(caller, addr, input_, gas, value, coin_id, value2):
        tracer.enter("CALLEX", caller, addr, value, gas, input_)
        ret, left, err = orig_expert(caller, addr, input_, gas, value, coin_id, value2)
        tracer.exit(ret, gas - left, str(err) if err else None)
        return ret, left, err

    def create(caller, code, gas, value, addr):
        tracer.enter("CREATE", caller, addr, value, gas, code)
        ret, out_addr, left, err = orig_create(caller, code, gas, value, addr)
        tracer.exit(ret, gas - left, str(err) if err else None)
        return ret, out_addr, left, err

    evm.call = call
    evm.call_code = call_code
    evm.delegate_call = delegate_call
    evm.static_call = static_call
    evm.call_expert = call_expert
    evm._create = create
    return evm
