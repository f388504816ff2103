"""Sandboxed user-scriptable tracers; counterpart of
coreth_tpu/eth/tracer_dsl.py (capability of the reference's
goja-backed JS tracers, eth/tracers/js/goja.go:1, minus
the JavaScript: operator-supplied scripts run in an OWN tree-walking
interpreter over a validated AST subset — never eval/exec).

Security stance (why this is safe where a Python-`eval` stand-in is
not):
  - the AST validator rejects attribute access outright, so the Python
    object graph (and every ``__``-dunder escape route) is unreachable;
  - names beginning with ``__`` are rejected at parse time;
  - imports, classes, lambdas, comprehensions, try/raise, with, global,
    yield and decorators are rejected — the language is straight-line
    statements, if/for/while, functions, and literals;
  - calls resolve ONLY to script-defined functions and a value-only
    builtin table (len/min/max/...); no callable ever leaks in through
    hook arguments because arguments are plain dicts/lists/ints/strs;
  - execution is fuel-metered per hook call, so a hostile loop costs a
    bounded number of interpreter steps, not a wedged node.

Script shape mirrors a goja tracer object (tracker.go lifecycle):

    count = {"calls": 0}
    def step(log):            # per opcode; log: pc/op/gas/gasCost/
        ...                   #   depth/stack (ints)
    def enter(frame):         # call-frame entry: type/from/to/value/
        ...                   #   gas/input
    def exit(res):            # frame exit: output/gasUsed/error
        ...
    def result():             # final JSON payload
        return count

Module-level variables persist across hooks (mutate containers via
subscript: ``count["calls"] = count["calls"] + 1``).
"""

from __future__ import annotations

import ast
import operator
from typing import Any, Dict, List, Optional

MAX_SOURCE = 64 * 1024
DEFAULT_FUEL = 500_000
# fuel charged per state-accessor call (balance/storage/...): each is a
# trie read, not an interpreter step — see DSLProgram._eval's Call path
STATE_BUILTIN_COST = 256


class DSLError(Exception):
    pass


_BINOPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod, ast.Pow: operator.pow,
    ast.LShift: operator.lshift, ast.RShift: operator.rshift,
    ast.BitOr: operator.or_, ast.BitAnd: operator.and_,
    ast.BitXor: operator.xor,
}
_UNARY = {ast.USub: operator.neg, ast.UAdd: operator.pos,
          ast.Not: operator.not_, ast.Invert: operator.invert}
_CMPS = {
    ast.Eq: operator.eq, ast.NotEq: operator.ne, ast.Lt: operator.lt,
    ast.LtE: operator.le, ast.Gt: operator.gt, ast.GtE: operator.ge,
    ast.In: lambda a, b: a in b, ast.NotIn: lambda a, b: a not in b,
}

# value-only helpers; no method calls exist in the language, so list/
# dict mutation helpers are functions
def _bounded_range(*args):
    r = range(*args)
    if len(r) > 1_000_000:
        raise DSLError("range too large")
    return r


_BUILTINS: Dict[str, Any] = {
    "len": len, "min": min, "max": max, "abs": abs, "sum": sum,
    "sorted": sorted, "str": str, "int": int, "hex": hex, "bool": bool,
    "range": _bounded_range,
    "push": lambda lst, x: (lst.append(x), None)[1],
    "pop": lambda lst: lst.pop(),
    "get": lambda d, k, default=None: d.get(k, default),
    "keys": lambda d: list(d.keys()),
    "values": lambda d: list(d.values()),
    "items": lambda d: [list(kv) for kv in d.items()],
    "delete": lambda d, k: (d.pop(k, None), None)[1],
}

_ALLOWED_STMT = (
    ast.FunctionDef, ast.Return, ast.Assign, ast.AugAssign, ast.Expr,
    ast.If, ast.For, ast.While, ast.Break, ast.Continue, ast.Pass,
)
_ALLOWED_EXPR = (
    ast.BoolOp, ast.BinOp, ast.UnaryOp, ast.Compare, ast.Call, ast.Name,
    ast.Constant, ast.Dict, ast.List, ast.Tuple, ast.Subscript, ast.Slice,
    ast.IfExp, ast.Load, ast.Store, ast.And, ast.Or,
    ast.arguments, ast.arg, ast.keyword,
) + tuple(_BINOPS) + tuple(_UNARY) + tuple(_CMPS)


def _validate(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        if isinstance(node, ast.Module):
            continue
        if isinstance(node, ast.Attribute):
            raise DSLError("attribute access is not allowed")
        if not isinstance(node, _ALLOWED_STMT + _ALLOWED_EXPR):
            raise DSLError(
                f"{type(node).__name__} is not part of the tracer language")
        if isinstance(node, ast.Name) and node.id.startswith("__"):
            raise DSLError("names starting with '__' are not allowed")
        if isinstance(node, ast.arg) and node.arg.startswith("__"):
            raise DSLError("names starting with '__' are not allowed")
        if isinstance(node, ast.FunctionDef):
            if node.decorator_list:
                raise DSLError("decorators are not allowed")
            a = node.args
            if (a.vararg or a.kwarg or a.kwonlyargs or a.posonlyargs
                    or a.defaults or a.kw_defaults):
                raise DSLError("only plain positional parameters allowed")
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Name):
                raise DSLError("only named functions can be called")
            if node.keywords:
                raise DSLError("keyword arguments are not allowed")
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            for t in targets:
                if not isinstance(t, (ast.Name, ast.Subscript, ast.Tuple)):
                    raise DSLError("bad assignment target")
                if isinstance(t, ast.Tuple) and not all(
                        isinstance(e, ast.Name) for e in t.elts):
                    raise DSLError("bad assignment target")


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


_PARSE_CACHE: Dict[str, ast.Module] = {}


def _parse_validated(source: str) -> ast.Module:
    """Parse+validate once per distinct source — traceBlock builds one
    DSLProgram per tx from the SAME script, and only the module-body
    execution (fresh state) needs repeating."""
    tree = _PARSE_CACHE.get(source)
    if tree is not None:
        return tree
    try:
        tree = ast.parse(source, mode="exec")
    except SyntaxError as e:
        raise DSLError(f"syntax error: {e}") from e
    _validate(tree)
    if len(_PARSE_CACHE) >= 64:
        _PARSE_CACHE.pop(next(iter(_PARSE_CACHE)))
    _PARSE_CACHE[source] = tree
    return tree


class DSLProgram:
    """Compiled (validated) tracer script + its persistent module env.

    extra_builtins: additional value-only functions exposed to the
    script (e.g. the tracer's read-only state accessors — goja's `db`
    object capability, but as plain named functions since the language
    has no attribute access)."""

    def __init__(self, source: str, fuel_per_call: int = DEFAULT_FUEL,
                 extra_builtins: Optional[Dict[str, Any]] = None):
        if len(source) > MAX_SOURCE:
            raise DSLError("tracer script too large")
        self._extra = extra_builtins or {}
        tree = _parse_validated(source)
        self.fuel_per_call = fuel_per_call
        self._fuel = 0
        self._depth = 0
        self.globals: Dict[str, Any] = {}
        self.functions: Dict[str, ast.FunctionDef] = {}
        self._fuel = fuel_per_call  # module body gets one allocation
        for stmt in tree.body:
            if isinstance(stmt, ast.FunctionDef):
                self.functions[stmt.name] = stmt
            else:
                try:
                    self._exec(stmt, self.globals)
                except (_Break, _Continue) as e:
                    raise DSLError("break/continue outside loop") from e
                except _Return as e:
                    raise DSLError("return outside function") from e

    def has(self, name: str) -> bool:
        return name in self.functions

    def call(self, name: str, *args) -> Any:
        fn = self.functions.get(name)
        if fn is None:
            return None
        self._fuel = self.fuel_per_call
        self._depth = 0
        return self._call_fn(fn, list(args))

    # --- interpreter ------------------------------------------------------

    def _burn(self) -> None:
        self._fuel -= 1
        if self._fuel <= 0:
            raise DSLError("tracer fuel exhausted")

    def _call_fn(self, fn: ast.FunctionDef, args: List[Any]) -> Any:
        params = [a.arg for a in fn.args.args]
        if len(args) > len(params):
            raise DSLError(f"{fn.name}() takes {len(params)} args")
        self._depth += 1
        if self._depth > 64:
            raise DSLError("call depth exceeded")
        env = dict(zip(params, args + [None] * (len(params) - len(args))))
        try:
            for stmt in fn.body:
                self._exec(stmt, env)
        except _Return as r:
            return r.value
        except (_Break, _Continue) as e:
            raise DSLError("break/continue outside loop") from e
        finally:
            self._depth -= 1
        return None

    def _exec(self, node: ast.stmt, env: Dict[str, Any]) -> None:
        self._burn()
        if isinstance(node, ast.Expr):
            self._eval(node.value, env)
        elif isinstance(node, ast.Assign):
            val = self._eval(node.value, env)
            for t in node.targets:
                self._assign(t, val, env)
        elif isinstance(node, ast.AugAssign):
            cur = self._eval_target(node.target, env)
            val = self._binop(type(node.op), cur,
                              self._eval(node.value, env))
            self._assign(node.target, val, env)
        elif isinstance(node, ast.If):
            body = node.body if self._eval(node.test, env) else node.orelse
            for s in body:
                self._exec(s, env)
        elif isinstance(node, ast.While):
            while self._eval(node.test, env):
                self._burn()
                try:
                    for s in node.body:
                        self._exec(s, env)
                except _Break:
                    break
                except _Continue:
                    continue
        elif isinstance(node, ast.For):
            if not isinstance(node.target, ast.Name):
                raise DSLError("for target must be a name")
            for item in self._eval(node.iter, env):
                self._burn()
                env[node.target.id] = item
                try:
                    for s in node.body:
                        self._exec(s, env)
                except _Break:
                    break
                except _Continue:
                    continue
        elif isinstance(node, ast.Return):
            raise _Return(
                self._eval(node.value, env) if node.value else None)
        elif isinstance(node, ast.Break):
            raise _Break()
        elif isinstance(node, ast.Continue):
            raise _Continue()
        elif isinstance(node, ast.Pass):
            pass
        elif isinstance(node, ast.FunctionDef):
            raise DSLError("nested function definitions are not allowed")
        else:  # pragma: no cover — _validate rejects everything else
            raise DSLError(f"unsupported statement {type(node).__name__}")

    def _assign(self, target: ast.expr, val: Any, env: Dict[str, Any]):
        if isinstance(target, ast.Name):
            env[target.id] = val
        elif isinstance(target, ast.Subscript):
            obj = self._eval(target.value, env)
            obj[self._eval(target.slice, env)] = val
        elif isinstance(target, ast.Tuple):
            vals = list(val)
            if len(vals) != len(target.elts):
                raise DSLError("unpack length mismatch")
            for t, v in zip(target.elts, vals):
                self._assign(t, v, env)
        else:
            raise DSLError("bad assignment target")

    def _eval_target(self, target: ast.expr, env: Dict[str, Any]) -> Any:
        return self._eval(target, env)

    # an int may not exceed 64 Kbit (8 KB) — fuel meters interpreter
    # STEPS, so single ops must be bounded in both time and allocation;
    # without a magnitude cap, repeated squaring doubles bit length per
    # ~3 fuel units and reaches GB-scale ints inside one hook call
    _MAX_BITS = 1 << 16
    # sequences (str/list/tuple) may not exceed 1M elements per op result
    _MAX_LEN = 1_000_000

    def _binop(self, op: type, left: Any, right: Any) -> Any:
        lbits = left.bit_length() if isinstance(left, int) else 0
        rbits = right.bit_length() if isinstance(right, int) else 0
        if op is ast.Pow:
            if not isinstance(right, int) or abs(right) > 4096 or \
                    lbits * max(abs(right), 1) > self._MAX_BITS:
                raise DSLError("exponent too large")
        elif op is ast.LShift:
            if not isinstance(right, int) or right < 0 or \
                    lbits + right > self._MAX_BITS:
                raise DSLError("shift too large")
        elif op is ast.Mult:
            if lbits + rbits > self._MAX_BITS:
                raise DSLError("operands too large")
            for seq, n in ((left, right), (right, left)):
                if isinstance(seq, (list, str, tuple)) and \
                        isinstance(n, int) and \
                        len(seq) * max(n, 1) > self._MAX_LEN:
                    raise DSLError("sequence repetition too large")
        elif op is ast.Add:
            # sequence concatenation doubles per ~3 fuel units — cap the
            # result size like int magnitude (ints grow 1 bit/op, fine)
            if isinstance(left, (list, str, tuple)) and \
                    isinstance(right, (list, str, tuple)) and \
                    len(left) + len(right) > self._MAX_LEN:
                raise DSLError("sequence too large")
        try:
            return _BINOPS[op](left, right)
        except (TypeError, ValueError, ZeroDivisionError) as e:
            raise DSLError(str(e)) from e

    def _lookup(self, name: str, env: Dict[str, Any]) -> Any:
        if name in env:
            return env[name]
        if name in self.globals:
            return self.globals[name]
        raise DSLError(f"undefined name {name!r}")

    def _eval(self, node: ast.expr, env: Dict[str, Any]) -> Any:
        self._burn()
        if isinstance(node, ast.Constant):
            return node.value
        if isinstance(node, ast.Name):
            return self._lookup(node.id, env)
        if isinstance(node, ast.BinOp):
            return self._binop(type(node.op), self._eval(node.left, env),
                               self._eval(node.right, env))
        if isinstance(node, ast.UnaryOp):
            return _UNARY[type(node.op)](self._eval(node.operand, env))
        if isinstance(node, ast.BoolOp):
            if isinstance(node.op, ast.And):
                val = True
                for v in node.values:
                    val = self._eval(v, env)
                    if not val:
                        return val
                return val
            for v in node.values:
                val = self._eval(v, env)
                if val:
                    return val
            return val
        if isinstance(node, ast.Compare):
            left = self._eval(node.left, env)
            for op, comp in zip(node.ops, node.comparators):
                right = self._eval(comp, env)
                if not _CMPS[type(op)](left, right):
                    return False
                left = right
            return True
        if isinstance(node, ast.Call):
            name = node.func.id  # validated: always a Name
            args = [self._eval(a, env) for a in node.args]
            if name in self.functions:
                return self._call_fn(self.functions[name], args)
            fn = _BUILTINS.get(name)
            if fn is None:
                fn = self._extra.get(name)
                if fn is not None:
                    # state accessors do trie/disk work, not one
                    # interpreter step: charge them so fuel still bounds
                    # a hostile script's REAL cost (~2k reads/hook call)
                    self._fuel -= STATE_BUILTIN_COST
                    if self._fuel <= 0:
                        raise DSLError("tracer fuel exhausted")
            if fn is None:
                raise DSLError(f"unknown function {name!r}")
            try:
                return fn(*args)
            except DSLError:
                raise
            except Exception as e:  # noqa: BLE001 — surface as DSL error
                raise DSLError(f"{name}(): {e}") from e
        if isinstance(node, ast.Subscript):
            obj = self._eval(node.value, env)
            if isinstance(node.slice, ast.Slice):
                lo = self._eval(node.slice.lower, env) if node.slice.lower else None
                hi = self._eval(node.slice.upper, env) if node.slice.upper else None
                if node.slice.step is not None:
                    raise DSLError("slice step is not allowed")
                return obj[lo:hi]
            try:
                return obj[self._eval(node.slice, env)]
            except (KeyError, IndexError, TypeError) as e:
                raise DSLError(f"subscript: {e}") from e
        if isinstance(node, ast.Dict):
            return {self._eval(k, env): self._eval(v, env)
                    for k, v in zip(node.keys, node.values)}
        if isinstance(node, ast.List):
            return [self._eval(e, env) for e in node.elts]
        if isinstance(node, ast.Tuple):
            return tuple(self._eval(e, env) for e in node.elts)
        if isinstance(node, ast.IfExp):
            return (self._eval(node.body, env)
                    if self._eval(node.test, env)
                    else self._eval(node.orelse, env))
        raise DSLError(f"unsupported expression {type(node).__name__}")


class DSLTracer:
    """vm.Config.Tracer + call-frame tracer backed by a DSLProgram —
    the registration seam debug_traceTransaction(tracer=<script>) uses
    (goja.go's newJsTracer equivalent).

    Hook isolation: a script failure must NEVER leak into the EVM loop —
    a raw exception there would be swallowed by the interpreter's
    opcode-error handling and silently falsify the traced execution.
    Instead the first failure disables the tracer and result() raises,
    so the canonical re-execution completes and the error surfaces as a
    clean RPC error (goja's tracker.go lifecycle behaves the same)."""

    def __init__(self, source: str):
        self._state = [None]  # mutable cell: bound per traced tx
        self.prog = DSLProgram(
            source, extra_builtins=self._state_builtins())
        self.failed = False
        self.output = b""
        self.gas_used = 0
        self._err: Optional[str] = None

    def bind_state(self, statedb) -> None:
        """Attach the traced execution's StateDB so scripts can read
        accounts (goja's db object: db.getBalance/getNonce/...). The
        accessors are read-only and value-returning; without a bound
        state they raise a DSLError the hook isolation absorbs."""
        self._state[0] = statedb

    def _state_builtins(self) -> dict:
        cell = self._state

        def need_state():
            if cell[0] is None:
                raise DSLError("no state bound to this tracer")
            return cell[0]

        def _addr(a) -> bytes:
            if isinstance(a, str):
                a = bytes.fromhex(a[2:] if a.startswith("0x") else a)
            if not isinstance(a, bytes) or len(a) != 20:
                raise DSLError("address must be 20 bytes / 0x-hex")
            return a

        return {
            "balance": lambda a: need_state().get_balance(_addr(a)),
            "nonce": lambda a: need_state().get_nonce(_addr(a)),
            "code_size": lambda a: len(need_state().get_code(_addr(a))
                                       or b""),
            "storage": lambda a, slot: "0x" + (
                need_state().get_state(
                    _addr(a), int(slot).to_bytes(32, "big")) or b""
            ).hex(),
            "exists": lambda a: need_state().exist(_addr(a)),
        }

    def _call(self, hook: str, arg: dict) -> None:
        if self._err is not None:
            return
        try:
            self.prog.call(hook, arg)
        except BaseException as e:  # noqa: BLE001 — isolate the sandbox
            self._err = f"{hook}(): {e}"

    # vm.Config.Tracer hook (interpreter loop)
    def capture_state(self, pc, op, gas, cost, scope, return_data,
                      depth) -> None:
        if self._err is not None or not self.prog.has("step"):
            return
        from ..evm import opcodes as OP

        self._call("step", {
            "pc": pc,
            "op": OP.name(op),
            "opcode": op,
            "gas": gas,
            "gasCost": cost,
            "depth": depth,
            "stack": list(scope.stack.data),
            "memSize": len(scope.memory),
        })

    # call-frame hooks (_instrument_call_tracer seam)
    def enter(self, typ: str, from_: bytes, to: Optional[bytes], value: int,
              gas: int, input_: bytes) -> None:
        self._call("enter", {
            "type": typ,
            "from": "0x" + from_.hex(),
            "to": "0x" + to.hex() if to else None,
            "value": value,
            "gas": gas,
            "input": "0x" + input_.hex(),
        })

    def exit(self, output: bytes, gas_used: int,
             err: Optional[str]) -> None:
        self._call("exit", {
            "output": "0x" + (output.hex() if output else ""),
            "gasUsed": gas_used,
            "error": err,
        })

    def result(self) -> Any:
        if self._err is not None:
            raise DSLError(f"tracer script failed: {self._err}")
        out = self.prog.call("result")
        return out if out is not None else {}
