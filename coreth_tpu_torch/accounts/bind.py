"""Contract bindings (semantics of coreth accounts/abi/bind/ + cmd/abigen);
counterpart of coreth_tpu/accounts/bind.py.

`BoundContract` is the runtime half (bind/base.go): ABI-typed call /
transact / deploy / event filtering over any ethclient.Client.
`generate_bindings` is the abigen half: emits a self-contained Python
module with one class per contract, typed methods per ABI function, and
event decoders — the Go-codegen workflow re-landed as Python codegen.

CLI (cmd/abigen analog):
    python -m coreth_tpu_torch.accounts.bind --abi C.json --name Counter --out c.py
"""

from __future__ import annotations

import json
import keyword
import re
from typing import Any, List, Optional

from .abi import ABI


class BindError(Exception):
    pass


class BoundContract:
    """bind/base.go BoundContract: one deployed contract + client."""

    def __init__(self, address: bytes, abi: ABI, client):
        self.address = address
        self.abi = abi
        self.client = client

    # --- reads ------------------------------------------------------------

    def call(self, method: str, *args, block: str = "latest",
             caller: bytes = b"\x00" * 20) -> List[Any]:
        """Constant call: pack -> eth_call -> unpack (base.go Call)."""
        data = self.abi.pack(method, *args)
        ret = self.client.call_contract({
            "from": "0x" + caller.hex(),
            "to": "0x" + self.address.hex(),
            "data": "0x" + data.hex(),
        }, block)
        return self.abi.unpack(method, ret)

    # --- writes -----------------------------------------------------------

    def transact(self, opts: "TransactOpts", method: Optional[str],
                 *args) -> bytes:
        """Signed state-changing call (base.go Transact); method None =
        plain transfer / raw data. Returns the tx hash."""
        data = self.abi.pack(method, *args) if method else b""
        return _send(self.client, opts, self.address, data)

    # --- events -----------------------------------------------------------

    def filter_logs(self, event: str, from_block: int = 0,
                    to_block: Optional[int] = None) -> List[dict]:
        """Decoded logs of [event] emitted by this contract
        (base.go FilterLogs + abigen's Filter* methods)."""
        e = self.abi.events[event]
        crit = {
            "address": "0x" + self.address.hex(),
            "fromBlock": hex(from_block),
            "topics": ["0x" + e.topic().hex()],
        }
        if to_block is not None:
            crit["toBlock"] = hex(to_block)
        out = []
        for raw in self.client.get_logs(crit):
            topics = [bytes.fromhex(t[2:]) for t in raw["topics"]]
            data = bytes.fromhex(raw["data"][2:])
            decoded = self.abi.decode_log(event, topics, data)
            decoded["_log"] = raw
            out.append(decoded)
        return out


class TransactOpts:
    """bind.TransactOpts: key + fee knobs for transact/deploy."""

    def __init__(self, priv_key: bytes, chain_id: int, gas_limit: int = 1_000_000,
                 max_fee: Optional[int] = None, tip: int = 0, value: int = 0):
        self.priv_key = priv_key
        self.chain_id = chain_id
        self.gas_limit = gas_limit
        self.max_fee = max_fee
        self.tip = tip
        self.value = value


def _send(client, opts: TransactOpts, to: Optional[bytes], data: bytes) -> bytes:
    from ..core.types import Signer, Transaction
    from ..crypto.secp256k1 import priv_to_address

    sender = priv_to_address(opts.priv_key)
    nonce = client.nonce_at(sender, "pending") if hasattr(client, "nonce_at") else 0
    max_fee = opts.max_fee
    if max_fee is None:
        max_fee = 2 * client.suggest_gas_price()
    tx = Transaction(
        type=2, chain_id=opts.chain_id, nonce=nonce, max_fee=max_fee,
        max_priority_fee=opts.tip, gas=opts.gas_limit, to=to,
        value=opts.value, data=data,
    )
    Signer(opts.chain_id).sign(tx, opts.priv_key)
    return client.send_transaction(tx)


def deploy_contract(client, opts: TransactOpts, abi: ABI, bytecode: bytes,
                    *ctor_args) -> tuple:
    """bind.DeployContract: send creation tx, return (address, tx_hash,
    BoundContract). Address is derived (CREATE rule) immediately."""
    from ..core.types import create_address
    from ..crypto.secp256k1 import priv_to_address

    data = bytes(bytecode)
    if abi.constructor is not None and ctor_args:
        from .abi import pack_values

        data += pack_values([t for _, t in abi.constructor.inputs],
                            list(ctor_args))
    sender = priv_to_address(opts.priv_key)
    nonce = client.nonce_at(sender, "pending")
    tx_hash = _send(client, opts, None, data)
    addr = create_address(sender, nonce)
    return addr, tx_hash, BoundContract(addr, abi, client)


# ---------------------------------------------------------------------------
# Code generation (cmd/abigen)
# ---------------------------------------------------------------------------

def _ident(name: str) -> str:
    out = re.sub(r"\W", "_", name)
    if not out or out[0].isdigit() or keyword.iskeyword(out):
        out = "_" + out
    return out


def generate_bindings(json_abi: list, contract_name: str,
                      bytecode: bytes = b"") -> str:
    """Emit a self-contained Python module for [json_abi]
    (abigen --abi --pkg equivalent)."""
    cls = _ident(contract_name)
    lines = [
        f'"""Auto-generated bindings for {contract_name} — do not edit.',
        "",
        "Generated by coreth_tpu_torch.accounts.bind (cmd/abigen analog).",
        '"""',
        "",
        "from coreth_tpu_torch.accounts.abi import ABI",
        "from coreth_tpu_torch.accounts.bind import (BoundContract, TransactOpts,",
        "                                      deploy_contract)",
        "",
        f"ABI_JSON = {json.dumps(json_abi)!r}",
        f"BYTECODE = bytes.fromhex({bytecode.hex()!r})",
        "",
        "",
        f"class {cls}:",
        f'    """{contract_name} contract session."""',
        "",
        "    def __init__(self, address: bytes, client):",
        "        import json as _json",
        "",
        "        self.contract = BoundContract(",
        "            address, ABI(_json.loads(ABI_JSON)), client)",
        "        self.address = address",
        "",
        "    @classmethod",
        "    def deploy(cls, client, opts, *ctor_args):",
        "        import json as _json",
        "",
        "        addr, tx_hash, _ = deploy_contract(",
        "            client, opts, ABI(_json.loads(ABI_JSON)), BYTECODE,",
        "            *ctor_args)",
        "        return cls(addr, client), tx_hash",
        "",
    ]
    seen = set()
    for entry in json_abi:
        if entry.get("type", "function") != "function":
            continue
        name = entry["name"]
        py = _ident(name)
        if py in seen:
            continue
        seen.add(py)
        n_in = len(entry.get("inputs", []))
        argnames = [
            _ident(i.get("name") or f"arg{k}")
            for k, i in enumerate(entry.get("inputs", []))
        ]
        args = "".join(f", {a}" for a in argnames)
        passed = "".join(f", {a}" for a in argnames)
        if entry.get("stateMutability") in ("view", "pure"):
            lines += [
                f"    def {py}(self{args}, block='latest'):",
                f"        out = self.contract.call({name!r}{passed}, block=block)",
                "        return out[0] if len(out) == 1 else out",
                "",
            ]
        else:
            lines += [
                f"    def {py}(self, opts{args}):",
                f"        return self.contract.transact(opts, {name!r}{passed})",
                "",
            ]
    for entry in json_abi:
        if entry.get("type") != "event":
            continue
        name = entry["name"]
        lines += [
            f"    def filter_{_ident(name)}(self, from_block=0, to_block=None):",
            f"        return self.contract.filter_logs({name!r}, from_block, to_block)",
            "",
        ]
    return "\n".join(lines)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(prog="abigen",
                                description="Generate Python contract bindings")
    p.add_argument("--abi", required=True, help="ABI JSON file")
    p.add_argument("--name", required=True, help="contract class name")
    p.add_argument("--bin", default=None, help="hex bytecode file (optional)")
    p.add_argument("--out", default=None, help="output .py (default stdout)")
    a = p.parse_args(argv)
    with open(a.abi) as f:
        json_abi = json.load(f)
    bytecode = b""
    if a.bin:
        with open(a.bin) as f:
            bytecode = bytes.fromhex(f.read().strip().removeprefix("0x"))
    src = generate_bindings(json_abi, a.name, bytecode)
    if a.out:
        with open(a.out, "w") as f:
            f.write(src)
    else:
        print(src)


if __name__ == "__main__":
    main()
