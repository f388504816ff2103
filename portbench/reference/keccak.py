"""Keccak-256 (the Ethereum variant: pad 0x01 ... 0x80, rate 136 bytes) in
plain PyTorch, batched over many messages.

A message batch is a uint8 tensor [n, W] whose row i holds message i in
its first lengths[i] bytes (the rest is ignored). The state is int64
[25, n], lane x + 5*y in row x + 5*y; a 64-bit lane is carried in int64
bits, so every right shift is masked back to a logical one. The same
code runs on the CPU (tests) and on a CUDA device (the benchmark's
comparison), with no kernel of its own and nothing of the program.
"""

from __future__ import annotations

import torch

RATE = 136  # bytes absorbed per permutation
RATE_LANES = RATE // 8

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation offset of lane (x, y), indexed x + 5*y
_ROT = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _pi_source():
    """src[dst]: pi moves lane (x, y) to (y, 2x + 3y mod 5)."""
    src = [0] * 25
    for x in range(5):
        for y in range(5):
            src[y + 5 * ((2 * x + 3 * y) % 5)] = x + 5 * y
    return src


class _Tables:
    """Per-device constants, built once per device."""

    def __init__(self, device):
        rot = torch.tensor(_ROT, dtype=torch.int64, device=device)[:, None]
        self.rot = rot
        self.rot_back = 64 - rot
        # mask of the low `rot` bits: what a logical shift right by
        # 64 - rot keeps (lane 0 rotates by 0 and keeps nothing)
        self.rot_mask = torch.tensor(
            [_signed((1 << r) - 1) for r in _ROT], dtype=torch.int64,
            device=device)[:, None]
        self.pi_src = torch.tensor(_pi_source(), dtype=torch.int64,
                                   device=device)
        self.rc = [torch.tensor(_signed(c), dtype=torch.int64, device=device)
                   for c in _RC]
        self.x_next = torch.tensor([(x + 1) % 5 for x in range(5)],
                                   device=device)
        self.x_next2 = torch.tensor([(x + 2) % 5 for x in range(5)],
                                    device=device)
        self.x_prev = torch.tensor([(x - 1) % 5 for x in range(5)],
                                   device=device)


_TABLES = {}


def _tables(device) -> _Tables:
    key = str(device)
    if key not in _TABLES:
        _TABLES[key] = _Tables(device)
    return _TABLES[key]


def keccak_f(a: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] over every column of int64 [25, m]; a new tensor."""
    t = _tables(a.device)
    m = a.shape[1]
    for rc in t.rc:
        s = a.view(5, 5, m)  # [y, x, m]
        c = s[0] ^ s[1] ^ s[2] ^ s[3] ^ s[4]  # [x, m]
        c1 = c.index_select(0, t.x_next)
        d = c.index_select(0, t.x_prev) ^ ((c1 << 1) | ((c1 >> 63) & 1))
        a = (s ^ d).view(25, m)
        r = (a << t.rot) | ((a >> t.rot_back) & t.rot_mask)
        b = r.index_select(0, t.pi_src).view(5, 5, m)
        a = b ^ (~b.index_select(1, t.x_next) & b.index_select(1, t.x_next2))
        a = a.view(25, m)
        a[0] ^= rc
    return a


def pad(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """uint8 [n, W] messages -> uint8 [n, B * 136] keccak-padded blocks,
    B the largest block count: bytes past each length are zeroed, 0x01
    follows the message and 0x80 ends its last block (0x81 when those
    are one byte)."""
    n = rows.shape[0]
    lengths = lengths.to(torch.int64)
    blocks = lengths // RATE + 1
    width = int(blocks.max()) * RATE if n else RATE
    out = torch.zeros((n, width), dtype=torch.uint8, device=rows.device)
    w = min(rows.shape[1], width)
    col = torch.arange(w, device=rows.device)
    out[:, :w] = torch.where(col[None, :] < lengths[:, None], rows[:, :w],
                             torch.zeros((), dtype=torch.uint8,
                                         device=rows.device))
    ar = torch.arange(n, device=rows.device)
    out[ar, lengths] ^= 0x01
    out[ar, blocks * RATE - 1] ^= 0x80
    return out


def keccak256(rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Keccak-256 of each message: uint8 [n, W] rows with int lengths
    [n] -> uint8 [n, 32] digests."""
    n = rows.shape[0]
    dev = rows.device
    if n == 0:
        return torch.zeros((0, 32), dtype=torch.uint8, device=dev)
    padded = pad(rows, lengths)
    blocks = lengths.to(torch.int64) // RATE + 1
    # longest messages first, so block j absorbs into a prefix of lanes
    order = torch.argsort(blocks, descending=True, stable=True)
    padded = padded.index_select(0, order)
    counts = [int(v) for v in
              torch.bincount(blocks, minlength=int(blocks.max()) + 1)]
    lanes = padded.view(torch.int64)  # [n, B * 17], little-endian lanes
    state = torch.zeros((25, n), dtype=torch.int64, device=dev)
    active = n
    for j in range(padded.shape[1] // RATE):
        if j:
            active -= counts[j]
        blk = lanes[:active, j * RATE_LANES:(j + 1) * RATE_LANES].t()
        head = state[:, :active].clone()
        head[:RATE_LANES] ^= blk
        state[:, :active] = keccak_f(head)
    digest = state[:4].t().contiguous().view(torch.uint8)  # [n, 32]
    out = torch.empty_like(digest)
    out[order] = digest
    return out


def keccak256_bytes(data: bytes, device="cpu") -> bytes:
    """Keccak-256 of one message (a convenience for tests and set-up)."""
    row = torch.tensor(list(data) or [0], dtype=torch.uint8,
                       device=device)[None, :]
    n = torch.tensor([len(data)], dtype=torch.int64, device=device)
    return bytes(keccak256(row, n)[0].cpu().tolist())


def keccak256_list(msgs, device="cpu") -> list:
    """Keccak-256 of each bytes object in `msgs`, in one batch."""
    if not msgs:
        return []
    width = max(1, max(len(m) for m in msgs))
    rows = torch.zeros((len(msgs), width), dtype=torch.uint8)
    for i, m in enumerate(msgs):
        if m:
            rows[i, :len(m)] = torch.frombuffer(bytearray(m),
                                                dtype=torch.uint8)
    lens = torch.tensor([len(m) for m in msgs], dtype=torch.int64)
    out = keccak256(rows.to(device), lens.to(device)).cpu().numpy()
    return [out[i].tobytes() for i in range(len(msgs))]
