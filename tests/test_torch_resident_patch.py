"""Kernel K3, the resident executor's delta patch
(coreth_tpu_torch/ops/csrc/resident_patch.cu via
ops/keccak_cuda.resident_patch), and its plain version
(ops/keccak_resident.resident_patch_plain).

On the CPU the plain version is held to a byte-level numpy model that
shares none of its arithmetic: each digest's 32 bytes are written at their
byte offset into a zeroed window, the old digest's window is subtracted
from the new one's word by word, and the difference is added to the arena
words, a word past the rows landing in the scratch word. The wrapper's
checks and its table slicing are tested through its CPU path. Tests marked
`cuda` hold K3 bit-equal to the plain version on the card and run the
executor on it; this file imports no JAX, so on the card it runs with
`python -m pytest --noconftest tests/test_torch_resident_patch.py -m cuda`
(tests/conftest.py imports JAX, which the card's machine lacks)."""

import numpy as np
import pytest
import torch

from coreth_tpu_torch.device import hopper_available
from coreth_tpu_torch.native.mpt import IncrementalTrie
from coreth_tpu_torch.ops import keccak_cuda
from coreth_tpu_torch.ops.keccak_resident import ResidentExecutor, \
    resident_patch_plain

WIDTH = 34       # words of a class-1 arena row
ROWS = 24        # arena rows in the CPU cases
STORE_ROWS = 40  # store slots (slot 0 the zero sentinel)
DIG_ROWS = 33    # digest matrix rows (row 0 the zero sentinel)
M32 = 1 << 32


def _i32(a: np.ndarray) -> torch.Tensor:
    """uint32 array -> int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _state(rng, rows=ROWS, store_rows=STORE_ROWS, dig_rows=DIG_ROWS):
    """Random arena (rows + the scratch word), store and digest matrix,
    each sentinel row 0 zero; uint32 arrays."""
    flat = rng.integers(0, M32, rows * WIDTH + 1, dtype=np.uint64)
    store = rng.integers(0, M32, (store_rows, 8), dtype=np.uint64)
    dig = rng.integers(0, M32, (dig_rows, 8), dtype=np.uint64)
    store[0] = dig[0] = 0
    return (flat.astype(np.uint32), store.astype(np.uint32),
            dig.astype(np.uint32))


def _model(flat, store, dig, off, src, oldidx) -> np.ndarray:
    """The byte-level model: the arena words after the patches."""
    out = [int(w) for w in flat]
    scratch = len(out) - 1
    for o, s, q in zip(off.tolist(), src.tolist(), oldidx.tolist()):
        new = dig[s] if s > 0 else store[-s]
        windows = []
        for d in (new, store[q]):
            win = np.zeros(36, np.uint8)
            win[o % 4:o % 4 + 32] = d.astype("<u4").view(np.uint8)
            windows.append(win.view("<u4"))
        for j in range(9):
            w = o // 4 + j
            if not 0 <= w < scratch:
                w = scratch
            out[w] = (out[w] + int(windows[0][j]) - int(windows[1][j])) % M32
    return np.array(out, np.uint32)


def _plain(flat, store, dig, off, src, oldidx) -> np.ndarray:
    f = _i32(flat).clone()
    resident_patch_plain(f, _i32(store), _i32(dig),
                         torch.from_numpy(off.astype(np.int32)),
                         torch.from_numpy(src.astype(np.int32)),
                         torch.from_numpy(oldidx.astype(np.int32)))
    return _u32(f)


def _random_patches(rng, n, shift, rows=ROWS, store_rows=STORE_ROWS,
                    dig_rows=DIG_ROWS):
    base = rng.integers(0, rows * WIDTH - 9, n)
    off = 4 * base + shift
    src = rng.integers(-(store_rows - 1), dig_rows, n)
    oldidx = rng.integers(0, store_rows, n)
    return off, src, oldidx


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_plain_matches_byte_model(shift):
    """Random patches at one byte shift, sources of every sign."""
    rng = np.random.default_rng(100 + shift)
    flat, store, dig = _state(rng)
    off, src, oldidx = _random_patches(rng, 48, shift)
    assert (src > 0).any() and (src < 0).any()
    want = _model(flat, store, dig, off, src, oldidx)
    assert np.array_equal(_plain(flat, store, dig, off, src, oldidx), want)


def _branch_row(first, holes, olds, news, store, dig, src_kind):
    """Patches for `holes` neighbouring holes 33 bytes apart from byte
    `first` (a branch node's child references), each replacing an old
    store digest by a new digest of the given source kind."""
    off, src, oldidx = [], [], []
    for k in range(holes):
        off.append(first + 33 * k)
        q = 2 + k
        store[q] = olds[k]
        oldidx.append(q)
        if src_kind == "dig":
            dig[1 + k] = news[k]
            src.append(1 + k)
        elif src_kind == "store":
            store[2 + holes + k] = news[k]
            src.append(-(2 + holes + k))
        else:
            src.append(0)
    return np.array(off), np.array(src), np.array(oldidx)


@pytest.mark.parametrize("src_kind", ["dig", "store", "none"])
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_neighbouring_holes_rewrite_their_bytes(shift, src_kind):
    """Five holes 33 bytes apart, whose strips overlap a word each: after
    the patches the row's bytes hold each new digest where the old one
    was (zeros where the source is none) and every other byte as it was."""
    rng = np.random.default_rng(200 + shift)
    flat, store, dig = _state(rng)
    holes, row = 5, 3
    first = row * WIDTH * 4 + 4 + shift
    olds = rng.integers(0, M32, (holes, 8), dtype=np.uint64).astype(
        np.uint32)
    news = rng.integers(0, M32, (holes, 8), dtype=np.uint64).astype(
        np.uint32)
    off, src, oldidx = _branch_row(first, holes, olds, news, store, dig,
                                   src_kind)
    # some hole's last byte shares a word with the next hole's first
    assert any((o + 32 - 1) // 4 == (o + 33) // 4 for o in off[:-1])
    data = flat.view(np.uint8)
    for k in range(holes):  # the old digests in place
        data[off[k]:off[k] + 32] = olds[k].astype("<u4").view(np.uint8)
    got = _plain(flat, store, dig, off, src, oldidx)
    assert np.array_equal(got, _model(flat, store, dig, off, src, oldidx))
    want = flat.copy()
    wb = want.view(np.uint8)
    for k in range(holes):
        wb[off[k]:off[k] + 32] = (news[k].astype("<u4").view(np.uint8)
                                  if src_kind != "none" else 0)
    assert np.array_equal(got, want)


def test_zero_pad_patches_change_nothing():
    """Pad patches (off = src = oldidx = 0) add zero strips."""
    rng = np.random.default_rng(3)
    flat, store, dig = _state(rng)
    z = np.zeros(16, np.int64)
    assert np.array_equal(_plain(flat, store, dig, z, z, z), flat)
    assert np.array_equal(_model(flat, store, dig, z, z, z), flat)


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_offset_past_rows_lands_in_scratch(shift):
    """A strip whose words lie past the rows adds into the scratch word
    alone: every row word is unchanged."""
    rng = np.random.default_rng(300 + shift)
    flat, store, dig = _state(rng)
    scratch = flat.shape[0] - 1
    off = np.array([4 * scratch + shift, 4 * (scratch + 40) + shift])
    src = np.array([5, -7])
    oldidx = np.array([9, 11])
    got = _plain(flat, store, dig, off, src, oldidx)
    assert np.array_equal(got[:scratch], flat[:scratch])
    assert got[scratch] != flat[scratch]
    assert np.array_equal(got, _model(flat, store, dig, off, src, oldidx))


def _tables(off, src, oldidx, pad=3):
    """The commit's patch tables back to back, each with `pad` extra
    patches on either side of the segment's: (tables, n_tables, start)."""
    n = len(off)
    m = n + 2 * pad
    out = np.zeros(3 * m, np.int32)
    for k, t in enumerate((off, src, oldidx)):
        out[k * m + pad:k * m + pad + n] = t
    return torch.from_numpy(out), m, pad


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_wrapper_on_cpu_takes_the_segment_of_the_tables(shift):
    """keccak_cuda.resident_patch on CPU tensors: the plain version over
    words [start, start + n) of each table, and no launch counted."""
    rng = np.random.default_rng(400 + shift)
    flat, store, dig = _state(rng)
    off, src, oldidx = _random_patches(rng, 32, shift)
    tables, m, start = _tables(off, src, oldidx)
    f = _i32(flat).clone()
    before = keccak_cuda.patch_launches
    keccak_cuda.resident_patch(f, _i32(store), _i32(dig), tables, m, start,
                               len(off))
    assert keccak_cuda.patch_launches == before
    assert np.array_equal(_u32(f), _model(flat, store, dig, off, src,
                                          oldidx))


def _args(rng):
    flat, store, dig = _state(rng)
    off, src, oldidx = _random_patches(rng, 8, 1)
    tables, m, start = _tables(off, src, oldidx)
    return dict(flat=_i32(flat).clone(), store=_i32(store), dig=_i32(dig),
                tables=tables, n_tables=m, start=start, n=len(off))


@pytest.mark.parametrize("name", ["flat", "store", "dig", "tables"])
def test_wrapper_refuses_a_wrong_dtype(name):
    a = _args(np.random.default_rng(5))
    a[name] = a[name].long()
    with pytest.raises(TypeError, match=f"int32 {name}"):
        keccak_cuda.resident_patch(**a)


@pytest.mark.parametrize("name", ["flat", "tables"])
def test_wrapper_refuses_a_non_contiguous_table(name):
    a = _args(np.random.default_rng(6))
    t = a[name]
    a[name] = torch.stack([t, t], dim=1).reshape(-1)[::2]
    assert not a[name].is_contiguous()
    with pytest.raises(ValueError, match=f"contiguous {name}"):
        keccak_cuda.resident_patch(**a)


@pytest.mark.parametrize("start,n", [(-1, 4), (0, 99), (10, 8)])
def test_wrapper_refuses_patches_outside_the_tables(start, n):
    a = _args(np.random.default_rng(7))
    a.update(start=start, n=n)
    with pytest.raises(ValueError, match="do not fit"):
        keccak_cuda.resident_patch(**a)


def _items(rng, n):
    keys = rng.integers(0, 256, size=(n, 32), dtype=np.uint8)
    lens = rng.integers(70, 84, n)
    return [(keys[i].tobytes(), rng.bytes(int(lens[i]))) for i in range(n)]


def _blocks(rng, items, rounds, leaves):
    """Blocks of `leaves` value updates of existing keys, plus a new key
    each."""
    keys = [k for k, _ in items]
    out = []
    for _ in range(rounds):
        pick = rng.choice(len(keys), leaves, replace=False)
        batch = [(keys[int(i)], rng.bytes(int(rng.integers(70, 84))))
                 for i in pick]
        k = rng.bytes(32)
        keys.append(k)
        batch.append((k, rng.bytes(75)))
        out.append(batch)
    return out


class _Segments:
    """Wraps an executor's run() to count each commit's segments with
    patches."""

    def __init__(self, ex):
        self.ex, self.run, self.patched = ex, ex.run, []
        ex.run = self

    def __call__(self, export):
        self.patched.append(int((np.asarray(export["specs"])[:, 3] > 0)
                                .sum()))
        return self.run(export)


def _chain(ex, items, blocks):
    """The roots of genesis and each block, committed on `ex`."""
    t = IncrementalTrie(items)
    roots, launches = [ex.root_bytes(t.commit_resident(ex))], []
    for batch in blocks:
        t.update(batch)
        roots.append(ex.root_bytes(t.commit_resident(ex)))
        launches.append(ex.last_patch_launches)
    return roots, launches


def test_cpu_commit_counts_no_patch_launch():
    """A CPU executor patches through the plain version: no K3 launch, and
    last_patch_launches 0, though its segments carry patches."""
    rng = np.random.default_rng(8)
    items = _items(rng, 2000)
    ex = ResidentExecutor(device="cpu")
    seg = _Segments(ex)
    before = keccak_cuda.patch_launches
    _, launches = _chain(ex, items, _blocks(rng, items, 2, 40))
    assert launches == [0, 0]
    assert all(n > 0 for n in seg.patched[1:])
    assert keccak_cuda.patch_launches == before


# ---------------------------------------------------------------- card


@pytest.fixture
def card():
    if not hopper_available():
        pytest.skip("needs a CUDA device with compute capability >= 9.0 "
                    "(K3 is a CUDA kernel with no CPU build)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 512, 4096])
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_k3_matches_plain_on_card(card, shift, n):
    """K3 bit-equal to the plain version on the same random tables (every
    source sign, pad patches, neighbouring strips, words past the rows),
    one launch."""
    rng = np.random.default_rng(1000 * shift + n)
    rows, store_rows, dig_rows = 4096, 8192, 4097
    flat, store, dig = _state(rng, rows, store_rows, dig_rows)
    off, src, oldidx = _random_patches(rng, n, shift, rows, store_rows,
                                       dig_rows)
    off[:n // 8] = off[n // 8:n // 4] + 33  # neighbours
    off[-2:] = 4 * (rows * WIDTH + 7) + shift  # past the rows
    off[n // 4:n // 4 + 4] = src[n // 4:n // 4 + 4] = 0  # pads
    oldidx[n // 4:n // 4 + 4] = 0
    tables, m, start = _tables(off, src, oldidx)
    args = (_i32(store).to(card), _i32(dig).to(card), tables.to(card), m,
            start, n)
    got = _i32(flat).to(card)
    want = got.clone()
    before = keccak_cuda.patch_launches
    keccak_cuda.resident_patch(got, *args)
    assert keccak_cuda.patch_launches == before + 1
    e = start + n
    t = args[2]
    resident_patch_plain(want, args[0], args[1], t[start:e],
                         t[m + start:m + e], t[2 * m + start:2 * m + e])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_resident_chain_on_card_equals_cpu(card):
    """Resident commits on the card (K3 a segment with patches, K1) give
    the CPU executor's roots, and last_patch_launches is each commit's
    number of segments with patches."""
    rng = np.random.default_rng(9)
    items = _items(rng, 20000)
    blocks = _blocks(rng, items, 4, 300)
    want, _ = _chain(ResidentExecutor(device="cpu"), items, blocks)
    ex = ResidentExecutor(device=card)
    seg = _Segments(ex)
    before = keccak_cuda.patch_launches
    got, launches = _chain(ex, items, blocks)
    assert got == want
    assert launches == seg.patched[1:]
    assert all(n > 0 for n in launches)
    assert keccak_cuda.patch_launches - before == sum(seg.patched)


@pytest.mark.cuda
def test_k1_launches_unchanged_with_k3_off(card, monkeypatch):
    """The same chain with K3 replaced in this test by the plain version on
    the card's tensors: the same roots and the same K1 launches, and no
    K3 launch."""
    rng = np.random.default_rng(10)
    items = _items(rng, 20000)
    blocks = _blocks(rng, items, 3, 300)
    k1 = keccak_cuda.launches
    on, _ = _chain(ResidentExecutor(device=card), items, blocks)
    k1_on = keccak_cuda.launches - k1

    def plain(flat, store, dig, tables, m, start, n):
        e = start + n
        resident_patch_plain(flat, store, dig, tables[start:e],
                             tables[m + start:m + e],
                             tables[2 * m + start:2 * m + e])

    monkeypatch.setattr(keccak_cuda, "resident_patch", plain)
    k1, k3 = keccak_cuda.launches, keccak_cuda.patch_launches
    off, _ = _chain(ResidentExecutor(device=card), items, blocks)
    assert off == on
    assert keccak_cuda.launches - k1 == k1_on > 0
    assert keccak_cuda.patch_launches == k3
