"""PyTorch port: launch sets (``ops/decode.py`` ``LaunchSet``, ``Stack``)
on the CPU, where the kernels' plain versions run.

Every staged container decodes in launch sets: ``ShardDecoder
.decompress_stacked`` cuts a unit's containers into pieces (one per batch
of ``decode.plan_batches``) and decodes each run of pieces of one
geometry as a set (one K1 launch per schedule, one
``combine_cells_grouped``), and ``start_staged`` decodes a stack of one.
The outputs must equal the original bytes and each member's
``decode.finish(decode.start(...))`` (``ShardDecoder.start``), byte for
byte, over a mix of every kind of member: bf16 containers of several
chunks with a ragged tail, a sub-chunk one (K1's lane schedule), a
shared-table one (K6's route under ``decode.start``, K1 in a set), an
fp32 one (a second geometry), an empty one, a lossy-integer one, a
streaming container of frames, one over a (patched, small)
``decode.BATCH_BYTES``, split over two sets, and one of 2-byte chunks (a
set of its own, K2 by ``combine_cells``).  Also: the first corrupt member
in order raises its own ``CorruptChunkError``; ``kernels.launch_sets``
counts sets and members; ``combine_cells_grouped``'s plain version equals
``combine_cells_plain`` member by member.  Imports neither ``jax`` nor
``zipnn_tpu``, so the card tests (``tests/test_torch_cuda.py``) build the
same mix from here.
"""
import numpy as np
import pytest
import torch

from zipnn_tpu_torch import CorruptChunkError, ZipNN, codec
from zipnn_tpu_torch.io.serving import ShardDecoder
from zipnn_tpu_torch.ops import combine, decode, kernels
from zipnn_tpu_torch.ops.byte_group import plane_lengths

CHUNK = 16384
SMALL_BATCH = 4 * CHUNK  # decode.BATCH_BYTES for the mix: sets close on size


def _bf16(nbytes, seed):
    rng = np.random.default_rng(seed)
    vals = (rng.standard_normal(nbytes // 2) * 0.05).astype(np.float32)
    return ((vals.view(np.uint32) >> 16).astype("<u2")).tobytes()[:nbytes]


def mixed_unit(device="cpu"):
    """(names, inputs, containers) of a unit holding every kind of member,
    in an order that makes sets close on geometry and on size.  ``inputs``
    are the bytes each container holds (None for the lossy one, whose
    output is its integers turned back to floats)."""
    kw = {"engine": "native", "compression_chunk": CHUNK}
    rng = np.random.default_rng(5)
    f32 = (rng.standard_normal(10_000) * 0.02).astype(np.float32).tobytes()
    lossy = torch.from_numpy((rng.standard_normal((64, 96)) * 0.05).astype(np.float32))
    items = [
        ("bf16_ragged", _bf16(3 * CHUNK + 1000, 1), {}),
        ("sub_chunk", _bf16(2000, 2), {}),
        ("shared", _bf16(2 * CHUNK, 3), {"huffman_table": "shared"}),
        ("bf16_tail6", _bf16(2 * CHUNK + 6, 4), {}),
        ("fp32", f32, {"bytearray_dtype": "float32"}),
        ("fp32_small", f32[:3000], {"bytearray_dtype": "float32"}),
        ("empty", b"", {}),
        ("bf16_a", _bf16(3 * CHUNK, 6), {}),
        ("lossy", None, {"input_format": "torch", "lossy_compressed_type": "integer"}),
        ("bf16_b", _bf16(3 * CHUNK + 100, 7), {}),
        ("streaming", _bf16(3 * CHUNK + 10, 8), {"is_streaming": True,
                                                 "streaming_chunk": 2 * CHUNK}),
        ("bf16_big", _bf16(6 * CHUNK + 50, 9), {}),
        ("sub_word", _bf16(1000, 11), {"compression_chunk": 2}),
        ("bf16_c", _bf16(CHUNK + 8, 10), {}),
    ]
    names = [n for n, _, _ in items]
    inputs = [d for _, d, _ in items]
    blobs = [bytes(ZipNN(**dict(kw, **extra)).compress(lossy if d is None else d))
             for _, d, extra in items]
    return names, inputs, blobs


def stage_mixed(dec, blobs):
    """Each container staged; each member's output decoded alone by
    ``decode.start`` (``ShardDecoder.start``), which no launch set runs."""
    staged = [dec.stage(b) for b in blobs]
    alone = [as_bytes(dec.start(b).finish()) for b in blobs]
    return staged, alone


def held_on_card(st) -> list:
    """The names of a staged container's tensor attributes: its payload
    only, never descriptor arrays."""
    return [k for k, v in vars(st.staged).items() if isinstance(v, torch.Tensor)]


def as_bytes(out) -> bytes:
    """A decoder's output (a uint8 tensor or numpy array) as bytes."""
    return bytes(out.cpu().numpy() if isinstance(out, torch.Tensor) else out)


@pytest.fixture(scope="module")
def mix():
    return mixed_unit()


@pytest.fixture
def small_batch(monkeypatch):
    monkeypatch.setattr(decode, "BATCH_BYTES", SMALL_BATCH)


def test_stacked_mix_equals_each_member_alone(mix, small_batch):
    names, inputs, blobs = mix
    dec = ShardDecoder(device="cpu", to_device=True)
    staged, alone = stage_mixed(dec, blobs)
    for name, data, got in zip(names, inputs, alone):
        if data is not None:
            assert got == data, name
    stk = dec.stack(staged)
    sets = stk.unit.sets
    pieces = [[(m, lo, hi) for m, lo, hi in ls.pieces] for ls in sets]
    where = {m: [i for i, ps in enumerate(pieces) for p in ps if p[0] == m]
             for m in range(len(names))}
    # what the mix is for: every member with bytes in a set, both K1
    # schedules in one set, the shared-table and the lossy members in sets,
    # the member over BATCH_BYTES cut into its batches over two sets, the
    # 2-byte chunks a set of its own, four geometries, a set closed on size
    big = staged[names.index("bf16_big")].staged.plan.g
    assert [(lo, hi) for ps in pieces for m, lo, hi in ps if names[m] == "bf16_big"] == \
        decode.plan_batches(big.n_chunks, big.chunk_size) == [(0, 4), (4, 7)]
    assert len(set(where[names.index("bf16_big")])) == 2
    assert where[names.index("empty")] == []
    assert all(where[m] for m, n in enumerate(names) if n != "empty")
    assert len(where[names.index("lossy")]) == 1
    (odd,) = where[names.index("sub_word")]
    assert len(pieces[odd]) == 1 and sets[odd].k2[0] is combine.combine_cells
    assert all(ls.k2[0] is combine.combine_cells_grouped for i, ls in enumerate(sets) if i != odd)
    assert any([g for g, _ in ls.k1] == [1, 32] for ls in sets)
    assert staged[names.index("shared")].staged.plan.shared
    assert len({ls.geometry for ls in sets}) == 4
    bf16 = [[m for m, _, _ in ps] for ls, ps in zip(sets, pieces) if ls.geometry[:2] == (CHUNK, 2)]
    assert any(a[-1] + 1 == b[0] for a, b in zip(bf16, bf16[1:]))  # closed on size
    for _ in range(2):  # a stack replays
        outs = dec.decompress_stacked(stk)
        assert [bytes(o.numpy()) for o in outs] == alone
        assert len(dec.timings) == len(blobs)
    # no member holds its descriptors on the device (the sets hold them),
    # nor a payload of its own beside the unit's; each still decodes alone
    # (a stack of one) after the stack moved its payload
    assert all(held_on_card(st) in ([], ["payload"]) for st in staged)
    unit = stk.unit.payload.untyped_storage().data_ptr()
    assert all(st.staged.payload.untyped_storage().data_ptr() == unit
               for st in staged if st.staged.plan is not None)
    for m, st in enumerate(staged):
        assert bytes(dec.start_staged(st).finish().numpy()) == alone[m], names[m]


def odd_chunk_staged(chunk=1002):
    """(staged, bytes) of a bf16 payload at a chunk size that is not a
    multiple of 4 but holds Huffman cells (``ZipNN`` takes powers of 2
    only, so it is staged from ``codec.compress_payload_numpy``)."""
    raw = _bf16(5 * chunk + 300, 12)
    payload = codec.compress_payload_numpy(np.frombuffer(raw, np.uint8), 2, 1, 10, chunk)
    st = decode.stage(payload, 2, 1, 10, chunk, len(raw), device="cpu")
    assert st.plan.n_huf > 0
    return st, raw


@pytest.mark.parametrize("unit", ["set", "odd_chunk", "split"])
def test_outputs_of_a_set_share_one_buffer(mix, monkeypatch, unit):
    """A unit's outputs are views of one buffer, each on a
    ``SET_ALIGN`` boundary, equal to the originals: three containers of
    one set; a container whose chunk size is not a multiple of 4 between
    two others, a set of its own whose K2 is ``combine_cells``; a
    container split over two sets (a patched, small ``BATCH_BYTES``), its
    second piece in a set with a small container."""
    names, inputs, blobs = mix
    dec = ShardDecoder(device="cpu", to_device=True)
    keep = {"set": ("bf16_ragged", "sub_chunk", "bf16_tail6"),
            "odd_chunk": ("bf16_ragged", "odd", "bf16_tail6"),
            "split": ("bf16_big", "sub_chunk")}[unit]
    if unit == "split":
        monkeypatch.setattr(decode, "BATCH_BYTES", SMALL_BATCH)
    staged, want = [], []
    for n in keep:
        st, raw = odd_chunk_staged() if n == "odd" else (
            dec.stage(blobs[names.index(n)]).staged, inputs[names.index(n)])
        staged.append(st)
        want.append(raw)
    stk = decode.Stack(staged, "cpu")
    outs, check = stk.start()
    decode.validate_deferred([check])
    assert [bytes(o.numpy()) for o in outs] == want
    assert len({o.untyped_storage().data_ptr() for o in outs}) == 1
    offs = [o.storage_offset() for o in outs]
    assert offs[0] == 0 and all(o % decode.SET_ALIGN == 0 for o in offs)
    assert outs[0].view(torch.bfloat16).numel() == outs[0].numel() // 2
    pieces = [ls.pieces for ls in stk.sets]
    if unit == "odd_chunk":
        assert pieces == [[(0, 0, 4)], [(1, 0, 6)], [(2, 0, 3)]]
        assert stk.sets[1].k2[0] is combine.combine_cells
    if unit == "split":
        assert pieces == [[(0, 0, 4)], [(0, 4, 7), (1, 0, 1)]]


def test_groups_take_the_same_launch_sets(mix, small_batch):
    names, _, blobs = mix
    dec = ShardDecoder(device="cpu", as_numpy=True)
    staged, alone = stage_mixed(dec, blobs)
    units = dec.stack_groups([blobs[0]] + staged[1:])
    assert [u[0] for u in units] == ["one", "stk", "n"]
    kernels.reset_launches()
    got = dec.decompress_groups(units)
    assert [g.tobytes() for g in got] == alone
    sets = units[1][1].unit.sets
    assert kernels.launch_sets == {"sets": len(sets), "containers": sum(ls.n for ls in sets)}


def test_launch_sets_count_sets_and_members(mix, small_batch):
    _, _, blobs = mix
    dec = ShardDecoder(device="cpu", to_device=True)
    stk = dec.stack([dec.stage(b) for b in blobs])
    sets = stk.unit.sets
    kernels.reset_launches()
    dec.decompress_stacked(stk)
    assert kernels.launch_sets == {"sets": len(sets),
                                   "containers": sum(len({m for m, _, _ in ls.pieces})
                                                     for ls in sets)}
    assert kernels.launches["huf_pc_decode"] == 0  # the plain versions launch nothing
    kernels.reset_launches()
    assert kernels.launch_sets == {"sets": 0, "containers": 0}


def test_stacks_with_no_launch(mix):
    """A stack of nothing, and one of empty containers only: no launch,
    nothing to fetch, the outputs in order."""
    names, _, blobs = mix
    dec = ShardDecoder(device="cpu", to_device=True)
    assert dec.decompress_stacked(dec.stack([])) == []
    empty = blobs[names.index("empty")]
    outs = dec.decompress_stacked([dec.stage(empty), dec.stage(empty)])
    assert [o.numel() for o in outs] == [0, 0]


def _reject_flip(blob: bytes, stream: int) -> bytes:
    """``blob`` (bf16) with one bit flipped in Huffman stream ``stream``, a
    copy that the port's own decode rejects."""
    z = ZipNN(engine="cuda", device="cpu")
    after = z._retrieve_header(memoryview(blob))
    plan = decode.build_plan(memoryview(blob)[after:], 2, z._bit_reorder,
                             z._byte_reorder, z.compression_chunk, z.original_len)
    s0, ln = after + int(plan.starts[stream]), int(plan.lens[stream])
    for bit in range(8 * (ln // 2), 8 * (ln - 1)):
        bad = bytearray(blob)
        bad[s0 + bit // 8] ^= 1 << (bit % 8)
        try:
            ZipNN(engine="cuda", device="cpu").decompress(bytes(bad))
        except CorruptChunkError:
            return bytes(bad)
    pytest.fail("no rejected bit flip found")


def test_first_corrupt_member_raises_its_own_error(mix):
    """The sub-chunk member decodes in the lane launch, after the warp
    launch's streams: its error is raised, before that of a later member
    whose stream lies earlier in the set's ``bits_left``."""
    names, _, blobs = mix
    first = names.index("sub_chunk")
    later = names.index("bf16_tail6")
    bad1 = _reject_flip(blobs[first], 1)
    bad2 = _reject_flip(blobs[later], 4 * 1 + 2)
    with pytest.raises(CorruptChunkError) as own:
        ZipNN(engine="cuda", device="cpu").decompress(bad1)
    dec = ShardDecoder(device="cpu", to_device=True)
    units = [blobs[0], bad1, blobs[3], bad2]
    stk = dec.stack([dec.stage(b) for b in units])
    (ls,) = stk.unit.sets
    assert [g for g, _ in ls.k1] == [1, 32] and ls.streams[1][0] > ls.streams[3][0]
    for call in (lambda: dec.decompress_stacked(stk),
                 lambda: dec.decompress_groups(dec.stack_groups(stk.shards))):
        with pytest.raises(CorruptChunkError) as got:
            call()
        assert (got.value.plane, got.value.chunk, got.value.stream) == (
            own.value.plane, own.value.chunk, own.value.stream)
        assert str(got.value) == str(own.value)


def grouped_case(num_buf, byte_reorder, seed, chunk=64, sizes=(300, 64, 7 * 64 + 4, 45)):
    """Random cells of several members at one chunk size: ``payload``, the
    set's symbol buffer, each member's ``combine_cells`` arguments (its
    rows of the symbol buffer) and the set's ``combine_cells_grouped`` ones
    (outputs at ``decode.SET_ALIGN``-aligned offsets).  Returns
    (payload, hsym, members, grouped, out_bytes); each member is
    ``(out_offset, total_bytes, kinds, srcs, hsym_offset, row)``."""
    rng = np.random.default_rng(seed)
    payload = torch.from_numpy(rng.integers(0, 256, 8192, dtype=np.uint8))
    row = -(-chunk // 4) * 4  # a member's symbol row: the longest plane, word-rounded
    members, kinds_g, srcs_g, offs_g, lens_g = [], [], [], [], []
    out_off = sym_off = 0
    for total in sizes:
        n_chunks = -(-total // chunk)
        kinds, srcs, h = [], [], 0
        for c in range(n_chunks):
            clen = min(chunk, total - c * chunk)
            for b, n in enumerate(plane_lengths(clen, num_buf, byte_reorder)):
                k = int(rng.integers(0, 3))
                kinds.append(k)
                if k == 0:
                    srcs.append(int(rng.integers(0, payload.numel() - n)))
                elif k == 1:
                    srcs.append(int(rng.integers(0, 256)))
                else:
                    srcs.append(h)
                    h += 1
            offs_g.append(out_off + c * chunk)
            lens_g.append(clen)
        kinds = np.array(kinds, np.int32)
        srcs = np.array(srcs, np.int64)
        members.append((out_off, total, kinds, srcs, sym_off, row))
        g = srcs.copy()
        g[kinds == 2] = sym_off + g[kinds == 2] * row
        kinds_g.append(kinds)
        srcs_g.append(g)
        out_off += -(-total // decode.SET_ALIGN) * decode.SET_ALIGN
        sym_off += -(-max(h, 1) * row // decode.SET_ALIGN) * decode.SET_ALIGN
    hsym = torch.from_numpy(rng.integers(0, 256, sym_off, dtype=np.uint8))
    grouped = (torch.from_numpy(np.concatenate(kinds_g)), torch.from_numpy(np.concatenate(srcs_g)),
               torch.tensor(offs_g, dtype=torch.int64), torch.tensor(lens_g, dtype=torch.int32))
    return payload, hsym, members, grouped, out_off


LAYOUTS = [(1, 0, 0), (2, 10, 1), (2, 1, 1), (2, 8, 0), (4, 220, 1), (4, 220, 0)]


@pytest.mark.parametrize("num_buf,byte_reorder,bit_reorder", LAYOUTS)
def test_grouped_plain_equals_combine_plain_member_by_member(num_buf, byte_reorder,
                                                             bit_reorder):
    chunk = 64
    payload, hsym, members, grouped, n_out = grouped_case(num_buf, byte_reorder, 11)
    out = torch.full((n_out,), 0xA5, dtype=torch.uint8)
    combine.combine_cells_grouped(payload, hsym, *grouped, 1, chunk, num_buf, byte_reorder,
                                  bit_reorder, out)
    for off, total, kinds, srcs, sym_off, row in members:
        own = torch.full((-(-total // 4) * 4,), 0x5A, dtype=torch.uint8)
        combine.combine_cells_plain(payload, hsym[sym_off:], torch.from_numpy(kinds),
                                    torch.from_numpy(srcs), row, chunk, total, num_buf,
                                    byte_reorder, bit_reorder, own)
        assert torch.equal(out[off : off + own.numel()], own), (off, total)
