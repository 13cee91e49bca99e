"""Multi-process compress and decompress of one file, on ``torch.distributed``.

The counterpart of the JAX package's ``parallel/multihost.py``.  The
``.znn`` format is chunk-parallel by construction, so several processes
(on one machine or many) need no data exchange, only agreement on
metadata:

1. every process takes a contiguous, deterministic chunk range of the
   input (:func:`chunk_range`) and reads only its byte range;
2. each compresses its range with any engine (``"cuda"`` by default, on
   its own card); the local payload's tables describe its cells;
3. the per-cell types and sizes are all-gathered (a few integers a chunk:
   the only collective, :func:`_allgather_i64`, on gloo over the host);
4. every process computes the same global tables and the byte offset of
   each of its plane regions, and writes them into the output file in
   place (``pwrite``): the container is assembled bit for bit where it
   lies, and no process holds more than its own range.

The result is byte-identical to a one-process ``ZipNN(...).compress`` of
the whole file, for any number of processes (one included, where no
collective runs).

Start the processes with ``torchrun --nproc_per_node N`` (its
``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` /
``LOCAL_RANK`` are :func:`initialize`'s defaults) or call
``initialize(address, n, rank)`` in each.  gloo and not NCCL: the
collectives carry a few integers per chunk on the host, and NCCL refuses
two ranks on one card.  Each rank's card is ``cuda:<LOCAL_RANK %
device_count>`` unless the caller passes ``device``.
"""
from __future__ import annotations

import datetime
import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import codec
from ..core import dtypes
from ..core.header import HEADER_LEN, Header
from .sharded import chunk_range  # noqa: F401  (part of this module's API)

TIMEOUT_S = 600  # a collective that waits longer (a rank died) raises

# what the last call spent on this process, host-clock seconds: read_s
# (the input range), compress_s / decompress_s (the codec), collective_s
# (all-gathers and barriers) and write_s (the output's pwrites)
last_timings: Dict[str, float] = {}


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout_s: float = TIMEOUT_S,
) -> None:
    """Join the process group (gloo), once per process.

    ``coordinator_address`` is ``host:port`` of rank 0 (default
    ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` the world size
    (default ``WORLD_SIZE``, else 1) and ``process_id`` this rank (default
    ``RANK``, else 0).  With one process and no address nothing is
    initialised.  A collective that waits ``timeout_s`` raises, so a rank
    that dies fails the others instead of hanging them."""
    import torch.distributed as dist  # noqa: PLC0415

    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if coordinator_address is None:
        if world > 1:
            raise ValueError("initialize: several processes need a coordinator address")
        return
    if not coordinator_address.startswith("tcp://"):
        coordinator_address = f"tcp://{coordinator_address}"
    dist.init_process_group("gloo", init_method=coordinator_address, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def _process():
    """(rank, world size): (0, 1) with no process group."""
    import torch.distributed as dist  # noqa: PLC0415

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather_i64(local: np.ndarray) -> np.ndarray:
    """All-gather an int64 array across processes -> [n_processes, ...]."""
    import torch.distributed as dist  # noqa: PLC0415

    t0 = time.perf_counter()
    local = np.ascontiguousarray(local, dtype=np.int64)
    if _process()[1] == 1:
        return local[None]
    mine = torch.from_numpy(local)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    _clock("collective_s", t0)
    return np.stack([p.numpy() for p in parts])


def _barrier(name: str) -> None:
    """All processes reach ``name`` before any goes on."""
    import torch.distributed as dist  # noqa: PLC0415

    if _process()[1] > 1:
        t0 = time.perf_counter()
        dist.barrier()
        _clock("collective_s", t0)


def _clock(key: str, t0: float) -> float:
    t = time.perf_counter()
    last_timings[key] = last_timings.get(key, 0.0) + t - t0
    return t


def _device(engine: str, device):
    """The card of this rank on engine ``"cuda"``: ``device``, else
    ``cuda:<LOCAL_RANK % device_count>``, made the current device."""
    if codec.resolve_engine(engine) != "cuda":
        return device or "cpu"
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("engine='cuda' needs a CUDA device; pass device='cpu' to run "
                               "the kernels' plain versions")
        local = int(os.environ.get("LOCAL_RANK", _process()[0]))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def _make_zipnn(
    bytearray_dtype, method, compression_chunk, threshold, engine, threads,
    huffman_table, check_th_after_percent, is_streaming, streaming_chunk,
    delta_second_path, device,
):
    from ..zipnn import ZipNN  # noqa: PLC0415

    return ZipNN(
        method=method,
        input_format="byte",
        bytearray_dtype=bytearray_dtype,
        threads=threads,
        compression_threshold=threshold,
        check_th_after_percent=check_th_after_percent,
        compression_chunk=compression_chunk,
        is_streaming=is_streaming,
        streaming_chunk=streaming_chunk,
        delta_compressed_type="file" if delta_second_path else 0,
        engine=engine,
        device=device,
        huffman_table=huffman_table,
    )


def _read(path: str, lo: int, n: int) -> bytes:
    with open(path, "rb") as f:
        f.seek(lo)
        return f.read(n)


def _read_range(in_path: str, lo: int, n: int, delta_path: Optional[str]) -> np.ndarray:
    """Bytes [lo, lo + n) of ``in_path``, XORed with the same range of
    ``delta_path`` if given."""
    t0 = time.perf_counter()
    data = np.frombuffer(_read(in_path, lo, n), dtype=np.uint8)
    if delta_path is not None:
        data = np.bitwise_xor(data, np.frombuffer(_read(delta_path, lo, data.size), np.uint8))
    _clock("read_s", t0)
    return data


def compress_file_multihost(
    in_path: str,
    out_path: str,
    *,
    bytearray_dtype: str = "bfloat16",
    method: str = "AUTO",
    compression_chunk: int = 256 * 1024,
    threshold: float = codec.DEFAULT_THRESHOLD,
    engine: str = "cuda",
    device=None,
    threads: int = 0,
    huffman_table: str = "per_chunk",
    check_th_after_percent: int = 10,
    is_streaming: bool = False,
    streaming_chunk: int = 1024 * 1024,
    delta_second_path: Optional[str] = None,
) -> None:
    """Compress ``in_path`` into one ``.znn`` container, every process of
    the group taking its chunk range.

    The knobs are ``ZipNN``'s (an instance is made here; the header comes
    from ``ZipNN._make_header``), and the output is byte-identical to a
    one-process ``ZipNN(...).compress`` of the whole file:

    * ``huffman_table="per_chunk"``: the bounded threshold check
      (``check_th_after_percent``) is made over the global prefix: chunks
      ``[0, K]`` are compressed first, their per-plane stored sizes
      all-gathered, and every process takes the same plane-abandonment
      decision (``raw_planes``) before it compresses its later chunks;
    * ``huffman_table="shared"``: each process counts only its sampled
      chunks (global chunk index 0 mod the sampling stride,
      ``codec.sampled_plane_counts``), one more all-gather sums the
      [num_buf, 256] counts, and every process builds the same tables
      (``preset_shared``);
    * ``is_streaming=True``: the frames (one per ``streaming_chunk``) are
      split over the processes, each frame compressed whole by one;
    * ``delta_second_path``: each process XORs its byte range with the
      same range of that file first (``delta_compressed_type="file"``).

    ``engine="cuda"`` (the default) encodes each range on the rank's card
    (``device``, default ``cuda:<LOCAL_RANK % device_count>``); ``"numpy"``
    and ``"native"`` on the host.
    """
    last_timings.clear()
    t_all = time.perf_counter()
    pid, n_proc = _process()
    device = _device(engine, device)
    z = _make_zipnn(
        bytearray_dtype, method, compression_chunk, threshold, engine,
        threads, huffman_table, check_th_after_percent, is_streaming,
        streaming_chunk, delta_second_path, device,
    )
    info = dtypes.from_any(bytearray_dtype)
    grp = dtypes.grouping_for_code(info.code)
    num_buf, byte_reorder, bit_reorder = grp.num_buf, grp.byte_reorder, grp.bit_reorder
    total = os.path.getsize(in_path)
    if delta_second_path is not None and os.path.getsize(delta_second_path) != total:
        raise ValueError("Length of delta file has to match the length of the original file.")

    if is_streaming:
        _compress_streaming_multihost(z, in_path, out_path, total, delta_second_path)
        last_timings["wall_s"] = time.perf_counter() - t_all
        return

    chunk = codec.effective_chunk(compression_chunk, num_buf)
    n_chunks = codec.num_chunks_for(total, chunk)
    lo, hi = chunk_range(pid, n_proc, n_chunks)
    max_local = -(-n_chunks // n_proc)
    local_n = hi - lo
    data = np.zeros(0, dtype=np.uint8)
    if local_n:
        data = _read_range(in_path, lo * chunk, min(hi * chunk, total) - lo * chunk,
                           delta_second_path)

    def encode(seg, **kw):
        t0 = time.perf_counter()
        out = codec.compress_payload(seg, num_buf, bit_reorder, byte_reorder, chunk,
                                     threshold=threshold, engine=engine, device=device, **kw)
        _clock("compress_s", t0)
        return out

    shared_tables = huffman_table == "shared"
    segments = []  # (payload, chunks) in chunk order over [lo, hi)
    check_idx = (None if shared_tables
                 else codec.check_abandon_index(n_chunks, check_th_after_percent))
    if shared_tables:
        # the shared profile's collective: the sampled counts summed over
        # the processes, so every process builds the same tables
        stride = codec.shared_sample_stride(n_chunks)
        if codec.resolve_engine(engine) == "numpy":
            counts = codec.sampled_plane_counts
        else:
            from .. import native  # noqa: PLC0415

            counts = native.sampled_counts
        t0 = time.perf_counter()
        local_counts = counts(data, num_buf, bit_reorder, byte_reorder, chunk,
                              global_chunk0=lo, stride=stride)
        _clock("compress_s", t0)
        preset = codec.shared_tables_from_counts(
            _allgather_i64(local_counts).sum(axis=0), threshold, stride)
        if local_n:
            segments.append((encode(data, shared_tables=True, preset_shared=preset), local_n))
    elif check_idx is not None:
        # the bounded threshold check over the global prefix [0, K]: its
        # per-plane stored sizes summed over the processes, the same
        # abandonment everywhere, then the later chunks with those planes raw
        plo, phi = lo, min(hi, check_idx + 1)
        prefix = np.zeros((num_buf, 2), dtype=np.int64)  # stored, uncompressed
        if phi > plo:
            payload = encode(data[: (phi - plo) * chunk])
            segments.append((payload, phi - plo))
            _, starts, _ = codec.parse_tables(payload, num_buf, phi - plo)
            prefix[:, 0] = starts[:, -1]
            prefix[:, 1] = (phi - plo) * (chunk // num_buf)
        stat = _allgather_i64(prefix).sum(axis=0)
        raw_planes = codec.check_abandon_planes(stat[:, 0], stat[:, 1], threshold)
        rest = max(lo, check_idx + 1)
        if hi > rest:
            segments.append((encode(data[(rest - lo) * chunk :], raw_planes=raw_planes),
                             hi - rest))
    elif local_n:
        segments.append((encode(data), local_n))

    # the segments' cell tables and each plane's blobs, in chunk order
    ltypes = np.zeros((num_buf, local_n), np.uint8)
    lsizes = np.zeros((num_buf, local_n), np.int64)
    plane_blobs = [[] for _ in range(num_buf)]
    at = 0
    for payload, seg_n in segments:
        st, ss, base = codec.parse_tables(payload, num_buf, seg_n)
        ltypes[:, at : at + seg_n] = st
        lsizes[:, at : at + seg_n] = ss[:, 1:] - ss[:, :-1]
        mv = memoryview(payload)
        for b in range(num_buf):
            plane_blobs[b].append(mv[base : base + int(ss[b, seg_n])])
            base += int(ss[b, seg_n])
        at += seg_n

    # the collective: every process's cell types and sizes
    packed = np.full((2, num_buf, max_local), -1, dtype=np.int64)
    packed[0, :, :local_n] = ltypes
    packed[1, :, :local_n] = lsizes
    world = _allgather_i64(packed)  # [n_proc, 2, num_buf, max_local]
    types = np.zeros((num_buf, n_chunks), dtype=np.uint8)
    sizes = np.zeros((num_buf, n_chunks), dtype=np.uint64)
    for p in range(n_proc):
        plo, phi = chunk_range(p, n_proc, n_chunks)
        types[:, plo:phi] = world[p, 0, :, : phi - plo]
        sizes[:, plo:phi] = world[p, 1, :, : phi - plo]

    cumulative = np.cumsum(sizes, axis=1, dtype=np.uint64)
    plane_totals = (cumulative[:, -1].astype(np.int64) if n_chunks
                    else np.zeros(num_buf, np.int64))
    plane_base = np.concatenate([[0], np.cumsum(plane_totals)[:-1]]).astype(np.int64)
    tables = types.tobytes() + cumulative.astype("<u8").tobytes()
    data_start = HEADER_LEN + len(tables)
    total_len = data_start + int(plane_totals.sum())

    # in place: rank 0 writes the header and tables, each its plane regions
    if pid == 0:
        t0 = time.perf_counter()
        hdr = z._make_header()
        hdr.byte_reorder, hdr.bit_reorder, hdr.dtype_code = byte_reorder, bit_reorder, info.code
        hdr.original_len, hdr.total_len = total, total_len
        with open(out_path, "wb") as f:
            f.truncate(total_len)
            f.write(hdr.to_bytes() + tables)
        _clock("write_s", t0)
    _barrier("znn-mh-header")
    if local_n:
        t0 = time.perf_counter()
        with open(out_path, "r+b") as f:
            for b in range(num_buf):
                f.seek(data_start + int(plane_base[b])
                       + int(cumulative[b, lo - 1] if lo else 0))
                for blob in plane_blobs[b]:
                    f.write(blob)
        _clock("write_s", t0)
    _barrier("znn-mh-data")
    last_timings["wall_s"] = time.perf_counter() - t_all


def _compress_streaming_multihost(
    z, in_path: str, out_path: str, total: int, delta_second_path: Optional[str]
) -> None:
    """Streaming mode: the frames (each an independent container of
    ``streaming_chunk`` input bytes) split over the processes, each
    compressed whole by one (``ZipNN._compress_one``); the frames' sizes
    all-gathered; each process writes its frames at their offsets."""
    pid, n_proc = _process()
    sc = z.streaming_chunk
    n_frames = codec.num_chunks_for(total, sc)
    lo, hi = chunk_range(pid, n_proc, n_frames)
    blobs = []
    local_sizes = np.full(-(-n_frames // n_proc), -1, dtype=np.int64)
    if hi > lo:
        raw = _read_range(in_path, lo * sc, min(hi * sc, total) - lo * sc, delta_second_path)
        t0 = time.perf_counter()
        for i in range(hi - lo):
            blobs.append(z._compress_one(raw[i * sc : (i + 1) * sc]))
            local_sizes[i] = len(blobs[-1])
        _clock("compress_s", t0)
    world = _allgather_i64(local_sizes)
    frame_sizes = np.zeros(n_frames, dtype=np.int64)
    for p in range(n_proc):
        plo, phi = chunk_range(p, n_proc, n_frames)
        frame_sizes[plo:phi] = world[p, : phi - plo]
    offsets = np.concatenate([[0], np.cumsum(frame_sizes)])
    if pid == 0:
        with open(out_path, "wb") as f:
            f.truncate(int(offsets[-1]))
    _barrier("znn-mh-sheader")
    if hi > lo:
        t0 = time.perf_counter()
        with open(out_path, "r+b") as f:
            for i, blob in enumerate(blobs):
                f.seek(int(offsets[lo + i]))
                f.write(blob)
        _clock("write_s", t0)
    _barrier("znn-mh-sdata")


_FLOAT_ST = {"F64", "F32", "F16", "BF16", "F8_E4M3", "F8_E5M2"}


def compress_safetensors_multihost(
    in_path: str,
    out_path: str,
    *,
    engine: str = "cuda",
    device=None,
    method: str = "HUFFMAN",
    huffman_table: str = "per_chunk",
) -> None:
    """Compress a safetensors file tensor by tensor into one
    ``.znn.safetensors`` file, every process taking its share.

    The tensors are split over the processes by
    ``io.streaming.partition_names`` (size-balanced, the same everywhere
    with no communication); each process range-reads and compresses only
    its own, the output sizes and keep-raw flags are all-gathered (2
    integers a tensor), and every process builds the same safetensors
    header (the ``znn_compressed_vectors`` schema that
    ``plugins.safetensors.SafeOpen`` loads) and writes its tensors' bytes
    in place.  Each tensor is compressed whole by one process, so the
    file does not depend on the process count in either profile.
    """
    from ..io.streaming import _ST_DTYPES, METADATA_KEY, SafetensorsStreamReader  # noqa: PLC0415
    from ..zipnn import ZipNN  # noqa: PLC0415

    last_timings.clear()
    t_all = time.perf_counter()
    pid, n_proc = _process()
    device = _device(engine, device)
    rdr = SafetensorsStreamReader(in_path)
    names = rdr.keys()  # file order = output order
    mine = set(rdr.shard_names(n_proc, pid))
    blobs: dict = {}
    local = np.zeros((len(names), 2), dtype=np.int64)  # [out bytes, compressed]
    for i, name in enumerate(names):
        if name not in mine:
            continue
        raw_n = rdr.nbytes(name)
        comp = None
        if rdr._tensors[name]["dtype"] in _FLOAT_ST:
            t0 = time.perf_counter()
            t = rdr._stored(name)
            t0 = _clock("read_s", t0)
            blob = ZipNN(input_format="torch", method=method, engine=engine, device=device,
                         huffman_table=huffman_table).compress(t)
            _clock("compress_s", t0)
            if blob is not None and len(blob) < raw_n:
                comp = bytes(blob)
        if comp is None:
            local[i] = (raw_n, 0)  # raw bytes pass through untouched
        else:
            blobs[name] = comp
            local[i] = (len(comp), 1)

    world = _allgather_i64(local)  # [n_proc, n_tensors, 2]
    owner = {n: p for p in range(n_proc) for n in rdr.shard_names(n_proc, p)}
    sizes = np.array([world[owner[n], i] for i, n in enumerate(names)],
                     dtype=np.int64).reshape(len(names), 2)

    # the same header on every process (insertion order = file order)
    infos, header = {}, {}
    md = dict(rdr.metadata)
    md.pop(METADATA_KEY, None)
    md.setdefault("format", "pt")
    off = 0
    for i, name in enumerate(names):
        nbytes, is_comp = int(sizes[i, 0]), int(sizes[i, 1])
        info = rdr._tensors[name]
        if is_comp:
            infos[name] = {"dtype": _ST_DTYPES[info["dtype"]], "shape": str(list(info["shape"]))}
            header[name] = {"dtype": "U8", "shape": [nbytes], "data_offsets": [off, off + nbytes]}
        else:
            header[name] = {"dtype": info["dtype"], "shape": list(info["shape"]),
                            "data_offsets": [off, off + nbytes]}
        off += nbytes
    md[METADATA_KEY] = json.dumps(infos)
    hjson = json.dumps({"__metadata__": md, **header}, separators=(",", ":")).encode()
    hjson += b" " * ((-(8 + len(hjson))) % 8)  # the data region on 8 bytes
    data_start = 8 + len(hjson)

    if pid == 0:
        with open(out_path, "wb") as f:
            f.truncate(data_start + off)
            f.write(len(hjson).to_bytes(8, "little") + hjson)
    _barrier("znn-mh-st-header")
    t0 = time.perf_counter()
    with open(out_path, "r+b") as f:
        for name in names:
            if name in mine:
                f.seek(data_start + header[name]["data_offsets"][0])
                f.write(blobs[name] if name in blobs else rdr.read_bytes(name))
    _clock("write_s", t0)
    _barrier("znn-mh-st-data")
    last_timings["wall_s"] = time.perf_counter() - t_all


def decompress_file_multihost(
    in_path: str, out_path: str, *, delta_second_path: Optional[str] = None,
    engine: str = "cuda", device=None,
) -> None:
    """Decompress a ``.znn`` container with every process of the group:
    each decodes its chunk range's cells (on ``engine="cuda"`` onto its
    card, then fetched) and writes its plaintext range in place.

    A streaming container (frames back to back) is split by frame: a walk
    of the headers indexes every frame's bytes and output offset, and each
    process decodes its frames whole.  With ``delta_second_path`` each
    range is XORed with the same range of that file before it is written.
    """
    last_timings.clear()
    t_all = time.perf_counter()
    pid, n_proc = _process()
    device = _device(engine, device)
    with open(in_path, "rb") as f:
        head = f.read(HEADER_LEN)
        if len(head) == 0:
            if pid == 0:
                open(out_path, "wb").close()
            _barrier("znn-mh-dempty")
            return
        if len(head) >= 14 and head[13] > 127:
            f.seek(0)
            _decompress_streaming_multihost(f, out_path, delta_second_path, engine, device)
            last_timings["wall_s"] = time.perf_counter() - t_all
            return
        hdr, _ = Header.from_bytes(head, formats_with_shape=())
        num_buf = dtypes.groups_for_decompress(hdr.dtype_code)
        chunk = codec.effective_chunk(hdr.compression_chunk, num_buf)
        n_chunks = codec.num_chunks_for(hdr.original_len, chunk)
        t_len = num_buf * n_chunks
        tables = f.read(t_len + t_len * 8)
        types = np.frombuffer(tables[:t_len], np.uint8).reshape(num_buf, n_chunks)
        starts = np.zeros((num_buf, n_chunks + 1), dtype=np.int64)
        starts[:, 1:] = np.frombuffer(tables[t_len:], "<u8").reshape(num_buf, n_chunks)
        plane_base = np.concatenate([[0], np.cumsum(starts[:, -1])[:-1]]).astype(np.int64)
        data_start = HEADER_LEN + t_len + t_len * 8

        lo, hi = chunk_range(pid, n_proc, n_chunks)
        if pid == 0:
            with open(out_path, "wb") as fo:
                fo.truncate(hdr.original_len)
        _barrier("znn-mh-dheader")
        if hi > lo:
            # a local payload (the tables of [lo, hi), then its blobs) for
            # the one-process decoder
            t0 = time.perf_counter()
            lsizes = (starts[:, lo + 1 : hi + 1] - starts[:, lo:hi]).astype(np.uint64)
            parts = [types[:, lo:hi].tobytes(),
                     np.cumsum(lsizes, axis=1, dtype=np.uint64).astype("<u8").tobytes()]
            for b in range(num_buf):
                f.seek(data_start + int(plane_base[b]) + int(starts[b, lo]))
                parts.append(f.read(int(starts[b, hi] - starts[b, lo])))
            local_len = min(hi * chunk, hdr.original_len) - lo * chunk
            t0 = _clock("read_s", t0)
            out = _host(codec.decompress_payload(
                b"".join(parts), num_buf, hdr.bit_reorder, hdr.byte_reorder, chunk, local_len,
                engine=engine, device=device))
            t0 = _clock("decompress_s", t0)
            if delta_second_path is not None:
                out = np.bitwise_xor(out, np.frombuffer(
                    _read(delta_second_path, lo * chunk, out.size), np.uint8))
            with open(out_path, "r+b") as fo:
                fo.seek(lo * chunk)
                fo.write(out)
            _clock("write_s", t0)
    _barrier("znn-mh-ddata")
    last_timings["wall_s"] = time.perf_counter() - t_all


def _host(flat) -> np.ndarray:
    """A decoded range on the host: a CUDA tensor fetched through the
    staging pool's pinned pieces (``decode.fetch``)."""
    if isinstance(flat, np.ndarray):
        return flat
    if not flat.is_cuda:
        return flat.numpy()
    from ..ops import decode  # noqa: PLC0415

    out = np.empty(flat.numel(), dtype=np.uint8)
    decode.fetch(flat, out, {})
    return out


def _decompress_streaming_multihost(f, out_path: str, delta_second_path: Optional[str],
                                    engine: str, device) -> None:
    """A streaming container's frames split over the processes, each
    decoded whole by one."""
    from ..zipnn import ZipNN  # noqa: PLC0415

    pid, n_proc = _process()
    frames = []  # (input offset, input length, output offset)
    in_off = out_off = 0
    f.seek(0, os.SEEK_END)
    file_len = f.tell()
    while in_off < file_len:
        f.seek(in_off)
        head = f.read(HEADER_LEN)
        if len(head) < HEADER_LEN or head[:2] != b"ZN":
            raise ValueError("Header should start with ZN")
        total = int.from_bytes(head[24:32], "little")
        if not 0 < total <= file_len - in_off:
            total = file_len - in_off
        frames.append((in_off, total, out_off))
        in_off += total
        out_off += int.from_bytes(head[16:24], "little")

    lo, hi = chunk_range(pid, n_proc, len(frames))
    if pid == 0:
        with open(out_path, "wb") as fo:
            fo.truncate(out_off)
    _barrier("znn-mh-dsheader")
    if hi > lo:
        z = ZipNN(input_format="byte", engine=engine, device=device)
        with open(out_path, "r+b") as fo:
            for foff, flen, ooff in frames[lo:hi]:
                f.seek(foff)
                t0 = time.perf_counter()
                piece = np.frombuffer(z.decompress_bin(memoryview(f.read(flen))), np.uint8)
                t0 = _clock("decompress_s", t0)
                if delta_second_path is not None:
                    piece = np.bitwise_xor(piece, np.frombuffer(
                        _read(delta_second_path, ooff, piece.size), np.uint8))
                fo.seek(ooff)
                fo.write(piece)
                _clock("write_s", t0)
    _barrier("znn-mh-dsdata")
