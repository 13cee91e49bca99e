"""The kernel library's bookkeeping, on the CPU: the build's name follows
every source and header, and launch events are recorded per thread."""
import threading

from zipnn_tpu_torch.ops import kernels


def test_source_tag_follows_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    tag = kernels.source_tag()
    assert kernels.source_tag() == tag
    (tmp_path / "b.cuh").write_text("// v2\n")
    assert kernels.source_tag() != tag
    (tmp_path / "b.cuh").write_text("// v1\n")
    assert kernels.source_tag() == tag
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n// edit\n')
    assert kernels.source_tag() != tag


def test_recording_is_per_thread_and_nests():
    assert kernels._recording.get() is None
    seen = []
    with kernels.recording() as outer:
        assert kernels._recording.get() is outer
        with kernels.recording() as inner:
            assert inner is not outer and kernels._recording.get() is inner
            t = threading.Thread(target=lambda: seen.append(kernels._recording.get()))
            t.start()
            t.join()
        assert kernels._recording.get() is outer
    assert kernels._recording.get() is None
    assert seen == [None]  # another thread's launches are not recorded here
    assert outer == [] and inner == []
    assert kernels.elapsed_ms(outer, ("huf_pc_decode", "combine_cells")) == {
        "huf_pc_decode": 0.0, "combine_cells": 0.0}
