"""Monkey-patch propagation across process spawns.

Python monkey-patches live in one interpreter; model servers (vLLM, sglang,
accelerate) spawn worker processes that would otherwise see the unpatched
library.  We wrap ``multiprocessing.process.BaseProcess.start`` so every
spawned process re-applies the registered patch functions before running its
target (behavioral equivalent of the reference's zipnn/util_patch.py:11-47).

Idempotent: a patch function is registered and applied at most once per
process, and ``BaseProcess.start`` is wrapped at most once.
"""
from __future__ import annotations

from multiprocessing.process import BaseProcess
from typing import Callable

_applied: dict = {}
_start_wrapped = False


class _PatchedTarget:
    """Picklable wrapper that re-applies patches in the child process."""

    def __init__(self, target, patch_funcs):
        self._target = target
        self._patch_funcs = patch_funcs

    def __call__(self, *args, **kwargs):
        for fn in self._patch_funcs:
            multi_process_patcher(fn)
        if self._target is None:
            return None
        return self._target(*args, **kwargs)


def multi_process_patcher(patch_func: Callable[[], None]) -> None:
    """Apply ``patch_func`` now and in every process spawned from here on."""
    global _start_wrapped
    if patch_func in _applied:
        return
    _applied[patch_func] = None
    patch_func()

    if _start_wrapped:
        return
    _start_wrapped = True
    original_start = BaseProcess.start

    def patched_start(self):
        self._target = _PatchedTarget(self._target, tuple(_applied.keys()))
        return original_start(self)

    BaseProcess.start = patched_start
