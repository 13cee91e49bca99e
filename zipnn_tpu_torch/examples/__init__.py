"""Runnable examples of the port: ``python -m zipnn_tpu_torch.examples.<name>``.

Each example runs on the card unless it is given ``--device cpu`` (the
kernels' plain versions), makes its data from a seed, writes only under a
temporary directory that it removes, and raises on a mismatch.
"""
import argparse

import torch


def parser(doc: str) -> argparse.ArgumentParser:
    """An example's argument parser, with its ``--device``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain versions)")
    return ap


def device_of(args) -> torch.device:
    """``args.device``; raises where it names the card and there is none."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    return dev


def require(ok: bool, what: str) -> None:
    """Raise (not an ``assert``: those vanish under ``python -O``) unless
    ``ok``."""
    if not ok:
        raise SystemExit(f"mismatch: {what}")
