"""Shared small utilities: the jax-free subset of ``repro.utils`` plus the
port's device rule, its timing helpers and the card's roofline constants."""
from __future__ import annotations

import base64
import contextlib
import dataclasses
import json
import os
import tempfile
import time
import zlib
from typing import Any, Callable

import numpy as np
import torch


class IntegrityError(RuntimeError):
    """A stored or transmitted artifact failed its checksum.

    Raised at every verification boundary (chunk section, spill batch,
    ckpt block, wire frame, manifest) with a message naming the damaged
    artifact — never a silent wrong result."""


def crc32(data, seed: int = 0) -> int:
    """CRC32 of ``data`` (bytes / buffer / ndarray), as unsigned int."""
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data)
    return zlib.crc32(memoryview(data).cast("B"), seed) & 0xFFFFFFFF


def json_crc(obj: Any) -> int:
    """Canonical CRC32 of a JSON-serializable object (sorted keys)."""
    return crc32(json.dumps(obj, sort_keys=True).encode())


def pack_bools(a) -> str:
    """Bool array -> base64 bitmap string (JSON-friendly; the run-log
    representation of a per-op active mask)."""
    a = np.asarray(a, bool)
    return base64.b64encode(np.packbits(a.reshape(-1)).tobytes()).decode(
        "ascii")


def unpack_bools(s: str, shape) -> np.ndarray:
    """Inverse of :func:`pack_bools` for a known shape."""
    raw = np.frombuffer(base64.b64decode(s), np.uint8)
    n = int(np.prod(shape))
    return np.unpackbits(raw, count=n).reshape(shape).astype(bool)


def atomic_write_json(path: str, obj: Any) -> None:
    """Write JSON via tmp-file + rename so a crash mid-write never leaves a
    truncated file behind (the blockstore/chunkstore manifest commit point)."""
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def token_ctx(lock):
    """Context manager over an optional shared compute token: the lock
    itself when given, a no-op otherwise.

    A prefetch pipeline holds it for each host-CPU decode burst, so
    concurrent pipelines take orderly turns at the host CPU instead of
    convoying on the GIL at every small numpy call; disk waits and queue
    handoffs stay outside the token.  Sequential pipelines pass None and
    pay nothing."""
    return lock if lock is not None else contextlib.nullcontext()


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


def tree_leaves(tree: Any):
    """Tensor / array leaves of a parameter tree: nested dicts, lists and
    tuples (a module's ``state_dict`` is a dict)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree


def tree_bytes(tree: Any) -> int:
    """Total bytes of all tensor / array leaves of a parameter tree."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
    return total


def tree_params(tree: Any) -> int:
    """Total number of elements of all tensor / array leaves."""
    return sum(int(np.prod(leaf.shape)) for leaf in tree_leaves(tree)
               if hasattr(leaf, "shape"))


class Timer:
    """Wall-clock timer; ``with Timer() as t: ...; t.seconds``."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False


def _sync(result) -> None:
    """Wait for the device work behind ``result`` (the port's
    ``block_until_ready``): synchronize CUDA when any leaf is on the card."""
    if any(isinstance(leaf, torch.Tensor) and leaf.is_cuda
           for leaf in tree_leaves(result)):
        torch.cuda.synchronize()


def time_fn(fn: Callable[[], Any], warmup: int = 1, iters: int = 3) -> float:
    """Median wall-time of fn() in seconds, waiting for CUDA results."""
    for _ in range(warmup):
        _sync(fn())
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants of the target card — for the port, one NVIDIA
    H100 80GB HBM3 (SXM5) at its 700 W power limit (:data:`H100`):
    data-sheet peaks (dense tensor-core bf16, CUDA-core fp32, HBM rate and
    size, SMs, shared memory per SM), not measurements.  A card set below
    700 W runs slower under load."""
    name: str
    peak_flops: float            # bf16 dense FLOP/s
    peak_flops_fp32: float       # fp32 FLOP/s (CUDA cores)
    hbm_bw: float                # bytes/s
    hbm_bytes: int               # device memory
    sms: int
    smem_per_sm: int             # bytes


# The figures the port's bounds use (PERF.md section 6).
H100 = HardwareSpec(name="NVIDIA H100 80GB HBM3", peak_flops=989e12,
                    peak_flops_fp32=67e12, hbm_bw=3.35e12,
                    hbm_bytes=80 * 10**9, sms=132, smem_per_sm=228 * 1024)


def resolve_device(device=None) -> torch.device:
    """The port's device rule: ``None`` means the GPU, and raises when
    there is none — an entry point never drifts to the CPU on its own.
    Tests pass ``device="cpu"`` explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)
