"""Shared small utilities: the jax-free subset of ``repro.utils`` plus the
port's device rule."""
from __future__ import annotations

import base64
import contextlib
import json
import os
import tempfile
import zlib
from typing import Any

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
