"""Graph dataset generators (numpy, host side) — the port's copy of
``repro.data.graphs``: the same seed gives bit-equal arrays, and an edge
file saved by either package loads in the other.

R-MAT with the standard (a,b,c,d) = (0.57, 0.19, 0.19, 0.05) parameters —
the generator family the paper uses for its largest graphs — plus a
uniform Erdos-Renyi-style generator as a low-skew control.
"""
from __future__ import annotations

import dataclasses
import io
import os
import tempfile

import numpy as np

from repro_torch.utils import IntegrityError, crc32


@dataclasses.dataclass
class GraphData:
    """An edge list with optional per-edge data, vertices are 0..n-1."""
    num_vertices: int
    src: np.ndarray           # int64 [E]
    dst: np.ndarray           # int64 [E]
    data: np.ndarray | None   # float32 [E] or None

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.num_vertices)

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.num_vertices)

    def reversed(self) -> "GraphData":
        """Graph with reversed edges (paper footnote 4: for 'reverse' messages)."""
        return GraphData(self.num_vertices, self.dst.copy(), self.src.copy(),
                         None if self.data is None else self.data.copy())

    def nbytes(self) -> int:
        """Raw size as (src, dst) pairs, the paper's Table 3 convention."""
        return self.num_edges * 8  # two int32s


def save_edge_list(g: GraphData, path: str) -> int:
    """Serialize a graph as a checksummed npz edge list and return the
    file's CRC32.

    Built once by a run's parent and referenced from the run spec
    (``graph: {"edge_file": path, "crc32": crc}``), so process-mode
    workers can load *arbitrary* graphs — not only ones regenerable from
    RMAT parameters — and verify the bytes before trusting them."""
    buf = io.BytesIO()
    arrays = dict(num_vertices=np.int64(g.num_vertices),
                  src=np.asarray(g.src, np.int64),
                  dst=np.asarray(g.dst, np.int64))
    if g.data is not None:
        arrays["data"] = np.asarray(g.data, np.float32)
    np.savez(buf, **arrays)
    raw = buf.getvalue()
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)))
    with os.fdopen(fd, "wb") as f:
        f.write(raw)
    os.replace(tmp, path)
    return crc32(raw)


def load_edge_list(path: str, expect_crc: int | None = None) -> GraphData:
    """Load a :func:`save_edge_list` file; with ``expect_crc`` the whole
    file is checksummed first and a mismatch raises
    :class:`~repro_torch.utils.IntegrityError` naming the file."""
    with open(path, "rb") as f:
        raw = f.read()
    if expect_crc is not None:
        got = crc32(raw)
        if got != int(expect_crc):
            raise IntegrityError(
                f"edge list {path} failed its checksum (expected "
                f"{int(expect_crc)}, read {got}) — disk corruption")
    with np.load(io.BytesIO(raw), allow_pickle=False) as z:
        data = z["data"] if "data" in z.files else None
        return GraphData(int(z["num_vertices"]), z["src"].copy(),
                         z["dst"].copy(),
                         None if data is None else data.copy())


def rmat_graph(scale: int, edge_factor: int = 16, *, a: float = 0.57,
               b: float = 0.19, c: float = 0.19, seed: int = 0,
               weighted: bool = False, dedup: bool = False) -> GraphData:
    """R-MAT generator (Chakrabarti et al. [14]); 2**scale vertices."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    abc = a + b + c
    for bit in range(scale):
        r = rng.random(m)
        right = r > ab                      # column bit set
        # row bit set: a < r <= ab or r > abc, as three thresholds' parity
        bottom = r > a
        bottom ^= right
        bottom ^= r > abc
        src <<= 1
        src |= bottom
        dst <<= 1
        dst |= right
    if dedup:
        key = src * n + dst
        _, idx = np.unique(key, return_index=True)
        src, dst = src[idx], dst[idx]
        m = src.shape[0]
    data = rng.random(m, dtype=np.float32) if weighted else None
    return GraphData(n, src, dst, data)


def uniform_graph(num_vertices: int, num_edges: int, *, seed: int = 0,
                  weighted: bool = False) -> GraphData:
    """Uniform random directed graph (low-skew control)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_vertices, num_edges, dtype=np.int64)
    dst = rng.integers(0, num_vertices, num_edges, dtype=np.int64)
    data = rng.random(num_edges, dtype=np.float32) if weighted else None
    return GraphData(num_vertices, src, dst, data)


def chain_graph(num_vertices: int, *, weighted: bool = False) -> GraphData:
    """Path graph 0 -> 1 -> ... -> n-1 (worst case diameter, like uk-2014's
    ~2500-iteration behaviour in miniature)."""
    src = np.arange(num_vertices - 1, dtype=np.int64)
    dst = src + 1
    data = np.ones(num_vertices - 1, np.float32) if weighted else None
    return GraphData(num_vertices, src, dst, data)


def star_graph(num_vertices: int) -> GraphData:
    """Hub vertex 0 with edges to everyone (max skew)."""
    src = np.zeros(num_vertices - 1, dtype=np.int64)
    dst = np.arange(1, num_vertices, dtype=np.int64)
    return GraphData(num_vertices, src, dst, None)
