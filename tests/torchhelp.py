"""Shared helpers for the ``tests/test_torch_*.py`` parity suites: one small
weighted RMAT problem built by the JAX package and carried into the port
through :mod:`repro_torch.interop`, so both packages run on identical
structures."""
import dataclasses

import numpy as np

GRAPH = dict(scale=7, edge_factor=8, seed=3, weighted=True)
SPEC = dict(num_partitions=4, batch_size=16)


def jax_fields(obj) -> dict:
    """A reference dataclass (DistGraph / ChunkFormats / BlockTiles) as the
    plain mapping :mod:`repro_torch.interop` takes: numpy arrays for the
    array fields, Python values for the static ones."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = dataclasses.asdict(v)
        elif hasattr(v, "shape"):
            out[f.name] = np.asarray(v)
        else:
            out[f.name] = v
    return out


def port_fields(obj) -> dict:
    """The port's structure as numpy arrays / Python values."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = dataclasses.asdict(v)
        elif hasattr(v, "cpu"):
            out[f.name] = v.cpu().numpy()
        else:
            out[f.name] = v
    return out


def assert_same_fields(ref: dict, port: dict):
    """Every array bit-equal (same dtype and shape), every static equal."""
    assert ref.keys() == port.keys()
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert port[k].dtype == v.dtype, (k, port[k].dtype, v.dtype)
            assert port[k].shape == v.shape, (k, port[k].shape, v.shape)
            assert np.array_equal(port[k], v), k
        else:
            assert port[k] == v, (k, port[k], v)
