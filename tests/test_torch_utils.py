"""The port's small helpers against the reference's: ``round_up``,
``Timer``, ``time_fn`` (median of the timed calls), ``tree_bytes`` /
``tree_params`` on parameter trees (nested dicts, a module's
``state_dict``), the card's ``HardwareSpec`` (the H100's data-sheet
figures, no TPU constant), and the token pipeline's batches equal to the
reference's for the same seed."""
import time

import numpy as np
import pytest
import torch

from repro import utils as jutils
from repro.data import tokens as jtokens

from repro_torch import utils
from repro_torch.data import tokens


@pytest.mark.parametrize("a,b", [(0, 8), (1, 8), (8, 8), (9, 8), (2047, 2048),
                                 (51865, 2048)])
def test_round_up(a, b):
    assert utils.round_up(a, b) == jutils.round_up(a, b)


def test_timer_and_time_fn():
    with utils.Timer() as t:
        time.sleep(0.01)
    assert t.seconds >= 0.01
    calls = []

    def fn():
        calls.append(1)
        time.sleep(0.002)
        return {"x": torch.ones(3)}
    s = utils.time_fn(fn, warmup=2, iters=5)
    assert len(calls) == 7 and 0.002 <= s < 1.0


def test_tree_bytes_and_params():
    tree = {"a": torch.zeros((3, 4), dtype=torch.bfloat16),
            "b": [{"c": torch.zeros(5)}, (torch.zeros(2, dtype=torch.int64),)],
            "d": np.zeros(7, np.float32), "e": None}
    assert utils.tree_bytes(tree) == 3 * 4 * 2 + 5 * 4 + 2 * 8 + 7 * 4
    assert utils.tree_params(tree) == 12 + 5 + 2 + 7
    ref = {"a": np.zeros((3, 4), np.float16), "b": [np.zeros(5, np.float32)]}
    assert utils.tree_bytes(ref) == jutils.tree_bytes(ref)
    assert utils.tree_params(ref) == jutils.tree_params(ref)
    sd = torch.nn.Linear(4, 3).state_dict()
    assert utils.tree_params(sd) == 4 * 3 + 3
    assert utils.tree_bytes(sd) == (4 * 3 + 3) * 4


def test_hardware_spec_is_the_card():
    h = utils.H100
    assert h.name == "NVIDIA H100 80GB HBM3"
    assert (h.peak_flops, h.peak_flops_fp32, h.hbm_bw) == (989e12, 67e12,
                                                           3.35e12)
    assert (h.hbm_bytes, h.sms, h.smem_per_sm) == (80 * 10**9, 132,
                                                   228 * 1024)
    assert h.peak_flops != jutils.V5E.peak_flops
    assert not hasattr(h, "vmem_bytes") and not hasattr(h, "ici_bw")


def test_token_pipeline_matches_reference():
    a = tokens.TokenPipeline(512, 16, 8, seed=3)
    b = jtokens.TokenPipeline(512, 16, 8, seed=3)
    for step in (0, 1, 7):
        for x, y in zip(a.batch_at(step), b.batch_at(step)):
            np.testing.assert_array_equal(x, y)
        for x, y in zip(a.shard_at(step, 1, 4), b.shard_at(step, 1, 4)):
            np.testing.assert_array_equal(x, y)
    got = list(tokens.synthetic_token_batches(100, 8, 4, 3, seed=1))
    want = list(jtokens.synthetic_token_batches(100, 8, 4, 3, seed=1))
    for (x1, y1), (x2, y2) in zip(got, want):
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(y1, y2)
