"""The port's mesh train step against the reference's, as
``test_torch_train_mesh.py`` holds it, with the batch split into two
microbatches (the dense, hybrid and MoE families) and with
``flags.MOE_GROUPS`` set (per-source-group expert capacity, the dispatch
buffers' group axis over 'data') for DeepSeek-MoE's EP and Mixtral's
TP-within-expert plans, and on a (1, 4) mesh Llama3 (2 KV heads, groups
of 4), where ``plan_for`` shards q and o over the GQA group axis, and
Gemma2 (2 KV heads, groups of 2), whose flat-head attention cuts the 4
heads over 'model' and gathers their gradients before the grouped
layout.  Same tolerances; one 4-rank job."""
import pytest

from test_torch_train_mesh import (
    assert_step_matches, case_id, run_against_reference,
)

VARIANTS = [("yi-6b", None, 2, None), ("zamba2-1.2b", None, 2, None),
            ("deepseek-moe-16b", None, 2, None),
            ("deepseek-moe-16b", None, 1, 2), ("mixtral-8x22b", 3, 1, 2),
            ("llama3-405b", None, 1, None, (1, 4)),
            ("gemma2-9b", None, 1, None, (1, 4))]


@pytest.fixture(scope="module")
def results():
    return run_against_reference(VARIANTS)


@pytest.mark.parametrize("case", VARIANTS, ids=case_id)
def test_mesh_train_step_variant_matches_reference(results, case):
    assert_step_matches(*results[case_id(case)])


def test_groups_shard_the_capacity_over_data(results):
    for key in ("deepseek-moe-16b-groups2", "mixtral-8x22b-e3-groups2"):
        assert any("per-group capacity (G=2) sharded over data axes" in n
                   for n in results[key][0]["notes"])


def test_group_axis_and_flat_head_plans(results):
    assert results["llama3-405b-mesh1x4"][0]["notes"] == (
        "kv=2 not divisible by tp=4: q/o sharded over the GQA group axis "
        "(g=4), k/v replicated",)
    assert results["gemma2-9b-mesh1x4"][0]["notes"] == (
        "kv=2, group=2 indivisible by tp=4 but H=4 divides: flat-head "
        "attention w/ repeated KV",)
