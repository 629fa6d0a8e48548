"""The port's mesh train step against the reference's, as
``test_torch_train_mesh.py`` holds it, with the batch split into two
microbatches (the dense, hybrid and MoE families) and with
``flags.MOE_GROUPS`` set (per-source-group expert capacity, the dispatch
buffers' group axis over 'data') for DeepSeek-MoE's EP and Mixtral's
TP-within-expert plans.  Same tolerances; one 4-rank job."""
import pytest

from test_torch_train_mesh import (
    assert_step_matches, case_id, run_against_reference,
)

VARIANTS = [("yi-6b", None, 2, None), ("zamba2-1.2b", None, 2, None),
            ("deepseek-moe-16b", None, 2, None),
            ("deepseek-moe-16b", None, 1, 2), ("mixtral-8x22b", 3, 1, 2)]


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
