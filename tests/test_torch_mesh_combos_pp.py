"""mp x pp in the port: bert-naml layer-split (a 3-layer BERT at
tune_from 1, LoRA r 2) with Megatron TP inside each GPipe stage, at (dp 1,
mp 2, pp 2) and at JAX's tests/test_mesh_policy.py layout (dp 2, mp 2,
pp 2), where dp's rows within microbatches, TP and the stages meet at
once; each against one process and against JAX on the same mesh of
virtual CPU devices (JAX gathers the TP-sharded kernels inside a stage:
the same function, to TP's rounding). The cases, the runs and the
tolerances are tests/torch_mesh_cases.py's; the two groups' twelve ranks
run at once (`python tests/test_torch_mesh_combos_pp.py <group> ...`).
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_cases as mc  # noqa: E402

GROUPS = {"mppp": ["mppp"], "dpmppp": ["dpmppp"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mc.run_groups(os.path.abspath(__file__), GROUPS,
                         str(tmp_path_factory.mktemp("combos_pp")))


@pytest.mark.parametrize("name", list(GROUPS))
def test_mp_x_pp_matches_one_process_and_jax(runs, name):
    """The loss, every gradient, the Adam update, the dev value, the first
    test pages' scores and the test metrics."""
    mc.check_case(runs["ranks"][name], runs["one"][name],
                  runs["jax"][name], runs["init"][name])


@pytest.mark.parametrize("name", list(GROUPS))
def test_each_stage_holds_its_tp_slice(runs, name):
    """Each rank holds its mp slice of every staged layer's q, k, v, FFN
    and output kernels (the sharded checkpoint's layout), and the
    gradients of the layers outside its stage come from the pp sum."""
    init = runs["init"][name]
    for o in runs["ranks"][name]:
        tp = [k for k, d in o["plan"].items() if k.startswith("item_op.lm.")]
        assert tp
        for k in tp:
            assert o["state"][k].shape[o["plan"][k]] * 2 == \
                init[k].shape[o["plan"][k]]


if __name__ == "__main__":
    mc.rank_main(sys.argv[1:], GROUPS)
