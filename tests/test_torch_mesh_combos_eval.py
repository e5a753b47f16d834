"""The full-forward evaluation and simple_dev under catalog_parallel with
a layer-split LM in the port: a 3-layer BERT at tune_from 2 (LoRA r 2)
whose cache each rank holds by rows, at (dp 2) and at (mp 2). Each rank
encodes its own rows through the upper slice in eval mode and the reprs
are gathered (runtime/evaluator.py `catalog_reprs`, runtime/trainer.py
`_simple_dev_loss`); Tester.test() by full forwards, the simple_dev value,
the first test pages' scores and the catalog-parallel step are held
against one process and against JAX on the same mesh of virtual CPU
devices. The cases, the runs and the tolerances are
tests/torch_mesh_cases.py's; the two groups' four ranks run at once
(`python tests/test_torch_mesh_combos_eval.py <group> ...`).
"""
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_cases as mc  # noqa: E402

GROUPS = {"catdp": ["catdp"], "catmp": ["catmp"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mc.run_groups(os.path.abspath(__file__), GROUPS,
                         str(tmp_path_factory.mktemp("combos_eval")))


@pytest.mark.parametrize("name", list(GROUPS))
def test_catalog_parallel_evaluation_matches_one_process_and_jax(runs,
                                                                 name):
    mc.check_case(runs["ranks"][name], runs["one"][name],
                  runs["jax"][name], runs["init"][name])


@pytest.mark.parametrize("name", list(GROUPS))
def test_no_rank_holds_the_whole_cache(runs, name):
    """Each of the two ranks encoded and holds 40 / 2 rows of the
    layer-split cache."""
    for o in runs["ranks"][name]:
        assert o["local_rows"] == 20


if __name__ == "__main__":
    mc.rank_main(sys.argv[1:], GROUPS)
