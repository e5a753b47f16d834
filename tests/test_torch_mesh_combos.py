"""Two axes of exp.policy.mesh at once in the port: mp x sp (the flatten
Transformer's Ulysses and ring paths beside row-sharded tables, at (dp 1,
mp 2, sp 2)) and sp x pp (a BERT item operator in GPipe stages beside a
sequence-parallel flatten Transformer user operator, at (dp 1, sp 2,
pp 2), which JAX runs), each against one process and against JAX on the
same mesh of virtual CPU devices. The cases, the runs and the tolerances
are tests/torch_mesh_cases.py's; the two groups' eight ranks run at once
(`python tests/test_torch_mesh_combos.py <group> ...`).
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_mesh_cases as mc  # noqa: E402

GROUPS = {"mpsp": ["mpsp_ulysses", "mpsp_ring"], "sppp": ["sppp"]}
NAMES = [n for cases in GROUPS.values() for n in cases]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return mc.run_groups(os.path.abspath(__file__), GROUPS,
                         str(tmp_path_factory.mktemp("combos")))


@pytest.mark.parametrize("name", NAMES)
def test_combination_matches_one_process_and_jax(runs, name):
    """The loss, every gradient, the Adam update, the dev value, the first
    test pages' scores and the test metrics."""
    mc.check_case(runs["ranks"][name], runs["one"][name],
                  runs["jax"][name], runs["init"][name])


def test_mp_x_sp_shards_the_tables_and_keeps_the_operator_whole(runs):
    """JAX's layout: mp row-shards the emb tables, the sp operator's
    parameters stay whole on every rank."""
    for o in runs["ranks"]["mpsp_ulysses"]:
        assert o["plan"] and all(k.startswith("eh.tables.")
                                 for k in o["plan"])
        for k, v in o["state"].items():
            if k.startswith("user_op."):
                assert v.shape == runs["init"]["mpsp_ulysses"][k].shape


if __name__ == "__main__":
    mc.rank_main(sys.argv[1:], GROUPS)
