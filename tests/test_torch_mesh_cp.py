"""Training over a DeviceMesh on 4 gloo ranks, continued from
tests/test_torch_mesh_train.py (same checks, same tolerances):

- internvl2 smoke over (4, 1), batch 2: context parallelism (the
  sequence over "data", the VLM prefix on rank 0's rows; the loss's sum
  and row count summed over the ranks).
- lightningdit smoke over (2, 2): one flow-matching step and one
  `distill_loss_fn` step (the paper's fine-tune).
- qwen3 and lightningdit smoke over a 1 x 1 mesh of one rank: the mesh
  path (its DTensor gathers and collectives over one rank) bitwise the
  port's one-device run, as the card holds it at full width.
"""
import pytest

from _torch_mesh_train import check_one_rank_is_plain, check_train_case
from _torch_threads import one_torch_thread  # noqa: F401

CASES = [
    ("internvl2-1b", (4, 1), ("loss_fn", "loss_fn")),
    ("lightningdit_1b", (2, 2), ("loss_fn", "distill_loss_fn")),
]


@pytest.mark.parametrize("arch,mesh,losses", CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m, _ in CASES])
def test_sharded_train_step_matches_one_device(arch, mesh, losses,
                                               tmp_path):
    check_train_case(arch, mesh, losses, tmp_path)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "lightningdit_1b"])
def test_one_rank_mesh_is_the_plain_path_bitwise(arch, tmp_path):
    check_one_rank_is_plain(arch, ("loss_fn", "loss_fn"), tmp_path)
