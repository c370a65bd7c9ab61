"""The MoE family (Moonlight smoke: 4 experts, top 2, a shared expert)
trained over a ("data", "model") DeviceMesh on gloo ranks, with expert
parallelism over "model", against the port on one device and the
reference on one device (the checks and tolerances of
tests/test_torch_mesh_train.py), and the train CLI's sharded resume.

- (2, 2): data parallelism, 2 experts a rank.
- (1, 4): one expert a rank; "model" does not divide the 2 KV heads.
- (4, 1), batch 2, capacity factor 0.5 on every side: context
  parallelism with a batch above 1 (a rank's tokens are not contiguous
  in the global order) and slots that drop.
- (2, 2) at batch 1: context parallelism and expert parallelism.
- (1, 1), one rank: bitwise the one-device run (as the card holds it at
  full width).
In every case each MoE call's kept and dropped slots (in the global
token order) are bitwise the one-device run's: the capacity is the
global one.
"""
import pytest

from _torch_mesh_train import (check_cli_resume, check_one_rank_is_plain,
                               check_train_case)
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "moonshot-v1-16b-a3b"
CASES = [
    ((2, 2), (), None),
    ((1, 4), (), None),
    ((4, 1), (("capacity_factor", 0.5),), None),
    ((2, 2), (), 1),
]


@pytest.mark.parametrize("mesh,overrides,batch", CASES, ids=[
    "2x2", "1x4", "4x1-cp-drops", "2x2-cp-batch1"])
def test_moe_trains_over_a_mesh_with_expert_parallelism(mesh, overrides,
                                                       batch, tmp_path):
    res = check_train_case(ARCH, mesh, ("loss_fn", "loss_fn"), tmp_path,
                           overrides, batch)
    assert res["slots"].size
    if overrides:
        assert not res["slots"].all()  # slots dropped


def test_moe_train_cli_resumes_on_a_2x2_mesh(tmp_path, capsys,
                                             monkeypatch):
    check_cli_resume(ARCH, tmp_path, capsys, monkeypatch)


def test_moe_one_rank_mesh_is_the_plain_path_bitwise(tmp_path):
    check_one_rank_is_plain(ARCH, ("loss_fn", "loss_fn"), tmp_path)
