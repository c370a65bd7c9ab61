"""The hybrid (zamba2 smoke: Mamba2 layers and the shared SLA block) and
recurrent (rwkv6) families trained over a ("data", "model") DeviceMesh
on gloo ranks, against the port on one device and the reference on one
device (the checks and tolerances of tests/test_torch_mesh_train.py),
and the train CLI's sharded resume at zamba2.

- zamba2 over (2, 2): the Mamba2 heads and the shared block's heads
  over "model".
- zamba2 over (2, 2) at batch 1: context parallelism, so the conv's
  halo, the scan's carried state and the shared block's attention over
  the gathered sequence.
- rwkv6 over (2, 2) and over (4, 1) at batch 1 (context parallelism:
  the token shifts' halo and the carried state), on the 4-head twin of
  the smoke config (the smoke config's 2-wide group norm is
  ill-conditioned at 5e-5: tests/test_torch_rwkv6.py).
- Both over a 1 x 1 mesh of one rank: bitwise the one-device run (as the
  card holds them at full width).
"""
import pytest

from _torch_mesh_train import (check_cli_resume, check_one_rank_is_plain,
                               check_train_case)
from _torch_threads import one_torch_thread  # noqa: F401

H4 = (("ssm_heads", 4),)
CASES = [
    ("zamba2-1.2b", (2, 2), (), None),
    ("zamba2-1.2b", (2, 2), (), 1),
    ("rwkv6-7b", (2, 2), H4, None),
    ("rwkv6-7b", (4, 1), H4, 1),
]


@pytest.mark.parametrize("arch,mesh,overrides,batch", CASES, ids=[
    "zamba2-2x2", "zamba2-2x2-cp", "rwkv6-h4-2x2", "rwkv6-h4-4x1-cp"])
def test_recurrent_families_train_over_a_mesh(arch, mesh, overrides, batch,
                                              tmp_path):
    check_train_case(arch, mesh, ("loss_fn", "loss_fn"), tmp_path,
                     overrides, batch)


def test_hybrid_train_cli_resumes_on_a_2x2_mesh(tmp_path, capsys,
                                                monkeypatch):
    check_cli_resume("zamba2-1.2b", tmp_path, capsys, monkeypatch)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_one_rank_mesh_is_the_plain_path_bitwise(arch, tmp_path):
    check_one_rank_is_plain(arch, ("loss_fn", "loss_fn"), tmp_path)
