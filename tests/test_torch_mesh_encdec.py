"""The encoder-decoder family (whisper smoke: 128 frames, 16 text
tokens) trained over a ("data", "model") DeviceMesh on gloo ranks,
against the port on one device and the reference on one device (the
checks and tolerances of tests/test_torch_mesh_train.py), and the
divisibility refusals of `sharding.check_mesh_family`.

- whisper over (2, 2): both stacks' heads and FFN columns over "model".
- whisper over (2, 2) at batch 1: context parallelism, the frames and the
  text split over "data", the cross-attention reading the whole encoder
  output.
- whisper over a 1 x 1 mesh of one rank: bitwise the one-device run.
- A "model" axis that does not divide what a family splits over it (its
  heads, experts, recurrence heads or FFN width) raises
  NotImplementedError naming each size; one that divides passes.
"""
import pytest

from _torch_mesh_train import check_one_rank_is_plain, check_train_case
from _torch_threads import one_torch_thread  # noqa: F401
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding


@pytest.mark.parametrize("batch", [None, 1], ids=["2x2", "2x2-cp"])
def test_encdec_trains_over_a_mesh(batch, tmp_path):
    check_train_case("whisper-small", (2, 2), ("loss_fn", "loss_fn"),
                     tmp_path, (), batch)


def test_encdec_one_rank_mesh_is_the_plain_path_bitwise(tmp_path):
    check_one_rank_is_plain("whisper-small", ("loss_fn", "loss_fn"),
                            tmp_path)


REFUSED = [
    ("moonshot-v1-16b-a3b", True, 3,
     ["num_heads (4)", "num_experts (4)", "moe_d_ff (64)"]),
    ("moonshot-v1-16b-a3b", False, 32, ["num_heads (16)"]),
    ("zamba2-1.2b", True, 8, ["num_heads (4)", "ssm_heads (4)"]),
    ("rwkv6-7b", False, 128, ["rwkv6._heads (64)"]),
    ("whisper-small", False, 8, ["num_heads (12)"]),
]


@pytest.mark.parametrize("arch,smoke,model,names", REFUSED,
                         ids=[f"{a}-{'smoke' if s else 'full'}-{m}"
                              for a, s, m, _ in REFUSED])
def test_a_model_axis_that_does_not_divide_raises(arch, smoke, model,
                                                  names):
    cfg = get_arch(arch)
    cfg = cfg.smoke() if smoke else cfg
    with pytest.raises(NotImplementedError) as err:
        sharding.check_mesh_family(cfg, {"data": 2, "model": model})
    msg = str(err.value)
    assert f"'model' axis of {model}" in msg
    for name in names:
        assert name in msg, msg
    assert msg.count("(") == len(names), msg


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "zamba2-1.2b",
                                  "rwkv6-7b", "whisper-small"])
def test_a_model_axis_that_divides_passes(arch):
    cfg = get_arch(arch)
    m = 4 if arch == "whisper-small" else 16
    sharding.check_mesh_family(cfg, {"data": 16, "model": m})
