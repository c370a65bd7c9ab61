"""Training over a ("data", "model") DeviceMesh on 4 gloo ranks, against
the port on one device and against the reference on one device.

Every case starts from the reference's init perturbed with seeded numpy
noise (so the zero-initialized leaves are live), carried over with
`repro_torch.bridge`, and the data pipeline's batches (bitwise the
reference's). The ranks run `make_train_step` in f32 on the kernel
backend (the kernels' plain twins on these CPU tensors) under
`activation_sharding(mesh, default_residual_spec(...), remat=True)`,
after one backward whose gradients they gather. Held, each within 5e-5 x
max(1, max |want|) of the port's one-device run and of the reference's
(f32, gather backend, `adamw.update`): the first loss and every
parameter's gradient, the loss of each AdamW step, and the parameters
after the steps. The attention operands each rank saw show the layout:
its batch rows (or the whole batch under context parallelism), its query
heads and the whole sequence.

- qwen3 smoke over (2, 2): batch over "data", 2 query and 1 KV head a
  rank.
- qwen3 smoke over (1, 4): 1 query head a rank; "model" does not divide
  its 2 KV heads, which stay whole (each rank picks its query head's).
- internvl2 and lightningdit: tests/test_torch_mesh_cp.py (the cases
  are split over two files so that parallel test workers share them).
"""
import pytest

from _torch_mesh_train import check_train_case
from _torch_threads import one_torch_thread  # noqa: F401

CASES = [
    ("qwen3-1.7b", (2, 2), ("loss_fn", "loss_fn")),
    ("qwen3-1.7b", (1, 4), ("loss_fn", "loss_fn")),
]


@pytest.mark.parametrize("arch,mesh,losses", CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m, _ in CASES])
def test_sharded_train_step_matches_one_device(arch, mesh, losses,
                                               tmp_path):
    check_train_case(arch, mesh, losses, tmp_path)
