"""Decode-time SLA over a ("data", "model") DeviceMesh of 8 ranks: the
reference's own decode cell (2 x 4, batch 2: the batch over "data", the
sequence over "model") in f32 and bf16, and batch 1 with the sequence
over ("data", "model") (layout C, every KV head on every rank), against
the port on one device and the reference on one device (the 1-, 2- and
4-rank cases: tests/test_torch_mesh_decode_sla.py).

Gloo cases (one spawn a world size, every case of that world in it,
`tests/_torch_mesh_decode_sla.py`, the worker's `case_serve_sla`): the
smoke model with `sla.decode_mode="sla"` from the reference's perturbed
init, carried over with `repro_torch.bridge` and placed by the rules;
`prefill(decode_max_len=128)` of a 64-token prompt on the global batch,
then 40 `make_serve_step` calls on the kernel backend (the kernels'
plain twins on these CPU tensors) decoding the reference's own greedy
tokens, crossing the block boundaries at 64, 80 and 96, all under
`activation_sharding(mesh, default_residual_spec(mesh, batch, 128))`.
Held (`check_case`):

- the logits of the prefill and of every step, gathered over the data
  ranks, within TOL x max(1, max |want|) of the port on one device and
  of the reference (f32 5e-5, bf16 5e-2); the f32 greedy tokens equal
  the reference's; the ranks that hold the same rows return them
  bitwise;
- every leaf of the cache and of its "sla" state assembled from the
  ranks' parts by the rule's spec: floats within the tolerance, integer
  leaves (the plan, the live row, the counters) bitwise, `rows` and
  `pos` equal; the ranks that hold the same shard of a leaf hold the
  same bits;
- each rank's bytes of an empty `make_cache` (and, in bf16, of the
  filled cache) equal `launch/dryrun.rank_bytes` of that cell;
- on a 1 x 1 mesh (one rank), every logit and leaf bitwise the plain
  path's.
"""
import pytest

from _torch_mesh_decode_sla import Case, check_case, worlds
from _torch_threads import one_torch_thread  # noqa: F401

Q3 = "qwen3-1.7b"
CASES = [
    Case("qwen3-2x4-batch1", Q3, (2, 4), 1, "C"),
    Case("qwen3-2x4-decode-cell", Q3, (2, 4), 2, "B"),
    Case("qwen3-2x4-decode-cell-bf16", Q3, (2, 4), 2, "B", "bfloat16"),
]
ranks = worlds(CASES)


@pytest.mark.parametrize("case", CASES, ids=[c.name for c in CASES])
def test_decode_sla_over_a_mesh_matches_one_device_and_the_reference(
        case, ranks):
    check_case(case, ranks(case.world)[case.name])
