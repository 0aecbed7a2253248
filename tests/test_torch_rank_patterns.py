"""The paper's five patterns, ``TaskFarm``, ``StreamExecutor`` with the
four SPMD adapters, ``Autoscaler`` and ``Supervisor`` with their workers
spread over ``torch.distributed`` ranks (``RankMesh``,
``RankMeshFactory``): gloo ranks on the CPU at world sizes 1, 2 and 4
against the JAX package at 8 placeholder host devices.

``_torch_rank_parity.py`` runs everything once (module fixture); each check
below is one of its results:

* ``w<R>/<result>`` -- every rank's result equal to the reference's:
  integers bit-exact, floats within 3e-5 (S1; S2 block and slot map; S3
  over ``flush_every`` {1, 2, 4, 8}, int32 sums that wrap included; S4
  over ``sync_every`` {1, 2, 8}; S5; the farm with and without a
  collector; the executor's outputs, final state, ``ResizeInfo`` and
  compiled degrees under ``{2: 4, 4: 8, 6: 2}`` and the slot map's ``{2:
  4, 4: 5, 6: 2}``, degree 5 on rank 0 alone; the autoscaled and the
  supervised runs, one of them failing on the last rank only);
* ``w<R>/bytes/...`` -- each rank's wire bytes by family and the bytes it
  received as an idle rank, chunk by chunk, at their closed forms; the S2
  block handoff's bytes (the slots whose owning rank changes) and each
  rank's resident block;
* ``w1/worker-mesh/...`` -- a world of one rank bit-equal to ``WorkerMesh``.
"""

import pytest

import _torch_rank_parity as rp


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return rp.run_all(str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("check", rp.checks())
def test_rank_check(results, check):
    passed, detail = results[check]
    assert passed, f"{check}: {detail}"
