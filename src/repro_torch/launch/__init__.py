"""repro_torch.launch -- cells, their rules and their steps.

* :mod:`~repro_torch.launch.cells` -- the per-(arch x shape) knobs;
* :mod:`~repro_torch.launch.mesh` -- mesh layouts, the live mesh and its
  collectives;
* :mod:`~repro_torch.launch.sharding` -- the sharding rules, their specs
  and their execution on local shards;
* :mod:`~repro_torch.launch.steps` -- the input specs on ``meta``, the
  training, prefill and serve steps, and ``build_cell``;
* :mod:`~repro_torch.launch.cost_analysis` -- one rank's step counted on
  ``meta``: per-chip FLOPs (and products), HBM bytes, collective bytes by
  family and peak bytes, each hand kernel charged as its launch on the
  card (``kernels/costs.py``);
* :mod:`~repro_torch.launch.dryrun` -- every cell's per-chip bytes, FLOPs
  and costs on ``meta``, with no card.

``launch/cost_analysis.py`` is the counterpart of the reference's
``launch/hlo_analysis.py``: where the reference parses the partitioned HLO
text of one chip, the port runs one rank's step on a counting mesh
(``mesh.counting_mesh``) and counts its operations as they dispatch.  One
file of the reference has no module here: ``compat.py`` backfills JAX API
names on old JAX releases and has no PyTorch meaning.

The execution half of the reference's sharding runs on a live
``torch.distributed`` mesh (``mesh.live_mesh``): the rules context and
``constrain``, ZeRO's gather at use, the layers on each rank's shards and
the expert-parallel ``moe_ffn_a2a`` (``models/``), and the steps under the
rules (``steps``).
"""
