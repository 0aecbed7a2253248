"""repro_torch.launch -- cells, their rules and their steps.

* :mod:`~repro_torch.launch.cells` -- the per-(arch x shape) knobs;
* :mod:`~repro_torch.launch.mesh` -- mesh layouts, the live mesh and its
  collectives;
* :mod:`~repro_torch.launch.sharding` -- the sharding rules, their specs
  and their execution on local shards;
* :mod:`~repro_torch.launch.steps` -- the input specs on ``meta``, the
  training, prefill and serve steps, and ``build_cell``;
* :mod:`~repro_torch.launch.dryrun` -- every cell's per-chip bytes and
  FLOPs on ``meta``, with no card.

Two files of the reference have no module here:

* ``launch/hlo_analysis.py`` parses XLA's HLO text, which PyTorch never
  produces.  Its three outputs map onto the port so: trip-count-aware
  FLOPs are the dry-run's eager count (every loop iteration runs);
  HBM bytes are the dry-run's per-chip argument bytes, activations not
  counted; collective bytes are counted from the collectives that run on
  a live mesh (``mesh.WIRE_BYTES``, per rank and family, by the same ring
  formulas).
* ``compat.py`` backfills JAX API names on old JAX releases; it has no
  PyTorch meaning.

The execution half of the reference's sharding runs on a live
``torch.distributed`` mesh (``mesh.live_mesh``): the rules context and
``constrain``, ZeRO's gather at use, the layers on each rank's shards and
the expert-parallel ``moe_ffn_a2a`` (``models/``), and the steps under the
rules (``steps``).
"""
