"""repro_torch.launch -- cells, their rules and their steps.

* :mod:`~repro_torch.launch.cells` -- the per-(arch x shape) knobs;
* :mod:`~repro_torch.launch.mesh` -- mesh layouts (axis names and sizes);
* :mod:`~repro_torch.launch.sharding` -- the sharding rules as data;
* :mod:`~repro_torch.launch.steps` -- the input specs on ``meta``, the
  training, prefill and serve steps, and ``build_cell``;
* :mod:`~repro_torch.launch.dryrun` -- every cell's per-chip bytes and
  FLOPs on ``meta``, with no card.

Two files of the reference have no module here:

* ``launch/hlo_analysis.py`` parses XLA's HLO text, which PyTorch never
  produces.  Its three outputs map onto the port so: trip-count-aware
  FLOPs are the dry-run's eager count (every loop iteration runs);
  HBM bytes are the dry-run's per-chip argument bytes, activations not
  counted; collective bytes come with the execution half of the sharding
  (a live ``DeviceMesh``), counted from the collectives that run.
* ``compat.py`` backfills JAX API names on old JAX releases; it has no
  PyTorch meaning.

The execution half of the reference's sharding (``constrain`` and the
rules context it reads, ZeRO-1's ``gather_params_for_compute``,
``moe_ffn_a2a``, a live mesh) needs more than one card and is queued in
ROADMAP.
"""
