"""repro_torch.launch -- the training step and its knobs
(:mod:`repro_torch.launch.steps`, :mod:`repro_torch.launch.cells`).  The
reference's mesh, sharding rules, dry-run and HLO analysis are not ported
(ROADMAP Queue 1 item 15): the port trains on one card."""
