"""repro_torch.checkpoint -- atomic step directories in the reference's
format (:mod:`repro_torch.checkpoint.checkpoint`)."""
