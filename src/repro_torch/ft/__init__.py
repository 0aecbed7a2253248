"""repro_torch.ft -- the fault-tolerant training loop
(:mod:`repro_torch.ft.driver`)."""
