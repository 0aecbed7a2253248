"""repro_torch.data -- the deterministic synthetic token stream
(:mod:`repro_torch.data.pipeline`)."""
