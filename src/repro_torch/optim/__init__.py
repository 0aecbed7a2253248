"""repro_torch.optim -- AdamW in the reference's arithmetic
(:mod:`repro_torch.optim.adamw`)."""
