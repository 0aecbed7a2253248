"""repro_torch.models -- the dense decoder of the serving slice: config,
layers, attention (through the flash and decode attention kernels) and the
transformer's prefill/decode entry points."""
