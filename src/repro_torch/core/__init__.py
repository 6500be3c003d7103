"""repro_torch.core -- the MTGC round engine, its state layouts and driver."""
