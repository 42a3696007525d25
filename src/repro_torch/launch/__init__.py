"""The LM launchers, train and serve (the counterpart of
``repro.launch``'s drivers; its ``mesh`` module re-exports
``repro.dist.mesh``, whose port is ``repro_torch.dist.mesh``)."""
