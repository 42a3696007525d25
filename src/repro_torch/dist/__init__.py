"""Device and launch-width policy (counterpart of ``repro.dist``)."""
