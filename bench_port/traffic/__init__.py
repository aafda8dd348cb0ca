"""Traffic drivers, found by the ``driver`` a mix file names."""
