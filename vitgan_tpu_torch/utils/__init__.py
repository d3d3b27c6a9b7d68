"""Image grids, PNG encoding, run directories."""
