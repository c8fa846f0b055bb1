"""Image metrics of the inversion report."""
