"""Port of ``examples/simple``."""
