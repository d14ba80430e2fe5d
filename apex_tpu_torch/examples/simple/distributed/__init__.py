"""Port of ``examples/simple/distributed``."""
