"""Entry points: the data-parallel trainer (``train``)."""
