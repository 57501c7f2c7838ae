"""Entry points: the data-parallel trainer (``train``) and the serving
steps (``steps``)."""
