"""Stream parallelism: one process per corruption stream (streams.py),
data-parallel evaluation (data_eval.py), the gloo group (mesh.py)."""
