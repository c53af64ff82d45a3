"""Console entry points of the port (pyproject [project.scripts]:
hyperion_tpu_torch, hyperion_tpu_torch2fits)."""
