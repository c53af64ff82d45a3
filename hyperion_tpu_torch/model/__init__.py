from .run import ModelRun, run_lucy_model, run_model  # noqa: F401
