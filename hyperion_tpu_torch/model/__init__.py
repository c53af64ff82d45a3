from .model import Model, Configuration  # noqa: F401
from .analytical_yso_model import AnalyticalYSOModel, Star  # noqa: F401
from .model_output import ModelOutput  # noqa: F401
from .sed import SED  # noqa: F401
from .image import Image  # noqa: F401
from .run import ModelRun, run_lucy_model, run_model  # noqa: F401
