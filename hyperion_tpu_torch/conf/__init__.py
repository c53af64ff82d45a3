from .conf_files import (OutputConf, RunConf, ImageConf,  # noqa: F401
                         BinnedImageConf, PeeledImageConf)
