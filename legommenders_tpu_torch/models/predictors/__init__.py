from legommenders_tpu_torch.models.predictors.base import BasePredictor
# import modules for registration side effects
from legommenders_tpu_torch.models.predictors import dot  # noqa: F401
