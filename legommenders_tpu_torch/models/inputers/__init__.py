from legommenders_tpu_torch.models.inputers.base import BaseInputer
from legommenders_tpu_torch.models.inputers.concat import ConcatInputer
from legommenders_tpu_torch.models.inputers.simple import SimpleInputer
from legommenders_tpu_torch.models.inputers.single_column import (
    SingleColumnInputer,
)
from legommenders_tpu_torch.models.inputers.flatten import FlattenSeqInputer
from legommenders_tpu_torch.models.inputers.semantic import (
    SemanticInputer, SemanticMixInputer,
)
