from legommenders_tpu_torch.config.parser import (
    load_config,
    resolve,
    Obj,
    parse_four_way,
)
