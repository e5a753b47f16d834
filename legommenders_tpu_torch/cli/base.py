"""BaseLego — experiment scaffold shared by the CLI drivers.

The port of the JAX package's cli/base.py (reference base_lego.py:68-437):
4-way config parse, seeding, PathHub + signature, logging, Manager/model
construction. It adds `--device` (default `cuda`): without a card it
raises unless the caller passes `--device cpu`. Configs are read from the
checkout's `config/` unless `config_root` names another directory.

Several processes (JAX cli/base.py:28-41): `--distributed true`, or a
`torchrun` launch, opens the process group from that launcher's
environment, `--coordinator host:port
--num_processes N --process_id i` is the manual launch; each process then
runs on `cuda:LOCAL_RANK` (gloo on the CPU), and rank 0 alone writes the
config JSON, the log file and the result CSV. `exp.policy.mesh` lays the
dp axis over the group.
"""
import os
import sys
from typing import Dict, Optional

from legommenders_tpu_torch.config.parser import parse_four_way
from legommenders_tpu_torch.parallel.mesh import (
    initialize_multihost, process_device, shutdown, world,
)
from legommenders_tpu_torch.runtime.manager import Manager
from legommenders_tpu_torch.utils.device import resolve_device
from legommenders_tpu_torch.utils.function import (
    get_signature, parse_cli, seeding,
)
from legommenders_tpu_torch.utils.io import json_save
from legommenders_tpu_torch.utils.logging import get_logger
from legommenders_tpu_torch.utils.path_hub import PathHub

CONFIG_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "config")


def write_results(path: str, results: Dict[str, float]):
    """The result CSV: one header line of metric names, one line of
    values."""
    with open(path, "w") as f:
        f.write(",".join(results.keys()) + "\n")
        f.write(",".join(f"{v:.6f}" for v in results.values()) + "\n")


def run_cli(cls, argv=None):
    """`cls(argv).run()`, then the process group the run opened (if any)
    destroyed."""
    try:
        return cls(argv).run()
    finally:
        shutdown()


class BaseLego:
    required = ("data", "model")

    def __init__(self, argv=None, extra: Optional[Dict] = None,
                 config_root: str = CONFIG_ROOT):
        cli = parse_cli(argv if argv is not None else sys.argv[1:])
        cli.update(extra or {})
        for key in self.required:
            if key not in cli:
                raise SystemExit(f"--{key} is required")
        cli.setdefault("exp", "default")
        device = resolve_device(cli.pop("device", "cuda"))
        if cli.get("coordinator") and (
                cli.get("num_processes") is None
                or cli.get("process_id") is None):
            raise SystemExit("--coordinator needs --num_processes and "
                             "--process_id")
        if (cli.get("coordinator") or cli.get("distributed")
                or "WORLD_SIZE" in os.environ):
            initialize_multihost(
                cli.get("coordinator"), cli.get("num_processes"),
                cli.get("process_id"), device=device)
        self.device = process_device(device)
        self.is_main = world()[0] == 0
        self.cli = cli
        self.cfg = parse_four_way(cli, config_root=config_root)

        self.seed = int(cli.get("seed", 2023))
        seeding(self.seed)

        data_cfg = self.cfg.data.raw() if self.cfg.data else {}
        model_cfg = self.cfg.model.raw() if self.cfg.model else {}
        embed_cfg = self.cfg.embed.raw() if self.cfg.embed else {}
        exp_cfg = self.cfg.exp.raw() if self.cfg.exp else {}

        signature = get_signature(data_cfg, model_cfg, embed_cfg, exp_cfg,
                                  {"seed": self.seed})
        # the evaluation's signature: the configs without the seed, as the
        # worker registers it on the lego-server
        self.config_signature = get_signature(data_cfg, model_cfg,
                                              embed_cfg, exp_cfg)
        self.ph = PathHub(
            data_cfg.get("name", cli.get("data", "data")),
            model_cfg.get("name", cli.get("model", "model")),
            signature)
        self.log = get_logger("lego",
                              self.ph.log_path if self.is_main else None)
        self.log.info(f"signature: {signature}, device: {self.device}")

        self.raw_configs = {"data": data_cfg, "model": model_cfg,
                            "embed": embed_cfg, "exp": exp_cfg}
        if self.is_main:
            json_save({**self.raw_configs, "seed": self.seed},
                      self.ph.cfg_path)

        self.manager = Manager(data_cfg, model_cfg, embed_cfg, exp_cfg,
                               device=self.device, seed=self.seed)

    def run(self):
        raise NotImplementedError
