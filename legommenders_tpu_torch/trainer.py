"""Training CLI of the port (the counterpart of the root trainer.py;
reference trainer.py:319-322).

    python -m legommenders_tpu_torch.trainer --data synthetic --model naml \
        --exp default --hidden_size 64 --lr 0.001 --batch_size 64 \
        [--device cpu]

Trains on the card (`--device cpu` for the CPU), keeps the best checkpoint
at checkpoints/<data>/<model>/<signature>.ckpt, tests it and writes the
metrics to <signature>.csv beside it. `--session <id>` ties the run to a
lego-server experiment (`.auth`'s `lego_uri` / `lego_auth`), as
`legommenders_tpu_torch.worker` launches it. Data parallel over two
processes of the CPU:

    python -m torch.distributed.run --nproc_per_node 2 \
        -m legommenders_tpu_torch.trainer ... --device cpu \
        --exp.policy.mesh true
"""
import sys

from legommenders_tpu_torch.cli.base import BaseLego, run_cli, write_results
from legommenders_tpu_torch.runtime.checkpoint import load_auto
from legommenders_tpu_torch.runtime.trainer import Trainer


class TrainerCLI(BaseLego):
    def run(self):
        session = self.cli.get("session")
        trainer = Trainer(self.manager, seed=self.seed,
                          ckpt_path=self.ph.ckpt_path, log=self.log,
                          session=str(session) if session else None,
                          signature=self.config_signature)
        load_sign = (self.cfg.exp.load.sign
                     if self.cfg.exp and self.cfg.exp.load else None)
        if load_sign:
            trainer.init()
            load_auto(f"{self.ph.dir}/{load_sign}.ckpt", self.manager.model,
                      model_only=True)
        trainer.train()
        results = trainer.test()
        if self.is_main:
            write_results(self.ph.result_path, results)
        return results


def main(argv=None):
    return run_cli(TrainerCLI, argv)


if __name__ == "__main__":
    main(sys.argv[1:])
