"""Training CLI of the port (the counterpart of the root trainer.py;
reference trainer.py:319-322).

    python -m legommenders_tpu_torch.trainer --data synthetic --model naml \
        --exp default --hidden_size 64 --lr 0.001 --batch_size 64 \
        [--device cpu]

Trains on the card (`--device cpu` for the CPU), keeps the best checkpoint
at checkpoints/<data>/<model>/<signature>.ckpt, tests it and writes the
metrics to <signature>.csv beside it.
"""
import sys

from legommenders_tpu_torch.cli.base import BaseLego, write_results
from legommenders_tpu_torch.runtime.checkpoint import load_auto
from legommenders_tpu_torch.runtime.trainer import Trainer


class TrainerCLI(BaseLego):
    def run(self):
        trainer = Trainer(self.manager, seed=self.seed,
                          ckpt_path=self.ph.ckpt_path, log=self.log,
                          session=self.cli.get("session"))
        load_sign = (self.cfg.exp.load.sign
                     if self.cfg.exp and self.cfg.exp.load else None)
        if load_sign:
            trainer.init()
            load_auto(f"{self.ph.dir}/{load_sign}.ckpt", self.manager.model,
                      model_only=True)
        trainer.train()
        results = trainer.test()
        write_results(self.ph.result_path, results)
        return results


def main(argv=None):
    return TrainerCLI(argv).run()


if __name__ == "__main__":
    main(sys.argv[1:])
