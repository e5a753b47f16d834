"""Test/latency CLI of the port (the counterpart of the root tester.py;
reference tester.py:110-121).

    python -m legommenders_tpu_torch.tester --data synthetic --model naml \
        --load_sign <sig> [--latency --num_batches 100] [--trace DIR] \
        [--device cpu]

`--load_sign` loads checkpoints/<data>/<model>/<sig>.ckpt, the port's own
or one the JAX package wrote; `--trace DIR` writes a torch.profiler chrome
trace of the evaluation to DIR/trace.json and the program's spans of it
(`utils/spans.py`: the cache builds and each of their pages, the scoring,
the metrics; start and end on the trace's clock, in ns since the Unix
epoch) to DIR/spans.json.
"""
import os
import sys

from legommenders_tpu_torch.cli.base import BaseLego, run_cli, write_results
from legommenders_tpu_torch.runtime.checkpoint import load_auto
from legommenders_tpu_torch.runtime.tester import Tester
from legommenders_tpu_torch.utils import spans


class TesterCLI(BaseLego):
    def _evaluate(self, tester):
        if self.cli.get("latency"):
            tester.latency(int(self.cli.get("num_batches", 100)))
        return tester.test()

    def run(self):
        m = self.manager
        load_sign = self.cli.get("load_sign")
        if load_sign:
            load_auto(f"{self.ph.dir}/{load_sign}.ckpt", m.model,
                      model_only=True)
        else:
            self.log.info("no --load_sign given: evaluating fresh weights")
        m.prepare_lm_cache()

        tester = Tester(m, log=self.log)
        trace_dir = self.cli.get("trace")
        if trace_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if m.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                results = self._evaluate(tester)
            os.makedirs(str(trace_dir), exist_ok=True)
            path = os.path.join(str(trace_dir), "trace.json")
            prof.export_chrome_trace(path)
            spans.dump(os.path.join(str(trace_dir), "spans.json"))
            self.log.info(f"profiler trace and spans written to {trace_dir}")
        else:
            results = self._evaluate(tester)
        if self.is_main:
            write_results(self.ph.result_path, results)
        return results


def main(argv=None):
    return run_cli(TesterCLI, argv)


if __name__ == "__main__":
    main(sys.argv[1:])
