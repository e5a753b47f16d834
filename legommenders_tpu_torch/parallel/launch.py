"""Runs one function in n rank processes of a gloo group.

A JAX process sees n (virtual) devices; here each device of a mesh is a
process of a group. `start(fn, n, args, device)` spawns n processes of

    python -m legommenders_tpu_torch.parallel.launch <dir> <rank>

each of which opens the group (`mesh.initialize_multihost("file://<dir>/
init", n, rank, device, backend="gloo")`: gloo lets every rank share one
card, which NCCL refuses), calls `fn(*args)` and saves what it returns;
`Launch.wait()` gives the n results in rank order. `fn` is a module-level
function or its "module:name"; `args` travel by `torch.save`. Each rank
runs under its own timeout and writes its output to a log of its own; if a
rank fails or outlasts its timeout, every rank of the launch is stopped
and `wait` raises with each failed rank's last log lines. Launches may run
at once (`start` several, then `wait` each). `launch` is `start` and
`wait`.
"""
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, List, Sequence, Union

import torch

# the directory that holds the package, put on each rank's PYTHONPATH
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RANK_TIMEOUT_S = 120
LOG_LINES = 40


def _name(fn: Union[str, Callable]) -> str:
    """"module:name" of `fn`; a function of the program being run (as a
    script or with -m) by the module it is importable as."""
    if isinstance(fn, str):
        return fn
    module = fn.__module__
    if module == "__main__":
        main = sys.modules["__main__"]
        spec = getattr(main, "__spec__", None)
        module = (spec.name if spec is not None else
                  os.path.splitext(os.path.basename(main.__file__))[0])
    return f"{module}:{fn.__qualname__}"


class Launch:
    """The n rank processes of one `start`."""

    def __init__(self, fn: Union[str, Callable], n: int, args: Sequence,
                 device, timeout: float):
        self.name, self.n, self.timeout = _name(fn), int(n), float(timeout)
        self.dir = tempfile.mkdtemp(prefix="launch_")
        torch.save({"fn": self.name, "args": tuple(args),
                    "device": str(device), "n": self.n},
                   os.path.join(self.dir, "job.pt"))
        path = os.environ.get("PYTHONPATH")
        # on the card every rank shares it: expandable segments let a rank
        # reuse (or hand back) the cached blocks that fixed-size segments
        # would strand, which are memory the other ranks lack
        env = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True",
               **os.environ, "OMP_NUM_THREADS": "1",
               "PYTHONPATH": _ROOT + (os.pathsep + path if path else "")}
        self.t0 = time.monotonic()
        self.procs = []
        for r in range(self.n):
            with open(self._log(r), "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, self.dir, str(r)],
                    env=env, stdout=log, stderr=subprocess.STDOUT))

    def _log(self, rank: int) -> str:
        return os.path.join(self.dir, f"rank{rank}.log")

    def _tail(self, rank: int) -> str:
        with open(self._log(rank), errors="replace") as f:
            return "".join(f.readlines()[-LOG_LINES:])

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def stop(self):
        """Kill the ranks still running and remove the launch's files."""
        self._kill()
        shutil.rmtree(self.dir, ignore_errors=True)

    def wait(self) -> List[Any]:
        """Every rank's result, in rank order; raises when a rank failed
        or timed out (the others are stopped first)."""
        try:
            # a rank that fails leaves the others waiting in a collective:
            # stop them all at the first failure
            while True:
                codes = [p.poll() for p in self.procs]
                if (None not in codes or any(codes)
                        or time.monotonic() > self.t0 + self.timeout):
                    break
                time.sleep(0.05)
            self._kill()
            late = ([] if any(codes)
                    else [r for r, c in enumerate(codes) if c is None])
            bad = [r for r, c in enumerate(codes) if c] or late
            if bad:
                why = {r: (f"timed out after {self.timeout:g} s" if late
                           else f"exit {codes[r]}") for r in bad}
                logs = "\n".join(f"--- rank {r} ({why[r]}):\n{self._tail(r)}"
                                 for r in bad)
                raise RuntimeError(f"{self.name} on {self.n} ranks: ranks "
                                   f"{bad} failed\n{logs}")
            return [torch.load(os.path.join(self.dir, f"out{r}.pt"),
                               weights_only=False) for r in range(self.n)]
        finally:
            self.stop()


def start(fn: Union[str, Callable], n: int, args: Sequence = (),
          device="cpu", timeout: float = RANK_TIMEOUT_S) -> Launch:
    """Spawn the n ranks of `fn(*args)` over gloo on `device`."""
    return Launch(fn, n, args, device, timeout)


def launch(fn: Union[str, Callable], n: int, args: Sequence = (),
           device="cpu", timeout: float = RANK_TIMEOUT_S) -> List[Any]:
    """`fn(*args)` on n ranks; their results in rank order."""
    return start(fn, n, args, device, timeout).wait()


def _resolve(name: str) -> Callable:
    module, _, attr = name.partition(":")
    obj = importlib.import_module(module)
    for part in attr.split("."):
        obj = getattr(obj, part)
    return obj


def rank_main(directory: str, rank: int) -> int:
    """One rank: open the group, run the job, save its result."""
    from legommenders_tpu_torch.parallel import mesh

    job = torch.load(os.path.join(directory, "job.pt"), weights_only=False)
    mesh.initialize_multihost(f"file://{os.path.join(directory, 'init')}",
                              job["n"], rank, device=job["device"],
                              backend="gloo")
    try:
        out = _resolve(job["fn"])(*job["args"])
        torch.save(out, os.path.join(directory, f"out{rank}.pt"))
    finally:
        mesh.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1], int(sys.argv[2])))
