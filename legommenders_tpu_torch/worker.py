"""Multi-run batch executor of the port (the counterpart of the root
worker.py; reference worker.py:57-270).

Reads a job file (one trainer CLI line per row), replicates each job over
N seeds (default 5, seeds 2023..), skips (job, seed) pairs that already
completed, and runs `python -m legommenders_tpu_torch.trainer <job> --seed
<seed>` one after another (a job line may carry `--device cpu`):

    python -m legommenders_tpu_torch.worker --jobs jobs.txt --replicate 5

Two ledgers, as in JAX:
  * a lego-server, where the `.auth` dotfile names one (`lego_uri` /
    `lego_auth`): each job registers an evaluation (its signature: the
    configs without the seed, its command and configuration), each seed an
    experiment whose session id reaches the trainer as `--session`;
    (command, seed) pairs the server holds completed are skipped;
  * the local JSONL ledger checkpoints/worker_ledger.jsonl.
"""
import json
import os
import subprocess
import sys

from legommenders_tpu_torch.utils.function import get_signature, parse_cli
from legommenders_tpu_torch.utils.io import jsonl_append, jsonl_load

LEDGER = "checkpoints/worker_ledger.jsonl"
TRAINER = "legommenders_tpu_torch.trainer"


def _env() -> dict:
    """The trainer's environment: this one, with the checkout that holds
    the port first on PYTHONPATH (the job runs in the caller's working
    directory)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def completed_set():
    if not os.path.isfile(LEDGER):
        return set()
    return {(r["command"], r["seed"]) for r in jsonl_load(LEDGER)
            if r.get("status") == "done"}


def job_signature(job: str):
    """The trainer's signature over the 4-way merged configs WITHOUT the
    seed (seeds tell experiments of one evaluation apart, reference
    worker.py:196-205), and the raw configs."""
    from legommenders_tpu_torch.cli.base import CONFIG_ROOT
    from legommenders_tpu_torch.config.parser import parse_four_way
    cli = parse_cli(job.split())
    cli.pop("device", None)
    cli.setdefault("exp", "default")
    cfg = parse_four_way(cli, config_root=CONFIG_ROOT)
    raw = {axis: (getattr(cfg, axis).raw() if getattr(cfg, axis) else {})
           for axis in ("data", "model", "embed", "exp")}
    return get_signature(raw["data"], raw["model"], raw["embed"],
                         raw["exp"]), raw


def main(argv=None):
    cli = parse_cli(argv if argv is not None else sys.argv[1:])
    jobs_file = cli.get("jobs")
    if not jobs_file:
        raise SystemExit("--jobs <file> is required")
    replicate = int(cli.get("replicate", 5))
    base_seed = int(cli.get("base_seed", 2023))
    done = completed_set()

    from legommenders_tpu_torch.utils.server import ExperimentBody, Server
    server = Server.auto_auth()
    server_done = {}
    if server.active:
        try:
            server_done = server.completed_seeds_by_command()
        except ValueError as e:
            print(f"lego-server unreachable ({e}); local ledger only")
            server = Server()  # inactive

    with open(jobs_file) as f:
        jobs = [line.strip() for line in f
                if line.strip() and not line.startswith("#")]

    ran = []
    for job in jobs:
        command = f"python -m {TRAINER} {job}"
        signature = None
        if server.active:
            try:
                signature, raw = job_signature(job)
            except Exception as e:  # job configs may be host-local only
                print(f"cannot compute signature for '{job}': {e}")
            else:
                reply = server.create_or_get_evaluation(
                    signature, command, json.dumps(raw, default=str))
                if not reply.ok:
                    print(f"evaluation registration failed: {reply.msg}")
                    signature = None
        for r in range(replicate):
            seed = base_seed + r
            if (job, seed) in done:
                print(f"skip (local ledger): {job} --seed {seed}")
                continue
            if seed in server_done.get(command, []):
                print(f"skip (server): {job} --seed {seed}")
                continue
            cmd = [sys.executable, "-m", TRAINER] + job.split() + [
                "--seed", str(seed)]
            if signature is not None:
                reply = server.create_or_get_experiment(signature, seed)
                if reply.ok:
                    session = reply.body
                    info = server.get_experiment_info(session)
                    if (info.ok
                            and ExperimentBody(info.body).is_completed):
                        print(f"skip (server, completed): {job} "
                              f"--seed {seed}")
                        continue
                    cmd += ["--session", str(session)]
            print("run:", " ".join(cmd), flush=True)
            ret = subprocess.call(cmd, env=_env())
            jsonl_append({"command": job, "seed": seed,
                          "status": "done" if ret == 0 else f"exit{ret}"},
                         LEDGER)
            ran.append((job, seed, ret))
    return ran


if __name__ == "__main__":
    main(sys.argv[1:])
