"""The port's lego-server client, the Trainer's session and the worker,
against a stub lego-server on a local thread (the wire contract of
tests/test_server.py: envelopes with `identifier == "OK"`, the
`Authentication` header, signature-keyed evaluations, session-keyed
experiments, paginated GET /evaluations/).

Checked: both packages' `Server` send the same requests (method, path,
query, body, header) for one scripted exchange; the Trainer registers its
session at init and completes it at test() with the metrics as JSON; a
mismatched signature or seed, or a completed experiment, stops the run
(SystemExit) as in JAX; an unreachable server leaves the run offline; the
worker registers and completes each seed through two tiny trainer
subprocesses (each under a timeout of 120 s) and skips both on a second
run, by the server and then by its local ledger.
"""
import json
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PAGE_SIZE = 2
TOKEN = "tok-123"
DATA_KW = dict(num_items=40, num_users=20, title_len=5, history_len=4,
               vocab_size=60, inters_per_user=4)
NAML_CFG = {"meta": {"item": "CNN", "user": "Ada", "predictor": "Dot"},
            "config": {"use_item_content": True, "hidden_size": 8,
                       "neg_count": 2, "cache_page_size": 16}}
EXP = {"policy": {"batch_size": 8, "epoch": 1, "epoch_batch": 2},
       "metrics": ["GAUC", "MRR"]}
TRAINER_TIMEOUT_S = 120


class _State:
    def __init__(self):
        self.evaluations = {}
        self.experiments = {}
        self.next_session = 100
        self.requests = []


class _Handler(BaseHTTPRequestHandler):
    state: _State = None

    def log_message(self, *a):
        pass

    def _send(self, body, identifier="OK", msg=None):
        payload = json.dumps(
            {"identifier": identifier, "msg": msg, "body": body}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _record(self):
        parsed = urlparse(self.path)
        n = int(self.headers.get("Content-Length", 0))
        data = json.loads(self.rfile.read(n)) if n else None
        self.state.requests.append(
            (self.command, parsed.path, parse_qs(parsed.query), data,
             self.headers.get("Authentication")))
        return parsed.path, {k: v[0] for k, v in
                             parse_qs(parsed.query).items()}, data or {}

    def do_POST(self):
        st = self.state
        path, _, data = self._record()
        if path == "/evaluations/":
            sig = data["signature"]
            st.evaluations.setdefault(sig, {
                "signature": sig, "command": data["command"],
                "configuration": data["configuration"], "experiments": []})
            return self._send(st.evaluations[sig])
        if path == "/experiments/":
            sig, seed = data["signature"], data["seed"]
            for exp in st.evaluations[sig]["experiments"]:
                if exp["seed"] == seed:
                    return self._send(exp["session"])
            session = str(st.next_session)
            st.next_session += 1
            exp = {"signature": sig, "seed": seed, "session": session,
                   "is_completed": False, "pid": None}
            st.evaluations[sig]["experiments"].append(exp)
            st.experiments[session] = exp
            return self._send(session)
        if path.startswith("/experiments/") and path.endswith("/register"):
            st.experiments[path.split("/")[2]]["pid"] = data["pid"]
            return self._send(None)
        return self._send(None, identifier="NOT_FOUND", msg=path)

    def do_GET(self):
        st = self.state
        path, query, _ = self._record()
        if path == "/evaluations/":
            evals = list(st.evaluations.values())
            pages = max(1, -(-len(evals) // PAGE_SIZE))
            page = int(query.get("page", 1))
            chunk = evals[(page - 1) * PAGE_SIZE: page * PAGE_SIZE]
            return self._send({"total_page": pages, "evaluations": chunk})
        if path == "/experiments/":
            exp = st.experiments.get(query.get("session"))
            if exp is None:
                return self._send(None, identifier="NOT_FOUND")
            return self._send(exp)
        return self._send(None, identifier="NOT_FOUND", msg=path)

    def do_PUT(self):
        st = self.state
        path, _, data = self._record()
        if path == "/experiments/":
            st.experiments[data["session"]].update(
                is_completed=True, log=data["log"],
                performance=data["performance"])
            return self._send(None)
        return self._send(None, identifier="NOT_FOUND")

    do_DELETE = do_PUT


@pytest.fixture()
def stub():
    state = _State()
    handler = type("H", (_Handler,), {"state": state})
    httpd = HTTPServer(("127.0.0.1", 0), handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_port}", state
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture()
def auth_dir(tmp_path, monkeypatch):
    """A working directory whose `.auth` the port reads; returns a writer
    of it."""
    from legommenders_tpu_torch.config.dotfiles import AuthInit

    monkeypatch.chdir(tmp_path)

    def write(uri):
        (tmp_path / ".auth").write_text(
            f"lego_uri: {uri}\nlego_auth: {TOKEN}\n")
        AuthInit.reload()

    yield write
    AuthInit.reload()


def _exchange(server_cls, uri):
    """One scripted exchange of every call the client has."""
    s = server_cls(uri=uri, auth=TOKEN, timeout=5.0)
    s.create_or_get_evaluation("sig-A", "python -m x --a 1", '{"lr": 0.1}')
    session = s.create_or_get_experiment("sig-A", 2023).body
    s.register_experiment(session)
    s.get_experiment_info(session)
    s.complete_experiment(session, "log text", json.dumps({"GAUC": 0.6}))
    for i in range(2):
        s.create_or_get_evaluation(f"sig-{i}", f"cmd {i}", "{}")
    table = s.completed_seeds_by_command()
    s.delete_evaluation("sig-0")
    return table


def test_both_clients_send_the_same_requests(stub):
    from legommenders_tpu.utils.server import Server as JServer
    from legommenders_tpu_torch.utils.server import Server

    uri, state = stub
    want = _exchange(JServer, uri)
    jax_requests = list(state.requests)
    state.__init__()
    got = _exchange(Server, uri)
    assert got == want == {"python -m x --a 1": [2023], "cmd 0": [],
                           "cmd 1": []}
    assert state.requests == jax_requests
    assert {r[4] for r in state.requests} == {TOKEN}
    assert {r[0] for r in state.requests} == {"GET", "POST", "PUT",
                                              "DELETE"}


def _trainer(session, signature=None, seed=3):
    from legommenders_tpu_torch.data.processors.synthetic import (
        SyntheticProcessor,
    )
    from legommenders_tpu_torch.runtime.manager import Manager
    from legommenders_tpu_torch.runtime.trainer import Trainer

    m = Manager(model_cfg=NAML_CFG, exp_cfg=EXP, device="cpu",
                data=SyntheticProcessor(**DATA_KW).as_lego_data())
    return Trainer(m, seed=seed, session=session, signature=signature)


def _experiment(uri, signature="sig-T", seed=3):
    from legommenders_tpu_torch.utils.server import Server

    s = Server(uri=uri, auth=TOKEN)
    s.create_or_get_evaluation(signature, "cmd", "{}")
    return s, s.create_or_get_experiment(signature, seed).body


def test_trainer_session_lifecycle(stub, auth_dir):
    uri, state = stub
    auth_dir(uri)
    _, session = _experiment(uri)
    tr = _trainer(session, signature="sig-T")
    exp = state.experiments[session]
    assert exp["pid"] == os.getpid() and not exp["is_completed"]
    tr.train()
    res = tr.test()
    assert exp["is_completed"]
    assert json.loads(exp["performance"]) == res
    assert set(res) == {"GAUC", "MRR"}


@pytest.mark.parametrize("fault", ["signature", "seed", "completed"])
def test_trainer_session_refuses(stub, auth_dir, fault):
    uri, state = stub
    auth_dir(uri)
    server, session = _experiment(uri)
    if fault == "completed":
        server.complete_experiment(session, "", "{}")
    with pytest.raises(SystemExit, match={
            "signature": "signature mismatch", "seed": "seed mismatch",
            "completed": "already completed"}[fault]):
        _trainer(session, signature="other" if fault == "signature"
                 else "sig-T", seed=4 if fault == "seed" else 3)
    assert state.experiments[session]["pid"] is None


def test_unreachable_server_leaves_the_run_offline(auth_dir):
    auth_dir("http://127.0.0.1:1")
    tr = _trainer("123")
    assert tr.server is None
    tr.train()
    assert set(tr.test()) == {"GAUC", "MRR"}


def test_worker_dedups_by_server_and_ledger(stub, auth_dir, tmp_path,
                                            monkeypatch):
    from legommenders_tpu_torch import process, worker

    uri, state = stub
    auth_dir(uri)
    data_dir = str(tmp_path / "synth")
    process.main(["--data", "synthetic", "--save_dir", data_dir])
    job = (f"--data synthetic --data_dir {data_dir} --model naml "
           f"--epoch 1 --epoch_batch 2 --batch_size 8 --hidden_size 8 "
           f"--device cpu")
    (tmp_path / "jobs.txt").write_text(f"# one job\n{job}\n")
    calls = []
    real_call = subprocess.call

    def call(cmd, env):
        calls.append(cmd)
        return real_call(cmd, env=env, timeout=TRAINER_TIMEOUT_S)

    monkeypatch.setattr(worker.subprocess, "call", call)
    argv = ["--jobs", "jobs.txt", "--replicate", "2"]
    ran = worker.main(argv)
    assert [(s, r) for _, s, r in ran] == [(2023, 0), (2024, 0)]
    assert all("--session" in c for c in calls)
    sig, raw = worker.job_signature(job)
    (evaluation,) = state.evaluations.values()
    assert evaluation["signature"] == sig
    assert evaluation["command"] == f"python -m {worker.TRAINER} {job}"
    assert json.loads(evaluation["configuration"])["model"]["name"] == "NAML"
    exps = evaluation["experiments"]
    assert [e["seed"] for e in exps] == [2023, 2024]
    for e in exps:
        assert e["is_completed"] and e["pid"] is not None
        assert set(json.loads(e["performance"])) >= {"GAUC", "MRR"}
    # again: the server holds both seeds completed
    assert worker.main(argv) == [] and len(calls) == 2
    # without the server: the local ledger holds both
    auth_dir("http://127.0.0.1:1")
    assert worker.main(argv) == [] and len(calls) == 2
    ledger = [json.loads(line) for line in
              open(worker.LEDGER).read().splitlines()]
    assert [(r["seed"], r["status"]) for r in ledger] == [
        (2023, "done"), (2024, "done")]
