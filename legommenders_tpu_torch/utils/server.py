"""lego-server REST client — remote experiment tracking.

The port's copy of the JAX package's utils/server.py (reference
utils/server.py:31-263), with the port's dotfiles and logging: the exact
wire contract of the lego-server backend:

  * every response is an envelope ``{identifier, msg, code, body, ...}``;
    success is ``identifier == "OK"`` (BaseResp.ok, reference :37-57);
  * auth rides in an ``Authentication`` header with the raw token from the
    ``.auth`` dotfile (``lego_uri`` / ``lego_auth`` keys, reference
    :120-129);
  * evaluations are keyed by *signature* and carry (command, configuration);
    experiments are keyed by (signature, seed) and addressed by a
    server-issued *session* id;
  * ``GET /evaluations/`` is paginated via a ``page`` query param and
    returns ``{total_page, evaluations: [...]}`` (reference :190-210);
  * GET requests pass data as URL query params (never a body).

Implemented with urllib (requests is not a dependency); any transport or
decode error degrades to a non-ok BaseResp with the error in ``msg`` — the
framework must train fine offline.
"""
import json
import os
from typing import Any, Dict, Iterator, Optional
from urllib import request as _urlreq
from urllib.error import URLError
from urllib.parse import urlencode

from legommenders_tpu_torch.config.dotfiles import AuthInit
from legommenders_tpu_torch.utils.logging import get_logger


class BaseResp:
    """Envelope wrapper (reference utils/server.py:31-57)."""

    def __init__(self, resp: Dict[str, Any]):
        self.msg: Optional[str] = resp.get("msg")
        self.identifier: Optional[str] = resp.get("identifier")
        self.append_msg: Optional[str] = resp.get("append_msg")
        self.debug_msg: Optional[str] = resp.get("debug_msg")
        self.code: Optional[int] = resp.get("code")
        self.body: Any = resp.get("body")
        self.http_code: Optional[int] = resp.get("http_code")

    @property
    def ok(self) -> bool:
        return self.identifier == "OK"


class ExperimentBody:
    """Experiment record (reference utils/server.py:60-78)."""

    def __init__(self, body: Dict[str, Any]):
        body = body or {}
        self.signature = body.get("signature")
        self.seed = body.get("seed")
        self.session = body.get("session")
        self.log = body.get("log")
        self.performance = body.get("performance")
        self.is_completed = body.get("is_completed")
        self.created_at = body.get("created_at")
        self.pid = body.get("pid")


class EvaluationBody:
    """Evaluation record + nested experiments (reference :80-96)."""

    def __init__(self, body: Dict[str, Any]):
        body = body or {}
        self.signature = body.get("signature")
        self.command = body.get("command")
        self.configuration = body.get("configuration")
        self.created_at = body.get("created_at")
        self.modified_at = body.get("modified_at")
        self.comment = body.get("comment")
        self.experiments = [ExperimentBody(e)
                            for e in body.get("experiments") or []]


class Server:
    def __init__(self, uri: Optional[str] = None,
                 auth: Optional[str] = None, timeout: float = 5.0):
        self.uri = (uri or "").rstrip("/")
        self.auth = auth or ""
        self.timeout = timeout
        self.pid = os.getpid()
        self.log = get_logger("server")

    @classmethod
    def auto_auth(cls) -> "Server":
        """Credentials from the `.auth` dotfile (reference :121-129);
        accepts the round-1 key names as fallbacks."""
        uri = AuthInit.get("lego_uri") or AuthInit.get("lego_server")
        auth = AuthInit.get("lego_auth") or AuthInit.get("token")
        return cls(uri=uri, auth=auth)

    @property
    def active(self) -> bool:
        return bool(self.uri)

    # ------------------------------------------------------------------
    # low-level HTTP (reference :143-183): Authentication header, JSON
    # bodies for POST/PUT, query params for GET
    # ------------------------------------------------------------------
    def _call(self, method: str, path: str,
              data: Optional[Dict[str, Any]] = None,
              query: Optional[Dict[str, Any]] = None) -> BaseResp:
        if not self.active:
            return BaseResp({"msg": "no lego-server configured"})
        url = f"{self.uri}{path}"
        if query:
            url = f"{url}?{urlencode(query)}"
        body = json.dumps(data).encode() if data is not None else None
        req = _urlreq.Request(url, data=body, method=method)
        req.add_header("Authentication", self.auth)
        if body is not None:
            req.add_header("Content-Type", "application/json")
        try:
            with _urlreq.urlopen(req, timeout=self.timeout) as resp:
                payload = resp.read().decode()
                return BaseResp(json.loads(payload) if payload else {})
        except (URLError, OSError, ValueError) as e:
            self.log.warning(f"lego-server {method} {path} failed: {e}")
            return BaseResp({"msg": str(e)})

    def post(self, path: str, data: Dict[str, Any]) -> BaseResp:
        return self._call("POST", path, data=data)

    def put(self, path: str, data: Dict[str, Any]) -> BaseResp:
        return self._call("PUT", path, data=data)

    def delete(self, path: str) -> BaseResp:
        return self._call("DELETE", path)

    def get(self, path: str, query: Dict[str, Any]) -> BaseResp:
        return self._call("GET", path, query=query)

    # ------------------------------------------------------------------
    # evaluations (reference :190-225)
    # ------------------------------------------------------------------
    def get_all_evaluations(self) -> Iterator[EvaluationBody]:
        """Paginated listing: server returns {total_page, evaluations}."""
        total_page = None
        page = 1
        while total_page is None or page <= total_page:
            resp = self.get("/evaluations/", {"page": page})
            if not resp.ok:
                raise ValueError(
                    "Unable to fetch evaluations: " + (resp.msg or ""))
            total_page = resp.body["total_page"]
            for evaluation in resp.body["evaluations"]:
                yield EvaluationBody(evaluation)
            page += 1

    def create_or_get_evaluation(self, signature: str, command: str,
                                 configuration: str) -> BaseResp:
        return self.post("/evaluations/", dict(
            signature=signature, command=command,
            configuration=configuration))

    def delete_evaluation(self, signature: str) -> BaseResp:
        return self.delete(f"/evaluations/{signature}")

    # ------------------------------------------------------------------
    # experiments (reference :212-263)
    # ------------------------------------------------------------------
    def get_experiment_info(self, session: str) -> BaseResp:
        return self.get("/experiments/", {"session": session})

    def create_or_get_experiment(self, signature: str, seed: int) -> BaseResp:
        return self.post("/experiments/", dict(signature=signature, seed=seed))

    def register_experiment(self, session: str) -> BaseResp:
        return self.post(f"/experiments/{session}/register",
                         dict(pid=self.pid))

    def complete_experiment(self, session: str, log: str,
                            performance: str) -> BaseResp:
        return self.put("/experiments/", dict(
            session=session, log=log, performance=performance))

    # ------------------------------------------------------------------
    # dedup helper (reference worker.py:93-113): command -> completed seeds
    # ------------------------------------------------------------------
    def completed_seeds_by_command(self) -> Dict[str, list]:
        table: Dict[str, list] = {}
        for evaluation in self.get_all_evaluations():
            seeds = table.setdefault(evaluation.command, [])
            for experiment in evaluation.experiments:
                if experiment.is_completed:
                    seeds.append(experiment.seed)
        return table
