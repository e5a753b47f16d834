"""Experiment path layout.

The port's copy of the JAX package's utils/path_hub.py (reference
utils/path_hub.py:27-107):
`checkpoints/<data>/<model>/<signature>.{log,json,ckpt,csv}`.
"""
import os


class PathHub:
    def __init__(self, data_name: str, model_name: str, signature: str,
                 root: str = "checkpoints"):
        self.data_name = data_name
        self.model_name = model_name
        self.signature = signature
        self.dir = os.path.join(root, data_name, model_name)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, ext: str) -> str:
        return os.path.join(self.dir, f"{self.signature}.{ext}")

    @property
    def log_path(self):
        return self._path("log")

    @property
    def cfg_path(self):
        return self._path("json")

    @property
    def ckpt_path(self):
        return self._path("ckpt")

    @property
    def result_path(self):
        return self._path("csv")
