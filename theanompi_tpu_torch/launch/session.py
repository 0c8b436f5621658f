"""Session API (port of ``theanompi_tpu/launch/session.py``).

``rule.init(devices, modelfile, modelclass)`` resolves the model class
and runs the training loop, blocking or on a background thread that
``wait()`` joins.
"""

from __future__ import annotations

import importlib
import importlib.util
import threading
from typing import Any, Optional


def resolve_model(modelfile: str, modelclass: str):
    """Import ``modelclass`` from ``modelfile``: a zoo short name
    (``alexnet``), a module path (``theanompi_tpu_torch.models.alex_net``)
    or a ``.py`` file path."""
    from theanompi_tpu_torch.models import MODEL_REGISTRY

    if modelfile in MODEL_REGISTRY:
        modelfile = MODEL_REGISTRY[modelfile][0]
    if modelfile.endswith(".py"):
        spec = importlib.util.spec_from_file_location("_tmpi_model", modelfile)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(modelfile)
    return getattr(mod, modelclass)


class SyncRule:
    """Base rule: subclasses set ``rule_name``."""

    rule_name: str = "base"

    def __init__(self, **rule_kwargs):
        self.rule_kwargs = rule_kwargs
        self._thread: Optional[threading.Thread] = None
        self._result: Any = None
        self._error: Optional[BaseException] = None

    def init(self, devices=1, modelfile: str = "alexnet", modelclass: str = "AlexNet",
             blocking: bool = False, **overrides):
        """Start training (``run_training`` kwargs in ``overrides``). With
        ``blocking=False`` training runs on a background thread and
        ``wait()`` joins it."""
        from theanompi_tpu_torch.launch.worker import run_training

        self._thread = None
        self._result = None
        self._error = None
        model_cls = resolve_model(modelfile, modelclass)
        kwargs = {**self.rule_kwargs, **overrides}

        def _run():
            try:
                self._result = run_training(rule=self.rule_name, model_cls=model_cls,
                                            devices=devices, **kwargs)
            except BaseException as e:  # surfaced in wait()
                self._error = e

        if blocking:
            _run()
            if self._error is not None:
                raise self._error
            return self._result
        self._thread = threading.Thread(target=_run, name=f"tmpi-{self.rule_name}", daemon=True)
        self._thread.start()
        return self

    def wait(self):
        """Block until training finishes; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
        if self._error is not None:
            raise self._error
        return self._result


class BSP(SyncRule):
    """Bulk-synchronous data parallelism (one device in this slice)."""

    rule_name = "bsp"
