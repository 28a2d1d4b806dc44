"""Stats logging with the reference's aggregation semantics (the port's own
copy of ``nsdp_tpu/utils/logger.py``).

``AverageAggregator``'s *setter accumulates* (``logger[k].value = v`` adds a
sample; ``.value`` reads the running mean) — reference ``utils/logger.py:5-17``.
``StatsLogger`` is a singleton with dynamically-named metrics, tty
carriage-return progress and file append.  ``WandB`` adds per-epoch logging of
the aggregated values on ``clear()`` (``val_`` prefix for validation epochs);
wandb itself is an optional dependency, imported only by ``WandB.init``.
``WandB.log_watch`` logs the parameter and gradient norms of the training
steps' ``watch_stats`` (the counterpart of the reference's
``wandb.watch(model)``, ``utils/logger.py:102-103``).
"""

import sys
import time
from typing import Dict, Optional


class AverageAggregator:
    def __init__(self):
        self._value = 0.0
        self._count = 0

    @property
    def value(self):
        return self._value / self._count if self._count else 0.0

    @value.setter
    def value(self, val):
        self._value += val
        self._count += 1


class StatsLogger:
    _INSTANCE: Optional["StatsLogger"] = None

    def __init__(self):
        if StatsLogger._INSTANCE is not None:
            raise RuntimeError(
                "StatsLogger is a singleton; use StatsLogger.instance()"
            )
        self._values: Dict[str, AverageAggregator] = {}
        self._loss = AverageAggregator()
        self._output_files = [sys.stdout]
        self._epoch_start = time.time()

    @classmethod
    def instance(cls) -> "StatsLogger":
        # The singleton lives on the BASE class explicitly: ``cls._INSTANCE
        # = ...`` from a subclass would shadow it on the subclass, leaving
        # ``WandB.instance()`` and ``StatsLogger.instance()`` as two live
        # "singletons" — progress lines would never reach wandb.
        inst = StatsLogger._INSTANCE
        if inst is None or not isinstance(inst, cls):
            StatsLogger._INSTANCE = None  # permit the subclass upgrade
            StatsLogger._INSTANCE = cls()
        return StatsLogger._INSTANCE

    @classmethod
    def reset(cls):
        StatsLogger._INSTANCE = None

    def add_output_file(self, f):
        self._output_files.append(f)

    def __getitem__(self, key: str) -> AverageAggregator:
        if key not in self._values:
            self._values[key] = AverageAggregator()
        return self._values[key]

    def clear(self):
        self._values.clear()
        self._loss = AverageAggregator()
        self._epoch_start = time.time()
        for f in self._output_files:
            if f.isatty():
                print(file=f, flush=True)

    def print_progress(self, epoch, batch, loss, precision="{:.5f}"):
        self._loss.value = loss
        msg = ("epoch: {} - batch: {} - loss: " + precision).format(
            epoch, batch, self._loss.value
        )
        for k, v in self._values.items():
            msg += " - " + k + ": " + precision.format(v.value)
        for f in self._output_files:
            if f.isatty():
                print(msg + "\b" * len(msg), end="", flush=True, file=f)
            else:
                print(msg, flush=True, file=f)

    @property
    def loss(self):
        return self._loss.value


def watch_log_dict(param_norms, grad_norms):
    """Flatten per-module parameter/gradient norms into a wandb-loggable
    dict (``nsdp_tpu/utils/logger.py:94-113``): the top-level modules' global
    L2 norms as scalars (``param_norm/<module>``, ``grad_norm/<module>``)
    and the per-parameter norm vectors (``param_leaf_norms``,
    ``grad_leaf_norms``) for histograms.  ``param_norms`` / ``grad_norms``
    are ``(top-level norms: dict, per-parameter norms: vector)`` pairs."""
    out = {}
    for prefix, (top, leaves) in (("param", param_norms), ("grad", grad_norms)):
        for mod, v in top.items():
            out[f"{prefix}_norm/{mod}"] = float(v)
        out[f"{prefix}_leaf_norms"] = [float(x) for x in leaves]
    return out


class WandB(StatsLogger):
    """StatsLogger that also ships aggregates to Weights & Biases per epoch."""

    def init(
        self,
        experiment_arguments,
        project: str = "experiment",
        name: str = "experiment_name",
        watch: bool = False,
        log_frequency: int = 10,
    ):
        try:
            import wandb
        except ImportError as e:
            raise RuntimeError(
                "wandb is not installed; run without --with_wandb_logger"
            ) from e
        self._wandb = wandb
        self.project = project
        self.experiment_name = name
        self._epoch = 0
        self._validation = False
        self.watch = watch
        self.log_frequency = log_frequency
        wandb.login()
        cfg = experiment_arguments
        if hasattr(cfg, "items"):
            cfg = dict(cfg.items())
        wandb.init(project=project or None, name=name or None, config=cfg)

    def log_watch(self, param_norms, grad_norms):
        """Log the norms of ``watch_stats`` (:func:`watch_log_dict`; the
        per-parameter vectors as wandb histograms) with ``commit=False``, so
        they join the epoch's aggregates that :meth:`clear` logs."""
        if not hasattr(self, "_wandb"):
            return
        values = watch_log_dict(param_norms, grad_norms)
        hist = getattr(self._wandb, "Histogram", None)
        for k in ("param_leaf_norms", "grad_leaf_norms"):
            values[k] = hist(values[k]) if hist is not None else None
        self._wandb.log({k: v for k, v in values.items() if v is not None}, commit=False)

    def print_progress(self, epoch, batch, loss, precision="{:.5f}"):
        super().print_progress(epoch, batch, loss, precision)
        self._validation = epoch < 0
        if not self._validation:
            self._epoch = epoch

    def clear(self):
        prefix = "val_" if getattr(self, "_validation", False) else ""
        values = {prefix + k: v.value for k, v in self._values.items()}
        values[prefix + "loss"] = self._loss.value
        values[prefix + "epoch"] = getattr(self, "_epoch", 0)
        if hasattr(self, "_wandb"):
            self._wandb.log(values)
        super().clear()
