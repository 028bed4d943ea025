"""TensorBoard summaries (≙ ``bigdl_tpu/visualization``:
com.intel.analytics.bigdl.visualization's Summary.scala,
TrainSummary.scala, ValidationSummary.scala).

TrainSummary records Loss/LearningRate/Throughput every iteration and
Parameters histograms on a trigger; ValidationSummary records each
ValidationMethod's result.  Files are real tfevents — point TensorBoard at
`log_dir` exactly as with the reference.
"""
from __future__ import annotations

import os
from typing import Dict, List, Tuple

from .event_writer import EventWriter, read_events, read_scalar


class Summary:
    """Shared scalar/histogram writer (≙ visualization/Summary.scala)."""

    def __init__(self, log_dir: str, app_name: str, sub_dir: str):
        self.log_dir = log_dir
        self.app_name = app_name
        self.folder = os.path.join(log_dir, app_name, sub_dir)
        self.writer = EventWriter(self.folder)

    def add_scalar(self, tag: str, value: float, step: int):
        self.writer.add_scalar(tag, value, step)
        return self

    def add_histogram(self, tag: str, values, step: int):
        self.writer.add_histogram(tag, values, step)
        return self

    def read_scalar(self, tag: str) -> List[Tuple[int, float, float]]:
        self.writer.flush()
        return read_scalar(self.folder, tag)

    def close(self):
        self.writer.close()


class TrainSummary(Summary):
    """≙ visualization/TrainSummary.scala: scalars Loss/LearningRate/
    Throughput per iteration by default; 'Parameters' histograms gated by
    setSummaryTrigger (expensive: full param pull)."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "train")
        from ..optim.trigger import Trigger
        self._triggers: Dict[str, object] = {
            "Loss": Trigger.several_iteration(1),
            "LearningRate": Trigger.several_iteration(1),
            "Throughput": Trigger.several_iteration(1),
        }

    def set_summary_trigger(self, name: str, trigger):
        if name not in ("Loss", "LearningRate", "Throughput", "Parameters"):
            raise ValueError(f"unsupported summary tag {name!r}")
        self._triggers[name] = trigger
        return self

    def get_summary_trigger(self, name: str):
        return self._triggers.get(name)


class ValidationSummary(Summary):
    """≙ visualization/ValidationSummary.scala."""

    def __init__(self, log_dir: str, app_name: str):
        super().__init__(log_dir, app_name, "validation")


__all__ = ["EventWriter", "Summary", "TrainSummary", "ValidationSummary",
           "read_events", "read_scalar"]
