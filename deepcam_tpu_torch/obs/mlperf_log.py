"""MLPerf-compliance logging with the exact ``:::MLLOG`` line contract
(counterpart of ``deepcam_tpu/obs/mlperf_log.py``):

    :::MLLOG {"namespace": "", "time_ms": <int>, "event_type":
    "POINT_IN_TIME"|"INTERVAL_START"|"INTERVAL_END", "key": "...",
    "value": ..., "metadata": {"file": "...", "lineno": N}}

* rank-0-only emission (the rank is the process group's, ``core/mesh.py``,
  else 0);
* ``sync=True`` runs the barrier before the timestamp, as the reference
  does for timed keys such as run_start and run_stop; the barrier is
  ``parallel/collectives.py:barrier``, a no-op without a process group;
* the constructor writes the submission header (benchmark, org,
  division=closed, status=onprem, platform=<N>x placeholder) and creates
  the log directory on rank 0.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Optional

from ..core.mesh import get_rank, get_size
from ..parallel import collectives


class MLPerfLogger:
    """Functional equivalent of the reference ``mlperf_logger``."""

    def __init__(self, filename: str, benchmark: str = "deepcam",
                 organization: str = "deepcam_tpu", platform: Optional[str] = None,
                 stdout: bool = False, barrier_fn=None):
        self.comm_rank = get_rank()
        self.comm_size = get_size()
        self.filename = filename
        self.stdout = stdout
        self._barrier_fn = barrier_fn or collectives.barrier
        self._fh = None

        logdir = os.path.dirname(filename)
        if self.comm_rank == 0 and logdir:
            os.makedirs(logdir, exist_ok=True)
        self.barrier()
        if self.comm_rank == 0:
            self._fh = open(filename, "a")

        self.log_event(key="submission_benchmark", value=benchmark)
        self.log_event(key="submission_org", value=organization)
        self.log_event(key="submission_division", value="closed")
        self.log_event(key="submission_status", value="onprem")
        self.log_event(key="submission_platform",
                       value=platform or f"{self.comm_size}xSUBMISSION_PLATFORM_PLACEHOLDER")

    def log_start(self, key: str, value: Any = None, metadata=None, sync=False):
        self._log("INTERVAL_START", key, value, metadata, sync)

    def log_end(self, key: str, value: Any = None, metadata=None, sync=False):
        self._log("INTERVAL_END", key, value, metadata, sync)

    def log_event(self, key: str, value: Any = None, metadata=None, sync=False):
        self._log("POINT_IN_TIME", key, value, metadata, sync)

    def barrier(self):
        self._barrier_fn()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def _log(self, event_type, key, value, metadata, sync):
        if sync:
            self.barrier()
        if self.comm_rank != 0:
            return
        caller = sys._getframe(2)  # the log_* caller
        md = {"file": os.path.basename(caller.f_code.co_filename), "lineno": caller.f_lineno}
        if metadata:
            md.update(metadata)
        record = {"namespace": "", "time_ms": int(time.time() * 1000),
                  "event_type": event_type, "key": key, "value": value, "metadata": md}
        line = ":::MLLOG " + json.dumps(record)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self.stdout:
            print(line)


def parse_mllog(path: str):
    """The records of an MLPerf log, as dicts, in file order."""
    records = []
    with open(path) as f:
        for line in f:
            if line.startswith(":::MLLOG "):
                records.append(json.loads(line[len(":::MLLOG "):]))
    return records
