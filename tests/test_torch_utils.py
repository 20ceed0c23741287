"""The port's telemetry utilities (`hsd_tpu_torch/utils/`) against the
JAX package's row shapes (the counterpart of `tests/test_utils.py`'s
timer case): Timer, StageClock, trace and MetricLogger."""
import json
import os

import numpy as np
import torch

from hsd_tpu.utils import StageClock as JStageClock
from hsd_tpu.utils.logging import MetricLogger as JMetricLogger
from hsd_tpu_torch.utils import StageClock, Timer, trace
from hsd_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(2)


def test_timer_and_stageclock():
    x = torch.ones((64, 64))
    with Timer("mm", sync=None) as t:
        x @ x
    assert t.elapsed > 0
    with Timer("mm", sync=[x, {"y": x @ x}]) as t2:
        pass
    assert t2.elapsed >= 0
    clocks = (StageClock(), JStageClock())
    for clk in clocks:
        with clk.stage("draft", sync=x if clk is clocks[0] else None):
            pass
        with clk.stage("draft"):
            pass
        with clk.stage("verify"):
            pass
    row, jrow = clocks[0].row(), clocks[1].row()
    assert len(row["draft_time"][0]) == 2
    assert set(row) == set(jrow) == {"draft_time", "verify_time"}
    assert {k: (len(v), len(v[0])) for k, v in row.items()} == \
        {k: (len(v), len(v[0])) for k, v in jrow.items()}
    assert set(clocks[0].totals()) == set(clocks[1].totals())
    assert abs(clocks[0].totals()["draft"]
               - sum(clocks[0].stages["draft"])) < 1e-12


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        torch.ones((32, 32)) @ torch.ones((32, 32))
    assert prof is not None
    data = json.loads((tmp_path / "trace.json").read_text())
    assert "traceEvents" in data


def test_metric_logger_rows(tmp_path):
    """The same JSONL row as the JAX logger's for the same metrics, with
    tensors and numpy scalars coerced by float()."""
    rows = []
    for name, cls, val in (("t", MetricLogger, torch.tensor(0.25)),
                           ("j", JMetricLogger, np.float32(0.25))):
        path = tmp_path / name / "m.jsonl"
        lg = cls(str(path))
        lg.log({"loss": val, "acc_0": 1}, step=3)
        lg.log({"loss": 0.5})
        lg.close()
        rows.append([json.loads(l) for l in open(path)])
    for t, j in zip(*rows):
        assert set(t) == set(j)
        assert {k: v for k, v in t.items() if k != "ts"} == \
            {k: v for k, v in j.items() if k != "ts"}
    assert rows[0][0] == dict(rows[0][0], loss=0.25, acc_0=1.0, step=3)
    assert not os.path.exists(tmp_path / "none")
    MetricLogger(None).log({"x": 1.0})        # no sink: nothing written
