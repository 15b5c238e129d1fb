"""The port's metrics loggers (``utils/metrics.py``) against the JAX
package's, fed the same sequence of logs (a key that appears late widens
the CSV header): the files equal except the CSV ``time`` column, the same
stdout text, torch scalars logged as floats, ``WandbLogger`` refused
without wandb in both, ``MetricsLogger`` finalizing every backend."""

import csv
import io
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_threads  # noqa: F401  (one torch thread a test process)

from bitorch_engine_tpu.utils import metrics as jm
from bitorch_engine_tpu_torch import utils as tutils
from bitorch_engine_tpu_torch.utils import metrics as tm

LOGS = [
    ({"loss": 2.5}, 0),
    ({"loss": 1.75, "acc": 0.25}, 1),  # a new key widens the header
    ({"acc": 0.5}, 2),
    ({"loss": 0.125, "acc": 0.75, "lr": 1e-3}, 3),
]


def _feed(mod, tmp, stream, value=lambda v: v):
    with mod.MetricsLogger([mod.CSVLogger(str(tmp)), mod.JSONLLogger(str(tmp)),
                            mod.StdoutLogger(stream=stream, every=2)]) as lg:
        for metrics, step in LOGS:
            lg.log({k: value(v) for k, v in metrics.items()}, step)


def _csv_rows(path):
    with open(path) as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


@pytest.mark.parametrize("scalars", [False, True], ids=["floats", "device_scalars"])
def test_loggers_match_jax(tmp_path, scalars):
    """Python floats to both, or f32 scalars (a jax array to the JAX
    loggers, a torch tensor to the port's)."""
    jax_out, port_out = io.StringIO(), io.StringIO()
    _feed(jm, tmp_path / "jax", jax_out, lambda v: jnp.asarray(v, jnp.float32) if scalars else v)
    _feed(tm, tmp_path / "port", port_out,
          lambda v: torch.tensor(v, dtype=torch.float32) if scalars else v)
    j_fields, j_rows = _csv_rows(tmp_path / "jax" / "metrics.csv")
    p_fields, p_rows = _csv_rows(tmp_path / "port" / "metrics.csv")
    assert p_fields == j_fields == ["step", "time", "loss", "acc", "lr"]
    assert len(p_rows) == len(j_rows) == len(LOGS)
    for p, j in zip(p_rows, j_rows):
        assert {k: v for k, v in p.items() if k != "time"} == \
            {k: v for k, v in j.items() if k != "time"}
        assert float(p["time"]) > 0
    j_lines = (tmp_path / "jax" / "metrics.jsonl").read_text().splitlines()
    p_lines = (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()
    assert p_lines == j_lines
    assert [json.loads(line) for line in p_lines][1] == {"step": 1, "loss": 1.75, "acc": 0.25}
    assert port_out.getvalue() == jax_out.getvalue()
    assert port_out.getvalue().splitlines()[0] == "step 0: loss 2.5000"


def test_torch_scalar_logged_as_float(tmp_path):
    lg = tm.JSONLLogger(str(tmp_path))
    lg.log({"loss": torch.tensor(0.25), "acc": torch.tensor(1, dtype=torch.int64)}, step=3)
    lg.finalize()
    rec = json.loads(open(lg.path).read())
    assert rec == {"step": 3, "loss": 0.25, "acc": 1.0}
    assert isinstance(rec["acc"], float)


def test_wandb_logger_needs_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb → ImportError
    for mod in (jm, tm):
        with pytest.raises(ImportError, match="wandb is not installed"):
            mod.WandbLogger("project")


def test_metrics_logger_finalizes_every_backend(tmp_path):
    done = []

    class Recorder:
        def __init__(self, name):
            self.name, self.logs = name, []

        def log(self, metrics, step):
            self.logs.append((step, dict(metrics)))

        def finalize(self):
            done.append(self.name)

    jsonl = tm.JSONLLogger(str(tmp_path))
    backends = [Recorder("a"), jsonl, Recorder("b")]
    with tm.MetricsLogger(backends) as lg:
        assert lg is not None
        lg.log({"x": np.float32(1.5)}, 7)
    assert done == ["a", "b"] and jsonl._f.closed
    assert backends[0].logs == backends[2].logs == [(7, {"x": np.float32(1.5)})]


def test_utils_exports_the_loggers():
    for name in ("CSVLogger", "JSONLLogger", "MetricsLogger", "StdoutLogger", "WandbLogger"):
        assert getattr(tutils, name) is getattr(tm, name)
