"""The cell's plan, read from ``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, per-layer metric
or kernel family lives in a file of its own under ``perfbench/``, found by
name:

* ``configs/<config>.json``: the model configuration as it is run; its
  ``"arch"`` key names its architecture (``"llama"`` where it has none);
* ``archs/<arch>.py``: the architecture, a module of functions of the
  configuration dict: ``shape(cfg)`` (a ``flops.Shape``), the seeded
  weights ``layer(cfg, seed, i, device)`` as the reference reads them and
  ``tree(cfg, seed, device)`` as the port's loader takes them,
  ``port_config(cfg, max_seq_len)`` (the port's model config), the plain
  reference's ``logits_at`` (``reference/llama_ref.py``'s signature, its
  route statistics in ``stats``), and for a training cell ``train_steps``,
  ``dequant``, ``PROJS`` and ``NORMS`` (``reference/train_ref.py``'s);
* ``mixes/<traffic>.json``: the traffic parameters (its ``kind`` picks the
  loop: ``closed_loop`` serving or ``train_steps``);
* ``metrics/<name>.py``: the reader of per-layer metric ``<name>``, a
  module with ``read(run) -> float | None``;
* ``kernels/*.json``: device kernel-name patterns and the operation class
  each carries;
* ``limits/<workload>.json``: the limit of each number the cell's check
  compares with the reference.

A new cell, mix, metric, kernel family or architecture is new files plus new
entries in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent

# the operation classes a kernel pattern may name: the three a roofline
# reads, and ``other`` for the families known to carry none of that work
# (elementwise, copy, index, reduce, scan, sort); a traced run fails on a
# kernel that no pattern claims
CLASSES = ("matmul", "attention_forward", "attention_backward", "other")


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    moves: Optional[str] = None
    layer: Optional[str] = None
    bound: Optional[float] = None
    workloads: Optional[List[str]] = None


@dataclasses.dataclass
class KernelFamily:
    name: str
    op_class: str
    patterns: List[re.Pattern]

    def claims(self, kernel: str) -> bool:
        return any(p.search(kernel) for p in self.patterns)


@dataclasses.dataclass
class Plan:
    workload: str
    chips: int
    config: Dict[str, Any]
    mix: Dict[str, Any]
    end_to_end: List[Metric]
    per_layer: List[Metric]
    kernels: List[KernelFamily]
    run_seconds: int
    root: Path
    limits: Dict[str, Any]
    arch: Any  # the configuration's ``archs/<arch>.py`` module

    @property
    def shape(self):
        return self.arch.shape(self.config)

    def reader(self, metric: Metric) -> Callable[[Any], Optional[float]]:
        return load_reader(self.root / "perfbench" / "metrics" / f"{metric.name}.py")

    def kernel_class(self, kernel: str) -> Optional[str]:
        """The operation class of a device kernel by its name, or ``None``."""
        for fam in self.kernels:
            if fam.claims(kernel):
                return fam.op_class
        return None


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


def load_reader(path: Path) -> Callable[[Any], Optional[float]]:
    """The ``read`` function of a metric's reader file."""
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{path.stem}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no metric reader at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_arch(cfg: Dict[str, Any], root: Path = ROOT) -> Any:
    """The architecture module a configuration names, loaded from
    ``root/perfbench/archs/<arch>.py``."""
    name = cfg.get("arch", "llama")
    path = root / "perfbench" / "archs" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_arch_{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no architecture {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kernels(root: Path) -> List[KernelFamily]:
    fams = []
    for path in sorted((root / "perfbench" / "kernels").glob("*.json")):
        spec = load_json(path)
        if spec["class"] not in CLASSES:
            raise ValueError(f"{path}: class {spec['class']!r} is not one of {CLASSES}")
        fams.append(KernelFamily(path.stem, spec["class"], [re.compile(p) for p in spec["patterns"]]))
    return fams


def _metric(entry: Dict[str, Any]) -> Metric:
    return Metric(**{f.name: entry.get(f.name) for f in dataclasses.fields(Metric)})


def _applies(metric: Metric, workload: str, e2e_names: List[str]) -> bool:
    if metric.workloads is not None:
        return workload in metric.workloads
    # a metric without a list: every cell that reports what it moves (or,
    # for an end-to-end metric, every cell)
    return metric.moves is None or metric.moves in e2e_names


def plan(workload: str, root: Path = ROOT) -> Plan:
    """The plan of one cell of ``root/BENCHMARK.json``."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[cell["config"]]
    config = load_json(root / cfg_entry["file"])
    e2e = [m for m in map(_metric, bench["end_to_end"]) if _applies(m, workload, [])]
    names = [m.name for m in e2e]
    per_layer = [m for m in map(_metric, bench["per_layer"]) if _applies(m, workload, names)]
    return Plan(
        workload=workload, chips=int(cell["chips"]), config=config,
        mix=load_json(root / "perfbench" / "mixes" / f"{cell['traffic']}.json"),
        end_to_end=e2e, per_layer=per_layer, kernels=load_kernels(root),
        run_seconds=int(bench["run_seconds"]), root=root,
        limits=load_json(root / "perfbench" / "limits" / f"{workload}.json"),
        arch=load_arch(config, root),
    )
