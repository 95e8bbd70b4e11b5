"""``BENCHMARK.json`` and the files it names, found by name.

For a cell ``<cell>`` of configuration ``<config>`` and traffic
``<traffic>``: the configuration file is the ``file`` that
``BENCHMARK.json`` gives, the traffic is ``traffic/<traffic>.json``, the
cell's serving settings and correctness limits are
``cells/<cell>.json``, and metric ``<name>`` is read by
``metrics/<name>.py`` or, failing that, by ``metrics/<stem>.py`` where
``<stem>`` is the name up to its first dot (``decode_step_ms.batch`` and
``decode_step_ms.online`` share ``metrics/decode_step_ms.py``), the
loop a traffic file names is ``loops/<loop>.py``, and the architecture a
configuration's ``model`` section names under ``arch`` (``gqa`` where it
names none) is ``archs/<arch>.py``.  Each is looked up under the
benchmark root's ``portbench/`` first and then beside this package, so a
cell defined in other files needs no edit here.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from dataclasses import dataclass
from typing import Callable, Dict, List

from portbench.archs import arch_name

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@dataclass
class Cell:
    name: str
    config: dict          # the configuration file, with "name"
    traffic: dict         # the traffic file
    serve: dict           # the cell file
    chips: int
    arch: object          # archs/<arch>.py of the configuration


class Bench:
    def __init__(self, root):
        self.root = pathlib.Path(root).resolve()
        with open(self.root / "BENCHMARK.json") as f:
            self.doc = json.load(f)
        self._modules: Dict[pathlib.Path, object] = {}

    def _find(self, kind: str, name: str, suffix: str) -> pathlib.Path:
        if not _NAME.match(name):
            raise ValueError(f"bad {kind} name {name!r}")
        for base in (self.root / "portbench", PACKAGE):
            p = base / kind / f"{name}{suffix}"
            if p.is_file():
                return p
        raise FileNotFoundError(f"no {kind}/{name}{suffix}")

    def _json(self, kind: str, name: str) -> dict:
        with open(self._find(kind, name, ".json")) as f:
            return json.load(f)

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.doc["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        conf = next(c for c in self.doc["configs"]
                    if c["name"] == entry["config"])
        with open(self.root / conf["file"]) as f:
            config = json.load(f)
        config["name"] = conf["name"]
        return Cell(name, config, self._json("traffic", entry["traffic"]),
                    self._json("cells", name), int(entry["chips"]),
                    self.arch(arch_name(config["model"])))

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end metrics
        with ``trace`` off, its per-layer metrics with it on."""
        e2e = [m for m in self.doc["end_to_end"]
               if "workloads" not in m or cell in m["workloads"]]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}

        def applies(m: dict) -> bool:
            if "workloads" in m:
                return cell in m["workloads"]
            return m["moves"] in moved

        return [m for m in self.doc["per_layer"] if applies(m)]

    def _module(self, kind: str, path: pathlib.Path):
        if path not in self._modules:
            mod_name = f"portbench_{kind}_" + re.sub(r"\W", "_", path.stem)
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]

    def reader(self, name: str) -> Callable:
        """``read(run) -> float | None`` of metric ``name``."""
        try:
            path = self._find("metrics", name, ".py")
        except FileNotFoundError:
            path = self._find("metrics", name.split(".", 1)[0], ".py")
        return self._module("metrics", path).read

    def loop(self, name: str) -> Callable:
        """``run(engine, traffic, seconds, ...) -> Window`` of the loop
        ``name`` (``harness/driver.py``)."""
        return self._module("loops", self._find("loops", name, ".py")).run

    def arch(self, name: str):
        """The module ``archs/<name>.py`` (``archs/__init__.py`` states
        what it gives)."""
        return self._module("archs", self._find("archs", name, ".py"))
