"""The benchmark's seam with the port, held on the CPU.

``benchmark/run.py`` measures the port through names: the harness wraps
the adaptive executor's methods in spans (``harness/rx.py`` ``SPANS``),
``control.py`` plants its faults in the port's classes and modules
(``FAULTS``), and the per-layer readers read the executor Tracer's stages
and counters and the graphs' captures. Here every cell of BENCHMARK.json is
rehearsed at its tiny sizes with ``--trace 1``, each in a process of its
own, and the two lists are read from their files with ``ast``: a rename in
the port fails these tests instead of a traced run on the card. Nothing of
the benchmark is imported into this process, and nothing is written under
``benchmark/``.
"""

import ast
import dataclasses
import importlib
import json
import os
import pathlib
import re
import subprocess
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
PROGRAM_SOURCES = ("program_span", "program_counter")
REHEARSAL_TIMEOUT_S = 240


def _assigned(path: pathlib.Path, name: str) -> ast.expr:
    """The value of the module-level assignment to ``name`` in ``path``."""
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in node.targets):
            return node.value
    raise LookupError(f"{path.relative_to(ROOT)} assigns no {name}")


def _hooks() -> list[tuple[str, str]]:
    """(module, attribute path) of every name the benchmark reaches into
    the port by: the executor methods of SPANS, the targets of FAULTS."""
    spans = ast.literal_eval(_assigned(ROOT / "benchmark" / "harness" / "rx.py", "SPANS"))
    hooks = {("parallel.executor", f"AdaptiveStreamExecutor.{name}") for name in spans}
    for node in ast.walk(_assigned(ROOT / "benchmark" / "control.py", "FAULTS")):
        if isinstance(node, ast.Tuple) and len(node.elts) == 3:
            module, path = (ast.literal_eval(e) for e in node.elts[:2])
            hooks.add((module, path))
    return sorted(hooks)


HOOKS = _hooks()


@dataclasses.dataclass
class Rehearsal:
    rc: int | None          # None: killed at REHEARSAL_TIMEOUT_S
    line: str | None        # its "rehearsal <cell>:" line
    tail: str               # the end of its output, for a failure's message

    def field(self, pattern: str) -> str:
        m = re.search(pattern, self.line or "")
        assert m, f"no {pattern!r} in {self.line!r}\n{self.tail}"
        return m.group(1)


@pytest.fixture(scope="module")
def rehearsals(tmp_path_factory) -> dict[str, Rehearsal]:
    """Every cell's rehearsal, all started at once, each waited on until
    REHEARSAL_TIMEOUT_S after its start and killed there."""
    out_dir = tmp_path_factory.mktemp("rehearsals")
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    started = {}
    for cell in CELLS:
        log = open(out_dir / f"{cell}.log", "w")
        p = subprocess.Popen([sys.executable, "benchmark/run.py", "--rehearse", "--trace", "1",
                              "--workload", cell],
                             cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
        started[cell] = (p, log, time.monotonic())
    done = {}
    for cell, (p, log, t0) in started.items():
        try:
            rc = p.wait(timeout=max(0.0, t0 + REHEARSAL_TIMEOUT_S - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = None
        log.close()
        text = (out_dir / f"{cell}.log").read_text()
        lines = [ln for ln in text.splitlines() if ln.startswith(f"rehearsal {cell}:")]
        done[cell] = Rehearsal(rc, lines[-1] if lines else None, text[-3000:])
    return done


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct(rehearsals, cell):
    r = rehearsals[cell]
    assert r.rc == 0, f"exit code {r.rc}\n{r.tail}"
    assert r.field(r" correct=(\w+) ") == "True", r.tail


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_reads_the_programs_own_metrics(rehearsals, cell):
    """Each per-layer metric that the program feeds in this cell (a span or
    a counter of its own) was read: a renamed stage or counter reads
    nothing and drops out of ``metrics read``."""
    wanted = {m["name"] for m in BENCH["per_layer"]
              if cell in m["workloads"] and m["source"] in PROGRAM_SOURCES}
    read = set(ast.literal_eval(rehearsals[cell].field(r" metrics read=(\[[^\]]*\]) ")))
    assert wanted <= read, f"not read: {sorted(wanted - read)}"


@pytest.mark.parametrize("module,path", HOOKS, ids=[f"{m}:{p}" for m, p in HOOKS])
def test_the_benchmarks_hooks_resolve_on_the_port(module, path):
    obj = importlib.import_module(f"gnuradio_wifi_imagetransfer_tpu_torch.{module}")
    for part in path.split("."):
        assert hasattr(obj, part), f"{module}.{path}: no {part} on {obj!r}"
        obj = getattr(obj, part)
    assert callable(obj), f"{module}.{path} is not callable"
