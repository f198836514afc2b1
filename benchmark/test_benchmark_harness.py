"""The harness on the CPU: BENCHMARK.json's shape, the files each entry
names, a cell and a per-layer metric added from new files and entries
alone, and the import check.

    python -m pytest benchmark/test_benchmark_harness.py
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE)]

from harness import common  # noqa: E402

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX_NAMES = ("jax", "jaxlib", "flax", "gnuradio_wifi_imagetransfer_tpu")
PORT = "gnuradio_wifi_imagetransfer_tpu_torch"


def test_benchmark_json_keys_names_and_units():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads((ROOT / c["file"]).read_text())["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200 and (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and (HERE / "metrics" / f"{m['name']}.py").is_file()
        for w in m["workloads"]:
            assert m["moves"] in {x["name"] for x in common.metrics_of(SPEC, w, 0)}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in common.metrics_of(SPEC, cell, 0)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = common.metrics_of(SPEC, cell, 1)
    assert layers and all(m["moves"] in e2e for m in layers)


def test_a_cell_and_a_metric_from_new_files_and_entries_alone(tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell on it and a
    per-layer metric through new files and BENCHMARK.json entries only;
    the rehearsal runs the new cell and reads the new metric."""
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "test_*"))
    (tmp_path / PORT).symlink_to(ROOT / PORT)
    spec = json.loads(json.dumps(SPEC))
    (tmp_path / "benchmark" / "traffic" / "few-mcs7.json").write_text(json.dumps({
        "kind": "stream", "why": "a few 100-byte frames at MCS 7",
        "mcs": [7], "psdu_lengths": [100], "pool_per_combo": 2,
        "placement": {"mode": "per_block", "per_block": 2, "margin": 400},
        "amplitude": 0.5, "snr_db": 30.0, "cfo_ppm": 20.0, "carrier_hz": 5.89e9,
        "sample_rate_hz": 20e6, "streams": 1}))
    (tmp_path / "benchmark" / "metrics" / "rx.frames_per_run.py").write_text(textwrap.dedent('''
        """rx.frames_per_run: a count the new metric reads."""


        def read(ctx):
            return ctx.get("runs")
        '''))
    spec["workloads"].append({"name": "rx-adaptive-4ch.few-mcs7", "config": "rx-adaptive-4ch",
                              "traffic": "few-mcs7", "chips": 1, "why": "a new cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "rx_msamples_per_s":
            m["workloads"].append("rx-adaptive-4ch.few-mcs7")
    spec["per_layer"].append({"name": "rx.frames_per_run", "unit": "count", "better": "higher",
                              "source": "program_counter", "layer": "host dispatch",
                              "moves": "rx_msamples_per_s",
                              "workloads": ["rx-adaptive-4ch.few-mcs7"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--rehearse", "--workload",
                          "rx-adaptive-4ch.few-mcs7", "--trace", "1", "--seconds", "0.5"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("rehearsal")][-1]
    assert "correct=True" in line and "'rx.frames_per_run'" in line


def test_without_the_program_the_run_fails_and_prints_no_result(tmp_path):
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          SPEC["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and "correct" not in out.stdout


_LOADED = textwrap.dedent('''
    import importlib, json, sys
    sys.path[:0] = [{here!r}]
    for m in {mods!r}:
        importlib.import_module(m)
    print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
''')


def _top_level(mods) -> set:
    code = _LOADED.format(here=str(HERE), mods=list(mods))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=HERE)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_reference_and_the_load_process_load_neither_jax_nor_the_program():
    """Top-level names compared whole: the port's name begins with the JAX
    package's, so a prefix test would be wrong both ways."""
    mods = ["yardstick.oracle_modem", "yardstick.vtx", "yardstick.streams",
            "yardstick.reference", "yardstick.pieces", "yardstick.roofline",
            "yardstick.readers", "loadgen"]
    top = _top_level(mods)
    assert not top & set(JAX_NAMES) and PORT not in top and "torch" not in top


def test_the_harness_loads_the_port_and_not_jax():
    top = _top_level(["harness.common", "harness.rx", "harness.radio", "run", "control",
                      "knee"])
    assert not top & set(JAX_NAMES)


def test_forbidden_modules_compares_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, PORT + ".phy", sys)
    assert common.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gnuradio_wifi_imagetransfer_tpu.phy", sys)
    assert common.forbidden_modules() == ["gnuradio_wifi_imagetransfer_tpu.phy"]


def test_reduce_trace_busy_gaps_and_labels():
    ev = [{"ph": "X", "name": "bench.slice", "cat": "user_annotation", "ts": 0, "dur": 100},
          {"ph": "X", "name": "bench.drain", "cat": "user_annotation", "ts": 40, "dur": 30},
          {"ph": "X", "name": "cudaStreamSynchronize", "cat": "cuda_runtime", "ts": 45, "dur": 20},
          {"ph": "X", "name": "void viterbi_kernel<3>(Seg)", "cat": "kernel", "ts": 10, "dur": 20},
          {"ph": "X", "name": "Memcpy DtoH", "cat": "gpu_memcpy", "ts": 25, "dur": 10},
          {"ph": "X", "name": "sync_detect_kernel(x)", "cat": "kernel", "ts": 80, "dur": 5}]
    r = common.reduce_trace(ev)
    assert r["busy_s"] == pytest.approx(30e-6) and r["window_s"] == pytest.approx(100e-6)
    assert r["kernel_s"] == pytest.approx({"viterbi_kernel": 20e-6, "sync_detect_kernel": 5e-6})
    assert r["gaps"][0] == ["bench.drain > cudaStreamSynchronize", pytest.approx(45e-6)]
    assert [g[0] for g in r["gaps"]][1:] == ["no host op (waiting)", "no host op (waiting)"]
