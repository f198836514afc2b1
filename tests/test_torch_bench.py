"""bench_torch.py on the CPU: its result contract (the last stdout line is
one JSON object with metric, value, unit and vs_baseline), its streams
against bench.py's (the JAX TX at tiny parameters), the CPU rehearsal
(``--device cpu --tiny``) in a subprocess, its failures (no card, a lost
frame), and its imports. Every subprocess has its own timeout and its own
TMPDIR, where the stream cache goes."""

import ast
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
TX_ATOL = 2e-6          # the TX tolerance of tests/test_torch_port.py


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_bench_test_{name}", REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod            # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def bench():
    return _load("bench_torch")


def _last_json(out: str) -> dict:
    lines = [ln for ln in out.strip().splitlines() if ln.strip()]
    assert lines, "no output"
    return json.loads(lines[-1])


def _printed(res) -> dict:
    cap, old = io.StringIO(), sys.stdout
    sys.stdout = cap
    try:
        res.print_line()
    finally:
        sys.stdout = old
    return _last_json(cap.getvalue())


def _step(msps):
    return {"ok": True, "shape": "4x16x262144", "frames": 192,
            "msps": {"median": msps, "spread": 0.1, "runs": [msps, msps, msps]}}


# -- (a) the result contract --------------------------------------------

def test_result_line_is_valid_json_with_contract_keys(bench):
    res = bench._Result()
    res.absorb({"name": "card", "device": {"name": "NVIDIA H100 80GB HBM3",
                                           "power_limit": "700.00 W", "count": 1}})
    res.absorb({"name": "device", **_step(2700.0)})
    res.absorb({"name": "adaptive:2", "ok": True, "frames": 511,
                "fps": {"median": 25000.0, "spread": 0.1, "runs": [25000.0] * 3}})
    res.absorb({"name": "ingest", "ok": True,
                "sc16": {"pinned": {"median": 20000.0, "spread": 0.0, "runs": [2e4] * 3}}})
    first = _printed(res)
    # a later phase lands and reprints: the last line is the whole record
    res.absorb({"name": "adaptive:mix", "ok": False, "error": "PhaseFailed('lost one')"})
    res.absorb({"name": "sweep", "skipped": "budget"})
    obj = _printed(res)
    assert obj["metric"] == first["metric"] == "rx_chain_throughput_per_card"
    assert obj["value"] == 2700.0
    assert obj["unit"] == "Msamples/s"
    assert obj["vs_baseline"] == pytest.approx(2700.0 / 80.0)
    d = obj["detail"]
    assert d["device"]["power_limit"] == "700.00 W"
    assert d["phases"]["adaptive:2"]["fps"]["median"] == 25000.0
    assert d["failed"] == {"adaptive:mix": "PhaseFailed('lost one')"}
    assert d["skipped"] == {"sweep": "budget"}
    # min(step rate, 20 000 MB/s / 4 bytes a sc16 sample)
    assert d["host_model"] == {"sc16_pinned_msps": 2700.0}


def test_partial_run_still_produces_a_number(bench):
    """Only the early small-shape phase landed: its rate is the value."""
    res = bench._Result()
    res.absorb({"name": "device_small", **_step(109.1)})
    assert _printed(res)["value"] == 109.1
    assert _printed(bench._Result())["value"] == 0.0


def test_rehearsal_value_is_null(bench):
    res = bench._Result(rehearsal=True)
    res.absorb({"name": "device", "ok": True, "frames": 4})
    obj = _printed(res)
    assert obj["value"] is None and obj["vs_baseline"] is None
    assert obj["detail"]["rehearsal"] and obj["detail"]["host_model"] is None


# -- (b) the streams against bench.py's -----------------------------------

def test_streams_equal_bench_py_streams(bench, tmp_path):
    """bench.py's _GEN_SNIPPET (JAX TX on the CPU) and the port's generator
    at the rehearsal's parameters: payloads and rates equal, samples within
    the TX tolerance."""
    g = bench.TINY
    path = tmp_path / "jax_streams.npz"
    snippet = _load("bench")._GEN_SNIPPET.format(
        params=(bench.MCS, bench.PSDU_LEN, g.block, g.channels, g.time_blocks,
                g.frames_per_block, g.dense_blocks, g.dense_max_frames), path=str(path))
    r = subprocess.run([sys.executable, "-c", snippet], cwd=REPO, capture_output=True,
                       text=True, timeout=120, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    want = dict(np.load(path))
    got = bench.make_streams(g)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        if key.endswith("_payloads") or key == "mixed_mcs":
            assert np.array_equal(got[key], w), key
        else:
            assert np.abs(got[key] - w).max() <= TX_ATOL, key
    assert want["primary_payloads"].shape == (g.channels, g.frames_per_block * g.time_blocks,
                                              bench.PSDU_LEN)
    assert set(want["mixed_mcs"]) == set(range(min(8, want["mixed_mcs"].size)))


# -- (c) the rehearsal and the failures in subprocesses -------------------

def _run(args, tmp_path, script=REPO / "bench_torch.py", timeout=150):
    env = dict(os.environ, TMPDIR=str(tmp_path),
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("GWT_BENCH_BUDGET_S", None)
    return subprocess.run([sys.executable, str(script), *args], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_cpu_rehearsal_brings_every_frame_back(bench, tmp_path):
    r = _run(["--device", "cpu", "--tiny"], tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    obj = _last_json(r.stdout)
    d = obj["detail"]
    assert obj["value"] is None and d["rehearsal"]
    assert d["device"]["name"] == "cpu" and not d["failed"] and not d["skipped"]
    assert tuple(d["phases"]) == bench.phase_ids(bench.TINY)
    for pid, p in d["phases"].items():
        if "frames" in p:
            assert p["frames"] > 0, pid
        # no time or rate from the CPU
        assert not {"msps", "fps", "step_ms", "run_ms"} & set(p), pid
    assert d["phases"]["device"]["frames"] == 4
    assert d["phases"]["frontend"]["decim2"]["output_samples"] == bench.TINY.fe_out
    assert os.path.exists(tmp_path / "gwt_bench_torch_streams_v1_tiny.npz")


def test_without_a_card_the_run_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the run without a card")
    r = _run(["--phases=device_small"], tmp_path, timeout=60)
    assert r.returncode != 0
    obj = _last_json(r.stdout)
    assert obj["value"] == 0.0 and "device_small" in obj["detail"]["failed"]
    assert "torch.cuda.is_available() is False" in r.stderr


def test_a_lost_frame_fails_the_run(tmp_path):
    """A collect that drops one record a step: device_small fails and the
    run exits non-zero; the adaptive phase beside it (another executor)
    still passes and the last line is printed."""
    wrapper = tmp_path / "lossy_bench.py"
    wrapper.write_text(
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from gnuradio_wifi_imagetransfer_tpu_torch.parallel import executor\n"
        "collect = executor.StreamExecutor._collect\n"
        "def lossy(self, offset, outs, n, samples, records):\n"
        "    collect(self, offset, outs, n, samples, records)\n"
        "    records.pop(min(records), None)\n"
        "executor.StreamExecutor._collect = lossy\n"
        "import bench_torch\n"
        "sys.exit(bench_torch.main())\n")
    r = _run(["--device", "cpu", "--tiny", "--phases=device_small,adaptive:2"], tmp_path,
             script=wrapper)
    assert r.returncode != 0
    d = _last_json(r.stdout)["detail"]
    assert set(d["failed"]) == {"device_small"} and "0 of 1 frames" in d["failed"]["device_small"]
    assert set(d["phases"]) == {"adaptive:2"}


# -- (d) imports ------------------------------------------------------------

def test_bench_imports_neither_jax_nor_the_jax_package_nor_bench_py():
    tree = ast.parse((REPO / "bench_torch.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "torch" in roots and "gnuradio_wifi_imagetransfer_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "optax", "gnuradio_wifi_imagetransfer_tpu",
                        "bench"}, sorted(roots)
    # the orchestrator itself stays cheap: importing the script loads no torch
    r = subprocess.run([sys.executable, "-c", "import sys, bench_torch; "
                        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                        "('torch', 'jax', 'gnuradio_wifi_imagetransfer_tpu', "
                        "'gnuradio_wifi_imagetransfer_tpu_torch')))"],
                       cwd=REPO, capture_output=True, text=True, timeout=60)
    assert r.returncode == 0 and r.stdout.strip() == "[]", r.stdout + r.stderr
