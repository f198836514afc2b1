"""The kernels' bounds, the card timers and the shared harness of the port.

The bounds live beside their kernels (``ops/sync_stats.py``,
``ops/viterbi_acs.py``, ``ops/fir.py``, ``ops/track_eq.py``) over the peaks of
``ops/roofline.py`` and read only the shapes of the work, so any reader
(the smoke run, a benchmark) reckons the same bound for the same shapes.
Here they reproduce PERF.md's kernel table at its shapes, with K1's and
K2's operations at the instruction rate (no FMA in their counts) and K3's
and K4's at the FMA rate. Then: the timers refuse to time without a card,
a recorded run's kernel calls are held on the CPU, and no file but the
JAX-free import check of tests/test_torch_port.py loads chip_smoke.py.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu_torch.ops import fir, holds, roofline
from gnuradio_wifi_imagetransfer_tpu_torch.ops import sync_stats as k1
from gnuradio_wifi_imagetransfer_tpu_torch.ops import track_eq as k5
from gnuradio_wifi_imagetransfer_tpu_torch.ops import viterbi_acs as k2
from gnuradio_wifi_imagetransfer_tpu_torch.utils import tracing

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the executor's blocks at the bench shape: 4 channels x 16 blocks,
# 262 144 samples and their halos a row (a shape only: no memory)
BLOCKS = torch.empty((64, 263_840), dtype=torch.complex64, device="meta")
K4_N = 5_595_478                          # the general front-end's 3/4 input a row
K4_TAPS = 36                              # design_lowpass(3, 4)


def _k4():
    n_out = fir.out_len(K4_N, 3, 4)
    return fir.resample_bound(4 * K4_N, 4 * n_out, K4_TAPS,
                              4 * fir.resample_terms(K4_N, 3, 4, K4_TAPS))


# (bound, key, PERF.md's value, decimals it is written to)
CASES = {
    "sync_detect bytes at (64, 263 840)": (lambda: k1.sync_detect_bound(BLOCKS, 4), "bytes",
                                           0.040, 3),
    "sync_detect operations at the instruction rate": (
        lambda: k1.sync_detect_bound(BLOCKS, 4), "operations", 0.022, 3),
    "dense sync_stats bytes at (64, 263 840)": (lambda: k1.sync_stats_bound(BLOCKS), "bytes",
                                                0.121, 3),
    "fir_filter bytes at (4, 4 194 304) x 65": (lambda: fir.fir_bound(4 << 22, 65), "bytes",
                                                0.080, 3),
    "fir_filter operations at the FMA rate": (lambda: fir.fir_bound(4 << 22, 65),
                                              "operations", 0.065, 3),
    "polyphase_resample bytes at 3/4 on (4, 5 595 478)": (_k4, "bytes", 0.094, 3),
    "polyphase_resample operations at the FMA rate": (_k4, "operations", 0.012, 3),
    "viterbi_decode_many operations on (256 x 422) + (256 x 24)": (
        lambda: k2.viterbi_bound(256 * (422 + 24)), "operations", 0.00113, 5),
    "viterbi_decode operations on stage A's 512 x 24": (
        lambda: k2.viterbi_bound(512 * 24), "operations", 0.00012, 5),
    "track_eq bytes at the ITS-G5 cell's largest bucket, 512 x 135": (
        lambda: k5.track_bound(512, 512 * 135), "bytes", 0.0205, 4),
    "track_eq operations at the instruction rate, 512 x 135": (
        lambda: k5.track_bound(512, 512 * 135), "operations", 0.0084, 4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bound_reproduces_the_kernel_table(case):
    fn, key, want, places = CASES[case]
    b = fn()
    assert round(b[key], places) == want, b


@pytest.mark.parametrize("steps,ms,places", [(422, 0.045, 3), (24, 0.0025, 4),
                                             (2374, 0.252, 3), (4798, 0.509, 3)])
def test_chain_floor_at_1980_mhz(steps, ms, places):
    assert round(k2.chain_floor_ms(steps, 1980.0), places) == ms


@pytest.mark.parametrize("symbols,ms", [(135, 0.022), (269, 0.044)])
def test_k5_chain_floor_at_1980_mhz(symbols, ms):
    assert round(k5.chain_floor_ms(symbols, 1980.0), 3) == ms


def test_the_instruction_rate_is_half_the_fma_rate():
    """132 SMs x 128 float32 lanes x 1.98 GHz, one instruction a lane a
    cycle; an FMA counts two operations."""
    assert roofline.FP32_INSTR_PER_S == pytest.approx(132 * 128 * 1.98e9, rel=2e-3)
    assert roofline.FP32_FMA_OPS_PER_S == 2 * roofline.FP32_INSTR_PER_S
    assert roofline.bound_str({"bytes": 0.5, "operations": 0.25}) == "0.50000 ms by bytes"


@pytest.mark.parametrize("interp,decim,n_taps,n", [(3, 4, 36, 50), (2, 1, 7, 20),
                                                   (1, 2, 9, 31), (5, 2, 13, 17)])
def test_resample_terms_counts_the_direct_forms_terms(interp, decim, n_taps, n):
    """Term by term, as polyphase_resample_plain sums them."""
    c = (n_taps - 1) // 2
    want = 0
    for j in range(fir.out_len(n, interp, decim)):
        t0 = (j * decim + c) % interp
        base = (j * decim + c - t0) // interp
        want += sum(1 for k in range(-(-n_taps // interp))
                    if t0 + k * interp < n_taps and 0 <= base - k < n)
    assert fir.resample_terms(n, interp, decim, n_taps) == want


@pytest.mark.parametrize("timer", ["cuda_ms", "cuda_event_ms", "device_profile"])
def test_card_timers_refuse_the_host_clock(timer):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the timers time it")
    calls = []
    args = (lambda: calls.append(1),) + ((3,) if timer != "device_profile" else ())
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        getattr(tracing, timer)(*args)
    assert not calls


def test_recorded_calls_are_held_on_the_cpu():
    """``recording`` keeps the calls made through the modules and leaves
    the launch counters to the wrappers; ``hold_recorded`` makes each again
    through the kernel and its plain version (on CPU tensors both are the
    plain one, so the hold reports no error)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((2, 3000)) + 1j * rng.standard_normal(
        (2, 3000))).astype(np.complex64))
    llr = torch.from_numpy(rng.standard_normal((3, 30, 2)).astype(np.float32))
    targets = ((k1, "sync_detect"), (k2, "viterbi_decode_many"), (fir, "polyphase_resample"))
    before = [getattr(m, n) for m, n in targets]
    with tracing.recording(*targets, keep=1) as calls:
        for _ in range(2):
            k1.sync_detect(x, 4, 0.56, 8, 0, None)
        k2.viterbi_decode_many([llr, llr[:, :24]], [True, True])
        fir.polyphase_resample(x, 3, 4, np.hanning(36).astype(np.float32))
        assert k2.viterbi_decode_many.launches == 0
    assert [getattr(m, n) for m, n in targets] == before
    assert [len(calls[n]) for _, n in targets] == [1, 1, 1]
    held = holds.hold_recorded(calls, "cpu")
    assert held == {"sync_detect": (0.0, [((2, 3000), 4)]),
                    "viterbi_decode_many": (0.0, [[(3, 30, 2), (3, 24, 2)]]),
                    "polyphase_resample": (0.0, [(2, 3000)])}
    holds.merge_held(held, {"sync_detect": (1e-6, [((1, 10), 2)])})
    assert held["sync_detect"] == (1e-6, [((2, 3000), 4), ((1, 10), 2)])


def _loads_chip_smoke(tree: ast.Module) -> list[str]:
    """The lines of a module that import chip_smoke or load chip_smoke.py
    by path."""
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import) and any(
                a.name.split(".")[0] == "chip_smoke" for a in node.names):
            hits.append(node.lineno)
        elif isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] == \
                "chip_smoke":
            hits.append(node.lineno)
        elif isinstance(node, ast.Call) and any(_names_the_script(a) for a in node.args):
            hits.append(node.lineno)
    return hits


def _names_the_script(arg: ast.expr) -> bool:
    """An argument that names the module or its file (``"chip_smoke"``,
    ``REPO / "chip_smoke.py"``, ``str(...)`` of it): a loader's. A command
    line (a list) that runs the script names it too, but runs it in a
    process of its own."""
    if isinstance(arg, ast.Constant):
        return arg.value in ("chip_smoke", "chip_smoke.py")
    if isinstance(arg, ast.BinOp):
        return _names_the_script(arg.left) or _names_the_script(arg.right)
    if isinstance(arg, ast.Call):
        return any(_names_the_script(a) for a in arg.args)
    return False


def _repo_modules():
    skip = {"tmp", "chiprun_out", ".git", "_build", "__pycache__", "runs"}
    return sorted(p for p in ROOT.rglob("*.py")
                  if not skip & set(p.relative_to(ROOT).parts[:-1]))


def test_no_file_loads_the_smoke_script():
    """multichip_torch.py and the tests read the package, never
    chip_smoke.py, which every slice edits. Only
    tests/test_torch_port.py's JAX-free import check imports it, in a
    process of its own from a string of code, which the scan does not
    parse; that the check still names it is held here too."""
    found = {}
    for path in _repo_modules():
        hits = _loads_chip_smoke(ast.parse(path.read_text(), filename=str(path)))
        if hits:
            found[str(path.relative_to(ROOT))] = hits
    assert not found, found
    assert "import chip_smoke," in (ROOT / "tests" / "test_torch_port.py").read_text()
    for name in ("multichip_torch.py", "tests/test_torch_waterfall.py",
                 "tests/test_torch_soak.py"):
        assert (ROOT / name).exists()


@pytest.mark.parametrize("source,loads", [
    ("import chip_smoke", True),
    ("import chip_smoke as cs", True),
    ("from chip_smoke import cuda_ms", True),
    ("spec = importlib.util.spec_from_file_location('cs', REPO / 'chip_smoke.py')", True),
    ("runpy.run_path(str(ROOT / 'chip_smoke.py'))", True),
    ("mod = importlib.import_module('chip_smoke')", True),
    ("from gnuradio_wifi_imagetransfer_tpu_torch.utils import scenarios", False),
    ("cs = _load('chip_smoke', 'chip_smoke.py')", True),
    ("subprocess.run([sys.executable, 'chip_smoke.py'])", False),
    ("ok = name == 'chip_smoke'", False),
])
def test_the_scan_sees_each_way_of_loading_it(source, loads):
    assert bool(_loads_chip_smoke(ast.parse(source))) == loads
