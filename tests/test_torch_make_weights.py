"""make_weights_torch.py's training-lineage plumbing, the port's npz writer
and the import rule of the training modules (CPU).

The twins of tests/test_make_weights.py (warm start, state save / restore)
on a tiny port SOMANet; make_weights_torch.crops and random_user_keys draw
for draw against make_weights.py's; an npz that the port writes read by the
JAX package's load_soma_npz leaf for leaf; the script itself at a 16 x 16
geometry on the CPU: a fresh run, its resume, and a warm start past its
--steps (which trains at the schedule's floor).
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import jax
import pytest
import torch

from gnuradio_wifi_imagetransfer_tpu.models import somanet as jsomanet
from gnuradio_wifi_imagetransfer_tpu.models import weights as jwt
from gnuradio_wifi_imagetransfer_tpu_torch.models import somanet
from gnuradio_wifi_imagetransfer_tpu_torch.models import weights as wt
from gnuradio_wifi_imagetransfer_tpu_torch.utils import trainer

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_{name}", REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mw():
    return _load("make_weights_torch")


@pytest.fixture
def tiny_trainer():
    model = somanet.SOMANet(16, 16, 4, device="cpu")
    return trainer.Trainer(model, learning_rate=1e-3, device="cpu")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 2, 16, 16, 3)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("augment", [False, True])
def test_crops_and_user_keys_match_make_weights(mw, augment):
    ref = _load("make_weights")
    imgs = ref.load_kodak(["kodim01", "kodim03"])
    for m in (mw, ref):
        m._set_geometry("small")
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):
        assert np.array_equal(mw.crops(a, imgs, 4, augment=augment),
                              ref.crops(b, imgs, 4, augment=augment))
        assert mw.random_user_keys(a, 2) == ref.random_user_keys(b, 2)
    assert (mw.TRAIN_IMAGES, mw.HOLDOUT, mw.TARGET_USERS) == (
        ref.TRAIN_IMAGES, ref.HOLDOUT, ref.TARGET_USERS)
    assert mw.GEOMETRIES == ref.GEOMETRIES


def test_warm_start_restores_params_and_step(mw, tiny_trainer, tmp_path):
    """The twin of tests/test_make_weights.py test_warm_start_restores_params_and_step."""
    tr = tiny_trainer
    variables = wt.flax_from_module(tr.model)
    path = str(tmp_path / "ckpt.npz")
    wt.save_soma_npz(variables, path, {"steps": 1234})
    loaded, meta = wt.load_soma_npz(path)
    fresh = trainer.Trainer(somanet.SOMANet(16, 16, 4, seed=9, device="cpu"), device="cpu")
    mw.warm_start(fresh, loaded, meta["steps"])
    assert fresh.step == 1234 and fresh.count == 0
    orig, back = wt._flatten(variables), wt._flatten(wt.flax_from_module(fresh.model))
    assert orig.keys() == back.keys()
    for k in orig:                                # exact at the float16 grid
        np.testing.assert_array_equal(orig[k].astype(np.float16), back[k].astype(np.float16))
    loss = fresh.train_step(_batch(), somanet.pe_labels(["3-4", "13-10"]))
    assert np.isfinite(loss) and fresh.step == 1235


def test_state_save_restore_roundtrip(mw, tiny_trainer, tmp_path):
    """The twin of tests/test_make_weights.py test_state_save_restore_roundtrip:
    parameters, statistics, Adam moments and counts come back exactly; a
    missing file or one of another model is refused."""
    tr = tiny_trainer
    labels = somanet.pe_labels(["3-4", "13-10"])
    tr.train_step(_batch(1), labels, mode="m2m")
    path = str(tmp_path / "state.pt")
    mw.save_state(tr, path, horizon=77)
    assert mw.saved_run(path) == {"horizon": 77}
    other = trainer.Trainer(somanet.SOMANet(16, 16, 4, seed=3, device="cpu"),
                            learning_rate=1e-3, device="cpu")
    assert mw.restore_state(other, path)
    assert (other.step, other.count) == (tr.step, tr.count)
    for a, b in zip(tr.model.state_dict().values(), other.model.state_dict().values()):
        assert torch.equal(a, b)
    # the restored Adam moments give the same next step
    la = tr.train_step(_batch(2), labels, mode="m2m")
    lb = other.train_step(_batch(2), labels, mode="m2m")
    assert la == lb
    for a, b in zip(tr.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)
    assert not mw.restore_state(tr, str(tmp_path / "missing.pt"))
    wider = trainer.Trainer(somanet.SOMANet(32, 16, 4, device="cpu"), device="cpu")
    assert not mw.restore_state(wider, path)
    assert mw.saved_run(str(tmp_path / "missing.pt")) == {}


def test_port_npz_reads_in_jax_leaf_for_leaf(tmp_path):
    """The port's reverse carrier and save_soma_npz write the JAX package's
    SOMANet variables: the same tree of leaves, shapes and float16 values."""
    images = np.zeros((2, 1, 16, 16, 3), np.float32)
    labels = jsomanet.pe_labels(["3-4", "13-10"])
    jvars = jax.jit(jsomanet.SOMANet(compressed_channel=16, img_size=16, n_irs=4).init)(
        jax.random.key(0), images, labels)
    want_shapes = {k: v.shape for k, v in jwt._flatten(jvars).items()}
    model = somanet.SOMANet(16, 16, 4, seed=2, device="cpu")
    path = str(tmp_path / "port.npz")
    wt.save_soma_npz(wt.flax_from_module(model), path, {"steps": 5, "img_size": 16})
    got, meta = jwt.load_soma_npz(path)
    assert meta == {"steps": 5, "img_size": 16}
    flat = jwt._flatten(got)
    assert {k: v.shape for k, v in flat.items()} == want_shapes
    sd = model.state_dict()
    back = wt.state_dict_from_flax(got, model)
    for k in sd:
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], sd[k].half().float()), k
    with np.load(path) as npz:
        assert all(npz[k].dtype == np.float16 for k in npz.files if k != "__meta__")


def _tiny_geometry(mw, monkeypatch, assets):
    """A 16 x 16, c = 16 geometry of 2 steps a call, its asset under ``assets``."""
    monkeypatch.setitem(mw.GEOMETRIES, "tiny", (16, 16, "tiny.npz", 2, 2, 4))
    monkeypatch.setattr(mw, "JAX_ASSETS", str(assets))
    monkeypatch.setattr(mw, "extra_train_images", lambda: [])


def test_script_trains_resumes_and_packages(mw, monkeypatch, tmp_path, capsys):
    _tiny_geometry(mw, monkeypatch, tmp_path)
    out = tmp_path / "out"
    args = ["--geometry", "tiny", "--cpu", "--out", str(out), "--eval-every", "0"]
    res = mw.main(args + ["--steps", "4"])
    tr = res["trainer"]
    assert tr.step == 4 and tr.count == 4 and len(res["losses"]) == 4
    assert np.all(np.isfinite(res["losses"]))
    variables, meta = wt.load_soma_npz(out / "tiny.npz")
    assert meta["steps"] == 4 and set(meta["holdout_metrics"]) == {"3-4", "13-10"}
    assert meta["holdout_metrics"] == res["holdout"]
    assert (out / "train_state_16_16.pt").exists()
    assert mw.saved_run(str(out / "train_state_16_16.pt")) == {"horizon": 4}
    # a restart resumes from the state file and keeps the horizon
    res2 = mw.main(args + ["--steps", "6"])
    assert "resumed step 4" in capsys.readouterr().out
    assert res2["trainer"].step == 6 and res2["trainer"].count == 6
    assert res2["trainer"].schedule(10) == pytest.approx(1e-3 * 0.01, rel=1e-6)
    with open(out / "training_curve.json") as f:
        curve = json.load(f)
    assert [p["step"] for p in curve["points"]] == [2, 4, 6]
    # --eval-only reads the npz this script wrote
    assert mw.main(["--geometry", "tiny", "--cpu", "--out", str(out), "--eval-only"])[
        "npz"] == str(out / "tiny.npz")


def test_warm_start_past_steps_trains_at_the_floor(mw, monkeypatch, tmp_path):
    """A warm start from an asset at step 100 with --steps 2 continues the
    lineage by 2 steps at the schedule's floor (lr * 0.01) and writes its
    npz under --out, never the asset."""
    _tiny_geometry(mw, monkeypatch, tmp_path)
    asset = somanet.SOMANet(16, 16, seed=4, device="cpu")
    wt.save_soma_npz(wt.flax_from_module(asset), tmp_path / "tiny.npz", {"steps": 100})
    before = (tmp_path / "tiny.npz").read_bytes()
    out = tmp_path / "out"
    res = mw.main(["--geometry", "tiny", "--cpu", "--out", str(out), "--eval-every", "0",
                   "--init-from-asset", "--steps", "2", "--lr", "1e-3"])
    tr = res["trainer"]
    assert tr.step == 102 and tr.count == 1 + 2
    assert tr.optimizer.param_groups[0]["lr"] == pytest.approx(1e-5, rel=1e-6)
    assert (tmp_path / "tiny.npz").read_bytes() == before
    assert wt.load_soma_npz(out / "tiny.npz")[1]["steps"] == 102
    assert mw.saved_run(str(out / "train_state_16_16.pt")) == {"horizon": 1, "stop": 102}


def test_training_modules_import_no_jax():
    """The slice's modules and make_weights_torch.py load with jax blocked
    and pull in no module of the JAX package."""
    code = textwrap.dedent("""
        import importlib, sys
        sys.modules["jax"] = None
        for m in ("channel.sv", "channel.irs", "models.somanet", "models.convert",
                  "models.weights", "utils.trainer", "utils.validation",
                  "utils.dataloader"):
            importlib.import_module("gnuradio_wifi_imagetransfer_tpu_torch." + m)
        import make_weights_torch
        make_weights_torch._set_geometry("ref")
        bad = [n for n, m in sys.modules.items() if m is not None and (
               n == "gnuradio_wifi_imagetransfer_tpu"
               or n.startswith("gnuradio_wifi_imagetransfer_tpu.")
               or n == "jax" or n.startswith("jax."))]
        assert not bad, bad
        print("OK")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")


def test_validation_and_dataloader_match_jax(tmp_path):
    from PIL import Image

    from gnuradio_wifi_imagetransfer_tpu.utils import dataloader as jdataloader
    from gnuradio_wifi_imagetransfer_tpu.utils import validation as jvalidation
    from gnuradio_wifi_imagetransfer_tpu_torch.utils import dataloader, validation

    rng = np.random.default_rng(6)
    (tmp_path / "sub").mkdir()
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (20, 24, 3), dtype=np.uint8)).save(
            tmp_path / ("sub" if i % 2 else ".") / f"im{i}.png")
    ds, jds = dataloader.ImageFolderDataset(str(tmp_path), (16, 12)), \
        jdataloader.ImageFolderDataset(str(tmp_path), (16, 12))
    assert ds.paths == jds.paths and len(ds) == 5
    batches = list(ds.batches(2, seed=3))
    jbatches = list(jds.batches(2, seed=3))
    assert len(batches) == 2 and all(np.array_equal(a, b) for a, b in zip(batches, jbatches))
    noisy = lambda x: x + 0.05 * np.sin(np.arange(x.size)).reshape(x.shape)   # noqa: E731
    for metric in ("PSNR", "SSIM"):
        assert validation.evaluate(noisy, batches, metric) == pytest.approx(
            jvalidation.evaluate(noisy, jbatches, metric), rel=1e-6)
    users = [np.stack([b, b[::-1]]) for b in batches]
    labels = np.zeros((2, 256), np.float32)
    apply = lambda imgs, labs: noisy(imgs)                                    # noqa: E731
    got = validation.evaluate_multiband({5: apply}, {5: users}, {5: labels})
    want = jvalidation.evaluate_multiband({5: apply}, {5: users}, {5: labels})
    assert got.keys() == want.keys() and got[5] == pytest.approx(want[5], rel=1e-6)
    with pytest.raises(FileNotFoundError):
        dataloader.ImageFolderDataset(str(tmp_path / "sub" / "none"))
    grid = tmp_path / "grid.png"
    validation.render_grid(users[0][0], users[0][1], str(grid))
    assert grid.stat().st_size > 0 and os.path.exists(grid)
