"""Train the SOMA-DSCN JSCE codec with the PyTorch port and package its npz.

The port's twin of make_weights.py: a 2-user SOMANet (shared DSCN encoder
+ PE decoder, superposition resolved by per-user positional-encoding
labels) trained on random crops of the public-domain Kodak images in the
repo, saved as the float16 npz that both packages read. The geometries,
images, crops, augmentation, user keys, state save / restore / resume,
warm start, holdout evaluation, best-so-far packaging and curve log are
make_weights.py's; the trainer is ``utils.trainer.Trainer`` on the card
(``--cpu`` for the CPU), taking K optimizer steps per ``train_steps`` call
from one uint8 batch that is normalised on the device.

Two geometries:

  --geometry ref    240x240 images, compressed_channel 128 -> (30,30,128)
                    latent (upload_featuremap_udp.py:78-82); warm-starts
                    from gnuradio_wifi_imagetransfer_tpu/assets/jsce_soma_dscn_240.npz
  --geometry small  80x80 / c=64 -> 10x10x64 latent
                    (gnuradio_wifi_imagetransfer_tpu/assets/jsce_soma_dscn.npz)

Everything this script writes goes under ``--out`` (default
``runs/make_weights_torch/``, git-ignored): the npz (named as the committed
asset), the full train state (``train_state_<img>_<c>.pt``: parameters,
BatchNorm statistics, Adam moments, counts) and the curve log. It never
writes the committed assets or make_weights.py's files.

``--steps`` is the step to reach on the lineage's axis, as in
make_weights.py, and a warm start puts the lineage at the asset's step. A
warm start whose asset is already at or past ``--steps`` (where
make_weights.py would take no step) continues the lineage by ``--steps``
steps; its cosine schedule is spent, so it trains at the schedule's floor
(0.01 * lr) from its first step.

Usage:
  python make_weights_torch.py                       # ref geometry (resumes)
  python make_weights_torch.py --geometry small --steps 8000
  python make_weights_torch.py --init-from-asset --steps 16 --out /some/dir
  python make_weights_torch.py --eval-only           # PSNR/SSIM of the npz
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
JAX_ASSETS = os.path.join(REPO, "gnuradio_wifi_imagetransfer_tpu", "assets")
DEFAULT_OUT = os.path.join(REPO, "runs", "make_weights_torch")
GEOMETRIES = {
    # name: (img, c, asset, batch, steps_per_call, default_steps)
    "ref": (240, 128, "jsce_soma_dscn_240.npz", 8, 8, 8000),
    "small": (80, 64, "jsce_soma_dscn.npz", 8, 25, 20000),
}
TRAIN_IMAGES = ["kodim01", "kodim03", "kodim04", "kodim07", "kodim21"]
HOLDOUT = "kodim23"
TARGET_USERS = ["3-4", "13-10"]      # the reference's hard-coded Mode-1 users
U = 2
# geometry-dependent globals, bound by _set_geometry()
IMG, C, ASSET, OUT_NPZ, B, K = None, None, None, None, None, None
STATE = None


def _set_geometry(name: str, out: str = DEFAULT_OUT) -> int:
    global IMG, C, ASSET, OUT_NPZ, B, K, STATE
    IMG, C, asset, B, K, steps = GEOMETRIES[name]
    ASSET = os.path.join(JAX_ASSETS, asset)
    OUT_NPZ = os.path.join(out, asset)
    STATE = os.path.join(out, f"train_state_{IMG}_{C}.pt")
    return steps


def _find_image(name: str) -> str:
    for d in (os.path.join(REPO, "assets"), JAX_ASSETS):
        p = os.path.join(d, name + ".png")
        if os.path.exists(p):
            return p
    raise FileNotFoundError(name)


def load_kodak(names):
    from PIL import Image

    return [np.asarray(Image.open(_find_image(n)).convert("RGB")) for n in names]


def extra_train_images():
    """Additional public sample images bundled with scikit-learn (china,
    flower, 427x640 RGB); an empty list where scikit-learn is absent."""
    try:
        from sklearn.datasets import load_sample_images

        return [np.ascontiguousarray(im.astype(np.uint8))
                for im in load_sample_images().images]
    except Exception:
        return []


def crops(rng, imgs, n, size=None, augment=False):
    """n random crops (n, size, size, 3) uint8 with flips; with
    ``augment`` also random scales (crop up to 2x the target then
    bicubic-resize down) and 90-degree rotations. make_weights.crops, draw
    for draw."""
    from PIL import Image

    if size is None:
        size = IMG               # bound by _set_geometry(), not at import
    out = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        im = imgs[rng.integers(len(imgs))]
        s = size
        if augment and rng.integers(2):
            s_max = min(im.shape[0], im.shape[1], 2 * size)
            if s_max > size:
                s = int(rng.integers(size, s_max + 1))
        y = rng.integers(im.shape[0] - s + 1)
        x = rng.integers(im.shape[1] - s + 1)
        c = im[y : y + s, x : x + s]
        if s != size:
            c = np.asarray(Image.fromarray(c).resize((size, size), Image.BICUBIC))
        if augment:
            c = np.rot90(c, int(rng.integers(4)))
        if rng.integers(2):
            c = c[:, ::-1]
        if rng.integers(2):
            c = c[::-1]
        out[i] = c
    return out


def random_user_keys(rng, u):
    """Random 're-im' CSI keys; the demo TARGET pair appears periodically
    so its labels are well-trained."""
    if rng.integers(4) == 0:
        return list(TARGET_USERS[:u])
    keys = []
    while len(keys) < u:
        # the 're-im' key format cannot express negative parts (the
        # reference's getCSI splits on '-', jsce_codec.py:98-100)
        re, im = int(rng.integers(0, 30)), int(rng.integers(0, 30))
        k = f"{re}-{im}"
        if k not in keys:
            keys.append(k)
    return keys


# --- full-train-state persistence (params + stats + adam moments) ---------

def save_state(trainer, path, horizon: int | None = None, stop: int | None = None):
    import torch

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"model": trainer.model.state_dict(),
                "optimizer": trainer.optimizer.state_dict(),
                "step": trainer.step, "count": trainer.count,
                "horizon": horizon, "stop": stop}, path)


def saved_run(path) -> dict:
    """The cosine horizon and the step to reach recorded in a state file
    ({} without one). Restarting with the same CLI as a warm-started run
    would otherwise stretch the schedule and move the stop."""
    import torch

    if not os.path.exists(path):
        return {}
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return {k: ckpt[k] for k in ("horizon", "stop") if ckpt.get(k) is not None}


def restore_state(trainer, path) -> bool:
    """Load a state file into the trainer; False (and nothing loaded) when
    the file is missing or its tensors do not fit the model."""
    import torch

    if not os.path.exists(path):
        return False
    ckpt = torch.load(path, map_location=trainer.device, weights_only=True)
    target = trainer.model.state_dict()
    if ckpt["model"].keys() != target.keys() or any(
            ckpt["model"][k].shape != target[k].shape for k in target):
        return False
    trainer.model.load_state_dict(ckpt["model"])
    trainer.optimizer.load_state_dict(ckpt["optimizer"])
    trainer.step, trainer.count = int(ckpt["step"]), int(ckpt["count"])
    return True


def warm_start(trainer, variables: dict, step: int) -> None:
    """Continue a training lineage from a packaged npz checkpoint: take
    its params/batch_stats, keep the trainer's fresh optimizer state (the
    npz carries no Adam moments), and set the step counter so curve/eval
    bookkeeping stays on the lineage's axis."""
    from gnuradio_wifi_imagetransfer_tpu_torch.models.weights import state_dict_from_flax

    trainer.model.load_state_dict(state_dict_from_flax(variables, trainer.model))
    trainer.step = int(step)


# --- evaluation -----------------------------------------------------------

def eval_holdout(variables, n_crops=16, seed=123, save_grid=None, device="cuda"):
    """PSNR/SSIM of the full Mode-1 path (per-user encode -> mean
    superpose -> L2-normalize -> per-user decode, the JSCE facade
    semantics) on held-out kodim23 crops for the demo TARGET users."""
    from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import JSCE
    from gnuradio_wifi_imagetransfer_tpu_torch.models.weights import split_soma
    from gnuradio_wifi_imagetransfer_tpu_torch.utils.metrics import psnr, ssim

    rng = np.random.default_rng(seed)
    holdout = load_kodak([HOLDOUT])
    jsce = JSCE(img_size=(IMG, IMG), compressed_channel=C, params=split_soma(variables),
                device=device)
    scores = {u: {"psnr": [], "ssim": []} for u in TARGET_USERS}
    grid = []
    for _ in range(n_crops):
        imgs = {u: crops(rng, holdout, 1)[0] for u in TARGET_USERS}
        latent = jsce.img2msg(imgs)
        for u in TARGET_USERS:
            rec = np.asarray(jsce.msg2img(latent, u))
            scores[u]["psnr"].append(psnr(rec, imgs[u]))
            scores[u]["ssim"].append(float(ssim(rec, imgs[u], channel_axis=2)))
        grid.append((imgs[TARGET_USERS[0]], np.asarray(jsce.msg2img(latent, TARGET_USERS[0]))))
    if save_grid:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(2, 4, figsize=(10, 5.2))
        for c, (src, rec) in enumerate(grid[:4]):
            axes[0, c].imshow(src)
            axes[0, c].axis("off")
            axes[1, c].imshow(rec)
            axes[1, c].axis("off")
        axes[0, 0].set_title("source", fontsize=9)
        axes[1, 0].set_title("reconstruction", fontsize=9)
        fig.tight_layout()
        fig.savefig(save_grid, dpi=110)
        plt.close(fig)
    return {u: {m: float(np.mean(v)) for m, v in d.items()} for u, d in scores.items()}


def main(argv=None) -> dict:
    """Runs the script; returns {"trainer", "npz", "holdout", "losses"} for
    a caller that drives it in-process (an --eval-only run: {"npz",
    "holdout"})."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--geometry", choices=sorted(GEOMETRIES), default="ref")
    ap.add_argument("--steps", type=int, default=None,
                    help="step to reach (default: per-geometry, ref 8000, small 20000)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--cpu", action="store_true", help="train on the CPU, not the card")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="directory of the npz, the train state and the curve log")
    ap.add_argument("--fresh", action="store_true", help="ignore the resume state")
    ap.add_argument("--init-from-asset", action="store_true",
                    help="warm-start params/batch_stats from the committed npz when no "
                    "resume state exists (fresh Adam moments)")
    ap.add_argument("--fresh-curve", action="store_true",
                    help="start a new curve file instead of appending")
    ap.add_argument("--horizon", type=int, default=None,
                    help="cosine-schedule horizon in optimizer steps (default: steps - "
                    "warm_start_step); pass the original when restarting from the state")
    ap.add_argument("--report-every", type=int, default=8,
                    help="train_steps calls between progress/checkpoint saves")
    ap.add_argument("--eval-every", type=int, default=4000,
                    help="steps between holdout-PSNR curve points (0=off)")
    ap.add_argument("--curve-out", default=None,
                    help="JSON training-curve log (default: <out>/training_curve.json)")
    ap.add_argument("--no-augment", action="store_true",
                    help="disable scale/rotation augmentation")
    args = ap.parse_args(argv)
    default_steps = _set_geometry(args.geometry, args.out)
    if args.steps is None:
        args.steps = default_steps
    curve_out = args.curve_out or os.path.join(args.out, "training_curve.json")

    import torch

    from gnuradio_wifi_imagetransfer_tpu_torch.models.weights import (
        flax_from_module, load_soma_npz, save_soma_npz)
    from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve

    dev = resolve("cpu" if args.cpu else "cuda")
    os.makedirs(args.out, exist_ok=True)

    if args.eval_only:
        path = OUT_NPZ if os.path.exists(OUT_NPZ) else ASSET
        variables, meta = load_soma_npz(path)
        table = eval_holdout(variables, device=dev, save_grid=os.path.join(
            args.out, "jsce_quality_grid.png"))
        print(json.dumps({"npz": path, "meta": meta, "holdout": table}, indent=2))
        return {"npz": path, "holdout": table}

    from gnuradio_wifi_imagetransfer_tpu_torch.models.somanet import SOMANet, pe_labels
    from gnuradio_wifi_imagetransfer_tpu_torch.utils.trainer import (
        Trainer, cosine_decay_schedule)

    print(f"device: {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}",
          flush=True)
    rng = np.random.default_rng(0)
    train_imgs = load_kodak(TRAIN_IMAGES) + extra_train_images()
    print(f"train pool: {len(train_imgs)} images, augment={not args.no_augment}", flush=True)

    # a warm start's Adam moments start fresh, so the cosine horizon spans
    # only the steps left to the lineage's target
    warm_step = 0
    warm_vars = None
    if args.init_from_asset and not args.fresh \
            and not os.path.exists(STATE) and os.path.exists(ASSET):
        warm_vars, warm_meta = load_soma_npz(ASSET)
        warm_step = int(warm_meta.get("steps", 0))
        print(f"warm-starting from {ASSET} (step {warm_step})", flush=True)

    saved = {} if args.fresh else saved_run(STATE)
    horizon = args.horizon or saved.get("horizon") or max(args.steps - warm_step, 1)
    # a continuation (a warm start already at or past --steps) records its
    # stop in the state file, so a restart with the same CLI keeps it
    stop = saved.get("stop") or (warm_step + args.steps if warm_vars is not None
                                 and warm_step >= args.steps else args.steps)
    continuation = stop if stop != args.steps else None
    model = SOMANet(compressed_channel=C, img_size=IMG, seed=0, device=dev)
    trainer = Trainer(model, learning_rate=cosine_decay_schedule(args.lr, horizon, alpha=0.01),
                      device=dev)
    if not args.fresh and restore_state(trainer, STATE):
        print(f"resumed step {trainer.step} from {STATE}", flush=True)
    elif warm_vars is not None:
        warm_start(trainer, warm_vars, warm_step)
        if continuation is not None:
            trainer.count = horizon          # the spent schedule: its floor

    def batch_seq(k):
        """(K, U, B, IMG, IMG, 3) uint8 images + (K, U, 256) labels; the
        trainer normalises the pixels on the device."""
        imgs = np.empty((k, U, B, IMG, IMG, 3), np.uint8)
        labs = np.empty((k, U, 256), np.float32)
        for i in range(k):
            for u in range(U):
                imgs[i, u] = crops(rng, train_imgs, B, augment=not args.no_augment)
            labs[i] = pe_labels(random_user_keys(rng, U))
        return imgs, labs

    curve: list[dict] = []
    if os.path.exists(curve_out) and not args.fresh_curve:
        try:
            with open(curve_out) as f:
                curve = json.load(f)["points"]
        except (OSError, ValueError, KeyError):
            curve = []

    def log_curve(step, loss, psnr=None):
        pt = {"step": int(step), "loss": float(loss)}
        if psnr is not None:
            pt["holdout_psnr"] = {u: round(v["psnr"], 3) for u, v in psnr.items()}
        curve.append(pt)
        os.makedirs(os.path.dirname(os.path.abspath(curve_out)), exist_ok=True)
        with open(curve_out, "w") as f:
            json.dump({"geometry": args.geometry, "train_pool": len(train_imgs),
                       "augment": not args.no_augment, "warm_start_step": warm_step,
                       "lr": args.lr, "total_steps": stop, "points": curve}, f, indent=1)

    next_eval = ((trainer.step // args.eval_every + 1)
                 * args.eval_every) if args.eval_every else None

    def package(variables, table, step):
        """Write this script's npz for these variables/metrics."""
        meta = {
            "geometry": args.geometry,
            "compressed_channel": C, "img_size": IMG, "users": TARGET_USERS,
            "steps": int(step), "lr": args.lr,
            "train_images": TRAIN_IMAGES, "holdout": HOLDOUT,
            "holdout_metrics": table,
        }
        save_soma_npz(variables, OUT_NPZ, meta)
        return meta

    # best-so-far packaging: a time-boxed run must never lose an improved
    # checkpoint to an unreached final save; the bar is this script's own
    # npz in --out, if any
    best_psnr = None
    if os.path.exists(OUT_NPZ):
        hm = load_soma_npz(OUT_NPZ)[1].get("holdout_metrics", {})
        if hm:
            best_psnr = float(np.mean([v["psnr"] for v in hm.values()]))

    t0 = time.time()
    step0 = trainer.step
    all_losses = []
    while trainer.step < stop:
        imgs, labs = batch_seq(K)
        losses = trainer.train_steps(imgs, labs, mode="m2m")
        all_losses.extend(losses.tolist())
        step = trainer.step
        if (step // K - 1) % args.report_every == 0 or step >= stop:
            rate = (step - step0) / max(time.time() - t0, 1e-9)
            print(f"step {step:6d}  loss {losses[-1]:.5f}  ({rate:.1f} steps/s)", flush=True)
            save_state(trainer, STATE, horizon, continuation)
            psnr = None
            if next_eval is not None and step >= next_eval:
                variables = flax_from_module(trainer.model)
                psnr = eval_holdout(variables, n_crops=16, device=dev)
                print("  holdout: " + ", ".join(
                    f"{u} {v['psnr']:.2f} dB" for u, v in psnr.items()), flush=True)
                mean_psnr = float(np.mean([v["psnr"] for v in psnr.values()]))
                if best_psnr is None or mean_psnr > best_psnr:
                    best_psnr = mean_psnr
                    package(variables, psnr, step)
                    print(f"  packaged {OUT_NPZ} @ step {step} ({mean_psnr:.2f} dB mean)",
                          flush=True)
                next_eval = (step // args.eval_every + 1) * args.eval_every
            log_curve(step, losses[-1], psnr)

    save_state(trainer, STATE, horizon, continuation)
    variables = flax_from_module(trainer.model)
    table = eval_holdout(variables, device=dev)
    mean_final = float(np.mean([v["psnr"] for v in table.values()]))
    if best_psnr is None or mean_final >= best_psnr:
        package(variables, table, trainer.step)
        print(json.dumps({"saved": OUT_NPZ, "holdout": table}, indent=2))
    else:
        print(json.dumps({"kept_packaged_best": best_psnr, "final_holdout": table}, indent=2))
    return {"trainer": trainer, "npz": OUT_NPZ, "holdout": table,
            "losses": np.asarray(all_losses)}


if __name__ == "__main__":
    main()
