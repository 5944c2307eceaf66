"""The port's training data path, loop, checkpoints and CLI
(starcop_tpu_torch.data.labels, .data.chip_cache, .ops.ratios.weight_mag1c,
.data.datamodule.DataModule, .setup_shims, .eval.plot, the Trainer's fit,
.train.checkpoint, the dropout network and .cli.train) against the JAX
package on the CPU.

Bars: labels, weight_mag1c, the chip-cache files and index CSV, the tiled
CSV and every DataModule batch bitwise; ``Trainer.fit`` from one JAX state
the same history with val_loss within 2 % (12 Adam steps at lr 3e-3, where
a gradient near zero flips an update by 2 lr); a resumed run bitwise the
uninterrupted one; a port checkpoint through JAX's loader at the logits bar
(rtol 1e-3 / atol 2e-4, tests/test_torch_port.py:37); the train CLI the
same experiment files, keys and CSV columns (its weights start from other
random streams, so its numbers are not compared).
"""

import csv
import glob
import json
import math
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from starcop_tpu.data import chip_cache as jcache  # noqa: E402
from starcop_tpu.data import labels as jlabels  # noqa: E402
from starcop_tpu.data.datamodule import DataModule as JDataModule  # noqa: E402
from starcop_tpu.eval import plot as jplot  # noqa: E402
from starcop_tpu.models import SegmentationModel as FlaxSegmentationModel  # noqa: E402
from starcop_tpu.ops.ratios import weight_mag1c as j_weight_mag1c  # noqa: E402
from starcop_tpu.setup_shims import load_pretrained_variables as j_load_pretrained  # noqa: E402
from starcop_tpu.train import loop as jloop  # noqa: E402
from starcop_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint  # noqa: E402
from starcop_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint  # noqa: E402
from starcop_tpu_torch import setup_shims  # noqa: E402
from starcop_tpu_torch.config import Config  # noqa: E402
from starcop_tpu_torch.data import chip_cache as tcache  # noqa: E402
from starcop_tpu_torch.data import labels as tlabels  # noqa: E402
from starcop_tpu_torch.data.datamodule import DataModule  # noqa: E402
from starcop_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_chip_batch,
    write_synthetic_chip_dataset,
)
from starcop_tpu_torch.eval import plot as tplot  # noqa: E402
from starcop_tpu_torch.models import layers  # noqa: E402
from starcop_tpu_torch.models.segmenter import SegmentationModel  # noqa: E402
from starcop_tpu_torch.models.weights import load_pretrained_state_dict  # noqa: E402
from starcop_tpu_torch.ops.ratios import weight_mag1c  # noqa: E402
from starcop_tpu_torch.train import loop as tloop  # noqa: E402
from starcop_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from tests.test_torch_train import LR, PRODUCTS, _batch, _torch  # noqa: E402

RGB = ["TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm"]


def _tree_bytes(root):
    """{relative path: file bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


# ---------------------------------------------------------------------------
# weight_mag1c, labels
# ---------------------------------------------------------------------------


def test_weight_mag1c_bitwise():
    m = np.random.default_rng(0).uniform(-100, 2000, (3, 37, 41)).astype(np.float32)
    m[0, 0, :4] = [0.0, 40.0, 400.0, np.float32(399.99997)]
    got = weight_mag1c(torch.from_numpy(m))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_weight_mag1c(jnp.asarray(m))))


def test_mosaic_labels_bitwise():
    rng = np.random.default_rng(1)
    windows = [{"window_row_off": -5, "window_col_off": 10},
               {"window_row_off": 30, "window_col_off": 50},
               {"window_row_off": 35, "window_col_off": 55},
               {"window_row_off": 200, "window_col_off": 0}]  # wholly outside
    for shape in ((20, 24), (4, 20, 24)):
        rasters = [rng.random(shape).astype(np.float32) for _ in windows]
        want = jlabels.mosaic_labels((64, 72), windows, rasters)
        got = tlabels.mosaic_labels((64, 72), windows, rasters)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tlabels.mosaic_labels((8, 8), [], []),
                                  jlabels.mosaic_labels((8, 8), [], []))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_proposed_mask_bitwise(seed):
    rng = np.random.default_rng(seed)
    h, w = 61, 67
    yy, xx = np.mgrid[:h, :w]
    mag1c = rng.normal(100, 60, (h, w))
    for _ in range(4):  # blobs, some touching the border
        cy, cx, r = rng.integers(0, h), rng.integers(0, w), rng.integers(3, 9)
        mag1c += 400 * ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)
    mag1c += 400 * ((yy - 15) ** 2 + (xx - 12) ** 2 < 36)  # one inside the annotation
    rgba = np.zeros((4, h, w), np.float32)
    rgba[3, : h // 2, : w // 2] = 255  # the annotation covers one quadrant
    want = jlabels.proposed_mask(rgba, mag1c[None].astype(np.float32))
    got = tlabels.proposed_mask(rgba, mag1c[None].astype(np.float32))
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0


# ---------------------------------------------------------------------------
# Chip cache: the files and the index, byte for byte
# ---------------------------------------------------------------------------


def _raw_products(seed, h=70, w=90):
    rng = np.random.default_rng(seed)
    mag1c = rng.normal(150, 120, (h, w)).astype(np.float32)
    mag1c[20:40, 30:60] += 900
    mag1c[0, :3] = [-50.0, 12000.0, 10000.0]  # both clamps
    products = {"mag1c": mag1c, **{b: rng.uniform(1, 30, (h, w)).astype(np.float32) for b in RGB}}
    rgba = np.zeros((4, h, w), np.float32)
    rgba[:, 15:45, 25:65] = 200.0
    toa = {"toa_correction_factor": 3.21, "toa_products": RGB,
           "solar_irradiance": {"TOA_AVIRIS_640nm": 1500.5, "TOA_AVIRIS_550nm": 1800.25,
                                "TOA_AVIRIS_460nm": 2000.0}}
    return products, rgba, toa


@pytest.mark.parametrize("fmt", ["tif", "npy"])
def test_cache_chip_files_bitwise(fmt, tmp_path):
    products, rgba, toa = _raw_products(3)
    geo = {"transform": (30.0, 0.0, 5e5, 0.0, -30.0, 4e6), "crs_epsg": 32613} if fmt == "tif" \
        else {}
    summaries, trees = {}, {}
    for name, mod in (("jax", jcache), ("port", tcache)):
        folder = tmp_path / name
        summaries[name] = mod.cache_chip(str(folder), products, rgba, output_size=(96, 96),
                                         fmt=fmt, **toa, **geo)
        trees[name] = _tree_bytes(folder)
        # an unlabeled chip (a mined negative) gets an all-background label
        mod.cache_chip(str(tmp_path / f"{name}_neg"), {"mag1c": products["mag1c"]},
                       output_size=(96, 96), fmt=fmt)
        trees[name + "_neg"] = _tree_bytes(tmp_path / f"{name}_neg")
    assert summaries["port"] == summaries["jax"] and summaries["port"]["has_plume"]
    assert set(trees["port"]) == {f"{p}.{fmt}" for p in
                                  [*products, "labelbinary", "label_rgba", "weight_mag1c"]}
    assert trees["port"] == trees["jax"]
    assert trees["port_neg"] == trees["jax_neg"]


def test_cache_dataset_index_bitwise(tmp_path):
    rows = [{"id": f"t{i}", "window_col_off": 10 * i, "window_row_off": 5, "window_width": 90,
             "window_height": 70, "qplume": 1.5 * i} for i in range(3)]

    def read_products(row):
        products, rgba, toa = _raw_products(int(row["id"][1:]))
        return products, (rgba if row["id"] != "t2" else None), toa

    root = tmp_path / "cache"
    trees = {}
    for name, mod in (("jax", jcache), ("port", tcache)):
        shutil.rmtree(root, ignore_errors=True)
        index = mod.cache_dataset(str(root), rows, read_products, output_size=(96, 96),
                                  num_workers=2)
        assert index == str(root / "index.csv")
        # the rerun skips the cached tiles and rebuilds the index from disk
        mod.cache_dataset(str(root), rows, lambda r: 1 / 0, output_size=(96, 96),
                          index_name="index_again.csv")
        trees[name] = _tree_bytes(root)
    assert trees["port"] == trees["jax"]
    assert len(trees["port"]) == 2 + 3 * 7 - 1  # two indexes; t2 has no label_rgba


# ---------------------------------------------------------------------------
# DataModule: the tiled CSV and every batch, bitwise
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chips(tmp_path_factory):
    root = tmp_path_factory.mktemp("chips")
    return write_synthetic_chip_dataset(str(root), np.random.default_rng(2), n_tiles=4, size=256)


def _assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("weight_sampling", [True, False])
def test_datamodule_batches_bitwise(weight_sampling, chips):
    """Bitwise with the chips read in the loader's thread. With reader
    threads (num_workers > 0) each thread draws the augmentation from its
    own child generator, so which sample gets which draw follows the
    threads' timing, in both packages: there the batches' tiles are the
    same, not their rotations."""
    kw = dict(input_products=["mag1c", *RGB], batch_size=6, weight_sampling=weight_sampling,
              num_workers=0, seed=5)
    cache = chips.replace(".csv", "_tiled_128_64.csv")
    if os.path.exists(cache):
        os.remove(cache)
    jdm = JDataModule(chips, chips, **kw)
    jrows = jdm.tiled_train_rows
    with open(cache, "rb") as fh:
        want_csv = fh.read()
    os.remove(cache)
    tdm = DataModule(chips, chips, **kw)
    assert tdm.tiled_train_rows == jrows and len(jrows) == 4 * 9
    with open(cache, "rb") as fh:
        assert fh.read() == want_csv
    # A second module reads the cached windows, as JAX's does.
    assert DataModule(chips, chips, **kw).tiled_train_rows == \
        JDataModule(chips, chips, **kw).tiled_train_rows
    assert len(tdm.train_loader()) == len(jdm.train_loader()) == 36 // 6
    _assert_same_batches(tdm.train_loader(), jdm.train_loader())
    _assert_same_batches(tdm.test_loader(batch_size=3), jdm.test_loader(batch_size=3))
    tdm.num_workers = jdm.num_workers = 2
    assert [b["id"] for b in tdm.train_loader()] == [b["id"] for b in jdm.train_loader()]
    assert [r["id"] for r in tdm.test_dataset(sort_plot=True).rows] == \
        [r["id"] for r in jdm.test_dataset(sort_plot=True).rows]


# ---------------------------------------------------------------------------
# Trainer.fit from one JAX state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fit_batches():
    r = np.random.default_rng(1)
    batches = [synthetic_chip_batch(r, batch_size=8, size=64, input_products=("mag1c",))
               for _ in range(6)]
    return lambda: iter(batches)


def test_trainer_fit_matches_jax(fit_batches, tmp_path):
    """tests/test_data_train_eval.py:177-192's setting (cnn on mag1c, lr
    3e-3, 2 epochs of 6 batches, validation at each epoch end), both
    packages from one JAX state: 12 steps, the same history keys, val_loss
    within 2 % of JAX's at each validation, a best checkpoint."""
    jm = FlaxSegmentationModel(["mag1c"], model_type="cnn", pos_weight=3.0)
    jstate, _ = jloop.create_train_state(jm, jax.random.PRNGKey(0),
                                         jnp.zeros((8, 1, 64, 64), jnp.float32), 3e-3)
    path = j_save_checkpoint(str(tmp_path), jstate, name="start")
    jt = jloop.Trainer(jm, learning_rate=3e-3, max_epochs=2, val_check_interval=1.0)
    jfinal = jt.fit(fit_batches, fit_batches, state=jstate)

    model = SegmentationModel(["mag1c"], model_type="cnn", pos_weight=3.0)
    state = load_checkpoint(path, tloop.create_train_state(model, 0, 3e-3, "cpu"))
    tt = tloop.Trainer(model, learning_rate=3e-3, max_epochs=2, val_check_interval=1.0,
                       device="cpu", checkpoint_dir=str(tmp_path / "run"))
    final = tt.fit(fit_batches, fit_batches, state=state)
    assert final.step == int(jfinal.step) == 12
    assert len(tt.history) == len(jt.history) == 2
    for got, want in zip(tt.history, jt.history):
        assert list(got) == list(want)
        assert got["val_loss"] == pytest.approx(want["val_loss"], rel=2e-2)
    assert tt.history[-1]["val_loss"] < tt.history[0]["val_loss"] * 1.5
    assert (tmp_path / "run" / "best.npz").exists()


# ---------------------------------------------------------------------------
# Setup shims, image logging, the train CLI
# ---------------------------------------------------------------------------


def test_setup_shims(chips, tmp_path):
    root, name = os.path.split(chips)
    cfg = Config().apply_overrides([f"dataset.root_folder={root}", f"dataset.train_csv={name}",
                                    f"dataset.test_csv={name}", "model.model_type=cnn",
                                    f"model.model_folder={tmp_path}"])
    dm = setup_shims.get_dataset(cfg)
    assert dm.train_rows == JDataModule(chips, chips).train_rows and dm.batch_size == 32
    model = setup_shims.get_model(cfg)
    assert (model.model_type, model.pos_weight, model.encoder_weights) == ("cnn", 15.0, "auto")
    state = tloop.create_train_state(model, 1, 1e-4, "cpu")
    save_checkpoint(str(tmp_path / "exp"), state, name="final_checkpoint_model")
    model2, sd = setup_shims.get_model(cfg, "exp")
    model2.network.load_state_dict(sd, strict=True)
    for a, b in zip(model.network.parameters(), model2.network.parameters()):
        assert torch.equal(a, b)
    # The regression model and the learned-ratio product build, as JAX's shims build them.
    from starcop_tpu_torch.data import features as tfeatures
    from starcop_tpu_torch.models.regression import RegressionModel

    regression = setup_shims.get_model(Config().apply_overrides(
        ["model.model_mode=regression_output", "model.model_type=cnn_regression"]))
    assert isinstance(regression, RegressionModel) and regression.loss_name == "BCEWithLogitsLoss"
    learned = cfg.apply_overrides(
        ['dataset.input_products=["ratio_lrn_bands2band8only_60ep_512_l1"]',
         f"dataset.learned_ratio_checkpoint={tmp_path / 'exp'}"])
    saved = dict(tfeatures._LEARNED_MODEL)
    try:
        dm = setup_shims.get_dataset(learned)
        assert dm.input_products == ["ratio_lrn_bands2band8only_60ep_512_l1"]
        assert tfeatures._LEARNED_MODEL["checkpoint"] == str(tmp_path / "exp")
    finally:
        tfeatures._LEARNED_MODEL.update(saved)


def _png_size(path):
    with open(path, "rb") as fh:
        head = fh.read(24)
    assert head[:8] == b"\x89PNG\r\n\x1a\n"
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


def test_image_logger_writes_jax_grid(chips, tmp_path):
    """ImageLogger's epoch grid: a PNG of JAX's size for the same batch and
    products (the plot registry is JAX's, entry for entry)."""
    assert tplot.PLOTTING_FUNCTIONS.keys() == jplot.PLOTTING_FUNCTIONS.keys()
    products = ["mag1c", *RGB]
    plots = ["rgb_aviris", "mag1c", "label", "pred", "differences", "loss_per_pixel"]
    batch = next(iter(DataModule(chips, chips, input_products=products).test_loader(
        batch_size=2)))
    model = SegmentationModel(products, model_type="cnn")
    state = tloop.create_train_state(model, 1, 1e-4, "cpu")
    tplot.ImageLogger(model, batch, products, plots, str(tmp_path / "port")).on_epoch_end(
        None, state, 3)
    path = save_checkpoint(str(tmp_path), state)
    with np.load(path) as data:
        params = {k[len("params/"):]: data[k] for k in data.files if k.startswith("params/")}

    class JState:  # what JAX's ImageLogger reads of a TrainState
        params = {n: {"kernel": params[f"{n}/kernel"], "bias": params[f"{n}/bias"]}
                  for n in ("conv0", "conv1", "conv2", "conv3", "head")}
        batch_stats = {}

    jm = FlaxSegmentationModel(products, model_type="cnn")
    jplot.ImageLogger(jm, batch, products, plots, str(tmp_path / "jax")).on_epoch_end(
        None, JState, 3)
    assert _png_size(tmp_path / "port" / "epoch_3.png") == \
        _png_size(tmp_path / "jax" / "epoch_3.png")


def _cli_args(chips, extra=()):
    root, name = os.path.split(chips)
    return [f"dataset.root_folder={root}", f"dataset.train_csv={name}",
            f"dataset.test_csv={name}", "model.model_type=cnn", "dataloader.batch_size=8",
            "dataloader.num_workers=0", "training.max_epochs=1", "training.accelerator=cpu",
            "plot_samples=2", *extra]


def test_train_cli_matches_jax(tmp_path, monkeypatch):
    """Both train CLIs on 2 tiles of 256^2 (cnn, batch 8: 18 windows, 2
    steps, validations at steps 0 and 1): the same experiment files, the
    same config but the accelerator, the same history, metrics and
    results keys and CSV columns."""
    from starcop_tpu.cli.train import main as jax_main
    from starcop_tpu_torch.cli.train import main as port_main

    monkeypatch.setenv("STARCOP_COMPILE_CACHE", "0")
    chips = write_synthetic_chip_dataset(str(tmp_path / "chips"), np.random.default_rng(4),
                                         n_tiles=2, size=256)
    exps = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        cache = chips.replace(".csv", "_tiled_128_64.csv")
        if os.path.exists(cache):
            os.remove(cache)
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert main(_cli_args(chips)) == 0
        (exp,) = glob.glob(str(tmp_path / name / "experiments" / "experiment" / "*"))
        exps[name] = exp
    files = {k: sorted(os.path.relpath(p, e) for p in glob.glob(f"{e}/**", recursive=True)
                       if os.path.isfile(p)) for k, e in exps.items()}
    assert files["port"] == files["jax"]
    assert {"best.npz", "final_checkpoint_model.npz", "history.json", "metrics.jsonl",
            "test/results.csv", "train/results.csv", "images/epoch_0.png"} <= set(files["port"])

    def load(name, rel):
        with open(os.path.join(exps[name], rel)) as fh:
            if rel.endswith(".json"):
                return json.load(fh)
            if rel.endswith(".jsonl"):
                return [json.loads(line) for line in fh]
            return list(csv.reader(fh))

    cj, cp = load("jax", "config.json"), load("port", "config.json")
    assert cp["training"].pop("accelerator") == "cpu" == cj["training"].pop("accelerator")
    assert cp == cj
    hj, hp = load("jax", "history.json"), load("port", "history.json")
    assert len(hp) == len(hj) == 2 and [list(h) for h in hp] == [list(h) for h in hj]
    mj, mp = load("jax", "metrics.jsonl"), load("port", "metrics.jsonl")
    assert [sorted(m) for m in mp] == [sorted(m) for m in mj]
    assert all(np.isfinite(m["train_loss"]) for m in mp if "train_loss" in m)
    for split in ("test", "train"):
        rj, rp = load("jax", f"{split}/results.csv"), load("port", f"{split}/results.csv")
        assert rp[0] == rj[0] and len(rp) == len(rj) == 3
        assert load("port", f"{split}/results_agg.json").keys() == \
            load("jax", f"{split}/results_agg.json").keys()
    with np.load(os.path.join(exps["port"], "final_checkpoint_model.npz")) as p, \
            np.load(os.path.join(exps["jax"], "final_checkpoint_model.npz")) as j:
        assert sorted(p.files) == sorted(j.files)
        assert all(p[k].shape == j[k].shape and p[k].dtype == j[k].dtype for k in j.files)


def test_train_cli_refusals(tmp_path, monkeypatch, chips):
    """What the port does not run raises before anything runs: a TPU
    config, no card without training.accelerator=cpu. The regression model
    trains and then stops where JAX's CLI stops, at the segmentation
    validation's missing ``pred_binary``. (``upload_path`` runs since the
    storage seam was ported: test_torch_resume.py.)"""
    from starcop_tpu_torch.cli.train import main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match="training.accelerator=gpu"):
        main(_cli_args(chips, ["training.accelerator=tpu"]))
    if not torch.cuda.is_available():
        no_card = [a for a in _cli_args(chips) if not a.startswith("training.accelerator")]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(no_card)
    assert not (tmp_path / "experiments").exists()
    with pytest.raises(KeyError, match="pred_binary"):
        main(_cli_args(chips, ["model.model_mode=regression_output"]))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _run_steps(state, n, seed):
    step = tloop.make_train_step(state.model)
    r = np.random.default_rng(seed)
    for _ in range(n):
        b = _torch(synthetic_chip_batch(r, batch_size=4, size=32, input_products=("mag1c",)))
        state, _ = step(state, b, 1e-3)
    return state


def test_checkpoint_round_trip_and_resume(tmp_path):
    """Save after 3 steps, run 3 more; a fresh state loaded from the file and
    run the same 3 steps ends bitwise where the uninterrupted run did."""
    model = SegmentationModel(["mag1c"], model_type="cnn")
    state = _run_steps(tloop.create_train_state(model, 4, 1e-3, "cpu"), 3, 0)
    path = save_checkpoint(str(tmp_path), state, extra={"config": {"a": 1}})
    assert (tmp_path / "checkpoint_meta.json").exists()
    a = _run_steps(state, 3, 1)
    fresh = tloop.create_train_state(SegmentationModel(["mag1c"], model_type="cnn"), 9, 1e-3,
                                     "cpu")
    b = _run_steps(load_checkpoint(path, fresh), 3, 1)
    assert a.step == b.step == 6
    for (n, p), q in zip(a.model.network.named_parameters(), b.model.network.parameters()):
        assert torch.equal(p, q), n
    with np.load(path) as data:
        del_key = "params/conv0/kernel"
        flat = {k: data[k] for k in data.files if k != del_key}
    np.savez(tmp_path / "broken.npz", **flat)
    with pytest.raises(KeyError, match=del_key):
        load_checkpoint(str(tmp_path / "broken.npz"), fresh)


@pytest.mark.parametrize("model_type", ["cnn", "unet_semseg"])
def test_port_checkpoint_read_by_jax(model_type, tmp_path):
    """A port checkpoint through JAX's load_pretrained_variables: logits
    within the weight-port bar; through the port's own loader: bitwise; and
    JAX's load_checkpoint resumes from it (step and Adam count)."""
    model = SegmentationModel(PRODUCTS, model_type=model_type, encoder_weights=None)
    state = tloop.create_train_state(model, 2, LR, "cpu")
    state = tloop.make_train_step(model)(state, _torch(_batch(3)), LR)[0]
    with torch.no_grad():  # spread the statistics, as a trained model's
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.8, 1.2)
    path = save_checkpoint(str(tmp_path), state, name="final_checkpoint_model")
    x = _batch(4)["input"]
    model.eval()
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    jm = FlaxSegmentationModel(PRODUCTS, model_type=model_type, encoder_weights=None)
    apply = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    got = np.asarray(apply(j_load_pretrained(str(tmp_path)), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    again = SegmentationModel(PRODUCTS, model_type=model_type).eval()
    again.network.load_state_dict(load_pretrained_state_dict(str(tmp_path)), strict=True)
    with torch.no_grad():
        assert torch.equal(again(torch.from_numpy(x)), torch.from_numpy(want))
    if model_type == "cnn":
        jstate, _ = jloop.create_train_state(jm, jax.random.PRNGKey(0),
                                             jnp.zeros((1, 4, 32, 32), jnp.float32))
        resumed = j_load_checkpoint(path, jstate)
        assert int(resumed.step) == 1 and int(resumed.opt_state.count) == 1


# ---------------------------------------------------------------------------
# Dropout: the intended deviation
# ---------------------------------------------------------------------------


def test_dropout_deviation(tmp_path):
    """unet_dropout: eval mode equal to JAX's (the logits bar); train-mode
    masks from a (seed, step) generator: a drop rate of 0.5 within 4 sigma,
    kept values doubled, the same mask for the same (seed, step) and
    another for the next step. JAX's masks (PRNGKey(0) folded with the
    step) cannot be reproduced, so they are not compared."""
    jm = FlaxSegmentationModel(PRODUCTS, model_type="unet_dropout", encoder_weights=None)
    jstate, _ = jloop.create_train_state(jm, jax.random.PRNGKey(0),
                                         jnp.zeros((2, 4, 64, 64), jnp.float32), LR)
    path = j_save_checkpoint(str(tmp_path), jstate)
    model = SegmentationModel(PRODUCTS, model_type="unet_dropout", encoder_weights=None)
    state = load_checkpoint(path, tloop.create_train_state(model, 0, LR, "cpu"))
    x = _batch(5)["input"]
    want = np.asarray(jm.apply({"params": jstate.params}, jnp.asarray(x), train=False))
    state.model.eval()
    with torch.no_grad():
        got = state.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)

    ones = torch.ones(200_000)
    gen = lambda step: tloop.dropout_generator(42, step, torch.device("cpu"))  # noqa: E731
    a, b, c = (layers.dropout(ones, 0.5, gen(s)) for s in (0, 0, 1))
    rate = float((a == 0).double().mean())
    assert abs(rate - 0.5) <= 4 * math.sqrt(0.25 / ones.numel()), rate
    assert set(torch.unique(a).tolist()) == {0.0, 2.0}
    assert torch.equal(a, b) and not torch.equal(a, c)
    state.model.train()
    with pytest.raises(ValueError, match="generator"):
        state.model(torch.from_numpy(x))
    state, loss = tloop.make_train_step(state.model, seed=42)(state, _torch(_batch(6)), LR)
    assert np.isfinite(float(loss))
