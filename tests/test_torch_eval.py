"""The port's evaluation path (starcop_tpu_torch.eval, models.baselines,
ops.morphology, the segmenter's loss and prediction protocol, the
normaliser's outputs, the evaluate and infer_emit CLIs) against the JAX
package on the CPU, on the same numpy-seeded inputs.

Bars: morphology and the baselines' masks bitwise; the validation
harness's confusion matrices exact on fixed predictions, its aggregates
within 1e-12; U-Net logits within rtol 1e-3 / atol 2e-4 (the weight-port
bar of tests/test_torch_port.py:37); the synthetic F1 within 2e-3 of JAX's
(f32 sums in another order move a thresholded quantity a little) and inside
the JAX test's bands. JAX's inputs are float32 (the test configuration
turns x64 on).
"""

import csv
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.data.normalizer import DataNormalizer as JDataNormalizer  # noqa: E402
from starcop_tpu.data.synthetic import write_synthetic_chip_dataset as j_write_chips  # noqa: E402
from starcop_tpu.eval import metrics as jmetrics  # noqa: E402
from starcop_tpu.eval import validation as jval  # noqa: E402
from starcop_tpu.models import SegmentationModel as FlaxSegmentationModel  # noqa: E402
from starcop_tpu.models import baselines as jbl  # noqa: E402
from starcop_tpu.models import segmenter as jseg  # noqa: E402
from starcop_tpu.ops import morphology as jmorph  # noqa: E402
from starcop_tpu_torch import eval as teval  # noqa: E402
from starcop_tpu_torch.data.normalizer import DataNormalizer  # noqa: E402
from starcop_tpu_torch.eval import metrics as tmetrics  # noqa: E402
from starcop_tpu_torch.eval import validation as tval  # noqa: E402
from starcop_tpu_torch.models import baselines as tbl  # noqa: E402
from starcop_tpu_torch.models import segmenter as tseg  # noqa: E402
from starcop_tpu_torch.models.weights import flax_to_torch_state_dict  # noqa: E402
from starcop_tpu_torch.ops import morphology as tmorph  # noqa: E402

PRODUCTS = list(tseg.EMIT_INPUT_PRODUCTS)
RATIOS = ["ratio_wv3_B8_B8MLR_SanchezGarcia22_sum_c_out", "ratio_wv3_B7_B5_varon21_sum_c_out"]


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# Morphology: bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("density", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("border_value", [0, 1])
def test_morphology_bitwise(density, border_value):
    x = np.random.default_rng(int(density * 10)).random((37, 41)) < density
    cases = [
        (jmorph.dilation(jnp.asarray(x)), tmorph.dilation(_t(x))),
        (jmorph.erosion(jnp.asarray(x), border_value=border_value),
         tmorph.erosion(_t(x), border_value=border_value)),
        (jmorph.binary_opening(jnp.asarray(x), border_value=border_value),
         tmorph.binary_opening(_t(x), border_value=border_value)),
    ]
    for want, got in cases:
        assert got.dtype == torch.bool and got.shape == x.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kernel", [np.ones((3, 3), np.float32), np.ones((2, 4), np.float32),
                                    np.array([[1, 0, 1, 0, 1]], np.float32)])
def test_morphology_custom_kernel_and_batch(kernel):
    x = np.random.default_rng(3).random((2, 3, 29, 33)) < 0.6
    for border_value in (0, 1):
        want = jmorph.binary_opening(jnp.asarray(x), jnp.asarray(kernel), border_value)
        got = tmorph.binary_opening(_t(x), kernel, border_value)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tmorph.dilation(_t(x), kernel).numpy(),
                                  np.asarray(jmorph.dilation(jnp.asarray(x), kernel)))


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def _cms():
    rng = np.random.default_rng(7)
    cms = [rng.integers(0, 5000, (2, 2)) for _ in range(6)]
    cms += [np.array([[10, 0], [0, 0]]), np.array([[0, 0], [5, 3]]), np.array([[0, 4], [0, 0]]),
            np.zeros((2, 2), np.int64), np.array([[7, 2], [0, 0]])]
    return cms


def test_metrics_match_jax():
    funcs = ["precision", "recall", "user_accuracy", "producer_accuracy", "TPR", "f1score",
             "FPR", "iou", "accuracy", "cohen_kappa", "balanced_accuracy", "TP", "TN", "FP", "FN"]
    assert [f.__name__ for f in tmetrics.METRICS_CONFUSION_MATRIX] == [
        f.__name__ for f in jmetrics.METRICS_CONFUSION_MATRIX]
    for cm in _cms():
        for name in funcs:
            want = float(getattr(jmetrics, name)(cm))
            for arg in (cm, torch.from_numpy(cm)):
                got = getattr(tmetrics, name)(arg)
                assert isinstance(got, float), name
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-12, equal_nan=True,
                                           err_msg=f"{name} {cm.tolist()}")
    assert set(teval.__dict__) >= {"confusion_matrix", "METRICS_CONFUSION_MATRIX", "TPR", "FN"}


def test_confusion_matrices_match_jax():
    rng = np.random.default_rng(8)
    pred = (rng.random((3, 1, 20, 24)) > 0.6).astype(np.int32)
    target = (rng.random((3, 1, 20, 24)) > 0.7).astype(np.float32)
    valid = rng.random((3, 1, 20, 24)) > 0.2
    got = tmetrics.confusion_matrix(_t(pred), _t(target))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jmetrics.confusion_matrix(pred, target)))
    np.testing.assert_array_equal(
        tmetrics.masked_confusion_matrix(_t(pred), _t(target), _t(valid)).numpy(),
        np.asarray(jmetrics.masked_confusion_matrix(pred, target, valid)))


# ---------------------------------------------------------------------------
# The normaliser's outputs, the segmenter's functions and loss
# ---------------------------------------------------------------------------


def test_normalizer_outputs_match_jax():
    rng = np.random.default_rng(9)
    x = rng.uniform(-100, 4000, (2, 4, 8, 8)).astype(np.float32)
    y = rng.uniform(-1, 4000, (2, 1, 8, 8)).astype(np.float32)
    for outputs in (("labelbinary",), ("mag1c",)):
        jn, tn = JDataNormalizer(PRODUCTS, outputs), DataNormalizer(PRODUCTS, outputs)
        assert list(tn.state_dict()) == []
        np.testing.assert_array_equal(tn.normalize_y(_t(y)).numpy(), np.asarray(jn.normalize_y(y)))
        np.testing.assert_array_equal(tn.denormalize_y(_t(y)).numpy(),
                                      np.asarray(jn.denormalize_y(y)))
        np.testing.assert_array_equal(tn.denormalize_x(_t(x)).numpy(),
                                      np.asarray(jn.denormalize_x(x)))
        np.testing.assert_array_equal(tn.normalize_x(_t(x)).numpy(), np.asarray(jn.normalize_x(x)))
    assert DataNormalizer(PRODUCTS).normalize_y(_t(y)) is not None
    with pytest.raises(ValueError, match="normalization"):
        DataNormalizer(PRODUCTS, ("mag1c", "labelbinary"))


def test_segmenter_functions_match_jax():
    rng = np.random.default_rng(10)
    # 10 * 64 * 64 / 64^2 = 10 pixels: tiles at 10 (no plume), 11 and 0.
    pb = np.zeros((3, 1, 64, 64), np.int32)
    pb[0].flat[rng.choice(64 * 64, 10, replace=False)] = 1
    pb[1].flat[rng.choice(64 * 64, 11, replace=False)] = 1
    gt = (rng.random((3, 1, 64, 64)) > 0.5).astype(np.float32)
    got = tseg.pred_classification(_t(pb))
    assert got.dtype == torch.int32 and got.numpy().ravel().tolist() == [0, 1, 0]
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jseg.pred_classification(jnp.asarray(pb))))
    np.testing.assert_array_equal(tseg.differences(_t(pb), _t(gt)).numpy(),
                                  np.asarray(jseg.differences(jnp.asarray(pb), jnp.asarray(gt))))
    z = rng.normal(0, 8, (2, 1, 16, 16)).astype(np.float32)
    for pw in (1.0, 3.5):
        np.testing.assert_allclose(
            tseg.weighted_bce_with_logits(_t(z), _t(gt[:2, :, :16, :16]), pw).numpy(),
            np.asarray(jseg.weighted_bce_with_logits(jnp.asarray(z),
                                                     jnp.asarray(gt[:2, :, :16, :16]), pw)),
            rtol=0, atol=1e-6)


@pytest.mark.parametrize("loss_name", ["BCEWithLogitsLoss", "l1", "mse"])
@pytest.mark.parametrize("use_weight_loss", [True, False])
def test_loss_fn_matches_jax(loss_name, use_weight_loss):
    """SegmentationModel.loss_fn against the JAX model's on the same logits
    (the JAX model built without its network's init)."""
    rng = np.random.default_rng(11)
    z = rng.normal(0, 4, (2, 1, 16, 16)).astype(np.float32)
    y = (rng.random((2, 1, 16, 16)) > 0.6).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (2, 1, 16, 16)).astype(np.float32)
    kw = dict(pos_weight=2.5, use_weight_loss=use_weight_loss, loss_name=loss_name)
    jm = FlaxSegmentationModel(PRODUCTS, model_type="unet_semseg", encoder_weights=None, **kw)
    tm = tseg.SegmentationModel(PRODUCTS, **kw)
    for weight in (w, None):
        want = float(jm.loss_fn(jnp.asarray(z), jnp.asarray(y),
                                None if weight is None else jnp.asarray(weight)))
        got = tm.loss_fn(_t(z), _t(y), None if weight is None else _t(weight))
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-7)


def test_other_model_types_are_refused():
    """Every segmentation model_type of the JAX package builds (the other
    networks, ROADMAP queue 1 item 9, are ported); a name outside its table
    is refused, as JAX refuses it."""
    for model_type in jseg.ARCHITECTURES:
        assert tseg.SegmentationModel(PRODUCTS, model_type=model_type).model_type == model_type
    for model_type in ("unet_plus", "regression"):
        with pytest.raises(ValueError, match="No model implemented"):
            tseg.SegmentationModel(PRODUCTS, model_type=model_type)
        with pytest.raises(ValueError, match="No model implemented"):
            jseg.configure_architecture(model_type, 1)


# ---------------------------------------------------------------------------
# batch_with_preds: the U-Net at full width, the baselines
# ---------------------------------------------------------------------------


def flax_variables(seed: int):
    """Flax variables of the U-Net's shapes (jax.eval_shape, no init
    compile) filled from numpy: Kaiming-normal (fan-out) kernels, so the
    logits spread, and randomised batch-norm statistics."""
    jmodel = FlaxSegmentationModel(PRODUCTS, model_type="unet_semseg", encoder_weights=None)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 4, 32, 32), jnp.float32)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":  # (kh, kw, in, out)
            fan_out = int(np.prod(leaf.shape[:2])) * leaf.shape[-1]
            v = rng.normal(size=leaf.shape) * np.sqrt(2.0 / fan_out)
        elif name in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, leaf.shape)
        else:  # bias, mean
            v = rng.normal(0, 0.05, leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(seed, b=2, size=64):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0, 3000, (b, size, size)), rng.uniform(0, 90, (b, size, size)),
                  rng.uniform(0, 90, (b, size, size)), rng.uniform(0, 90, (b, size, size))],
                 1).astype(np.float32)
    y = (rng.random((b, 1, size, size)) > 0.8).astype(np.float32)
    return {"input": x, "output": y,
            "weight_loss": rng.uniform(0.1, 1, (b, 1, size, size)).astype(np.float32),
            "id": [f"t{i}" for i in range(b)]}


def test_batch_with_preds_matches_jax():
    variables = flax_variables(0)
    jm = FlaxSegmentationModel(PRODUCTS, model_type="unet_semseg", encoder_weights=None,
                               pos_weight=2.0)
    tm = tseg.SegmentationModel(PRODUCTS, pos_weight=2.0).eval()
    tm.network.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    batch = _batch(12)
    want = jm.batch_with_preds(variables, batch)
    with torch.inference_mode():
        got = tm.batch_with_preds(batch)
    assert set(got) == set(want)
    assert got["id"] == batch["id"]
    for key in ("input_norm", "output_norm", "differences", "pred_classification",
                "pred_binary"):
        assert got[key].shape == np.shape(want[key]), key
    # XLA may divide by the factors as a product with their reciprocals: 1 ulp.
    np.testing.assert_allclose(got["input_norm"].numpy(), np.asarray(want["input_norm"]),
                               rtol=2.5e-7, atol=0)
    logits, want_logits = got["logits"].numpy(), np.asarray(want["logits"])
    assert logits.dtype == np.float32 and logits.std() > 1.0
    np.testing.assert_allclose(logits, want_logits, rtol=1e-3, atol=2e-4)
    sure = np.abs(want_logits) >= 1e-3
    np.testing.assert_array_equal(got["pred_binary"].numpy()[sure],
                                  np.asarray(want["pred_binary"])[sure])
    for key in ("prediction", "loss_per_pixel", "loss_per_pixel_weighted"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-3, atol=2e-4)
    # bf16-resident weights: the same protocol, logits f32, the mask close
    # to f32's (tests/test_models.py:255's bar).
    tseg.cast_for_inference(tm)
    with torch.inference_mode():
        got_bf16 = tm.batch_with_preds(batch)
    assert got_bf16["logits"].dtype == torch.float32
    p32, p16 = got["prediction"].numpy().ravel(), got_bf16["prediction"].numpy().ravel()
    assert np.corrcoef(p32, p16)[0, 1] > 0.999


def _ratio_batch(seed):
    rng = np.random.default_rng(seed)
    b, h, w = 3, 48, 40
    mag1c = np.zeros((b, h, w), np.float32)
    mag1c[:, 10:30, 8:28] = rng.uniform(300, 2000, (b, 20, 20))
    mag1c += rng.uniform(0, 700, (b, h, w)).astype(np.float32) * (rng.random((b, h, w)) > 0.7)
    ratios = rng.normal(0.03, 0.05, (b, 2, h, w)).astype(np.float32)
    x = np.concatenate([mag1c[:, None], rng.uniform(0, 90, (b, 3, h, w)).astype(np.float32),
                        ratios], 1)
    y = (mag1c[:, None] > 600).astype(np.float32)
    return {"input": x, "output": y, "id": [f"r{i}" for i in range(b)]}


@pytest.mark.parametrize("name", ["Mag1cBaseline", "SanchezBaseline", "VaronBaseline"])
def test_baselines_match_jax(name):
    products = PRODUCTS + RATIOS
    jb, tb = getattr(jbl, name)(products), getattr(tbl, name)(products)
    batch = _ratio_batch(13)
    want = jb.batch_with_preds(batch)
    got = tb.batch_with_preds(batch)
    assert set(got) == set(want)
    assert int(np.asarray(want["pred_binary"]).sum()) > 0
    for key in ("pred_binary", "differences", "pred_classification"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    np.testing.assert_array_equal(got["prediction"].numpy(), np.asarray(want["prediction"]))
    for thr in (0.0, 0.05, 450.0):
        np.testing.assert_array_equal(
            tb.apply_threshold(got["prediction"], thr).numpy(),
            np.asarray(jb.apply_threshold(np.asarray(want["prediction"]), thr)))


# ---------------------------------------------------------------------------
# run_validation
# ---------------------------------------------------------------------------


class _Fixed:
    """A model with fixed predictions (tests/test_data_train_eval.py's
    FakeModel), for either package: pred_binary = prediction > 0.5 and the
    given nodata mask."""

    def __init__(self, prediction, nodata, pred_classification, as_array):
        self.prediction, self.nodata = prediction, nodata
        self.pred_classification, self.as_array = pred_classification, as_array
        self.calls = 0

    def batch_with_preds(self, batch):
        i = self.calls
        self.calls += 1
        out = dict(batch)
        out["output_norm"] = self.as_array(batch["output"])
        out["prediction"] = self.as_array(self.prediction[i])
        out["pred_binary"] = self.as_array((self.prediction[i] > 0.5).astype(np.int32))
        out["pred_classification"] = self.pred_classification(out["pred_binary"])
        out["nodata_mask"] = self.as_array(self.nodata[i])
        return out


def _validation_batches(seed):
    rng = np.random.default_rng(seed)
    b, h, w = 3, 48, 48
    labels = [np.zeros((b, 1, h, w), np.float32) for _ in range(2)]
    labels[0][0, 0, :40, :40] = 1  # 1600 px: easy
    labels[0][1, 0, 5:15, 5:20] = 1  # 150 px: hard
    labels[1][0, 0] = rng.random((h, w)) > 0.6  # easy
    labels[1][2, 0, 20:30, :] = 1  # hard
    prediction = [np.clip(y * 0.7 + rng.uniform(0, 0.6, y.shape), 0, 1).astype(np.float32)
                  for y in labels]
    nodata = [(rng.random(y.shape) > 0.9).astype(np.int32) for y in labels]
    batches = [{"input": y, "output": y, "id": [f"v{k}{i}" for i in range(b)]}
               for k, y in enumerate(labels)]
    return batches, prediction, nodata


@pytest.mark.parametrize("mask_from_magic", [False, True])
def test_run_validation_matches_jax_fixed_predictions(mask_from_magic, tmp_path):
    batches, prediction, nodata = _validation_batches(14)
    jmodel = _Fixed(prediction, nodata,
                    lambda pb: np.asarray(jseg.pred_classification(jnp.asarray(pb))), np.asarray)
    tmodel = _Fixed(prediction, nodata, tseg.pred_classification, torch.from_numpy)
    jrows, jagg = jval.run_validation(jmodel.batch_with_preds, iter(batches),
                                      mask_from_magic=mask_from_magic,
                                      path_save_results=str(tmp_path / "jax"))
    trows, tagg = tval.run_validation(tmodel.batch_with_preds, iter(batches),
                                      mask_from_magic=mask_from_magic,
                                      path_save_results=str(tmp_path / "port"))
    _assert_same_validation(jrows, jagg, trows, tagg, tmp_path)
    assert {r["difficulty"] for r in trows} == {"easy", "hard"}
    assert "FPR_no_plume" in tagg and "f1score_hard" in tagg
    # The sweep's matrices, restated in numpy.
    for entry in tagg["thresholded"]:
        want = np.zeros((2, 2), np.int64)
        for y, p, nd in zip((b["output"] for b in batches), prediction, nodata):
            v = (nd == 0) if mask_from_magic else np.ones(y.shape, bool)
            pb, t = p > np.float32(entry["threshold"]), y == 1
            want += [[np.sum(v & ~pb & ~t), np.sum(v & pb & ~t)],
                     [np.sum(v & ~pb & t), np.sum(v & pb & t)]]
        assert entry["confusion_matrix"] == want.tolist()


def _assert_same_validation(jrows, jagg, trows, tagg, tmp_path=None):
    assert len(trows) == len(jrows)
    for tr, jr in zip(trows, jrows):
        assert list(tr) == list(jr)
        for k, v in jr.items():
            if isinstance(v, float):
                np.testing.assert_allclose(tr[k], v, rtol=0, atol=1e-12, equal_nan=True, err_msg=k)
            else:
                assert tr[k] == v, k
    assert list(tagg) == list(jagg)
    _assert_close_tree(tagg, jagg)
    if tmp_path is not None:
        with open(tmp_path / "jax" / "results.csv") as fj, \
                open(tmp_path / "port" / "results.csv") as ft:
            assert list(csv.reader(ft)) == list(csv.reader(fj))
        _assert_close_tree(json.loads((tmp_path / "port" / "results_agg.json").read_text()),
                           json.loads((tmp_path / "jax" / "results_agg.json").read_text()))


def _assert_close_tree(got, want, path="", atol=1e-12):
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _assert_close_tree(got[k], want[k], f"{path}/{k}", atol)
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close_tree(g, w, f"{path}[{i}]", atol)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, equal_nan=True, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("mask_from_magic", [False, True])
def test_run_validation_matches_jax_baseline(mask_from_magic, tmp_path):
    """Mag1cBaseline through both harnesses: its morphology-aware
    apply_threshold sweeps the mag1c thresholds."""
    products = PRODUCTS + RATIOS
    jb, tb = jbl.Mag1cBaseline(products), tbl.Mag1cBaseline(products)
    batches = [_ratio_batch(15 + k) for k in range(2)]
    rng = np.random.default_rng(17)
    for b in batches:
        b["nodata_mask"] = (rng.random(b["output"].shape) > 0.85).astype(np.int32)
    thresholds = [100.0, 300.0, 500.0, 750.0]
    jrows, jagg = jval.run_validation(jb.batch_with_preds, iter(batches), thresholds=thresholds,
                                      apply_threshold=jb.apply_threshold,
                                      mask_from_magic=mask_from_magic,
                                      path_save_results=str(tmp_path / "jax"))
    trows, tagg = tval.run_validation(tb.batch_with_preds, iter(batches), thresholds=thresholds,
                                      apply_threshold=tb.apply_threshold,
                                      mask_from_magic=mask_from_magic,
                                      path_save_results=str(tmp_path / "port"))
    _assert_same_validation(jrows, jagg, trows, tagg, tmp_path)
    assert sum(r["TP"] for r in trows) > 0


def test_batch_eval_stats_loop_matches_jax():
    rng = np.random.default_rng(18)
    pr = rng.uniform(0, 1, (4, 1, 16, 16)).astype(np.float32)
    y = (rng.random(pr.shape) > 0.7).astype(np.float32)
    valid = rng.random(pr.shape) > 0.1
    pb = (pr > 0.5).astype(np.int32)
    thr = tval.DEFAULT_THRESHOLDS
    assert thr == jval.DEFAULT_THRESHOLDS
    for v_np, v in ((valid, _t(valid)), (np.ones(pr.shape, bool), None)):
        want = jval._batch_eval_stats(jnp.asarray(pb), jnp.asarray(pr), jnp.asarray(y),
                                      jnp.asarray(v_np), jnp.asarray(thr, jnp.float32))
        got = tval._batch_eval_stats(_t(pb), _t(pr), _t(y), v, thr)
        for g, w in zip(got, want):
            assert g.dtype == torch.int64
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# The synthetic F1 probe
# ---------------------------------------------------------------------------


def test_synthetic_detection_f1_matches_jax():
    from starcop_tpu.eval.synthetic_eval import synthetic_detection_f1 as jax_f1
    from starcop_tpu_torch.eval.synthetic_eval import MAG1C_THRESHOLDS, synthetic_detection_f1

    got = synthetic_detection_f1(n_tiles=2, height=256, width=216, device="cpu")
    want = jax_f1(n_tiles=2, height=256, width=216)
    assert list(MAG1C_THRESHOLDS) == [100.0, 200.0, 300.0, 400.0, 500.0, 750.0, 1000.0, 1500.0]
    assert set(got) == set(want) == {"synthetic_f1", "synthetic_f1_at_500"}
    for k in want:
        assert abs(got[k] - want[k]) <= 2e-3, (got, want)
    assert 0.955 <= got["synthetic_f1"] <= 0.985, got
    assert 0.94 <= got["synthetic_f1_at_500"] <= 0.975, got
    assert got["synthetic_f1"] >= got["synthetic_f1_at_500"] - 1e-9


def test_f1_probe_refuses_a_vacuous_set():
    from starcop_tpu_torch.eval.synthetic_eval import f1_by_threshold

    entry = {"threshold": 500.0, "confusion_matrix": [[10, 2], [0, 0]],
             "precision": 0.0, "recall": float("nan")}
    with pytest.raises(RuntimeError, match="vacuous"):
        f1_by_threshold({"thresholded": [entry]})


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------


def _save_npz(path, variables):
    """The JAX package's checkpoint layout: flat "params/..." and
    "batch_stats/..." keys, plus a step a loader must skip."""
    flat = {"step": np.asarray(3)}
    for keys, leaf in jax.tree_util.tree_leaves_with_path(variables):
        flat["/".join(k.key for k in keys)] = np.asarray(leaf)
    np.savez(path, **flat)


def test_evaluate_cli_matches_jax(tmp_path, capsys, monkeypatch):
    """Both evaluate CLIs on one 4-tile, 128-pixel dataset: the mag1c
    baseline (the same results_agg.json, exact), and an .npz checkpoint at
    f32 (the same keys; the two U-Nets' sums in another order may flip a
    pixel at a threshold, so counts within 1e-4 of the pixels and rates
    within 1e-3)."""
    from starcop_tpu.cli.evaluate import main as jax_main
    from starcop_tpu_torch.cli.evaluate import main as port_main

    monkeypatch.setenv("STARCOP_COMPILE_CACHE", "0")
    index = j_write_chips(str(tmp_path / "chips"), np.random.default_rng(3), n_tiles=4, size=128)
    _save_npz(tmp_path / "best.npz", flax_variables(4))
    runs = {"baseline": ["--baseline", "mag1c"],
            "checkpoint": ["--checkpoint", str(tmp_path / "best.npz"), "--model-dtype", "f32"]}
    for name, extra in runs.items():
        agg, lines = {}, {}
        for pkg, main, dev in (("jax", jax_main, []), ("port", port_main, ["--device", "cpu"])):
            out = tmp_path / f"{name}_{pkg}"
            assert main(["--test-csv", index, "--output", str(out), *extra, *dev]) == 0
            lines[pkg] = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            agg[pkg] = json.loads((out / "results_agg.json").read_text())
            assert (out / "results.csv").exists()
        assert list(lines["port"]) == list(lines["jax"])
        if name == "baseline":
            _assert_close_tree(agg["port"], agg["jax"])
            assert lines["port"] == pytest.approx(lines["jax"], abs=1e-12, nan_ok=True)
        else:
            _assert_close_tree(agg["port"], agg["jax"], atol=1e-3)
            for got, want in zip(agg["port"]["thresholded"], agg["jax"]["thresholded"]):
                diff = np.abs(np.subtract(got["confusion_matrix"], want["confusion_matrix"]))
                assert diff.max() <= 1e-4 * 4 * 128 * 128, got["threshold"]


def test_infer_emit_cli_matches_jax(tmp_path, capsys, monkeypatch):
    """Both infer_emit CLIs on one small EMIT-like h5 granule (fill-marked
    pixels, a GLT) with the same .npz checkpoint at f32: the same GeoTIFFs,
    mag1c at detection parity, the masks correlated > 0.9999; and the
    port's default bf16-resident U-Net runs too."""
    pytest.importorskip("h5py")
    from starcop_tpu.cli.infer_emit import main as jax_main
    from starcop_tpu_torch.cli.infer_emit import main as port_main
    from starcop_tpu_torch.data.geotiff import read_geotiff
    from tests.test_torch_serve import FILL, _granule

    monkeypatch.setenv("STARCOP_COMPILE_CACHE", "0")
    rng = np.random.default_rng(19)
    glt = (rng.integers(0, 45, (70, 50)), rng.integers(0, 65, (70, 50)))
    path, _ = _granule(tmp_path, "EMIT_cli", 19, glt=glt)
    _save_npz(tmp_path / "best.npz", flax_variables(5))
    common = [path, "--checkpoint", str(tmp_path / "best.npz"), "--column-step", "16",
              "--num-iter", "5", "--georeference"]
    outs = {}
    for pkg, main, extra in (("jax", jax_main, ["--model-dtype", "f32"]),
                             ("port", port_main, ["--model-dtype", "f32", "--device", "cpu"]),
                             ("port_bf16", port_main, ["--device", "cpu"])):
        out = tmp_path / pkg
        assert main([*common, "--output", str(out), *extra]) == 0
        line = capsys.readouterr().out.strip().splitlines()[-1]
        assert line.startswith("EMIT inference EMIT_cli.nc: ") and "pred mean" in line
        outs[pkg] = {f[:-4]: read_geotiff(str(out / f)) for f in sorted(os.listdir(out))}
    assert set(outs["port"]) == set(outs["jax"]) == set(outs["port_bf16"]) == {
        "mag1c", "albedo", "rgb", "prediction", "mag1c_geo", "prediction_geo"}
    for name, (arr, meta) in outs["port"].items():
        want, want_meta = outs["jax"][name]
        assert arr.shape == want.shape and meta.descriptions == want_meta.descriptions, name
        assert meta.transform == want_meta.transform and meta.crs_epsg == want_meta.crs_epsg
    mf, mf_j = outs["port"]["mag1c"][0][0], outs["jax"]["mag1c"][0][0]
    np.testing.assert_array_equal(mf == FILL, mf_j == FILL)
    keep = mf_j != FILL
    assert (mf_j[keep] > 500).sum() > 0
    assert ((mf[keep] > 500) == (mf_j[keep] > 500)).mean() >= 0.999
    np.testing.assert_array_equal(outs["port"]["rgb"][0], outs["jax"]["rgb"][0])
    for pkg, bar in (("port", 0.9999), ("port_bf16", 0.999)):
        p, p_j = outs[pkg]["prediction"][0].ravel(), outs["jax"]["prediction"][0].ravel()
        assert np.corrcoef(p, p_j)[0, 1] > bar, pkg


def test_entry_points_need_a_card_or_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be shown")
    from starcop_tpu_torch.cli.evaluate import main as evaluate_main
    from starcop_tpu_torch.cli.infer_emit import main as infer_main
    from starcop_tpu_torch.data.datamodule import prefetch_to_device
    from starcop_tpu_torch.data.synthetic import write_synthetic_chip_dataset
    from starcop_tpu_torch.eval.synthetic_eval import synthetic_detection_f1

    calls = [
        lambda: synthetic_detection_f1(n_tiles=1, height=32, width=32),
        lambda: write_synthetic_chip_dataset(str(tmp_path / "d"), np.random.default_rng(0),
                                             n_tiles=1, size=32, run_matched_filter=True),
        lambda: prefetch_to_device(iter([])),
        lambda: evaluate_main(["--test-csv", "x.csv", "--output", str(tmp_path),
                               "--baseline", "mag1c"]),
        lambda: infer_main(["g.nc", "--checkpoint", "c.npz", "--output", str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
