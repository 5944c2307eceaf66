"""The port's multispectral products and the other models against the JAX
package: ops/ratios.py, data/features.py (registry, extract_features, the
learned ratio), models/regression.py, models/cloud.py, and the setup shims
that now build them.

Inputs are made with numpy seeds and go through both packages on the CPU in
float32. A ratio is held against JAX's float64 result: the port's f32 error
at most 4x JAX's own f32 error plus 1e-6 of the product's range (the
z-scored ``simple_plus`` divides the f32 rounding of the reconstruction by
a small spread, so its f32 results part by ~1e-4), and so are the files
``extract_features`` writes. The network logits
bar is the U-Net's, rtol 1e-3 / atol 2e-4 (tests/test_torch_port.py:37).
Flax variables are filled from ``jax.eval_shape`` and carried through
``models.weights``.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.data import features as jfeat  # noqa: E402
from starcop_tpu.models.cloud import CloudDetector as JCloud  # noqa: E402
from starcop_tpu.models.regression import RegressionModel as JRegression  # noqa: E402
from starcop_tpu.ops import ratios as jr  # noqa: E402
from starcop_tpu_torch import setup_shims  # noqa: E402
from starcop_tpu_torch.config import Config  # noqa: E402
from starcop_tpu_torch.data import features as tfeat  # noqa: E402
from starcop_tpu_torch.models.cloud import CloudDetector  # noqa: E402
from starcop_tpu_torch.models.regression import RegressionModel  # noqa: E402
from starcop_tpu_torch.models.weights import flax_to_torch_state_dict  # noqa: E402
from starcop_tpu_torch.ops import ratios as tr  # noqa: E402

LOGIT_TOL = dict(rtol=1e-3, atol=2e-4)
MODES = ("simple", "simple_plus", "residual", "c_matched_outliers")


def _wv3(seed=0, h=48, w=40):
    """Eight correlated SWIR bands of a WV3-like tile, some no-data zeros."""
    rng = np.random.default_rng(seed)
    albedo = rng.uniform(0.1, 0.5, (h, w))
    bands = [albedo * rng.uniform(0.8, 1.2) + rng.normal(0, 0.01, (h, w)) for _ in range(8)]
    bands = np.stack(bands).astype(np.float32)
    bands[:, :3, :5] = 0.0
    return bands


def _both(a):
    return torch.from_numpy(np.ascontiguousarray(a)), jnp.asarray(a)


def _held(fn_t, fn_j, *arrays, **kw):
    """fn_t on torch f32 tensors against fn_j on JAX f32 and f64 arrays: the
    port's error against JAX's f64 result at most 4x JAX's f32 error + 1e-6
    of its range. Returns the port's result."""
    def cast(a, dt):
        return [cast(x, dt) for x in a] if isinstance(a, list) else jnp.asarray(a, dt)

    tt = [[torch.from_numpy(np.ascontiguousarray(x)) for x in a] if isinstance(a, list)
          else torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    got = fn_t(*tt, **kw).numpy().astype(np.float64)
    want32 = np.asarray(fn_j(*[cast(a, jnp.float32) for a in arrays], **kw), np.float64)
    want64 = np.asarray(fn_j(*[cast(a, jnp.float64) for a in arrays], **kw))
    e_port, e_jax = np.abs(got - want64).max(), np.abs(want32 - want64).max()
    assert e_port <= 4 * e_jax + 1e-6 * np.abs(want64).max(), (e_port, e_jax)
    return got


def test_percentiles_and_inlier_sum():
    """The sort-based linear percentile equals jnp.percentile and
    torch.quantile; the inlier sums agree."""
    x = np.random.default_rng(1).normal(size=1001).astype(np.float32)
    srt = torch.sort(torch.from_numpy(x)).values
    for q in (0.0, 5.0, 37.3, 95.0, 100.0):
        got = float(tr._percentiles(srt, (q,))[0])
        assert got == pytest.approx(float(jnp.percentile(jnp.asarray(x), q)), rel=1e-6)
        assert got == pytest.approx(float(torch.quantile(torch.from_numpy(x), q / 100)), rel=1e-6)
    t, j = _both(x)
    assert float(tr._inlier_sum(t, 5.0)) == pytest.approx(float(jr._inlier_sum(j, 5.0)), rel=1e-5)


def test_two_band_ratio():
    b = _wv3()
    for p, zero in ((5.0, -0.6), (10.0, -0.5)):
        got = _held(tr.ratio_2c_match_c_from_sums_outlier, jr.ratio_2c_match_c_from_sums_outlier,
                    b[6], b[4], p=p, zero_value_out=zero)
        assert (got[:3, :5] == np.float32(zero)).all()


@pytest.mark.parametrize("deficient", [False, True])
@pytest.mark.parametrize("autoclip", [False, True])
@pytest.mark.parametrize("division", MODES)
def test_ratio_mlr_local(division, autoclip, deficient):
    """Every division mode, with autoclip, and with a rank-deficient
    regressor set (a constant band and a duplicated band)."""
    b = _wv3(2)
    bg = [b[0], b[1], b[3], b[4], b[5]]
    if deficient:
        bg = [b[0], b[0].copy(), np.full_like(b[1], 0.3), b[4], b[5]]
    got = _held(tr.ratio_mlr_local, jr.ratio_mlr_local, bg, b[7], division=division,
                autoclip=autoclip)
    assert np.isfinite(got).all()
    if autoclip:
        assert np.abs(got).max() <= 0.2 + 1e-7
    with pytest.raises(ValueError):
        tr.ratio_mlr_local([torch.from_numpy(x) for x in bg], torch.from_numpy(b[7]),
                           division="nope")


@pytest.mark.parametrize("deficient", [False, True])
def test_lr_bands(deficient):
    b = _wv3(3)
    regs = [b[0], b[1], b[2]] if not deficient else [b[0], b[0].copy(), np.ones_like(b[1])]
    assert np.isfinite(_held(tr.lr_bands, jr.lr_bands, regs, b[6])).all()


def test_features_registry_equal():
    assert list(tfeat.FEATURES) == list(jfeat.FEATURES) and len(tfeat.FEATURES) == 16
    for name, spec in jfeat.FEATURES.items():
        assert tfeat.FEATURES[name]["inputs"] == spec["inputs"], name
    assert tfeat.raw_bands_available() == jfeat.raw_bands_available()
    assert tfeat.LEARNED_RATIO_EXPERIMENT == jfeat.LEARNED_RATIO_EXPERIMENT


def _fill(shapes, seed):
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":  # (kh, kw, in, out)
            v = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:3]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, leaf.shape)
        else:
            v = rng.normal(0, 0.05, leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _regressor_variables(seed=0):
    jmodel = JRegression(tfeat.LEARNED_RATIO_INPUTS, ["TOA_WV3_SWIR8"],
                         inhibit_normalisation=True)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 6, 8, 8), jnp.float32)))
    return jmodel, _fill(shapes, seed)


def _save_npz(path, variables):
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(jax.tree_util.tree_map(np.asarray, dict(variables)), "")
    np.savez(path, **flat)


@pytest.mark.parametrize("normalised", [False, True])
def test_regression_model_logits_and_loss(normalised):
    products = ["TOA_WV3_SWIR1", "TOA_WV3_SWIR2", "mag1c"]
    jmodel = JRegression(products, ["TOA_WV3_SWIR8"], inhibit_normalisation=not normalised)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 3, 8, 8), jnp.float32)))
    variables = _fill(shapes, 1)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (2, 3, 24, 20)).astype(np.float32)
    x[:, 2] *= 3000
    y = rng.uniform(0, 1, (2, 1, 24, 20)).astype(np.float32)
    model = RegressionModel(products, ["TOA_WV3_SWIR8"], inhibit_normalisation=not normalised)
    model.network.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    model.eval()
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
        out = model.batch_with_preds({"input": x, "output": y, "id": ["a", "b"]})
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    jout = jmodel.batch_with_preds(variables, {"input": jnp.asarray(x), "output": jnp.asarray(y)})
    for k in ("prediction", "output_norm", "residual"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), **LOGIT_TOL)
    assert out["id"] == ["a", "b"]
    for loss in ("l1", "mse"):
        model.loss_name = jmodel.loss_name = loss
        w = rng.uniform(0, 1, y.shape).astype(np.float32)
        got_l = model.loss_fn(got, torch.from_numpy(y), torch.from_numpy(w))
        want_l = jmodel.loss_fn(jnp.asarray(want), jnp.asarray(y), jnp.asarray(w))
        assert float(got_l) == pytest.approx(float(want_l), rel=1e-4)


def test_cloud_detector_logits_predict_scene():
    """13 bands, 4 classes: logits, predict and the reflect-padded
    predict_scene on an odd-sized scene against JAX's."""
    jmodel = JCloud()
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 13, 32, 32), jnp.float32)))
    variables = _fill(shapes, 2)
    model = CloudDetector()
    model.network.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    rng = np.random.default_rng(6)
    scene = rng.uniform(0, 1, (13, 29, 31)).astype(np.float32)
    want_scene = np.asarray(jmodel.predict_scene(variables, jnp.asarray(scene)))
    got_scene = model.predict_scene(scene)
    assert got_scene.shape == (29, 31) and got_scene.dtype == torch.int64
    assert (got_scene.numpy() == want_scene).mean() >= 0.999
    x = np.pad(scene, ((0, 0), (1, 2), (0, 1)), mode="reflect")[None]  # (1, 13, 32, 32)
    with torch.inference_mode():
        model.eval()
        got = model.logits(torch.from_numpy(x))
    want = np.asarray(jmodel.logits(variables, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    assert (model.predict(x).numpy() == want.argmax(1)).mean() >= 0.999


def _write_tiles(root, n=2):
    """Tile folders holding every raw band the products read."""
    rng = np.random.default_rng(7)
    names = sorted({p for spec in jfeat.FEATURES.values() for p in spec["inputs"]})
    rows = []
    for t in range(n):
        folder = os.path.join(root, f"t{t}")
        os.makedirs(folder)
        albedo = rng.uniform(0.1, 0.5, (40, 36))
        for name in names:
            band = albedo * rng.uniform(0.8, 1.2) + rng.normal(0, 0.01, albedo.shape)
            if name == "mag1c":
                band = rng.uniform(0, 800, albedo.shape)
            band[:2, :3] = 0.0
            np.save(os.path.join(folder, f"{name}.npy"), band.astype(np.float32))
        rows.append({"folder": folder})
    return rows


@pytest.fixture
def learned_checkpoint(tmp_path, monkeypatch):
    """A JAX cnn_regression checkpoint registered in neither registry yet;
    both registries restored afterwards."""
    monkeypatch.setattr(tfeat, "_LEARNED_MODEL", {"apply": None, "checkpoint": None})
    monkeypatch.setattr(jfeat, "_LEARNED_MODEL", {"apply": None, "checkpoint": None})
    folder = tmp_path / jfeat.LEARNED_RATIO_EXPERIMENT
    folder.mkdir()
    _, variables = _regressor_variables(3)
    _save_npz(folder / "best.npz", variables)
    return str(folder)


def test_extract_features_matches_jax(tmp_path, learned_checkpoint):
    """Every product on two tile folders, the learned ratio from one
    registered checkpoint: the same .npy files within the ratio bars; a
    second run writes nothing."""
    rows_t = _write_tiles(str(tmp_path / "port"))
    rows_j = _write_tiles(str(tmp_path / "jax"))
    tfeat.register_learned_ratio_checkpoint(learned_checkpoint)
    jfeat.register_learned_ratio_checkpoint(learned_checkpoint)
    names = list(tfeat.FEATURES)
    assert tfeat.extract_features(names, rows_t, device="cpu") == 2 * len(names)
    assert jfeat.extract_features(names, rows_j) == 2 * len(names)
    for rt, rj in zip(rows_t, rows_j):
        for name in names:
            got = np.load(os.path.join(rt["folder"], f"{name}.npy"))
            want = np.load(os.path.join(rj["folder"], f"{name}.npy"))
            assert got.dtype == np.float32 and got.shape == want.shape == (40, 36), name
            # JAX's product in f64 on the same files judges both f32 results.
            inputs = [np.load(os.path.join(rj["folder"], f"{p}.npy")).astype(np.float64)
                      for p in jfeat.FEATURES[name]["inputs"]]
            want64 = np.asarray(jfeat.FEATURES[name]["function"](*map(jnp.asarray, inputs)))
            e_port, e_jax = np.abs(got - want64).max(), np.abs(want - want64).max()
            assert e_port <= 4 * e_jax + 1e-6 * np.abs(want64).max(), (name, e_port, e_jax)
    assert tfeat.extract_features(names, rows_t, device="cpu") == 0
    with pytest.raises(KeyError):
        tfeat.extract_features(["nope"], rows_t, device="cpu")


def test_learned_ratio_needs_a_model(tmp_path, monkeypatch):
    monkeypatch.setattr(tfeat, "_LEARNED_MODEL", {"apply": None, "checkpoint": None})
    rows = _write_tiles(str(tmp_path))
    with pytest.raises(RuntimeError, match="registered regression model"):
        tfeat.extract_features(["ratio_lrn_bands2band8only_60ep_512_l1"], rows, device="cpu")
    tfeat.register_learned_ratio_model(lambda x: x[:, 5:6] * 2.0)
    assert tfeat.extract_features(["ratio_lrn_bands2band8only_60ep_512_l1"], rows,
                                  device="cpu") == 2


def test_setup_shims_build_regression_and_learned_ratio(tmp_path, learned_checkpoint):
    """``regression_output`` builds the regression model JAX's shims build,
    and a learned-ratio product with its checkpoint (explicit, or found
    under ``model.model_folder``) builds the DataModule."""
    cfg = Config().apply_overrides(["model.model_mode=regression_output",
                                    "model.model_type=cnn_regression", "model.loss=mse",
                                    'dataset.input_products=["TOA_WV3_SWIR1","TOA_WV3_SWIR2"]',
                                    'dataset.output_products=["TOA_WV3_SWIR8"]'])
    model = setup_shims.get_model(cfg)
    assert isinstance(model, RegressionModel) and model.loss_name == "mse"
    assert model.normalizer is not None and model.network.conv0.in_channels == 2
    rows = _write_tiles(str(tmp_path / "tiles"))
    csv = tmp_path / "tiles" / "index.csv"
    csv.write_text("folder\n" + "".join(f"{r['folder']}\n" for r in rows))
    product = "ratio_lrn_bands2band8only_60ep_512_l1"
    for overrides in ([f"dataset.learned_ratio_checkpoint={learned_checkpoint}"],
                      [f"model.model_folder={os.path.dirname(learned_checkpoint)}"]):
        tfeat._LEARNED_MODEL.update(apply=None, checkpoint=None)
        cfg = Config().apply_overrides([
            f"dataset.root_folder={tmp_path / 'tiles'}", "dataset.train_csv=index.csv",
            "dataset.test_csv=index.csv", f'dataset.input_products=["{product}","mag1c"]',
            *overrides])
        dm = setup_shims.get_dataset(cfg)
        assert tfeat._LEARNED_MODEL["checkpoint"] == learned_checkpoint
        assert list(dm.input_products) == [product, "mag1c"]
