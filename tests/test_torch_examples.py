"""The port's experiments and examples (starcop_tpu_torch.experiments,
starcop_tpu_torch.examples) against the JAX package's
(examples/paper_reproduction_synthetic.py, experiments/srf_sensitivity/run.py,
examples/*.py, examples/recipes.sh) on the CPU, at small sizes.

Bars:
  * the paper reproduction's chips (2 + 2 of 64^2 with the real filter,
    JAX's seeds): every product but mag1c and its loss weights bitwise
    JAX's, mag1c at threshold-500 agreement >= 0.999 with detections (the
    port filters in float32, JAX under the tests' x64 in float64);
  * its baseline stage on one set of chips (JAX's), so that a pixel
    flipping between the two packages' filters cannot move it: the per-tile
    confusion matrices equal, every aggregate metric within 1e-6;
  * one port run end to end (16 + 2 chips of 64^2, one epoch): JAX's
    summary and results_agg.json keys;
  * the SRF sensitivity (64^2, 2 draws): each draw's band_rel_rms and
    ratio_rms within 1e-5 relative of JAX's, JAX's bounds
    (tests/test_srf.py:182);
  * recipes.sh: the five invocations are JAX's, apply to the port's Config,
    and name known products (tests/test_ops_misc.py:229-256).
"""

import csv
import importlib.util
import json
import pathlib
import shlex

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.data import synthetic as jsyn  # noqa: E402
from starcop_tpu.data.datamodule import DataModule as JDataModule  # noqa: E402
from starcop_tpu.eval.validation import run_validation as j_run_validation  # noqa: E402
from starcop_tpu.models import Mag1cBaseline as JMag1cBaseline  # noqa: E402
from starcop_tpu_torch.config import Config  # noqa: E402
from starcop_tpu_torch.examples import (  # noqa: E402
    dataset_exploration,
    emit_zero_shot,
    model_demo_synthetic,
    srf_simulation_demo,
    training_demo,
)
from starcop_tpu_torch.experiments import paper_reproduction as pr  # noqa: E402
from starcop_tpu_torch.experiments import srf_sensitivity as tsrf  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PAPER = ROOT / "experiments" / "paper_reproduction_synthetic"
CM = ("TP", "FP", "TN", "FN")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and the full-width U-Net's convolutions on oversubscribed threads ran
    ~20x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(index):
    with open(index, newline="") as fh:
        return list(csv.DictReader(fh))


@pytest.fixture(scope="module")
def paper_chips(tmp_path_factory):
    """The paper reproduction's chips at 2 + 2 of 64^2, from both packages."""
    root = tmp_path_factory.mktemp("paper")
    jax_idx = tuple(
        jsyn.write_synthetic_chip_dataset(str(root / "jax" / split), np.random.default_rng(seed),
                                          n_tiles=2, size=64, run_matched_filter=True,
                                          max_confounders=3)
        for split, seed in (("train", 0), ("test", 1)))
    port_idx = pr.write_chips(str(root / "port"), 2, 2, size=64, device="cpu")
    return root, jax_idx, port_idx


def test_paper_chips_match_jax(paper_chips):
    _, jax_idx, port_idx = paper_chips
    detections, agree = 0, []
    for j_index, t_index in zip(jax_idx, port_idx):
        for want, got in zip(_rows(j_index), _rows(t_index)):
            assert {k: v for k, v in got.items() if k != "folder"} == \
                {k: v for k, v in want.items() if k != "folder"}
            files = sorted(p.name for p in pathlib.Path(want["folder"]).iterdir())
            assert files == sorted(p.name for p in pathlib.Path(got["folder"]).iterdir())
            for f in files:
                a = np.load(pathlib.Path(got["folder"]) / f)
                b = np.load(pathlib.Path(want["folder"]) / f)
                assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (64, 64)
                if f == "mag1c.npy":
                    detections += int((b > 500).sum())
                    agree.append(((a > 500) == (b > 500)).mean())
                elif f != "weight_mag1c.npy":
                    np.testing.assert_array_equal(a, b, err_msg=f)
    assert detections > 0 and min(agree) >= 0.999, (detections, agree)


def test_paper_baseline_matches_jax(paper_chips, tmp_path):
    """Both packages' baseline stage on JAX's chips."""
    _, (j_train, j_test), _ = paper_chips
    jdm = JDataModule(j_train, j_test, input_products=pr.PRODUCTS, batch_size=16,
                      num_workers=2)
    baseline = JMag1cBaseline(pr.PRODUCTS)
    _, want = j_run_validation(baseline.batch_with_preds, iter(jdm.test_loader()),
                               apply_threshold=baseline.apply_threshold,
                               path_save_results=str(tmp_path / "jax"))
    got = pr.validate_baseline(pr.make_datamodule(j_train, j_test), str(tmp_path / "port"),
                               device="cpu")
    assert want["f1score"] > 0
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, (int, float)):
            assert abs(got[k] - v) <= 1e-6 or (np.isnan(v) and np.isnan(got[k])), (k, got[k], v)
    for g, w in zip(_rows(tmp_path / "port" / "results.csv"),
                    _rows(tmp_path / "jax" / "results.csv")):
        assert [int(float(g[k])) for k in CM] == [int(float(w[k])) for k in CM], (g, w)


def test_paper_reproduction_main_small(tmp_path):
    """One port run end to end on the CPU: JAX's summary and files."""
    timings = {}
    summary = pr.main(str(tmp_path), n_train=16, n_test=2, epochs=1, device="cpu", size=64,
                      timings=timings)
    want = json.loads((JAX_PAPER / "summary.json").read_text())
    assert set(summary) == set(want)
    for part in ("model", "baseline"):
        assert set(summary[part]) == set(want[part])
        assert all(np.isfinite(v) for v in summary[part].values())
    assert json.loads((tmp_path / "summary.json").read_text()) == summary
    for val in ("val_model", "val_baseline"):
        agg = set(json.loads((tmp_path / val / "results_agg.json").read_text()))
        want_agg = set(json.loads((JAX_PAPER / val / "results_agg.json").read_text()))
        # The difficulty split's keys appear only for a difficulty that has
        # tiles: at 64^2 every tile is "easy" or none is.
        assert {k for k in want_agg if not k.endswith(("_easy", "_hard"))} <= agg <= want_agg
        assert len(_rows(tmp_path / val / "results.csv")) == 2
    assert set(timings) == {"chips_s", "train_s", "val_model_s", "val_baseline_s"}


def test_srf_sensitivity_matches_jax():
    jrun = _load(ROOT / "experiments" / "srf_sensitivity" / "run.py", "jax_srf_sensitivity_run")
    want = jrun.run(size=64, n_draws=2)
    got = tsrf.run(size=64, n_draws=2, device="cpu")

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in d.items()}

    assert keys({k: v for k, v in got.items() if k != "draws"}) == \
        keys({k: v for k, v in want.items() if k != "draws"})
    assert got["config"] == want["config"]
    assert len(got["draws"]) == len(want["draws"]) == 2
    for g, w in zip(got["draws"], want["draws"]):
        assert keys(g) == keys(w)
        for k in ("band_rel_rms", "ratio_rms"):
            assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (k, g[k], w[k])
    fam = got["perturbation_family"]
    assert fam["abs_delta_f1_max"] < 0.05
    assert fam["ratio_rms_max"] < 0.01
    assert all(v > 0.5 for v in got["nominal_best_f1"].values())
    for name in ("CENTER_TOL_NM", "FWHM_TOL", "ORDER_RANGE", "RIPPLE", "VARON_PAIRS"):
        assert getattr(tsrf, name) == getattr(jrun, name), name


def _recipes(path: pathlib.Path, cli: str):
    text = path.read_text()
    out = []
    for block in text.split(f"python -m {cli}")[1:]:
        line = block.replace("\\\n", " ").splitlines()[0]
        out.append([t for t in shlex.split(line) if "=" in t])
    return out


def test_recipes_apply_to_the_ports_config():
    from starcop_tpu_torch.data.features import FEATURES
    from starcop_tpu_torch.data.normalizer import BAND_NORMALIZATION

    got = _recipes(ROOT / "starcop_tpu_torch" / "examples" / "recipes.sh",
                   "starcop_tpu_torch.cli.train")
    assert len(got) == 5  # the five published recipes
    assert got == _recipes(ROOT / "examples" / "recipes.sh", "starcop_tpu.cli.train")
    known = set(BAND_NORMALIZATION) | set(FEATURES)
    for overrides in got:
        cfg = Config()
        cfg.apply_overrides([o.replace('"$ROOT"', "/tmp/x") for o in overrides])
        assert cfg.dataset.input_products, overrides
        for prod in cfg.dataset.input_products:
            assert prod in known or prod.startswith("TOA_AVIRIS"), prod


def test_training_demo_passes_jax_overrides(monkeypatch, tmp_path):
    """The train CLI gets JAX's overrides plus the accelerator, and they
    apply to the port's Config."""
    import tempfile

    jdemo = _load(ROOT / "examples" / "training_demo.py", "jax_training_demo")
    seen = {}
    monkeypatch.setattr(tempfile, "mkdtemp", lambda prefix=None: str(tmp_path))
    monkeypatch.setattr(jdemo, "write_synthetic_chip_dataset", lambda *a, **k: None)
    monkeypatch.setattr(jdemo, "train_main", lambda argv: seen.setdefault("jax", argv) and 0)
    import starcop_tpu_torch.cli.train as tcli
    import starcop_tpu_torch.data.synthetic as tsyn

    monkeypatch.setattr(tsyn, "write_synthetic_chip_dataset", lambda *a, **k: None)
    monkeypatch.setattr(tcli, "main", lambda argv: seen.setdefault("port", argv) and 0)
    jdemo.main(3)
    training_demo.main(3, device="cpu")
    strip = lambda argv: [a for a in argv if not a.startswith("dataset.root_folder=")]  # noqa: E731
    assert strip(seen["port"]) == strip(seen["jax"]) + ["training.accelerator=cpu"]
    cfg = Config()
    cfg.apply_overrides(seen["port"])
    assert cfg.training.max_epochs == 3 and cfg.training.accelerator == "cpu"


def test_emit_zero_shot_forwards_to_infer_emit(monkeypatch):
    seen = []
    from starcop_tpu_torch.cli import infer_emit

    monkeypatch.setattr(infer_emit, "main", lambda argv: seen.append(argv) or 0)
    assert emit_zero_shot.main(["g.nc", "m.ckpt", "out", "--device", "cpu"]) == 0
    assert seen == [["g.nc", "--checkpoint", "m.ckpt", "--output", "out", "--georeference",
                     "--device", "cpu"]]
    assert emit_zero_shot.main(["g.nc"]) == 2 and len(seen) == 1


def test_srf_simulation_demo_runs(tmp_path):
    srf_simulation_demo.main(str(tmp_path), device="cpu")
    assert (tmp_path / "srf_curves.png").stat().st_size > 0
    assert (tmp_path / "simulated_bands.png").stat().st_size > 0


def test_dataset_exploration_runs(tmp_path, capsys):
    dataset_exploration.main(str(tmp_path), n_tiles=2, device="cpu", size=64)
    out = capsys.readouterr().out
    assert "2 chips:" in out and "2 training tiles" in out
    assert (tmp_path / "sample_grid.png").stat().st_size > 0


def test_model_demo_runs(tmp_path, capsys):
    model_demo_synthetic.main(out_dir=str(tmp_path), device="cpu")
    assert "tiles: 4" in capsys.readouterr().out
    assert (tmp_path / "demo_grid.png").stat().st_size > 0
    assert (tmp_path / "validation" / "results_agg.json").exists()


@pytest.mark.parametrize("call", [
    lambda: pr.main(),
    lambda: tsrf.run(size=64, n_draws=1),
    lambda: dataset_exploration.main(),
    lambda: model_demo_synthetic.main(),
    lambda: srf_simulation_demo.main(),
], ids=["paper_reproduction", "srf_sensitivity", "dataset_exploration", "model_demo",
        "srf_simulation_demo"])
def test_entry_points_need_a_card(call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the no-card refusal cannot be shown")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_committed_port_artifacts():
    """The port's committed run on the card
    (starcop_tpu_torch/experiments/paper_reproduction_synthetic): JAX's
    summary and results_agg.json keys, the claim's direction, the baseline
    within chip_smoke.py's bars of JAX's committed one."""
    port = ROOT / "starcop_tpu_torch" / "experiments" / "paper_reproduction_synthetic"
    got = json.loads((port / "summary.json").read_text())
    want = json.loads((JAX_PAPER / "summary.json").read_text())
    assert set(got) == set(want)
    assert got["model"]["f1score"] > got["baseline"]["f1score"]
    assert got["model"]["FPR_no_plume"] <= got["baseline"]["FPR_no_plume"]
    for key, bar in (("f1score", 0.01), ("precision", 0.01), ("recall", 0.01),
                     ("FPR_no_plume", 0.005)):
        assert abs(got["baseline"][key] - want["baseline"][key]) <= bar, key
    for val in ("val_model", "val_baseline"):
        assert set(json.loads((port / val / "results_agg.json").read_text())) == \
            set(json.loads((JAX_PAPER / val / "results_agg.json").read_text()))
    srf = json.loads((port.parent / "srf_sensitivity_summary.json").read_text())
    assert srf["config"] == json.loads(
        (ROOT / "experiments" / "srf_sensitivity" / "summary.json").read_text())["config"]
