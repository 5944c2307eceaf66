"""Weight-port parity: torch smp-layout MobileNetV2-UNet -> Flax, forward equal."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.models.mobilenet_unet import MobileNetV2UNet  # noqa: E402
from starcop_tpu.models.torch_port import port_smp_mobilenetv2_unet  # noqa: E402
from tests.torch_twin import TorchMobileNetV2UNet  # noqa: E402


def test_port_forward_parity():
    torch.manual_seed(0)
    tm = TorchMobileNetV2UNet(in_channels=4, classes=1).eval()
    # Randomize BN stats so the port is tested beyond defaults.
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.8, 1.2)

    variables = port_smp_mobilenetv2_unet(tm.state_dict())

    x = np.random.default_rng(0).normal(size=(1, 4, 64, 64)).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()

    fm = MobileNetV2UNet(num_classes=1)
    got = fm.apply(variables, jnp.asarray(np.transpose(x, (0, 2, 3, 1))), train=False)
    got = np.transpose(np.asarray(got), (0, 3, 1, 2))

    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_port_rejects_nothing_missing():
    """Every flax param leaf must be populated by the port (no silent inits)."""
    tm = TorchMobileNetV2UNet(in_channels=3, classes=1)
    variables = port_smp_mobilenetv2_unet(tm.state_dict())
    fm = MobileNetV2UNet(num_classes=1)
    ref = fm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32), train=False)

    ref_paths = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(ref["params"])[0]}
    got_paths = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(variables["params"])[0]}
    assert ref_paths == got_paths
    # Shapes agree everywhere.
    for (p, leaf_ref), (_, leaf_got) in zip(
        jax.tree_util.tree_flatten_with_path(ref["params"])[0],
        jax.tree_util.tree_flatten_with_path(variables["params"])[0],
    ):
        assert np.shape(leaf_ref) == np.shape(leaf_got), jax.tree_util.keystr(p)


def test_imagenet_encoder_init_rule(tmp_path, monkeypatch):
    """torchvision-layout mobilenet_v2 state_dict -> encoder-only init, applied
    iff in_channels == 3 (reference model_module.py:244-246)."""
    from tests.torch_twin import MobileNetV2Features
    from starcop_tpu.models import SegmentationModel
    from starcop_tpu.models.torch_port import port_torchvision_mobilenet_v2

    torch.manual_seed(1)
    tv = MobileNetV2Features(in_channels=3).eval()
    with torch.no_grad():
        for m in tv.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.8, 1.2)
    # bare torchvision layout: features.* (+ a classifier.* that must be ignored)
    sd = dict(tv.state_dict())
    sd["classifier.1.weight"] = torch.zeros(1000, 1280)
    sd["classifier.1.bias"] = torch.zeros(1000)
    ckpt = tmp_path / "mobilenet_v2-imagenet.pth"
    torch.save(sd, ckpt)
    monkeypatch.setenv("STARCOP_TPU_IMAGENET_MOBILENETV2", str(ckpt))

    rgb = ["TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm"]
    model3 = SegmentationModel(rgb, model_type="unet_semseg", encoder_weights="imagenet")
    x3 = jnp.asarray(np.random.default_rng(0).uniform(0, 60, (1, 3, 64, 64)), jnp.float32)
    variables = model3.init(jax.random.PRNGKey(0), x3)

    ported = port_torchvision_mobilenet_v2(sd)
    got_stem = np.asarray(variables["params"]["encoder"]["features_0"]["conv"]["kernel"])
    want_stem = np.asarray(ported["params"]["encoder"]["features_0"]["conv"]["kernel"])
    np.testing.assert_array_equal(got_stem, want_stem)
    got_bn = np.asarray(variables["batch_stats"]["encoder"]["features_17"]["project_bn"]["mean"])
    want_bn = np.asarray(ported["batch_stats"]["encoder"]["features_17"]["project_bn"]["mean"])
    np.testing.assert_array_equal(got_bn, want_bn)
    # decoder/head remain randomly initialized (not part of the port)
    assert "decoder_0" in variables["params"]
    # model still runs forward
    out = model3.apply(variables, x3, train=False)
    assert np.isfinite(np.asarray(out)).all()

    # 4-channel model: the auto rule does NOT port (ImageNet stem is 3-ch)
    model4 = SegmentationModel(["mag1c"] + rgb, model_type="unet_semseg")
    x4 = jnp.asarray(np.random.default_rng(0).uniform(0, 60, (1, 4, 64, 64)), jnp.float32)
    v4 = model4.init(jax.random.PRNGKey(0), x4)
    assert v4["params"]["encoder"]["features_0"]["conv"]["kernel"].shape[2] == 4

    # explicit 'imagenet' with no checkpoint available -> loud error
    monkeypatch.delenv("STARCOP_TPU_IMAGENET_MOBILENETV2")
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        SegmentationModel(rgb, model_type="unet_semseg",
                          encoder_weights="imagenet").init(jax.random.PRNGKey(0), x3)


def test_lightning_ckpt_file_round_trip(tmp_path):
    """The one path a released HF checkpoint takes, end to end through a FILE:
    a Lightning-format ``final_checkpoint_model.ckpt`` (top-level 'state_dict'
    with 'network.*' prefixes plus 'normalizer.*'/'pos_weight' buffers to
    drop — reference model_module.py:258-266 loads exactly this layout) ->
    ``load_pretrained_variables(experiment_dir)`` -> forward parity with the
    torch network. Covers file dispatch, prefix-strip, and buffer-drop in one
    test."""
    from starcop_tpu.setup_shims import load_pretrained_variables
    from tests.torch_twin import TorchMobileNetV2UNet

    torch.manual_seed(2)
    tm = TorchMobileNetV2UNet(in_channels=4, classes=1).eval()
    with torch.no_grad():
        for m in tm.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.8, 1.2)

    # Lightning checkpoint layout: the LightningModule's state_dict prefixes
    # the wrapped smp.Unet with 'network.' and carries the normalizer
    # constants and BCE pos_weight as extra buffers.
    state_dict = {f"network.{k}": v for k, v in tm.state_dict().items()}
    state_dict["normalizer.offsets"] = torch.zeros(4)
    state_dict["normalizer.factors"] = torch.ones(4)
    state_dict["pos_weight"] = torch.tensor([15.0])
    ckpt = {
        "state_dict": state_dict,
        "epoch": 15,  # Lightning metadata keys ride along and must be ignored
        "hyper_parameters": {"model": {"model_type": "unet_semseg"}},
    }
    exp_dir = tmp_path / "experiment"
    exp_dir.mkdir()
    torch.save(ckpt, exp_dir / "final_checkpoint_model.ckpt")

    variables = load_pretrained_variables(str(exp_dir))

    x = np.random.default_rng(3).normal(size=(1, 4, 64, 64)).astype(np.float32)
    with torch.no_grad():
        want = tm(torch.from_numpy(x)).numpy()
    fm = MobileNetV2UNet(num_classes=1)
    got = fm.apply(variables, jnp.asarray(np.transpose(x, (0, 2, 3, 1))), train=False)
    got = np.transpose(np.asarray(got), (0, 3, 1, 2))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
