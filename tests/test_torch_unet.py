"""The port's MobileNetV2 U-Net and segmenter against the Flax model.

Flax variables from ``PRNGKey(0)`` with randomised BN statistics are carried
into the port by ``flax_to_torch_state_dict`` and loaded strictly; logits
must match within the weight-port bar of tests/test_torch_port.py:37
(rtol 1e-3, atol 2e-4).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.models import SegmentationModel as FlaxSegmentationModel  # noqa: E402
from starcop_tpu.models.mobilenet_unet import MobileNetV2UNet as FlaxUNet  # noqa: E402
from starcop_tpu.models.torch_port import port_smp_mobilenetv2_unet  # noqa: E402
from starcop_tpu_torch.models.mobilenet_unet import MobileNetV2UNet  # noqa: E402
from starcop_tpu_torch.models.segmenter import EMIT_INPUT_PRODUCTS, SegmentationModel  # noqa: E402
from starcop_tpu_torch.models.weights import (  # noqa: E402
    flax_to_torch_state_dict,
    load_lightning_state_dict,
)


def _randomize_bn(variables, seed=0):
    rng = np.random.default_rng(seed)

    def walk(tree):
        if "mean" in tree and "var" in tree:
            return {"mean": rng.normal(0, 0.05, np.shape(tree["mean"])).astype(np.float32),
                    "var": rng.uniform(0.8, 1.2, np.shape(tree["var"])).astype(np.float32)}
        return {k: walk(v) for k, v in tree.items()}

    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return {"params": params, "batch_stats": walk(variables["batch_stats"])}


@pytest.fixture(scope="module")
def flax_variables():
    fm = FlaxUNet(num_classes=1)
    init = jax.jit(lambda key, x: fm.init(key, x, train=False))  # 3x faster than eager
    return _randomize_bn(init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 4), jnp.float32)))


def _port(variables):
    net = MobileNetV2UNet(in_channels=4, num_classes=1).eval()
    net.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    return net


def test_flax_weights_forward_parity(flax_variables):
    x = np.random.default_rng(0).normal(size=(1, 4, 64, 64)).astype(np.float32)
    with torch.no_grad():
        got = _port(flax_variables)(torch.from_numpy(x)).numpy()
    want = FlaxUNet(num_classes=1).apply(
        flax_variables, jnp.asarray(np.transpose(x, (0, 2, 3, 1))), train=False)
    want = np.transpose(np.asarray(want), (0, 3, 1, 2))
    assert got.shape == want.shape == (1, 1, 64, 64)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def test_round_trip_through_torch_port(flax_variables):
    """flax -> port state_dict -> the JAX package's torch->flax port gives back
    every Flax leaf exactly (and no other leaf)."""
    back = port_smp_mobilenetv2_unet(flax_to_torch_state_dict(flax_variables))
    for col in ("params", "batch_stats"):
        want = jax.tree_util.tree_flatten_with_path(flax_variables[col])[0]
        got = dict(jax.tree_util.tree_flatten_with_path(back[col])[0])
        assert {p for p, _ in want} == set(got)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]), leaf)


def test_lightning_checkpoint_loads(flax_variables):
    sd = flax_to_torch_state_dict(flax_variables)
    ckpt = {"state_dict": {f"network.{k}": v for k, v in sd.items()}, "epoch": 15}
    ckpt["state_dict"]["normalizer.offsets"] = torch.zeros(4)
    ckpt["state_dict"]["pos_weight"] = torch.tensor([15.0])
    ckpt["state_dict"]["loss_function.pos_weight"] = torch.tensor([15.0])
    loaded = load_lightning_state_dict(ckpt)
    assert set(loaded) == set(sd)
    model = SegmentationModel(EMIT_INPUT_PRODUCTS)
    model.network.load_state_dict(loaded, strict=True)
    assert set(model.state_dict()) == {f"network.{k}" for k in sd}


def test_segmenter_matches_jax(flax_variables):
    """normalise -> network, against the JAX SegmentationModel.apply, on inputs
    in the products' own ranges (mag1c ppm x m, AVIRIS RGB radiance)."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(0, 4000, (1, 1, 64, 96)),
                        rng.uniform(0, 150, (1, 3, 64, 96))], axis=1).astype(np.float32)
    model = SegmentationModel(EMIT_INPUT_PRODUCTS).eval()
    model.network.load_state_dict(flax_to_torch_state_dict(flax_variables), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    jmodel = FlaxSegmentationModel(list(EMIT_INPUT_PRODUCTS), model_type="unet_semseg",
                                   encoder_weights=None)
    want = np.asarray(jmodel.apply(flax_variables, jnp.asarray(x), train=False))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(
        model.normalizer.normalize_x(torch.from_numpy(x)).numpy(),
        np.asarray(jmodel.normalizer.normalize_x(jnp.asarray(x))), rtol=1e-7)
