"""The port's training path (starcop_tpu_torch.config, .train, the
segmentation networks, their weights and optimizer carries) against the JAX
package on the CPU, on the same numpy-seeded inputs.

Bars, each measured on this host's CPU with margin:
  * config dicts, the plateau and early-stopping sequences, the eval step's
    loss-free outputs (both confusion matrices): equal;
  * one train step from a JAX state carried into the port (2 x 64^2): the
    loss within rel 1e-5; the gradients in float64 equal to JAX's up to
    rounding, in float32 no farther from JAX's float64 ones than 4x JAX's
    own float32 gradients (test_one_step_matches_jax says why); the running
    statistics within 1e-4 (the torch batch norm's unbiased update misses
    this by 100x at the deepest level); the parameters after the Adam step
    within 2 lr of JAX's (a gradient near zero flips Adam's first update,
    lr * sign(g));
  * a bf16 train step from the same carried state: the loss within 1e-2
    of JAX's bf16 step's and within 2e-2 of the port's f32 step's, but not
    equal to it, every convolution returning bf16;
  * Adam against ``optax.inject_hyperparams(optax.adam)`` on a shared
    gradient stream with an lr change: parameters within 1e-6;
  * initialisation: each convolution's standard deviation within 5 / sqrt(n)
    (n its weights; 10 % at least) of Flax's lecun_normal, inside +-2 sigma.
The checkpoints, the Trainer and dropout are in test_torch_train_data.py.
JAX's inputs are float32 (the test configuration turns x64 on).
"""

import copy
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

import optax  # noqa: E402

from starcop_tpu import config as jconfig  # noqa: E402
from starcop_tpu.models import SegmentationModel as FlaxSegmentationModel  # noqa: E402
from starcop_tpu.train import loop as jloop  # noqa: E402
from starcop_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint  # noqa: E402
from starcop_tpu_torch import config as tconfig  # noqa: E402
from starcop_tpu_torch.models import layers  # noqa: E402
from starcop_tpu_torch.models.segmenter import SegmentationModel  # noqa: E402
from starcop_tpu_torch.models.unet import upsample2  # noqa: E402
from starcop_tpu_torch.models.weights import (  # noqa: E402
    _to_flax_array,
    adam_state_from_flax,
    adam_state_to_flax,
    flax_location,
    flax_to_torch_state_dict,
    is_semseg,
    torch_to_flax_variables,
)
from starcop_tpu_torch.train import loop as tloop  # noqa: E402
from starcop_tpu_torch.train.checkpoint import load_checkpoint  # noqa: E402

PRODUCTS = ["mag1c", "TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm"]
LR = 1e-4


def _batch(seed, b=2, size=64, products=PRODUCTS):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.uniform(0, 3000, (b, size, size))]
                 + [rng.uniform(0, 90, (b, size, size)) for _ in products[1:]], 1)
    return {"input": x.astype(np.float32),
            "output": (rng.random((b, 1, size, size)) > 0.8).astype(np.float32),
            "weight_loss": rng.uniform(0.1, 1, (b, 1, size, size)).astype(np.float32),
            "has_plume": np.asarray([1.0, 0.0] * (b // 2), np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _leaves(tree, prefix=()):
    """{path tuple: numpy leaf} of a nested mapping / Flax pytree."""
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _carry(jstate, tmp_path, model_type, **kw):
    """The port's TrainState holding JAX's state (params, batch_stats, Adam,
    step), through JAX's checkpoint file."""
    path = j_save_checkpoint(str(tmp_path), jstate, name=f"jax_{model_type}")
    model = SegmentationModel(PRODUCTS, model_type=model_type, encoder_weights=None, **kw)
    return load_checkpoint(path, tloop.create_train_state(model, 0, LR, "cpu"))


@pytest.fixture(scope="module")
def jax_states():
    """JAX train states (create_train_state from PRNGKey(0)) and their tx,
    built once: the U-Net's init compiles for ~12 s."""
    cache = {}

    def get(model_type):
        if model_type not in cache:
            jm = FlaxSegmentationModel(PRODUCTS, model_type=model_type, encoder_weights=None,
                                       pos_weight=15.0)
            state, tx = jloop.create_train_state(jm, jax.random.PRNGKey(0),
                                                 jnp.zeros((2, 4, 64, 64), jnp.float32), LR)
            cache[model_type] = (jm, state, tx)
        return cache[model_type]

    return get


@pytest.fixture(scope="module")
def jax_steps(jax_states):
    """JAX's training forward on ``_batch(7)`` per model type, computed
    once: (model, state, batch, loss, f32 gradients, new batch statistics,
    f64 gradients)."""
    cache = {}

    def get(model_type):
        if model_type not in cache:
            jm, jstate, _ = jax_states(model_type)
            batch = _batch(7)
            loss, grads, stats = _jax_grads(jm, jstate, _jax(batch))
            _, grads64, _ = _jax_grads(jm, jstate, _jax(batch), f64=True)
            cache[model_type] = (jm, jstate, batch, loss, grads, stats, grads64)
        return cache[model_type]

    return get


# ---------------------------------------------------------------------------
# Config, schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("overrides", [
    [],
    ["model.lr=3e-4", "dataset.training_size=[256,256]", "dataloader.batch_size=8"],
    ["model.dtype=bfloat16", "training.max_epochs=2", "wandb.images_logging=false",
     "model.model_type=cnn", "dataset.input_products=[\"mag1c\"]", "upload_path=none"],
])
def test_config_matches_jax(overrides, tmp_path):
    want = jconfig.Config().apply_overrides(overrides)
    got = tconfig.Config().apply_overrides(overrides)
    w, g = want.to_dict(), got.to_dict()
    assert w["training"].pop("accelerator") == "tpu" and g["training"].pop("accelerator") == "gpu"
    assert g == w
    # A JAX experiment's config.json loads, its accelerator kept (and refused).
    loaded = tconfig.Config.from_dict(want.to_dict())
    assert loaded.to_dict() == want.to_dict()
    with pytest.raises(ValueError, match="training.accelerator=gpu"):
        loaded.training.resolve_device()
    assert str(loaded.apply_overrides(["training.accelerator=cpu"]).training.resolve_device()) \
        == "cpu"
    yaml_path = tmp_path / "c.yaml"
    yaml_path.write_text("model:\n  lr: 0.002\ndataset:\n  training_size: [64, 64]\n")
    assert tconfig.Config.from_yaml(str(yaml_path)).to_dict()["model"] == \
        jconfig.Config.from_yaml(str(yaml_path)).to_dict()["model"]
    assert tconfig.Config.from_yaml(str(yaml_path)).dataset.training_size == (64, 64)
    dtype = got.model.resolve_dtype()
    assert dtype == (torch.bfloat16 if got.model.dtype == "bfloat16" else None)
    with pytest.raises(AttributeError, match="Unknown config key"):
        tconfig.Config().apply_overrides(["model.nope=1"])


def _metric_stream(seed, n=60):
    """A val_loss-like stream with plateaus, exact repeats and improvements."""
    rng = np.random.default_rng(seed)
    x, out = 1.0, []
    for _ in range(n):
        r = rng.random()
        x = x * (0.9 if r < 0.3 else 1.0 if r < 0.6 else 1.05)
        out.append(float(np.float32(x)))
    return out


@pytest.mark.parametrize("seed,patience,factor", [(0, 4, 0.5), (1, 2, 0.5), (2, 0, 0.1),
                                                  (3, 8, 0.5)])
def test_plateau_and_early_stopping_match_jax(seed, patience, factor):
    js, ts = jloop.ReduceLROnPlateau(factor, patience), tloop.ReduceLROnPlateau(factor, patience)
    je, te = jloop.EarlyStopping(patience), tloop.EarlyStopping(patience)
    seq = []
    for m in _metric_stream(seed):
        got = (ts.update(m), te.update(m), ts.num_bad, te.num_bad, ts.best)
        want = (js.update(m), je.update(m), js.num_bad, je.num_bad, js.best)
        assert got == want
        seq.append(got[0])
    assert min(seq) < 1.0  # the stream does plateau


def test_torch_plateau_scheduler_is_not_jax():
    """Why the schedule is copied: torch's ReduceLROnPlateau needs a
    relative improvement of 1e-4, so a tiny decrease counts as bad there."""
    metric = [1.0] + [1.0 - 1e-6 * i for i in range(1, 8)]
    ours = tloop.ReduceLROnPlateau(0.5, 2)
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.SGD([p], lr=1.0)
    theirs = torch.optim.lr_scheduler.ReduceLROnPlateau(opt, factor=0.5, patience=2)
    for m in metric:
        ours.update(m)
        theirs.step(m)
    assert ours.scale == 1.0 and opt.param_groups[0]["lr"] < 1.0


# ---------------------------------------------------------------------------
# Networks: initialisation, both-way carries, bilinear upsampling
# ---------------------------------------------------------------------------


def _conv_std_ok(w, fan_in):
    std = 1.0 / math.sqrt(fan_in)
    n = w.size
    ratio = float(w.std()) / std
    return (abs(ratio - 1) <= max(0.1, 5 / math.sqrt(n))
            and float(np.abs(w).max()) <= 2 * std / 0.87962566103423978 + 1e-7
            and abs(float(w.mean())) <= 5 * std / math.sqrt(n))


@pytest.mark.parametrize("model_type", ["cnn", "unet", "unet_semseg"])
def test_init_moments_match_flax(model_type, jax_states):
    _, jstate, _ = jax_states(model_type)
    model = SegmentationModel(PRODUCTS, model_type=model_type, encoder_weights=None)
    model.init(torch.Generator().manual_seed(0))
    ours = _leaves(torch_to_flax_variables(model.network.state_dict()))
    flax = _leaves({"params": jstate.params, "batch_stats": jstate.batch_stats})
    assert ours.keys() == flax.keys()
    n_conv = 0
    for path, want in flax.items():
        got = ours[path]
        assert got.shape == want.shape and got.dtype == want.dtype == np.float32
        if path[-1] == "kernel":
            fan_in = int(np.prod(want.shape[:3]))  # kh * kw * in / groups
            assert _conv_std_ok(want, fan_in), ("flax", path)
            assert _conv_std_ok(got, fan_in), ("port", path, got.std() * math.sqrt(fan_in))
            n_conv += 1
        elif path[-1] in ("scale", "var"):
            np.testing.assert_array_equal(got, np.ones_like(want))
            np.testing.assert_array_equal(want, np.ones_like(want))
        else:  # conv and batch-norm biases, running means
            np.testing.assert_array_equal(got, np.zeros_like(want))
            np.testing.assert_array_equal(want, np.zeros_like(want))
    assert n_conv >= 5


def test_imagenet_encoder_rule(tmp_path, monkeypatch):
    """encoder_weights: 'auto' and 'imagenet' load a torchvision mobilenet_v2
    found on disk into a 3-product unet_semseg's encoder, as JAX's
    port_torchvision_mobilenet_v2 carries it (bitwise; the classifier
    ignored); 4 products take none; 'imagenet' without a checkpoint raises,
    'auto' without one keeps the random encoder."""
    from starcop_tpu.models.torch_port import port_torchvision_mobilenet_v2
    from tests.torch_twin import MobileNetV2Features

    torch.manual_seed(1)
    tv = MobileNetV2Features(in_channels=3).eval()
    with torch.no_grad():
        for m in tv.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.05)
                m.running_var.uniform_(0.8, 1.2)
    sd = dict(tv.state_dict())
    sd["classifier.1.weight"] = torch.zeros(1000, 1280)
    sd["classifier.1.bias"] = torch.zeros(1000)
    ckpt = tmp_path / "mobilenet_v2-imagenet.pth"
    torch.save(sd, ckpt)
    monkeypatch.setenv("STARCOP_TPU_IMAGENET_MOBILENETV2", str(ckpt))
    want = port_torchvision_mobilenet_v2(sd)
    rgb = PRODUCTS[1:]
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    for rule in ("auto", "imagenet"):
        got = torch_to_flax_variables(SegmentationModel(rgb, encoder_weights=rule).init(
            gen()).network.state_dict())
        for coll in ("params", "batch_stats"):
            w = _leaves(want[coll]["encoder"])
            g = _leaves(got[coll]["encoder"])
            assert g.keys() == w.keys()
            for path, leaf in w.items():
                np.testing.assert_array_equal(g[path], leaf, err_msg=str((rule, coll, path)))
    four = SegmentationModel(PRODUCTS, encoder_weights="imagenet").init(gen())
    assert four.network.encoder.features[0][0].weight.shape[1] == 4
    monkeypatch.delenv("STARCOP_TPU_IMAGENET_MOBILENETV2")
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError, match="imagenet"):
        SegmentationModel(rgb, encoder_weights="imagenet").init(gen())
    plain = SegmentationModel(rgb, encoder_weights="auto").init(gen())
    stem = plain.network.encoder.features[0][0].weight
    assert not torch.equal(stem, sd["features.0.0.weight"])


@pytest.mark.parametrize("model_type", ["single", "cnn", "cnn_regression", "unet",
                                        "unet_dropout", "unet_semseg"])
def test_weights_carry_both_ways(model_type):
    model = SegmentationModel(PRODUCTS, model_type=model_type, encoder_weights=None)
    model.init(torch.Generator().manual_seed(3))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    sd = model.network.state_dict()
    variables = torch_to_flax_variables(sd)
    assert ("batch_stats" in variables) == (model_type == "unet_semseg")
    back = flax_to_torch_state_dict(variables)
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k
    # The Flax model of the same type takes the carried variables.
    jm = FlaxSegmentationModel(PRODUCTS, model_type=model_type, encoder_weights=None)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 4, 32, 32), jnp.float32)))
    want = {tuple(k.key for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    assert {p: a.shape for p, a in _leaves(variables).items()} == want


def test_upsample_matches_jax_resize():
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 7)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (2, 10, 14, 3), "bilinear")
    got = upsample2(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    # the borders: edge rows and columns
    np.testing.assert_allclose(got[:, [0, -1]], np.asarray(want)[:, [0, -1]], atol=1e-6)
    np.testing.assert_allclose(got[:, :, [0, -1]], np.asarray(want)[:, :, [0, -1]], atol=1e-6)


# ---------------------------------------------------------------------------
# One train step from a carried JAX state
# ---------------------------------------------------------------------------


def _jax_grads(jm, jstate, batch, f64=False):
    """JAX's loss, gradients and new batch statistics of a training forward.
    ``f64``: everything in float64, the input normalised in float64 too
    (``normalize_x`` would round it to float32), by the network's own
    apply."""
    stats = jstate.batch_stats
    if f64:
        to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
        params, stats, batch = to64(jstate.params), to64(stats), to64(batch)
        factors = jnp.asarray(jm.normalizer.factors_input, jnp.float64).reshape(1, -1, 1, 1)
        xn = jnp.clip(batch["input"] / factors, 0.0, 2.0).transpose(0, 2, 3, 1)
    else:
        params = jstate.params

    def loss_fn(p):
        variables = {"params": p, "batch_stats": stats}
        if f64:
            logits, updates = jm.network.apply(variables, xn, train=True, mutable=["batch_stats"])
            logits = logits.transpose(0, 3, 1, 2)
        else:
            logits, updates = jm.apply(variables, batch["input"], train=True)
        return jm.loss_fn(logits, batch["output"], batch["weight_loss"]), updates

    (loss, updates), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return float(loss), grads, updates.get("batch_stats", {})


def _port_grads(model):
    semseg = is_semseg(dict(model.network.named_parameters()))
    return {flax_location(n, semseg)[1]: _to_flax_array(p.grad)
            for n, p in model.network.named_parameters()}


def _l2_err(got, want):
    """||got - want|| / ||want|| over all gradient leaves, in float64."""
    num = sum(float(((got[p].astype(np.float64) - w) ** 2).sum()) for p, w in want.items())
    return math.sqrt(num / sum(float((w.astype(np.float64) ** 2).sum()) for w in want.values()))


# The gradients in float64, port against JAX (relative L2 over all leaves):
# rounding only, but a 2 x 64^2 batch leaves 2 x 2 x 2 values per channel
# at the U-Net's deepest batch norms, which amplify it ~1e6 (the two f64
# losses differ at 5e-10, the gradients at 6e-8); the BN-free networks
# agree to 1e-14 or better.
GRAD64_BARS = {"single": 1e-12, "cnn": 1e-12, "unet": 1e-12, "unet_semseg": 1e-6}


@pytest.mark.parametrize("model_type", ["single", "cnn", "unet", "unet_semseg"])
def test_one_step_matches_jax(model_type, jax_steps, tmp_path):
    """One train step from a carried JAX state. Gradients: in float64 the
    port's equal JAX's within GRAD64_BARS; in float32 (the train step's) the
    port's are no farther from JAX's float64 gradients than 4x JAX's own
    float32 gradients are, + 1e-6 (measured: unet_semseg 1.6e-2 against
    JAX's 4.1e-2, unet 5.7e-7 against 9.5e-5)."""
    jm, jstate, batch, jloss, jgrads, jstats, jgrads64 = jax_steps(model_type)
    want64 = _leaves(jgrads64)
    state = _carry(jstate, tmp_path, model_type, pos_weight=15.0)
    twin = copy.deepcopy(state.model).double().train()
    x64 = {k: v.double() for k, v in _torch(batch).items()}
    twin.loss_fn(twin(x64["input"]), x64["output"], x64["weight_loss"]).backward()
    assert _l2_err(_port_grads(twin), want64) <= GRAD64_BARS[model_type]

    state, loss = tloop.make_train_step(state.model)(state, _torch(batch), LR)
    assert state.step == 1
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)
    got = _port_grads(state.model)
    assert got.keys() == want64.keys()
    assert _l2_err(got, want64) <= 4 * _l2_err(_leaves(jgrads), want64) + 1e-6
    ours = torch_to_flax_variables(state.model.network.state_dict())
    if jstats:
        for path, s in _leaves(jstats).items():
            np.testing.assert_allclose(_leaves(ours["batch_stats"])[path], s, rtol=1e-4,
                                       atol=1e-4, err_msg=str(path))
    # Adam's first step from JAX's gradients, p - lr g / (|g| + eps): within
    # 2 lr (a sign flip) of ours.
    params = _leaves(ours["params"])
    for path, g in _leaves(jgrads).items():
        p = _leaves(jstate.params)[path]
        want = p - LR * g / (np.abs(g) + 1e-8)
        assert np.abs(params[path] - want).max() <= 2 * LR * (1 + 1e-3), path


def test_biased_running_variance_is_jax(jax_steps, tmp_path, monkeypatch):
    """The trap: torch's own batch norm updates the running variance with
    the unbiased batch variance, 8/7 of Flax's at the 2 x 2 x 2 deepest
    level of a 2 x 64^2 batch, which the one-step bar above catches."""
    _, jstate, batch, _, _, jstats, _ = jax_steps("unet_semseg")
    monkeypatch.setattr(layers.BatchNorm2d, "forward", torch.nn.BatchNorm2d.forward)
    state = _carry(jstate, tmp_path, "unet_semseg", pos_weight=15.0)
    tloop.make_train_step(state.model)(state, _torch(batch), LR)
    ours = _leaves(torch_to_flax_variables(state.model.network.state_dict())["batch_stats"])
    deep = ("encoder", "features_18", "bn", "var")
    want = np.asarray(_leaves(jstats)[deep])
    # running = 0.9 + 0.1 * batch_var: the unbiased update adds 0.1 * var / 7.
    excess = (ours[deep] - 0.9) / (want - 0.9)
    np.testing.assert_allclose(excess, 8 / 7, rtol=1e-3)
    assert np.abs(ours[deep] - want).max() > 100 * 1e-4


def test_one_value_per_channel_trains():
    """Flax normalises a batch of one value per channel (to the bias);
    torch's batch norm raises there."""
    bn = layers.BatchNorm2d(3).train()
    with torch.no_grad():
        bn.bias.copy_(torch.tensor([0.5, -1.0, 2.0]))
    x = torch.randn(1, 3, 1, 1, requires_grad=True)
    y = bn(x)
    np.testing.assert_array_equal(y.detach().numpy().ravel(), [0.5, -1.0, 2.0])
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * x.detach().numpy().ravel(),
                               rtol=1e-6)
    np.testing.assert_array_equal(bn.running_var.numpy(), np.full(3, 0.9, np.float32))
    y.sum().backward()
    with pytest.raises(ValueError):
        torch.nn.BatchNorm2d(3).train()(torch.randn(1, 3, 1, 1))


def test_bf16_step_close_to_f32(jax_states, tmp_path):
    """model.dtype=bfloat16: autocast compute, f32 parameters, f32 logits.
    From one carried JAX state and batch: the port's bf16 loss within 1e-2
    of JAX's own bf16 step's (measured 1.5e-3 to 6.8e-3 over seeds 8-11)
    and within 2e-2 of the port's f32 step's (1.9e-3 to 1.2e-2; JAX's own
    bf16 against f32 4.9e-3 to 1.0e-2); the bf16 route must differ from the
    f32 one (d > 0) and every convolution must return bf16, so a route that
    dropped autocast fails."""
    jm, jstate, _ = jax_states("unet_semseg")
    batch = _batch(8)
    jm16 = FlaxSegmentationModel(PRODUCTS, model_type="unet_semseg", encoder_weights=None,
                                 pos_weight=15.0, model_dtype=jnp.bfloat16)

    @jax.jit
    def jax_loss(b):
        logits, _ = jm16.apply({"params": jstate.params, "batch_stats": jstate.batch_stats},
                               b["input"], train=True)
        return jm16.loss_fn(logits, b["output"], b["weight_loss"])

    jloss16 = float(jax_loss(_jax(batch)))
    losses = {}
    for dtype in (None, torch.bfloat16):
        state = _carry(jstate, tmp_path, "unet_semseg", pos_weight=15.0, model_dtype=dtype)
        convs = [m for m in state.model.network.modules() if isinstance(m, torch.nn.Conv2d)]
        seen = []
        hooks = [m.register_forward_hook(lambda _m, _i, out: seen.append(out.dtype))
                 for m in convs]
        state, loss = tloop.make_train_step(state.model)(state, _torch(batch), LR)
        for h in hooks:
            h.remove()
        assert len(seen) == len(convs) and set(seen) == {dtype or torch.float32}, dtype
        losses[dtype] = float(loss)
        assert all(p.dtype == torch.float32 for p in state.model.parameters())
        state.model.eval()
        with torch.no_grad():
            assert state.model(_torch(batch)["input"]).dtype == torch.float32
    d = abs(losses[torch.bfloat16] - losses[None])
    assert 0 < d <= 2e-2 * abs(losses[None])
    np.testing.assert_allclose(losses[torch.bfloat16], jloss16, rtol=1e-2)


# ---------------------------------------------------------------------------
# Adam, the eval step
# ---------------------------------------------------------------------------


def test_adam_matches_optax():
    """The same gradient stream through optax.inject_hyperparams(optax.adam)
    and the port's Adam, with the learning rate halved after 3 steps; then
    the optimizer state carried both ways."""
    model = SegmentationModel(PRODUCTS, model_type="cnn", encoder_weights=None)
    model.init(torch.Generator().manual_seed(1))
    net = model.network
    params = torch_to_flax_variables(net.state_dict())["params"]
    params = jax.tree.map(jnp.asarray, params)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    opt_state = tx.init(params)
    opt = tloop.make_adam(model, 1e-3)
    rng = np.random.default_rng(5)
    names = dict(net.named_parameters())
    for step in range(6):
        lr = 1e-3 if step < 3 else 5e-4
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)
                                                   * 10 ** rng.uniform(-6, 0)), params)
        opt_state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        update, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, update)
        tgrads = flax_to_torch_state_dict({"params": jax.tree.map(np.asarray, grads)})
        for g in opt.param_groups:
            g["lr"] = lr
        for n, p in names.items():
            p.grad = tgrads[n]
        opt.step()
        got = _leaves(torch_to_flax_variables(net.state_dict())["params"])
        for path, want in _leaves(params).items():
            np.testing.assert_allclose(got[path], want, rtol=0, atol=1e-6, err_msg=str(path))
    flat = adam_state_to_flax(opt, net)
    want = j_flat_opt_state(opt_state)
    assert flat.keys() == want.keys()
    for k, v in want.items():  # mu near 0 cancels: an absolute floor per leaf
        np.testing.assert_allclose(flat[k], v, rtol=1e-5, atol=1e-6 * np.abs(v).max(),
                                   err_msg=k)
        assert flat[k].dtype == v.dtype, k
    # optax's state into a fresh port Adam: the next step agrees.
    fresh = copy.deepcopy(model)
    opt2 = tloop.make_adam(fresh, 1.0)
    adam_state_from_flax(want, fresh.network, opt2)
    assert opt2.param_groups[0]["lr"] == pytest.approx(5e-4)
    for n, p in fresh.network.named_parameters():
        p.grad = names[n].grad.clone()
    opt.step()
    opt2.step()
    for (n, a), b in zip(net.named_parameters(), fresh.network.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-7, err_msg=n)


def j_flat_opt_state(opt_state):
    """optax's state flattened as JAX's checkpoint writer flattens it."""
    from starcop_tpu.train.checkpoint import _flatten

    return _flatten(opt_state, "opt_state/")


def test_eval_step_matches_jax(tmp_path):
    """Both confusion matrices bitwise, with logits of exactly 0: a 1x1
    probe 2 * mag1c / 1750 - 1 is 0 at mag1c = 875, where ``logits >= 0``
    counts a detection and ``sigmoid > 0.5`` would not. The loss, a mean
    summed in another order than XLA's, within rtol 1e-6 (one f32 ulp
    here)."""
    jm = FlaxSegmentationModel(PRODUCTS, model_type="single", pos_weight=3.0)
    jstate, _ = jloop.create_train_state(jm, jax.random.PRNGKey(0),
                                         jnp.zeros((1, 4, 32, 32), jnp.float32))
    kernel = np.zeros((1, 1, 4, 1), np.float32)
    kernel[0, 0, 0, 0] = 2.0
    jstate = jstate.replace(params={"Conv_0": {"kernel": jnp.asarray(kernel),
                                               "bias": jnp.asarray([-1.0], jnp.float32)}})
    batch = _batch(11, b=4, size=32)
    zero = np.random.default_rng(12).random((4, 32, 32)) < 0.3
    batch["input"][:, 0][zero] = 875.0
    jloss, jcm, jcls = jloop.make_eval_step(jm)(jstate, _jax(batch))
    state = _carry(jstate, tmp_path, "single", pos_weight=3.0)
    with torch.no_grad():
        logits = state.model(torch.from_numpy(batch["input"]))
    assert int((logits == 0).sum()) == int(zero.sum()) > 0
    loss, cm, cls = tloop.make_eval_step(state.model)(state, _torch(batch))
    assert cm.dtype == cls.dtype == torch.int64
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    np.testing.assert_array_equal(cls.numpy(), np.asarray(jcls))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    detected = int(cm[:, 1].sum())
    assert detected == int((logits >= 0).sum()) > int((torch.sigmoid(logits) > 0.5).sum())


# ---------------------------------------------------------------------------
# Trainer.fit, checkpoints
# ---------------------------------------------------------------------------


def test_trainer_refuses_several_devices():
    """Outside a launched world several devices raise and name torchrun
    (one process per device); a mesh that is not a ``parallel.Mesh`` raises.
    Training over a world: tests/test_torch_parallel_train.py."""
    model = SegmentationModel(["mag1c"], model_type="single")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tloop.Trainer(model, device="cpu", n_devices=2)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        tloop.Trainer(model, device="cpu", mesh=object())
