"""The port's bf16 stream (K2's bf16 dots, K3 and K4) against the JAX package.

The layout kernels' twins (``blocked_transpose``, ``init_stats`` for row
10, ``init_stats_bsp``), the
masked bf16 round twin (``filter_round_bsp`` with ``bf16_dots``) and both
bf16 routes of ``mag1c_column_blocks`` are held against the Pallas kernels
in interpret mode on the same inputs, made with numpy seeds; the
bf16-resident U-Net (``cast_for_inference``) against ``model_dtype=bf16`` with
``cast_variables_for_inference``. JAX runs with float32 pinned (the test
configuration turns x64 on).

Bars: bitwise for the layouts; 1e-5 relative for statistics and single
rounds on the same bf16 stream (f32 sums in another order); the JAX suite's
bf16 detection contract (tests/test_mag1c.py:199-217) for whole filters,
whose 30-odd reweighting rounds amplify rounding near the threshold.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

torch = pytest.importorskip("torch")

from starcop_tpu.models import SegmentationModel as FlaxSegmentationModel  # noqa: E402
from starcop_tpu.models import cast_variables_for_inference  # noqa: E402
from starcop_tpu.ops import mag1c as jm  # noqa: E402
from starcop_tpu.ops import mag1c_pallas as jp  # noqa: E402
from starcop_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from starcop_tpu_torch.models.segmenter import (  # noqa: E402
    EMIT_INPUT_PRODUCTS,
    SegmentationModel,
    cast_for_inference,
)
from starcop_tpu_torch.models.weights import flax_to_torch_state_dict  # noqa: E402
from starcop_tpu_torch.ops import mag1c as tm  # noqa: E402
from starcop_tpu_torch.ops import mag1c_kernels as tk  # noqa: E402
from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands  # noqa: E402
from tests.test_mag1c import assert_bf16_detection_equivalent  # noqa: E402

H, W, S, NB, STEP = 128, 48, 12, 3, 16
ROWS = tk.stream_rows(S)


def _cube():
    """tests/test_torch_mag1c.py's direct-swh geometry and plume."""
    rng = np.random.default_rng(11)
    template = -np.abs(np.sin(np.linspace(0.3, 3 * np.pi, S)))
    base = rng.uniform(2.0, 6.0, size=(1, 1, S))
    x = rng.uniform(0.5, 2.0, (H, W, 1)) * base * (1 + 0.02 * rng.normal(size=(H, W, S)))
    conc = np.zeros((H, W))
    conc[40:80, 10:30] = rng.uniform(1000, 6000, size=(40, 20))
    x = x * np.exp(conc[..., None] * template[None, None, :] / 1e5)
    return x.astype(np.float32), template.astype(np.float32)


def _masked_case():
    """The cube cut to a ragged width (45 = 2 * 16 + 13), the fill value in
    every band at invalid pixels (a rectangle and 1 % scattered)."""
    x, tpl = _cube()
    x = x[:, :45].copy()
    valid = np.random.default_rng(7).random((H, 45)) >= 0.01
    valid[5:9, 3:30] = False
    x[~valid] = tm.NODATA
    return x, tpl, valid


def _rel(a, ref) -> float:
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


# ---------------------------------------------------------------------------
# The layout kernels (K4, K3's init statistics)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row", ["blocked_transpose", "blocked_transpose_swh"])
def test_blocked_transpose_twin_matches_pallas_bitwise(row):
    """Row 1 at H = 64, row 2 at H = 128 (H % 128 == 0, W % 8 == 0) with its
    j-major pixel order permuted to the port's h-major; pad rows included.
    The twin writes the bf16 stream, so it is centred on m0 = 0 and held
    against the Pallas layout rounded to bf16 as XLA's astype does."""
    h = 64 if row == "blocked_transpose" else 128
    x = np.random.default_rng(1).normal(size=(h, W, S)).astype(np.float32)
    got = tk.blocked_transpose_plain(torch.from_numpy(x), NB, STEP, ROWS, torch.zeros(NB, S))
    assert got.dtype == torch.bfloat16 and got.shape == (NB, ROWS, h * STEP)
    assert not got[:, S:].any()
    if row == "blocked_transpose":
        want = np.asarray(jp.blocked_transpose(jnp.asarray(x), NB, STEP, pad_s=ROWS,
                                               interpret=True))
    else:
        swh = jnp.transpose(jnp.asarray(x), (2, 1, 0))
        want = np.asarray(jp.blocked_transpose_swh(swh, NB, STEP, pad_s=ROWS, interpret=True))
        want = want.reshape(NB, ROWS, STEP, h).transpose(0, 1, 3, 2).reshape(NB, ROWS, -1)
    want = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_blocked_transpose_twin_centres_masks_and_rounds():
    """The bf16 routes' options: x - m0 rounded to bf16 (nearest even, as
    JAX's astype) at the pixels that count, exactly 0 elsewhere and past W."""
    x, tpl, valid = _masked_case()
    m0 = np.random.default_rng(2).uniform(1, 5, (NB, S)).astype(np.float32)
    got = tk.blocked_transpose_plain(torch.from_numpy(x), NB, STEP, ROWS, torch.from_numpy(m0),
                                     valid=torch.from_numpy(valid))
    assert got.dtype == torch.bfloat16 and got.shape == (NB, ROWS, H * STEP)
    xp = np.pad(x, ((0, 0), (0, NB * STEP - 45), (0, 0)))
    vp = np.pad(valid, ((0, 0), (0, NB * STEP - 45)))
    xb = xp.reshape(H, NB, STEP, S).transpose(1, 3, 0, 2).reshape(NB, S, -1)
    keep = vp.reshape(H, NB, STEP).transpose(1, 0, 2).reshape(NB, 1, -1)
    want = jnp.asarray(np.where(keep, xb - m0[:, :, None], 0.0).astype(np.float32))
    want = np.asarray(want.astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(got[:, :S].float().numpy(), want)
    assert not got[:, S:].any()


def test_init_stats_bsp_twin_matches_pallas():
    """Row 10 (_init_stats_kernel on JAX's blocked f32 copy) against the
    unmasked bf16 route's statistics, ``init_stats`` on the cube itself; the
    init_stats_bsp twin against the XLA second moment of a centred bf16
    stream (mag1c_pallas.py:1814-1824) with n per block."""
    x, _ = _cube()
    xt = torch.from_numpy(x)
    m0, c0 = tk.init_stats_plain(xt, NB, STEP)
    xb_j = jp.blocked_transpose(jnp.asarray(x), NB, STEP, pad_s=ROWS, interpret=True)
    m_j, c_j = jp._make_init_stats_call(NB, H * STEP, ROWS, 1.0 / (H * STEP), True)(xb_j)
    m_j, c_j = np.asarray(m_j)[:, :S, 0], np.asarray(c_j)
    assert _rel(m0, m_j) <= 1e-5 and _rel(c0, c_j[:, :S, :S]) <= 1e-5
    assert not c_j[:, S:].any()

    xs = tk.blocked_transpose_plain(xt, NB, STEP, ROWS, m0)
    n = torch.tensor([2048.0, 1500.0, 1.0])
    c1 = tk.init_stats_bsp_plain(xs, n, S)
    xs_j = jnp.asarray(xs.float().numpy()).astype(jnp.bfloat16)
    want = jnp.einsum("bsp,btp->bst", xs_j, xs_j, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST) / jnp.asarray(n.numpy())[:, None, None]
    want = np.asarray(want)
    assert c1.dtype == torch.float32 and c1.shape == (NB, S, S)
    assert _rel(c1, want[:, :S, :S]) <= 1e-5
    assert not want[:, S:].any()  # the zero pad rows add nothing: the twin keeps S rows


def _masked_stream():
    """The masked route's inputs at test size: f32 block means over the
    valid pixels, the centred masked bf16 stream, its statistics and the
    Woodbury base (port twins), and JAX's weight rows."""
    x, tpl, valid = _masked_case()
    xt, vt, tt = torch.from_numpy(x), torch.from_numpy(valid), torch.from_numpy(tpl)
    n = tk.block_valid_counts(vt, NB, STEP).clamp(min=1).float()
    m0 = tk.masked_block_means(xt, vt, NB, STEP, n)
    xs = tk.blocked_transpose_plain(xt, NB, STEP, ROWS, m0, valid=vt)
    c0 = tk.init_stats_bsp_plain(xs, n, S)
    base = tk._woodbury_base(c0, m0, tt, 1e-4)
    wb = tk._keep_rows(vt, NB, STEP).float()
    return xs, vt, tt, n, m0, base, wb


def _stats_ref(xs, mf, r):
    """[u | sum g | sum g^2] in f64 from a round's mf and R, with g = R mf
    rounded to bf16 for u (JAX's _lane_dot, mag1c_pallas.py:555-574)."""
    g = np.asarray(r, np.float32) * np.asarray(mf, np.float32)
    g16 = np.asarray(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32), np.float64)
    u = np.einsum("bsp,bp->bs", xs[:, :S].float().numpy().astype(np.float64), g16)
    g = g.astype(np.float64)
    return np.concatenate([u, g.sum(1, keepdims=True), (g * g).sum(1, keepdims=True)], 1)


def test_filter_round_bsp_twin_matches_pallas_bf16_rounds():
    """The masked bf16-dots twin against _first_round_kernel and
    _loop_round_kernel (rows 5-6, bf16_dots=True, interpret mode) on the same
    bf16 stream and carry: mf and R within 1e-5 relative, the statistics
    within 1e-5 relative of their f64 sums over JAX's own round."""
    xs, vt, tt, n, m0, (k0, tgt0, cit0, norm0), wb = _masked_stream()
    p = H * STEP
    first, loop = jp._make_round_calls(NB, p, S, 256, 1.0, 1e-4, True, has_w=True,
                                       bf16_dots=True)
    f32 = lambda t: jnp.asarray(np.asarray(t, np.float32))  # noqa: E731
    xs_j = f32(xs[:, :S].float().numpy()).astype(jnp.bfloat16)
    consts = [f32(m0)[:, :, None], f32(tt)[None, :, None], f32(k0), f32(1.0 / n)[:, None, None]]
    w_row = f32(wb)[:, None, :]
    mf_j, r_j, *carry_j = first(xs_j, w_row, f32(cit0)[:, :, None], f32(norm0)[:, None, None],
                                *consts)

    carry = tk.pack_carry(tgt0, cit0, norm0)
    mf, r, stats = tk.filter_round_bsp_plain(xs, vt, STEP, m0, carry, None, None, mode=tk.FIRST,
                                             bf16_dots=True)
    assert _rel(mf, mf_j[:, 0]) <= 1e-5 and _rel(r, r_j[:, 0]) <= 1e-5
    assert _rel(stats[:, 0], _stats_ref(xs, mf_j[:, 0], r_j[:, 0])) <= 1e-5
    assert (mf[wb == 0] == 0).all() and (r[wb == 0] == 1).all()

    # LOOP from JAX's first-round carry: (mu, target, cit, norm).
    mu, target, cit, norm = (np.asarray(c, np.float32) for c in carry_j)
    carry_loop = torch.from_numpy(np.stack([mu[..., 0], target[..., 0], cit[..., 0],
                                            np.broadcast_to(norm[:, 0], (NB, S))], axis=1))
    mf2_j = loop(xs_j, w_row, r_j, mf_j, *(f32(c) for c in carry_j), *consts)[0]
    mf2, _, stats2 = tk.filter_round_bsp_plain(
        xs, vt, STEP, m0, carry_loop, torch.tensor(np.asarray(r_j)[:, 0]),
        torch.tensor(np.asarray(mf_j)[:, 0]), mode=tk.LOOP, bf16_dots=True)
    assert _rel(mf2, mf2_j[:, 0]) <= 1e-5
    assert _rel(stats2[:, 0], _stats_ref(xs, mf2_j[:, 0], r_j[:, 0])) <= 1e-5


# ---------------------------------------------------------------------------
# The bf16 routes of mag1c_column_blocks end to end
# ---------------------------------------------------------------------------


def _emit_scene(masked: bool):
    """A 256 x 96 synthetic scene on the 50-band EMIT-like template, the
    serving column_step 32; masked: cut to a ragged 93 columns with the fill
    value at invalid pixels (a rectangle and 1 % scattered)."""
    centers = np.arange(2122.0, 2488.0, 7.4)
    tpl = generate_template_from_bands(centers, np.full_like(centers, 8.0))[:, 1]
    x = synthetic_scene(np.random.default_rng(0), 256, 96, n_plumes=2, template=tpl)["radiance"]
    if not masked:
        return x, tpl.astype(np.float32), None
    x = x[:, :93].copy()
    valid = np.random.default_rng(7).random(x.shape[:2]) >= 0.01
    valid[5:9, 3:30] = False
    x[~valid] = tm.NODATA
    return x, tpl.astype(np.float32), valid


@pytest.mark.parametrize("case", ["unmasked", "masked_ragged"])
def test_column_blocks_bf16_match_pallas(case):
    """Port vs JAX at stream_dtype=bf16 (use_pallas, interpret): the resident
    bsp route (rows 2, 10, 9) unmasked, the bf16-dots rounds (rows 5-6)
    masked and ragged. Each is also held to the contract against JAX's f32.

    The L1 reweighting pins a pixel whose early mf touches 0, so under any
    half-precision stream a few near-zero starts go the other way; on small
    blocks some of them end decisive. The scene is one on which JAX's own
    bf16 route meets its contract against its f32 route (asserted first)."""
    x, tpl, valid = _emit_scene(case == "masked_ragged")
    kw = dict(column_step=32, num_iter=8, alpha=1e-4)
    jkw = dict(use_pallas=True, interpret=True, **kw)
    mf_j, alb_j = jm.mag1c_column_blocks(jnp.asarray(x), jnp.asarray(tpl), valid,
                                         stream_dtype=jnp.bfloat16, **jkw)
    mf_f, _ = jm.mag1c_column_blocks(jnp.asarray(x), jnp.asarray(tpl), valid, **jkw)
    keep = np.ones(x.shape[:2], bool) if valid is None else valid
    mf_j, alb_j, mf_f = np.asarray(mf_j), np.asarray(alb_j), np.asarray(mf_f)
    assert (mf_f[keep] > 1000).sum() > 100
    assert_bf16_detection_equivalent(mf_f[keep], mf_j[keep])

    mf, alb = tm.mag1c_column_blocks(x, tpl, valid, stream_dtype=torch.bfloat16, device="cpu",
                                     **kw)
    assert mf.dtype == torch.float32 and mf.shape == x.shape[:2]
    mf, alb = mf.numpy(), alb.numpy()
    np.testing.assert_array_equal(mf == tm.NODATA, ~keep)
    np.testing.assert_array_equal(mf_j == tm.NODATA, ~keep)
    assert_bf16_detection_equivalent(mf_j[keep], mf[keep])
    assert_bf16_detection_equivalent(mf_f[keep], mf[keep])
    np.testing.assert_allclose(alb[keep], alb_j[keep], rtol=5e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_flips_on_small_blocks_are_jax_own(seed):
    """Why the whole-filter bf16 checks run on blocks of >= 8,192 pixels: at
    2,048-pixel blocks (64 rows, column_step 32) JAX's own bf16 route
    (interpret mode) breaks its contract's no-decisive-flip clause against
    its f32 route, every flip a pixel the f32 filter pins near 0 that ends
    above 500 under bf16 dots; the port's bf16 route flips only pixels that
    JAX's flips as well."""
    centers = np.arange(2122.0, 2488.0, 7.4)
    tpl = generate_template_from_bands(centers, np.full_like(centers, 8.0))[:, 1]
    tpl = tpl.astype(np.float32)
    x = synthetic_scene(np.random.default_rng(seed), 64, 96, n_plumes=2, template=tpl)["radiance"]
    x = x[:, :93].copy()
    valid = np.random.default_rng(7).random(x.shape[:2]) >= 0.01
    x[~valid] = tm.NODATA
    kw = dict(column_step=32, num_iter=8, alpha=1e-4)
    jkw = dict(use_pallas=True, interpret=True, **kw)
    ref = np.asarray(jm.mag1c_column_blocks(jnp.asarray(x), jnp.asarray(tpl), valid, **jkw)[0],
                     np.float64)[valid]

    def flips(mf):
        got = np.asarray(mf, np.float64)[valid]
        flipped = ((ref > 500) != (got > 500)) & ((ref < 250) | (ref > 1000))
        assert (got[flipped] > 500).all() and (ref[flipped] < 250).all()
        return set(np.flatnonzero(flipped).tolist())

    jax_flips = flips(jm.mag1c_column_blocks(jnp.asarray(x), jnp.asarray(tpl), valid,
                                             stream_dtype=jnp.bfloat16, **jkw)[0])
    port_flips = flips(tm.mag1c_column_blocks(x, tpl, valid, stream_dtype=torch.bfloat16,
                                              device="cpu", **kw)[0])
    assert jax_flips and port_flips <= jax_flips


def test_bsp_whole_filter_twin_is_the_route():
    """On the CPU both bf16 filters are bsp_filter_plain run from the twins'
    statistics and Woodbury base (on the card chip_smoke.py holds the
    kernels to the same twin), and they refuse what the kernel route does.
    The unmasked one starts from K1's statistics of the cube."""
    x, tpl = _cube()
    xt, tt = torch.from_numpy(x), torch.from_numpy(tpl)
    mf, r = tk.acrwl1mf_resident_bsp(xt, tt, NB, STEP, num_iter=3, alpha=1e-4, device="cpu")
    m0, c0 = tk.init_stats_plain(xt, NB, STEP)
    base = tk._woodbury_base(c0, m0, tt, 1e-4)
    xs = tk.blocked_transpose_plain(xt, NB, STEP, ROWS, m0)
    mf2, r2 = tk.bsp_filter_plain(xs, None, STEP, m0, *base, tt, H * STEP, num_iter=3,
                                  alpha=1e-4)
    assert torch.equal(mf, mf2) and torch.equal(r, r2)

    xs_m, vt, _, n, m0_m, base_m, _ = _masked_stream()
    xm = torch.from_numpy(_masked_case()[0])
    mf, r = tk.acrwl1mf_masked_bf16(xm, tt, vt, NB, STEP, num_iter=3, alpha=1e-4, device="cpu")
    mf2, r2 = tk.bsp_filter_plain(xs_m, vt, STEP, m0_m, *base_m, tt, n, bf16_dots=True,
                                  num_iter=3, alpha=1e-4)
    assert torch.equal(mf, mf2) and torch.equal(r, r2)
    with pytest.raises(ValueError, match="num_iter"):
        tk.bsp_filter_plain(xs, None, STEP, m0, *base, tt, H * STEP, num_iter=0)
    with pytest.raises(ValueError, match="nb\\*step"):
        tk.acrwl1mf_resident_bsp(xt, tt, NB, 15, device="cpu")
    with pytest.raises(ValueError, match="do not fit"):
        tk.acrwl1mf_masked_bf16(xm, tt, vt, NB, 14, device="cpu")


# ---------------------------------------------------------------------------
# The bf16-resident U-Net
# ---------------------------------------------------------------------------


def test_bf16_resident_unet_matches_jax():
    """cast_for_inference against JAX's model_dtype=bf16 +
    cast_variables_for_inference on the same seeded variables: logit
    correlation > 0.999 (tests/test_models.py:255), f32 logits, and every
    float parameter and batch-norm buffer narrowed once. The kernels are
    LeCun-normal (fan-in), Flax's default, as in that test; the batch-norm
    statistics are randomised."""
    jmodel = FlaxSegmentationModel(list(EMIT_INPUT_PRODUCTS), model_type="unet_semseg",
                                   model_dtype=jnp.bfloat16, encoder_weights=None)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 4, 32, 32), jnp.float32)))
    rng = np.random.default_rng(0)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":  # (kh, kw, in, out)
            v = rng.normal(size=leaf.shape) / np.sqrt(np.prod(leaf.shape[:3]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, leaf.shape)
        else:
            v = rng.normal(0, 0.05, leaf.shape)
        return v.astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    x = rng.uniform(0, 100, (2, 4, 64, 64)).astype(np.float32)
    want = np.asarray(jmodel.apply(cast_variables_for_inference(variables), jnp.asarray(x),
                                   train=False))

    model = SegmentationModel(EMIT_INPUT_PRODUCTS)
    model.network.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    assert cast_for_inference(model) is model
    model.eval()
    floats = [t for t in list(model.network.parameters()) + list(model.network.buffers())
              if t.is_floating_point()]
    assert floats and all(t.dtype == torch.bfloat16 for t in floats)
    assert model.normalizer.factors.dtype == torch.float32
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 1, 64, 64)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999


def test_granule_to_mask_entry_points_take_the_bf16_stream():
    """emit_granule_to_mask and its batched variant pass stream_dtype to the
    filter: the single call's mf is mag1c_column_blocks' bf16 result, and a
    batch of two scenes gives each scene's own (column blocks never straddle
    scenes); an unknown stream dtype raises before any work."""
    from starcop_tpu_torch.scenes import emit_pipeline as tpipe

    x, tpl, _ = _emit_scene(False)
    cubes = np.stack([x[:, :64], x[:, 32:]])
    rgbs = np.random.default_rng(3).uniform(0, 60, (2, 3) + cubes.shape[1:3]).astype(np.float32)
    probe = lambda b: b[:, :1] / 1750.0 - 0.5  # noqa: E731
    kw = dict(column_step=32, num_iter=4, stream_dtype=torch.bfloat16, device="cpu")
    pred, mf = tpipe.emit_granule_to_mask(cubes[0], rgbs[0], tpl, probe, **kw)
    want, _ = tm.mag1c_column_blocks(cubes[0], tpl, None, alpha=1e-4, **kw)
    assert torch.equal(mf, want) and pred.shape == mf.shape == cubes.shape[1:3]
    pred_b, mf_b = tpipe.emit_granule_to_mask_batched(cubes, rgbs, tpl, probe, **kw)
    for i in range(2):
        one_p, one_mf = tpipe.emit_granule_to_mask(cubes[i], rgbs[i], tpl, probe, **kw)
        torch.testing.assert_close(mf_b[i], one_mf, rtol=1e-4, atol=1e-2)
        torch.testing.assert_close(pred_b[i], one_p, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="stream_dtype"):
        tpipe.emit_granule_to_mask(cubes[0], rgbs[0], tpl, probe,
                                   **dict(kw, stream_dtype=torch.float16))
