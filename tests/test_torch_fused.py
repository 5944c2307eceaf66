"""The port's acrwl1mf_fused (every glue, both layouts), blocked_transpose_shw
and mag1c_column_blocks(scene_layout="shw") against the JAX package.

Same inputs, made with numpy seeds, go through JAX's function (Pallas
kernels in interpret mode) and the port's on the CPU, where the kernel
wrappers run their plain twins. JAX runs with float32 pinned (the test
configuration turns x64 on).

Bars: JAX's own cross-glue bar (tests/test_mag1c.py:437-445: mf correlation
> 0.99999, threshold-500 agreement > 0.999, median relative error < 1e-3
over mf > 100) and R within rtol 1e-5 for f32 routes, on the direct-swh
cube of tests/test_torch_mag1c.py, on which JAX's own bps and bsp routes
agree inside that bar (on the conftest fixture they do not:
test_cross_glue_bar_holds_on_the_cube_not_the_fixture); the JAX suite's
bf16 contract (tests/test_mag1c.py:199-217) at bf16, on 8,192-pixel blocks
of an EMIT-like scene where JAX's own bf16 routes meet it; bitwise for the
layout; tests/test_mag1c.py:462's rtol 2e-4 / atol 2e-3 between the port's
own shw and hws routes where they share kernels (masked), and the distance
to the float64 twin where they do not.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.ops import mag1c as jm  # noqa: E402
from starcop_tpu.ops import mag1c_pallas as jp  # noqa: E402
from starcop_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from starcop_tpu_torch.ops import mag1c as tm  # noqa: E402
from starcop_tpu_torch.ops import mag1c_fused as tf  # noqa: E402
from starcop_tpu_torch.ops import mag1c_kernels as tk  # noqa: E402
from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands  # noqa: E402
from tests.test_mag1c import assert_bf16_detection_equivalent  # noqa: E402
from tests.test_torch_mag1c import _assert_detection_parity, _cube, _FakeKernels  # noqa: E402

H, W, S, NB, STEP = 128, 48, 12, 3, 16
KW = dict(num_iter=6, alpha=1e-4)


def _blocks():
    """tests/test_torch_mag1c.py's direct-swh cube as JAX's (B, P, S) column
    blocks, (3, 2048, 12) f32, and its template."""
    x, template = _cube()
    return np.ascontiguousarray(tm.block_columns(torch.from_numpy(x), NB, STEP).numpy()), template


def _layout(x, layout):
    """(x, weights, x_layout) of a test case: bps, bps with a weight row whose
    last 40 pixels are 0, the raw (B, S, P) stream, or that stream padded to
    ceil8(S) zero rows."""
    if layout == "bps":
        return x, None, "bps"
    if layout == "bps_weights":
        w = np.ones(x.shape[:2], np.float32)
        w[:, -40:] = 0.0
        return x, w, "bps"
    xt = np.ascontiguousarray(np.swapaxes(x, 1, 2))
    if layout == "bsp_padded":
        xt = np.pad(xt, ((0, 0), (0, tk.stream_rows(S) - S), (0, 0)))
    return xt, None, "bsp"


def _cross_glue_bar(mf, ref):
    """tests/test_mag1c.py:437-445."""
    a, b = np.asarray(ref, np.float64).ravel(), np.asarray(mf, np.float64).ravel()
    assert np.corrcoef(a, b)[0, 1] > 0.99999
    assert (a > 500).sum() > 0 and ((a > 500) == (b > 500)).mean() > 0.999
    det = a > 100
    assert np.median(np.abs(b - a)[det] / a[det]) < 1e-3


CASES = [(g, lay) for g in tf.GLUES for lay in ("bps", "bps_weights", "bsp")]
CASES += [("mono", "bsp_padded"), ("resident", "bsp_padded")]


@pytest.mark.parametrize("glue,layout", CASES)
def test_acrwl1mf_fused_matches_jax(glue, layout):
    x, tpl = _blocks()
    xx, w, x_layout = _layout(x, layout)
    mf_j, r_j = jp.acrwl1mf_fused(jnp.asarray(xx), jnp.asarray(tpl),
                                  None if w is None else jnp.asarray(w), glue=glue,
                                  x_layout=x_layout, tile_p=256, interpret=True, **KW)
    mf, r = tf.acrwl1mf_fused(xx, tpl, w, glue=glue, x_layout=x_layout, device="cpu", **KW)
    assert mf.shape == r.shape == (NB, H * STEP, 1) and mf.dtype == torch.float32
    _cross_glue_bar(mf, mf_j)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j), rtol=1e-5)
    if w is not None:
        assert (mf.numpy()[w == 0] == 0).all() and (r.numpy()[w == 0] == 1).all()


def test_cross_glue_bar_holds_on_the_cube_not_the_fixture(synthetic_radiance):
    """Why the cases above run on the direct-swh cube: on the conftest
    fixture JAX's own resident route parts between the raw bsp stream and
    the bps layout below the cross-glue bar's correlation (its raw-stream
    mean rounds apart from its bps mean in f32, and the fixture's deep
    plumes amplify that), while on the cube the two agree inside it."""
    def layouts_corr(x, tpl):
        kw = dict(glue="resident", tile_p=256, interpret=True, **KW)
        a = jp.acrwl1mf_fused(jnp.asarray(x), jnp.asarray(tpl), **kw)[0]
        b = jp.acrwl1mf_fused(jnp.asarray(np.swapaxes(x, 1, 2)), jnp.asarray(tpl),
                              x_layout="bsp", **kw)[0]
        return np.corrcoef(np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel())[0, 1]

    x64, tpl64 = synthetic_radiance
    fixture = layouts_corr(x64.astype(np.float32), tpl64.astype(np.float32))
    assert fixture < 0.99999 < layouts_corr(*_blocks())


def _emit_blocks():
    """tests/test_torch_bf16.py's EMIT-like 256 x 96 scene as 3 column
    blocks of 8,192 pixels (column_step 32), (3, 8192, 50) f32."""
    centers = np.arange(2122.0, 2488.0, 7.4)
    tpl = generate_template_from_bands(centers, np.full_like(centers, 8.0))[:, 1]
    x = synthetic_scene(np.random.default_rng(0), 256, 96, n_plumes=2, template=tpl)["radiance"]
    xb = x.reshape(256, 3, 32, -1).transpose(1, 0, 2, 3).reshape(3, 256 * 32, -1)
    return xb.astype(np.float32), tpl.astype(np.float32)


@pytest.mark.parametrize("glue,layout", [("mono", "bsp"), ("woodbury", "bps"), ("fused", "bps")])
def test_acrwl1mf_fused_bf16_matches_jax(glue, layout):
    """bf16 streams: mono with bf16 dots (:976), woodbury with bf16 storage
    and f32 products (:412), fused with bf16 dots (:1897). The port's bf16
    route meets the contract against JAX's bf16 route and against its own
    f32 route (JAX's bf16 routes meet it against theirs on these blocks, as
    on the scene they are cut from, tests/test_torch_bf16.py)."""
    x, tpl = _emit_blocks()
    xx, _, x_layout = _layout(x, layout)
    kw = dict(glue=glue, x_layout=x_layout, num_iter=8, alpha=1e-4)
    mf_j, r_j = jp.acrwl1mf_fused(jnp.asarray(xx), jnp.asarray(tpl), None,
                                  stream_dtype=jnp.bfloat16, tile_p=2048, interpret=True, **kw)
    mf_f, _ = tf.acrwl1mf_fused(xx, tpl, device="cpu", **kw)
    mf, r = tf.acrwl1mf_fused(xx, tpl, stream_dtype=torch.bfloat16, device="cpu", **kw)
    mf_f, mf = mf_f.numpy().ravel(), mf.numpy().ravel()
    assert (mf_f > 1000).sum() > 100
    assert_bf16_detection_equivalent(np.asarray(mf_j).ravel(), mf)
    assert_bf16_detection_equivalent(mf_f, mf)
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j), rtol=1e-4)


REFUSALS = {
    "num_iter": (dict(num_iter=0), "num_iter must be >= 1"),
    "bsp_weights": (dict(x_layout="bsp", weights=True), "weights=None"),
    "bsp_bands": (dict(x_layout="bsp", rows=S + 1), "band dim"),
    "prepadded_woodbury": (dict(x_layout="bsp", rows=16, glue="woodbury"), "pre-padded"),
    "prepadded_fused": (dict(x_layout="bsp", rows=16, glue="fused"), "pre-padded"),
    "glue": (dict(glue="xla"), "glue must be"),
    "x_layout": (dict(x_layout="spb"), "x_layout must be"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_acrwl1mf_fused_refuses(case):
    """JAX's semantic ValueErrors (:1660, :1671, :1676, :1734), and an unknown
    glue or layout, which JAX would take as cholesky or bps."""
    args, match = REFUSALS[case]
    x, tpl = _blocks()
    args = dict(args)
    rows, weights = args.pop("rows", S), args.pop("weights", None)
    if args.get("x_layout") == "bsp":
        x = np.zeros((NB, rows, 256), np.float32)
    w = np.ones(x.shape[::2], np.float32) if weights else None
    with pytest.raises(ValueError, match=match):
        tf.acrwl1mf_fused(x, tpl, w, device="cpu", **args)


# ---------------------------------------------------------------------------
# Row 3 and the band-major cube
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("h,nb,step,s,pad_s", [(64, 3, 18, 7, None), (64, 2, 54, 50, 56),
                                                (96, 4, 16, 24, None)])
def test_blocked_transpose_shw_twin_matches_pallas_bitwise(h, nb, step, s, pad_s):
    """tests/test_mag1c.py:596-600's geometries, pad rows included."""
    x = np.random.default_rng(7).normal(size=(h, nb * step, s)).astype(np.float32)
    xs = np.ascontiguousarray(x.transpose(2, 0, 1))
    rows = pad_s or s
    want = np.asarray(jp.blocked_transpose_shw(jnp.asarray(xs), nb, step, pad_s=pad_s,
                                               interpret=True))
    got = tk.blocked_transpose_shw(torch.from_numpy(xs), nb, step, rows)
    assert got.dtype == torch.float32 and got.shape == (nb, rows, h * step)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="width"):
        tk.blocked_transpose_shw(torch.from_numpy(xs)[:, :, 1:], nb, step, rows)


def _shw_scene():
    """tests/test_mag1c.py:618's scene: (H, W, S) = (64, 36, 12) and its
    band-major copy."""
    rng = np.random.default_rng(11)
    h, w, s = 64, 36, 12
    template = -np.abs(np.sin(np.linspace(0.3, 3 * np.pi, s)))
    base = rng.uniform(2.0, 6.0, size=(1, 1, s))
    x = rng.uniform(0.5, 2.0, (h, w, 1)) * base * (1 + 0.02 * rng.normal(size=(h, w, s)))
    conc = np.zeros((h, w))
    conc[10:20, 4:12] = rng.uniform(1000, 6000, size=(10, 8))
    x = (x * np.exp(conc[..., None] * template[None, None, :] / 1e5)).astype(np.float32)
    return x, np.ascontiguousarray(x.transpose(2, 0, 1)), template.astype(np.float32)


def _bar_misses(mf, ref):
    """Pixels outside tests/test_mag1c.py:462's bar (rtol 2e-4, atol 2e-3)."""
    mf, ref = np.asarray(mf, np.float64), np.asarray(ref, np.float64)
    return int((np.abs(mf - ref) > 2e-3 + 2e-4 * np.abs(ref)).sum())


@pytest.mark.parametrize("masked", [False, True])
def test_column_blocks_shw_matches_jax_and_hws(masked):
    """Unmasked (step 18: row 3, row 10 on the stream, the resident rounds)
    and masked with a ragged last block (step 16, restated as (H, W, S)):
    against JAX's shw (use_pallas, interpret) and the port's own hws route.

    Masked, both layouts take the same route and meet tests/test_mag1c.py:
    462's bar. Unmasked they run different kernels, and that bar is below
    this scene's f32 noise: the hws route itself misses it against its own
    float64 twin on ~220 background pixels (mf < 25, the L1 reweighting
    amplifies their rounding), so the shw route is held to detection parity
    with the hws route and to miss the bar against the f64 twin on no more
    pixels than the hws route does."""
    x, xs, tpl = _shw_scene()
    mask = None
    kw = dict(column_step=18, num_iter=4, alpha=1e-4)
    if masked:
        mask = np.ones(x.shape[:2], bool)
        mask[:, -5:] = False
        kw["column_step"] = 16
    mf_j, alb_j = jm.mag1c_column_blocks(jnp.asarray(xs), jnp.asarray(tpl), mask,
                                         scene_layout="shw", use_pallas=True, interpret=True,
                                         **kw)
    mf, alb = tm.mag1c_column_blocks(xs, tpl, mask, scene_layout="shw", device="cpu", **kw)
    assert mf.shape == x.shape[:2] and mf.dtype == torch.float32
    keep = np.ones(x.shape[:2], bool) if mask is None else mask
    mf_j, alb_j = np.asarray(mf_j), np.asarray(alb_j)
    np.testing.assert_array_equal(mf.numpy() == tm.NODATA, ~keep)
    np.testing.assert_array_equal(mf_j == tm.NODATA, ~keep)
    _assert_detection_parity(mf.numpy()[keep], mf_j[keep], alb.numpy()[keep], alb_j[keep])
    mf_h, alb_h = tm.mag1c_column_blocks(x, tpl, mask, device="cpu", **kw)
    np.testing.assert_allclose(alb.numpy(), alb_h.numpy(), rtol=1e-5)
    if masked:
        np.testing.assert_allclose(mf.numpy(), mf_h.numpy(), rtol=2e-4, atol=2e-3)
        return
    _assert_detection_parity(mf.numpy(), mf_h.numpy(), alb.numpy(), alb_h.numpy())
    nb, step = 2, kw["column_step"]
    xd, td = torch.from_numpy(x).double(), torch.from_numpy(tpl).double()
    m0, c0 = tk.init_stats_plain(xd, nb, step)
    mf_64, _ = tk.resident_filter_plain(xd, nb, step, m0, *tk._woodbury_base(c0, m0, td, 1e-4),
                                        td, num_iter=4, alpha=1e-4)
    mf_64 = tm.unblock_columns(mf_64, x.shape[0], step).numpy()
    assert 0 < _bar_misses(mf.numpy(), mf_64) <= _bar_misses(mf_h.numpy(), mf_64)


def test_column_blocks_shw_bf16_meets_contract():
    """The shw route at bf16 reads the centred bf16 copy of the stream
    (:1702-1707): the bf16 contract against its own f32 route and against
    JAX's bf16 shw route, on tests/test_torch_bf16.py's EMIT-like scene."""
    centers = np.arange(2122.0, 2488.0, 7.4)
    tpl = generate_template_from_bands(centers, np.full_like(centers, 8.0))[:, 1]
    tpl = tpl.astype(np.float32)
    x = synthetic_scene(np.random.default_rng(0), 256, 96, n_plumes=2, template=tpl)["radiance"]
    xs = np.ascontiguousarray(x.transpose(2, 0, 1))
    kw = dict(column_step=32, num_iter=8, alpha=1e-4, scene_layout="shw")
    mf_f, _ = tm.mag1c_column_blocks(xs, tpl, None, device="cpu", **kw)
    mf, _ = tm.mag1c_column_blocks(xs, tpl, None, stream_dtype=torch.bfloat16, device="cpu", **kw)
    mf_j, _ = jm.mag1c_column_blocks(jnp.asarray(xs), jnp.asarray(tpl), None,
                                     stream_dtype=jnp.bfloat16, use_pallas=True, interpret=True,
                                     **kw)
    assert (mf_f.numpy() > 1000).sum() > 100
    assert_bf16_detection_equivalent(mf_f.numpy().ravel(), mf.numpy().ravel())
    assert_bf16_detection_equivalent(np.asarray(mf_j).ravel(), mf.numpy().ravel())


def test_column_blocks_refuses_unknown_layout():
    _, xs, tpl = _shw_scene()
    with pytest.raises(ValueError, match="scene_layout"):
        tm.mag1c_column_blocks(xs, tpl, None, scene_layout="spw", device="cpu")


# ---------------------------------------------------------------------------
# The twins of rows 4, 7-8 and 10 are the existing sequence in other order
# ---------------------------------------------------------------------------


def _f64_stream():
    """The blocks as the raw f64 stream (B, S, P), row 10's statistics and
    the Woodbury base without shrinkage (alpha = 0: the rank-2 update is
    exact, so the Cholesky glue solves the same system)."""
    x, tpl = _blocks()
    xs = torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 1, 2))).double()
    td = torch.from_numpy(tpl).double()
    m0, c0 = tk.init_stats_stream_plain(xs, S)
    xb = x.astype(np.float64)
    np.testing.assert_allclose(m0.numpy(), xb.mean(1), rtol=1e-12)
    xc = xb - xb.mean(1, keepdims=True)
    np.testing.assert_allclose(c0.numpy(), np.einsum("bps,bpt->bst", xc, xc) / xb.shape[1],
                               rtol=1e-10)
    return xs, td, m0, tk._woodbury_base(c0, m0, td, 0.0)


def test_mono_twin_is_the_round_and_glue_sequence():
    """glue="mono" on the CPU: filter_round_mono_plain is filter_round_bsp_plain
    then filter_glue_plain, so the mono filter equals bsp_filter_plain (the
    resident twin) bitwise, raw stream centred by m0 in both."""
    xs, td, m0, base = _f64_stream()
    n = torch.full((NB,), float(xs.shape[2]), dtype=torch.float64)
    kw = dict(num_iter=6, alpha=0.0)
    mf, r = tf._mono_filter(xs, m0, *base, td, n, cov_scale=1.0, center=True, **kw)
    rnd = functools.partial(tk.filter_round_bsp_plain, xs, None, 1, m0, center=True)
    mf2, r2 = tk._filter_sequence(rnd, tk.filter_glue_plain, m0, *base, td, n, **kw)
    assert torch.equal(mf, mf2) and torch.equal(r, r2)


@pytest.mark.parametrize("woodbury", [True, False])
def test_fused_iter_twin_matches_round_sequence_f64(monkeypatch, woodbury):
    """glue="woodbury" / "cholesky" in f64 (fused_iter_plain and the glues,
    R and mf0 from one product, slab by slab) against the filter_round_plain
    + filter_glue_plain sequence (R from the stream): one function, sums in
    another order."""
    xs, td, m0, base = _f64_stream()
    n = torch.full((NB,), float(xs.shape[2]), dtype=torch.float64)
    kw = dict(num_iter=6, alpha=0.0, cov_scale=1.0)
    monkeypatch.setattr(tf, "RMF_SLAB", 500)  # five slabs, the last one ragged
    mf, r = tf._fused_iter_filter(xs, None, m0, *base, td, n, woodbury=woodbury, center=True,
                                  **kw)
    cube = torch.from_numpy(_blocks()[0]).double().reshape(NB, H, STEP, S)
    cube = cube.permute(1, 0, 2, 3).reshape(H, NB * STEP, S)
    mf2, r2 = tk.resident_filter_plain(cube, NB, STEP, m0, *base, td, num_iter=6, alpha=0.0)
    np.testing.assert_allclose(r.numpy(), r2.numpy(), rtol=1e-12)
    np.testing.assert_allclose(mf.numpy(), mf2.numpy(), rtol=1e-7, atol=1e-4)


# ---------------------------------------------------------------------------
# The launches of each route on a device tensor
# ---------------------------------------------------------------------------


ROUTE_LAUNCHES = {
    # (glue, layout): (the first calls, one iteration's, LAUNCH_COUNTS at num_iter = 3)
    ("mono", "bsp"): (["init_stats_stream", "woodbury_base"], ["filter_round_mono"],
                      dict(init_stats_stream=1, woodbury_base=1, filter_round_mono_first=1,
                           filter_round_mono_loop=3)),
    ("resident", "bsp"): (["init_stats_stream", "woodbury_base"],
                          ["filter_round_bsp", "filter_glue"],
                          dict(init_stats_stream=1, woodbury_base=1, filter_round_bsp_f32=4,
                               filter_glue=3)),
    ("fused", "bps_weights"): (["woodbury_base"], ["filter_round_bsp", "filter_glue"],
                               dict(woodbury_base=1, filter_round_bsp_f32_masked_first=1,
                                    filter_round_bsp_f32_masked_loop=3, filter_glue=3)),
    ("woodbury", "bsp"): (["init_stats_stream", "woodbury_base"],
                          ["fused_iter_woodbury", "filter_glue"],
                          dict(init_stats_stream=1, woodbury_base=1, fused_iter_woodbury=4,
                               filter_glue=3)),
    ("cholesky", "bsp"): (["init_stats_stream"], ["fused_iter_cholesky"],
                          dict(init_stats_stream=1, fused_iter_cholesky=4)),
    ("cholesky", "bps"): ([], ["fused_iter_cholesky"], dict(fused_iter_cholesky=4)),
}


@pytest.mark.parametrize("glue,layout", sorted(ROUTE_LAUNCHES))
def test_routes_launch_their_kernels(monkeypatch, glue, layout):
    """On a device tensor (the meta device here, CUDA on the card) each glue
    takes the kernels of its route and no other: a (B, S, P) stream row 10's
    statistics, one woodbury_base but for cholesky, mono one launch per round
    and no filter_glue, woodbury and cholesky num_iter + 1 fused_iter passes
    with filter_glue or the Cholesky glue in torch after each but the last."""
    fake = _FakeKernels()
    monkeypatch.setattr(tk, "_kernels", lambda: fake)
    monkeypatch.setattr(tk, "_stream", lambda x: 0)
    x, tpl = _blocks()
    xx, w, x_layout = _layout(x, layout)
    tk.reset_launch_counts()
    mf, r = tf.acrwl1mf_fused(xx, tpl, w, glue=glue, x_layout=x_layout, num_iter=3,
                              device="meta")
    assert mf.device.type == r.device.type == "meta" and mf.shape == (NB, H * STEP, 1)
    head, per_iter, counts = ROUTE_LAUNCHES[(glue, layout)]
    assert fake.calls == head + per_iter * 3 + per_iter[:1]
    want = {k: 0 for k in tk.LAUNCH_COUNTS}
    want.update(counts)
    assert tk.LAUNCH_COUNTS == want


def test_mono_rounds_share_one_set_of_counters(monkeypatch):
    """The mono filter zeroes its block counters once, and every round gets
    those same counters (each launch leaves them at 0 for the next)."""
    counters = []

    class Kernels(_FakeKernels):
        def filter_round_mono(self, *args):
            self.calls.append("filter_round_mono")
            counters.append(args[10])

    fake = Kernels()
    monkeypatch.setattr(tk, "_kernels", lambda: fake)
    monkeypatch.setattr(tk, "_stream", lambda x: 0)
    made = []
    monkeypatch.setattr(tf, "mono_counters", lambda xs: made.append(tk.mono_counters(xs))
                        or made[-1])
    x, tpl = _blocks()
    xx, _, _ = _layout(x, "bsp")
    tf.acrwl1mf_fused(xx, tpl, glue="mono", x_layout="bsp", num_iter=3, device="meta")
    assert len(made) == 1 and made[0].shape == (NB,) and made[0].dtype == torch.int32
    assert len(counters) == 4 and all(c is made[0] for c in counters)


@pytest.mark.parametrize("bf16", [False, True])
def test_shw_route_launches_row_3(monkeypatch, bf16):
    """scene_layout="shw" without a mask: one blocked_transpose_shw, row 10
    on the stream, the resident rounds (f32 storage, or bf16 on the centred
    copy) and their glues; no permuted copy of the cube goes to K1."""
    fake = _FakeKernels()
    monkeypatch.setattr(tk, "_kernels", lambda: fake)
    monkeypatch.setattr(tk, "_stream", lambda x: 0)
    _, xs, tpl = _shw_scene()
    tk.reset_launch_counts()
    mf, _ = tm.mag1c_column_blocks(xs, tpl, None, column_step=18, num_iter=3, device="meta",
                                   stream_dtype=torch.bfloat16 if bf16 else None,
                                   scene_layout="shw")
    assert mf.device.type == "meta" and mf.shape == (64, 36)
    want = {k: 0 for k in tk.LAUNCH_COUNTS}
    want.update(blocked_transpose_shw=1, init_stats_stream=1, woodbury_base=1, filter_glue=3,
                **{"filter_round_bsp" if bf16 else "filter_round_bsp_f32": 4})
    assert tk.LAUNCH_COUNTS == want
    assert fake.calls == (["blocked_transpose_shw", "init_stats_stream", "woodbury_base"]
                          + ["filter_round_bsp", "filter_glue"] * 3 + ["filter_round_bsp"])
