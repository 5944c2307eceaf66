"""The port's multi-device layer (starcop_tpu_torch.parallel and ``mesh=`` on
the scene entry points and the feed) against the JAX package on the CPU.

The port runs one process per device, so its worlds here are real gloo
worlds of CPU processes (``parallel.run_world``, a ``file://`` rendezvous
in the test's tmp_path, one thread a rank, a timeout); their rank functions
are in tests/torch_parallel_worlds.py. JAX runs on its 8-virtual-device CPU
mesh (tests/conftest.py), its inputs in float32.

Bars:
  * ``initialize_multihost``'s argument errors: JAX's messages;
  * ``shard_batch``: the rank's rows are JAX's shard on the mesh's device of
    that index; it raises for the batch sizes JAX's raises for;
  * ``replicate``: every rank holds rank 0's values, bitwise;
  * batch norm over two ranks: the one-process layer on the global batch
    (outputs, running statistics, input and weight gradients) within
    1e-12, in float64; dropout's rank masks are the rows of the global one;
  * ``sharded_mag1c_scene`` over 2 and 3 ranks (a valid mask, a ragged last
    block, 7 blocks of 8,192 pixels: 4 + 3 and 3 + 2 + 2) against JAX's on
    make_mesh(2) and make_mesh(3) at JAX's own bar
    (tests/test_data_train_eval.py:318-326: mf correlation > 0.99999,
    threshold-500 agreement > 0.999, albedo rtol 1e-4), and against the
    port's one-process ``mag1c_column_blocks`` at the same bar; in float64
    JAX's within 1e-10 of the scale;
  * ``emit_mag1c(mesh=)`` and ``emit_inference(mesh=)`` against JAX's with
    ``make_mesh(2)``: the fill pixels equal, JAX's bar on the filter, the
    predictions' correlation > 0.9999 (tests/test_torch_eval.py's
    infer_emit bar); ``emit_mag1c(compute_dtype=torch.float64)`` within
    1e-10 of JAX's float64.
"""

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu.data.emit import EMITRawScene as JEMITRawScene  # noqa: E402
from starcop_tpu.models import SegmentationModel as FlaxSegmentationModel  # noqa: E402
from starcop_tpu.parallel import mesh as jmesh  # noqa: E402
from starcop_tpu.parallel.scene_mag1c import sharded_mag1c_scene as j_sharded  # noqa: E402
from starcop_tpu.scenes import emit_pipeline as jep  # noqa: E402
from starcop_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from starcop_tpu_torch.models import layers  # noqa: E402
from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands  # noqa: E402
from starcop_tpu_torch.ops.mag1c import mag1c_column_blocks  # noqa: E402
from starcop_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from starcop_tpu_torch.parallel import run_world  # noqa: E402
from starcop_tpu_torch.scenes import emit_pipeline as tep  # noqa: E402
from starcop_tpu_torch.train.loop import dropout_generator  # noqa: E402
from tests import torch_parallel_worlds as worlds  # noqa: E402

FILL = -9999.0
H, W, STEP, NUM_ITER = 1024, 53, 8, 30  # 7 blocks of 8,192 pixels, the last 5 columns wide
CENTERS = np.arange(2122.0, 2488.0, 7.4)


def _world(fn, n, tmp, *args, timeout_s=240.0):
    return run_world(fn, n, backend="gloo", device="cpu", init_file=str(tmp / f"rdv_{n}"),
                     timeout_s=timeout_s, args=args)


# ---------------------------------------------------------------------------
# initialize_multihost, make_mesh outside a world
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(num_processes=2),
    dict(num_processes=2, coordinator_address="localhost:1"),
    dict(num_processes=2, coordinator_address="localhost:1", process_id=2),
    dict(num_processes=3, coordinator_address="localhost:1", process_id=-1),
])
def test_initialize_multihost_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jmesh.initialize_multihost(**kw)
    with pytest.raises(ValueError) as got:
        tmesh.initialize_multihost(**kw)
    assert str(got.value) == str(want.value)


def test_one_process_world(monkeypatch, tmp_path):
    """Without torchrun's environment ``initialize_multihost`` joins no
    world; the mesh is one process, which shards and replicates as JAX's
    make_mesh(1) does; a mesh of two raises and names torchrun; NCCL on the
    CPU raises."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    tmesh.initialize_multihost(device="cpu")
    assert not torch.distributed.is_initialized()
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.device, mesh.group, mesh.lead) == (
        1, 0, torch.device("cpu"), None, True)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        tmesh.make_mesh(2, "cpu")
    x = np.arange(15.0).reshape(5, 3)
    want = jmesh.shard_batch(jmesh.make_mesh(1), {"x": x})["x"]
    got = tmesh.shard_batch(mesh, {"x": x})["x"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for shard in (lambda: jmesh.shard_batch(jmesh.make_mesh(1), np.float32(1.0)),
                  lambda: tmesh.shard_batch(mesh, np.float32(1.0))):
        with pytest.raises(ValueError):
            shard()
    np.testing.assert_array_equal(tmesh.replicate(mesh, {"x": x})["x"].numpy(), x)
    with pytest.raises(ValueError, match="backend='nccl' needs the card"):
        tmesh.initialize_multihost(f"file://{tmp_path / 'rdv'}", 2, 0, backend="nccl",
                                   device="cpu")


def test_batch_norm_without_a_group_is_unchanged():
    """No group (one process, or a world of one): torch's normalisation
    and running mean bitwise, the running variance by Flax's biased rule
    as before (the unbiased increment rescaled by (n - 1) / n)."""
    x = torch.as_tensor(worlds.bn_input())
    for mesh in (None, tmesh.make_mesh(device="cpu")):
        ours = layers.BatchNorm2d(3).double()
        if mesh is not None:
            layers.set_data_parallel(ours, mesh)
            assert ours.process_group is None
        ref = torch.nn.BatchNorm2d(3).double()
        ref.load_state_dict(ours.state_dict())
        kept = ref.running_var.clone() * (1 - 0.1)
        y, y_ref = ours.train()(x), ref.train()(x)
        assert torch.equal(y, y_ref)
        assert torch.equal(ours.running_mean, ref.running_mean)
        n = x.numel() // 3
        assert torch.equal(ours.running_var, torch.lerp(kept, ref.running_var, (n - 1) / n))


# ---------------------------------------------------------------------------
# A world of two: make_mesh, shard_batch, replicate, prefetch, batch norm, dropout
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    return _world(worlds.mesh_world, 2, tmp_path_factory.mktemp("mesh"))


def test_world_meshes(mesh_ranks):
    assert [(r["rank"], r["size"], r["device"], r["make_mesh_2"]) for r in mesh_ranks] == [
        (0, 2, "cpu", 2), (1, 2, "cpu", 2)]
    assert all("torchrun --nproc-per-node 3" in r["make_mesh_3"] for r in mesh_ranks)


def test_shard_batch_matches_jax(mesh_ranks):
    mesh2 = jmesh.make_mesh(2)
    for b in (2, 4, 6):
        want = jmesh.shard_batch(mesh2, {"x": np.arange(b * 2).reshape(b, 2)})["x"]
        shards = {s.device: np.asarray(s.data) for s in want.addressable_shards}
        for rank, r in enumerate(mesh_ranks):
            np.testing.assert_array_equal(r["shards"][b], shards[mesh2.devices[rank]])
    for b in (1, 3, 5):
        with pytest.raises(ValueError):
            jmesh.shard_batch(mesh2, np.zeros((b, 2)))
        assert all("does not divide over 2" in r["shard_raises"][b] for r in mesh_ranks)


def test_replicate_takes_rank_0(mesh_ranks):
    torch.manual_seed(100)
    net = torch.nn.Sequential(torch.nn.Conv2d(2, 3, 3), layers.BatchNorm2d(3))
    with torch.no_grad():
        net[1].running_mean.uniform_()
    want = {k: v.numpy() for k, v in net.state_dict().items()}
    want["1.num_batches_tracked"] = np.asarray(5)
    for r in mesh_ranks:
        assert r["replicated"].keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(r["replicated"][k], v, err_msg=k)
        np.testing.assert_array_equal(r["replicated_tree"][0], np.zeros(3))
        np.testing.assert_array_equal(r["replicated_tree"][1], np.arange(2))


def test_prefetch_to_device_mesh(mesh_ranks):
    for rank, r in enumerate(mesh_ranks):
        assert len(r["prefetched"]) == 3
        for i, (arrays, ids) in enumerate(r["prefetched"]):
            rows = slice(4 * rank, 4 * rank + 4)
            full = np.arange(8 * 3, dtype=np.float32).reshape(8, 3) + i
            np.testing.assert_array_equal(arrays["input"], full[rows])
            np.testing.assert_array_equal(arrays["has_plume"], np.arange(8.0)[rows])
            assert ids == [f"t{j}" for j in range(8)]
        assert "does not divide over 2" in r["prefetch_raises"]


def test_global_batch_norm_is_one_process_on_the_global_batch(mesh_ranks):
    x = worlds.bn_input()
    y, rm, rv, dx, dw, db = worlds.bn_forward(x)
    got = [r["bn"] for r in mesh_ranks]
    np.testing.assert_allclose(np.concatenate([g[0] for g in got]), y, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.concatenate([g[3] for g in got]), dx, rtol=0, atol=1e-12)
    for g in got:
        for a, b in zip(g[1:3] + g[4:], (rm, rv, dw, db)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-13)
    # The shard's own statistics would be far off: the test can tell.
    y_local = worlds.bn_forward(x[:2])[0]
    assert np.abs(y_local - y[:2]).max() > 0.1


def test_dropout_rank_masks_are_rows_of_the_global_mask(mesh_ranks):
    want = layers.dropout(torch.ones(4, 3, 4, 4), 0.5, dropout_generator(42, 3,
                                                                          torch.device("cpu")))
    got = np.concatenate([r["dropout"] for r in mesh_ranks])
    np.testing.assert_array_equal(got, want.numpy())
    assert 0 < (got == 0).mean() < 1


# ---------------------------------------------------------------------------
# The sharded scene filter and the EMIT entry points
# ---------------------------------------------------------------------------


def _scene():
    """(cube, template, valid): 1024 x 53 x 50, plumes, the fill value on
    a corner of every band and on scattered pixels of one band."""
    template = generate_template_from_bands(CENTERS, np.full_like(CENTERS, 8.0))[:, 1]
    sc = synthetic_scene(np.random.default_rng(5), H, W, n_plumes=4, template=template)
    cube = sc["radiance"].astype(np.float32)
    cube[:100, :12, :] = FILL
    rng = np.random.default_rng(6)
    rows, cols = np.nonzero(rng.random((H, W)) < 0.01)
    cube[rows, cols, rng.integers(0, len(CENTERS), rows.size)] = FILL
    return cube, template.astype(np.float32), ~(cube == FILL).any(-1)


@pytest.fixture(scope="module")
def scene_ranks(tmp_path_factory):
    """The scene's world runs: {2: ranks, 3: ranks}, the 2-rank world also
    running f64, emit_mag1c and emit_inference on an h5 granule."""
    pytest.importorskip("h5py")
    from tests.test_torch_eval import _save_npz, flax_variables
    from tests.test_torch_serve import _granule

    tmp = tmp_path_factory.mktemp("scene")
    cube, template, valid = _scene()
    granule, _ = _granule(tmp, "EMIT_mesh", 23, h=256, w=45)
    _save_npz(tmp / "best.npz", flax_variables(6))
    out = {"cube": cube, "template": template, "valid": valid, "granule": granule,
           "checkpoint": str(tmp / "best.npz")}
    for n in (2, 3):
        path = tmp / f"scene_{n}.npz"
        np.savez(path, cube=cube, template=template, valid=valid, step=STEP, num_iter=NUM_ITER,
                 full=n == 2, wavelengths=CENTERS, fwhm=np.full_like(CENTERS, 8.0),
                 granule=granule, checkpoint=out["checkpoint"])
        out[n] = _world(worlds.scene_world, n, tmp, str(path))
    return out


def _jax_bar(got, want, valid):
    """JAX's sharded bar, on the valid pixels, and the fill elsewhere."""
    (mf, alb), (mf_w, alb_w) = got, want
    assert np.array_equal(mf == FILL, ~valid) and np.array_equal(mf_w == FILL, ~valid)
    a, b = np.asarray(mf_w, np.float64)[valid], np.asarray(mf, np.float64)[valid]
    assert (b > 500).sum() > 0
    assert np.corrcoef(a, b)[0, 1] > 0.99999
    assert ((a > 500) == (b > 500)).mean() > 0.999
    np.testing.assert_allclose(np.asarray(alb)[valid], np.asarray(alb_w)[valid], rtol=1e-4)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_scene_matches_jax(scene_ranks, n):
    s = scene_ranks
    assert [r["blocks"] for r in s[n]] == {2: [(0, 4), (4, 7)],
                                           3: [(0, 3), (3, 5), (5, 7)]}[n]
    mf0, alb0 = s[n][0]["f32"]
    for r in s[n][1:]:  # every rank holds the same assembled scene
        np.testing.assert_array_equal(r["f32"][0], mf0)
        np.testing.assert_array_equal(r["f32"][1], alb0)
    want = j_sharded(jnp.asarray(s["cube"]), jnp.asarray(s["template"]), s["valid"],
                     mesh=jmesh.make_mesh(n), column_step=STEP, num_iter=NUM_ITER, alpha=1e-4)
    _jax_bar((mf0, alb0), [np.asarray(v) for v in want], s["valid"])
    one = mag1c_column_blocks(s["cube"], s["template"], s["valid"], column_step=STEP,
                              num_iter=NUM_ITER, alpha=1e-4, device="cpu")
    _jax_bar((mf0, alb0), [v.numpy() for v in one], s["valid"])


def test_sharded_scene_f64_matches_jax(scene_ranks):
    s = scene_ranks
    mf, alb = s[2][0]["f64"]
    assert mf.dtype == np.float64
    want = j_sharded(jnp.asarray(s["cube"], jnp.float64), jnp.asarray(s["template"], jnp.float64),
                     s["valid"], mesh=jmesh.make_mesh(2), column_step=STEP, num_iter=NUM_ITER,
                     alpha=1e-4, compute_dtype=jnp.float64)
    for got, w in zip((mf, alb), want):
        w = np.asarray(w)
        np.testing.assert_array_equal(got == FILL, w == FILL)
        assert np.abs(got - w).max() <= 1e-10 * np.abs(w[s["valid"]]).max()


def test_emit_mag1c_mesh_matches_jax(scene_ranks):
    s = scene_ranks
    kw = dict(column_step=STEP, num_iter=NUM_ITER, alpha=1e-4)
    want = jep.emit_mag1c(s["cube"], CENTERS, np.full_like(CENTERS, 8.0), s["valid"],
                          mesh=jmesh.make_mesh(2), **kw)
    for r in s[2]:
        got = r["emit_mag1c"]
        assert got[0].dtype == got[1].dtype == np.float32
        np.testing.assert_array_equal(got[0], s[2][0]["f32"][0])  # the sharded filter's
        _jax_bar(got, want, s["valid"])
        assert "not the mesh's device" in r["emit_mag1c_wrong_device"]


def test_emit_inference_mesh_matches_jax(scene_ranks):
    from tests.test_torch_eval import flax_variables

    s = scene_ranks
    jm = FlaxSegmentationModel(worlds.PRODUCTS, model_type="unet_semseg", encoder_weights=None)
    variables = flax_variables(6)
    scene = JEMITRawScene(s["granule"])
    try:
        want = jep.emit_inference(scene, lambda x: jm.apply(variables, x, train=False),
                                  column_step=16, num_iter=5, mesh=jmesh.make_mesh(2))
    finally:
        scene.close()
    for r in s[2]:
        got = r["emit_inference"]
        assert got.keys() == want.keys()
        mf, mf_w = got["mag1c"], np.asarray(want["mag1c"])
        np.testing.assert_array_equal(mf == FILL, mf_w == FILL)
        keep = mf_w != FILL
        assert (mf_w[keep] > 500).sum() > 0
        assert ((mf[keep] > 500) == (mf_w[keep] > 500)).mean() >= 0.999
        np.testing.assert_array_equal(got["rgb"], np.asarray(want["rgb"]))
        assert np.corrcoef(got["prediction"].ravel(),
                           np.asarray(want["prediction"]).ravel())[0, 1] > 0.9999
    np.testing.assert_array_equal(s[2][1]["emit_inference"]["prediction"],
                                  s[2][0]["emit_inference"]["prediction"])


def test_emit_mag1c_compute_dtype_f64_matches_jax():
    """The repair: ``emit_mag1c`` takes ``compute_dtype``, and at float64
    it is JAX's float64 filter within 1e-10 of the scale, returned as
    float32 as JAX returns it."""
    cube, template, valid = _scene()
    cube, valid = cube[:256], valid[:256]
    kw = dict(column_step=16, num_iter=5, alpha=1e-4)
    fwhm = np.full_like(CENTERS, 8.0)
    got = tep.emit_mag1c(cube, CENTERS, fwhm, valid, compute_dtype=torch.float64,
                         device="cpu", **kw)
    want = jep.emit_mag1c(cube, CENTERS, fwhm, valid, compute_dtype=jnp.float64, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g == FILL, w == FILL)
        # Both are float64 results rounded to float32: 1e-10 of the scale
        # plus one float32 step.
        err = np.abs(g.astype(np.float64) - w)
        assert (err <= 1e-10 * np.abs(w[valid]).max() + np.spacing(np.abs(w))).all()
    f32 = tep.emit_mag1c(cube, CENTERS, fwhm, valid, device="cpu", **kw)
    assert not np.array_equal(f32[0], got[0])
