"""Entry points: the flagship forward and a multi-device dry run
(counterpart of the repository's root ``__graft_entry__.py``).

    python -m starcop_tpu_torch.entry N [--device cpu] [--backend gloo]

``entry()`` returns the MobileNetV2-encoder U-Net's forward and its example
arguments. ``dryrun_multichip(n)`` starts a world of ``n`` ranks (one
process per device, ``parallel.run_world``) and runs, over it, one
data-parallel train step, the column-sharded scene filter and scene-parallel
serving of ``emit_granule_to_mask``, then checks what the JAX dry run checks
and prints one OK line.
"""

from __future__ import annotations

import argparse
import copy
import sys
from typing import Optional

import numpy as np
import torch

from starcop_tpu_torch.device import DeviceLike, float32_precision, resolve_device

PRODUCTS = ["mag1c", "TOA_AVIRIS_640nm", "TOA_AVIRIS_550nm", "TOA_AVIRIS_460nm"]


def _model():
    from starcop_tpu_torch.models.segmenter import SegmentationModel

    return SegmentationModel(PRODUCTS, model_type="unet_semseg", pos_weight=1.0)


def entry(device: DeviceLike = None):
    """``(fn, example_args)``: ``fn(model, x)`` is the unet_semseg forward
    (eval mode, logits) and the arguments are the model initialised from
    seed 0 and a (2, 4, 128, 128) input, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    model = _model().init(torch.Generator().manual_seed(0)).to(dev).eval()
    x = torch.as_tensor(np.random.default_rng(0).uniform(0, 100, size=(2, 4, 128, 128)),
                        dtype=torch.float32, device=dev)

    def forward(model, x):
        with torch.inference_mode(), float32_precision():
            return model(x)

    return forward, (model, x)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _dryrun_rank(mesh) -> dict:
    """One rank of the dry run: a train step on its shard of a 2n x 64^2
    global batch, its blocks of the 64 x 8n scene, and two granules served
    on its device."""
    from starcop_tpu_torch.data.synthetic import synthetic_chip_batch, synthetic_scene
    from starcop_tpu_torch.ops import mag1c_kernels as mk
    from starcop_tpu_torch.parallel.mesh import replicate, shard_batch
    from starcop_tpu_torch.parallel.scene_mag1c import sharded_mag1c_scene
    from starcop_tpu_torch.scenes.emit_pipeline import emit_granule_to_mask
    from starcop_tpu_torch.serve.pipeline import ScenePipeline
    from starcop_tpu_torch.train.loop import create_train_state, make_train_step

    mk.reset_launch_counts()
    n, dev = mesh.size, mesh.device
    model = _model()
    batch = synthetic_chip_batch(np.random.default_rng(0), batch_size=2 * n, size=64)
    state = create_train_state(model, 0, 1e-4, dev)
    replicate(mesh, model.network)
    # The serving leg below runs the initial weights, as JAX's copy taken
    # before its step.
    serve_model = copy.deepcopy(model).eval()
    with float32_precision():
        state, loss = make_train_step(model, 0, mesh)(state, shard_batch(mesh, batch), 1e-4)
    loss = float(loss)

    scene = synthetic_scene(np.random.default_rng(1), 64, 8 * n, n_plumes=1)
    mf, _ = sharded_mag1c_scene(scene["radiance"], scene["template"], None, mesh=mesh,
                                column_step=8, num_iter=3, alpha=1e-4)

    sh, sw, sbands = 64, 16, 16
    tiny_template = -np.abs(np.sin(np.linspace(0.3, 3 * np.pi, sbands)))

    def read_granule(name):
        sc = synthetic_scene(np.random.default_rng(100 + int(name)), sh, sw, n_plumes=1,
                             template=tiny_template)
        return {"cube": sc["radiance"],
                "rgb": np.moveaxis(sc["rgb"], -1, 0).astype(np.float32)}

    def compute(payload):
        pred, mf_s = emit_granule_to_mask(payload["cube"], payload["rgb"], tiny_template,
                                          serve_model, column_step=8, num_iter=2, device=dev)
        return {"mask_mean": float(pred.mean()), "mf_max": float(mf_s.max())}

    mine = [str(i) for i in range(2 * mesh.rank, 2 * mesh.rank + 2)]
    served = ScenePipeline(read_fn=read_granule, compute_fns=[compute], write_fn=None).run(mine)
    return {"loss": loss, "mf_shape": tuple(mf.shape), "mf_finite": bool(torch.isfinite(mf).all()),
            "mf_max": float(mf.max()),
            "served": [(r.name, r.error, r.outputs) for r in served],
            "launches": dict(mk.LAUNCH_COUNTS)}


def dryrun_multichip(n_devices: int, device: DeviceLike = None, backend: Optional[str] = None,
                     timeout_s: float = 600.0) -> dict:
    """Run the dry run over a world of ``n_devices`` ranks on this host:
    one data-parallel train step of the full unet_semseg at a global batch
    of 2n x 64^2, ``sharded_mag1c_scene`` at 64 x 8n (step 8, 3
    iterations), and 2n granules through ``ScenePipeline`` (one compute
    worker on each rank's device, two granules a rank) on
    ``emit_granule_to_mask`` at 64 x 16 x 16 (step 8, 2 iterations).
    Checks a finite loss, the mf's shape and that every granule's mf fires
    (max > 100); prints the OK line and returns each rank's results.
    ``device`` and ``backend`` as ``parallel.run_world`` takes them (two
    ranks sharing one card: ``device="cuda:0", backend="gloo"``)."""
    from starcop_tpu_torch.parallel.launch import run_world

    ranks = run_world(_dryrun_rank, n_devices, backend=backend, device=device,
                      timeout_s=timeout_s)
    n = n_devices
    loss = ranks[0]["loss"]
    _require(all(r["loss"] == loss for r in ranks) and np.isfinite(loss),
             f"the ranks' losses {[r['loss'] for r in ranks]} (finite, one value)")
    _require(all(r["mf_shape"] == (64, 8 * n) and r["mf_finite"] for r in ranks),
             f"sharded mf shapes {[r['mf_shape'] for r in ranks]} (64, {8 * n}), finite")
    served = [s for r in ranks for s in r["served"]]
    _require(len(served) == 2 * n and all(err is None for _, err, _ in served),
             f"{len(served)} granules served (want {2 * n}), errors "
             f"{[err for _, err, _ in served if err]}")
    mf_maxes = [out["mf_max"] for _, _, out in served]
    mask_means = [out["mask_mean"] for _, _, out in served]
    _require(all(np.isfinite(v) for v in mf_maxes + mask_means), "finite serving outputs")
    # Every granule carries one injected plume; the matched filter must fire.
    _require(min(mf_maxes) > 100.0, f"mf maxima {mf_maxes} (> 100)")
    print(f"dryrun_multichip({n}) OK: train loss {loss:.4f}, "
          f"sharded mag1c mf max {ranks[0]['mf_max']:.1f}, "
          f"{len(served)} granule->mask scenes served over "
          f"{n} workers (mf_max {min(mf_maxes):.0f}-{max(mf_maxes):.0f}, "
          f"mask_mean {min(mask_means):.3f}-{max(mask_means):.3f})", flush=True)
    return {"loss": loss, "ranks": ranks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("n_devices", type=int, nargs="?", default=2)
    p.add_argument("--device", default=None,
                   help="every rank's device (cpu, or cuda:0 for ranks sharing one card); "
                        "default: each rank its own card")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device, backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
