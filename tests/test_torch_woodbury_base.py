"""The filter's Woodbury base (``ops.mag1c_kernels.woodbury_base``, kernel
``csrc/woodbury_base.cu``) and its plain twin ``_woodbury_base``.

On the CPU: the wrapper is the twin, bitwise, at f32 and f64, and an
all-zero C0 block (a block with no valid pixel) gives NaN in that block's
k0, cit0 and norm0 only; a device tensor of another dtype than f32 raises;
under ``utils.profiling.trace`` each of the five routes that take the base
records one span ``mag1c.base`` with counters ``blocks`` = nb and
``kernel`` = 0 (``test_torch_mag1c.py`` holds the twin against JAX's).

On the card (marker ``cuda``, skipped without one; imports no JAX, so it
runs with ``--noconftest``): on C0 from a seeded synthetic granule's
statistics (cond 7e5-2.5e6) at S in {5, 12, 50, 64, 128} and nb in {1, 23,
39}, the kernel's K0 is no farther from the f64 inverse than the plain f32
recursion's, and cit0 and norm0 lie within CIT_RTOL and NORM_RTOL of the
f64 twin's; the zero block is NaN and leaves the other blocks bitwise as
they were, and a rerun is bitwise equal; each of the four routes of
``mag1c_column_blocks`` and ``acrwl1mf_fused`` launches one
``woodbury_base`` a filter, and no ``bmm`` or ``cat`` runs inside
``mag1c.base``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cpu_share  # noqa: E402,F401

from starcop_tpu_torch.data.synthetic import synthetic_scene  # noqa: E402
from starcop_tpu_torch.ops import mag1c_fused as tf  # noqa: E402
from starcop_tpu_torch.ops import mag1c_kernels as tk  # noqa: E402
from starcop_tpu_torch.ops.ch4_template import generate_template_from_bands  # noqa: E402
from starcop_tpu_torch.ops.mag1c import mag1c_column_blocks  # noqa: E402
from starcop_tpu_torch.utils import profiling  # noqa: E402
from starcop_tpu_torch.utils.profiling import clear_spans, spans  # noqa: E402

ALPHA = 1e-4
# The kernel's cit0 and norm0 against the f64 twin's, max |gap| / max |f64|:
# measured at most 1.06e-7 and 8.3e-8 over every case here on an NVIDIA H100
# 80GB HBM3 at 700 W (the K0 of the f32 recursion reads 3.6e-4 - 2.8e-3).
CIT_RTOL = 1e-6
NORM_RTOL = 1e-6


def _rel_gap(a, ref) -> float:
    a, ref = a.double().cpu(), ref.double().cpu()
    return float((a - ref).abs().max() / ref.abs().max())


def _random_stats(nb, s, dtype, seed=0):
    """C0 (nb, s, s) and m0 (nb, s) of random blocks, block nb // 2 empty (C0
    = 0, m0 = 0, as a block with no valid pixel), and a template (s,)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nb, 3 * s, s)) * rng.uniform(0.01, 10.0, s)
    c0 = torch.from_numpy(np.einsum("bps,bpt->bst", x, x) / (3 * s)).to(dtype)
    m0 = torch.from_numpy(rng.uniform(1.0, 3.0, (nb, s))).to(dtype)
    c0[nb // 2] = 0.0
    m0[nb // 2] = 0.0
    return c0, m0, torch.from_numpy(-rng.uniform(0.1, 1.0, s)).to(dtype)


@pytest.mark.parametrize("s", [5, 50])
@pytest.mark.parametrize("nb", [1, 23, 39])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_route_is_the_twin_bitwise(dtype, nb, s):
    c0, m0, tpl = _random_stats(nb, s, dtype)
    got = tk.woodbury_base(c0, m0, tpl, ALPHA)
    want = tk._woodbury_base(c0, m0, tpl, ALPHA)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    k0, tgt0, cit0, norm0 = got
    z = nb // 2
    live = torch.arange(nb) != z
    assert k0[z].isnan().all() and cit0[z].isnan().all() and norm0[z].isnan()
    assert torch.equal(tgt0[z], tpl * m0[z])
    assert k0[live].isfinite().all() and cit0[live].isfinite().all()
    assert norm0[live].isfinite().all() and tgt0.isfinite().all()


def test_device_tensors_of_another_dtype_raise(monkeypatch):
    """Only f32 goes to the kernel (the meta device stands in for the card);
    nothing falls back to the twin."""
    monkeypatch.setattr(tk, "_kernels", lambda: pytest.fail("no launch for f64"))
    c0, m0, tpl = (t.to("meta") for t in _random_stats(3, 5, torch.float64))
    with pytest.raises(TypeError, match="float32"):
        tk.woodbury_base(c0, m0, tpl, ALPHA)


ROUTES = ["resident", "masked", "resident_bf16", "masked_bf16", "fused"]


def _route_case(route, dev):
    """One filter of ``route`` on a small cube on ``dev``; the blocks."""
    rng = np.random.default_rng(5)
    h, w, s, step = 64, 80, 50, 16
    x = torch.as_tensor(rng.uniform(1.0, 3.0, (h, w, s)).astype(np.float32), device=dev)
    tpl = torch.as_tensor(-rng.uniform(0.1, 1.0, s).astype(np.float32), device=dev)
    valid = torch.as_tensor(rng.random((h, w)) > 0.1, device=dev)
    kw = dict(num_iter=3, alpha=ALPHA, device=dev)
    if route == "fused":
        xb = x.reshape(h, w // step, step, s).permute(1, 0, 2, 3).reshape(-1, h * step, s)
        tf.acrwl1mf_fused(xb, tpl, valid.reshape(-1, h * step).float(), **kw)
    else:
        bf16 = torch.bfloat16 if route.endswith("bf16") else None
        mask = valid if route.startswith("masked") else None
        mag1c_column_blocks(x, tpl, mask, column_step=step, stream_dtype=bf16, **kw)
    return w // step


@pytest.mark.parametrize("route", ROUTES)
def test_each_route_records_one_base_span(tmp_path, route, monkeypatch):
    """acrwl1mf_resident, _masked, _resident_bsp, _masked_bf16 (through
    mag1c_column_blocks) and acrwl1mf_fused: one ``mag1c.base`` a filter, its
    counters the blocks and 0 for the twin."""
    calls = []
    real = tk._woodbury_base
    monkeypatch.setattr(tk, "_woodbury_base", lambda *a: calls.append(1) or real(*a))
    clear_spans()
    with profiling.trace(str(tmp_path)):
        nb = _route_case(route, "cpu")
    base = [s for s in spans() if s.name == "mag1c.base"]
    clear_spans()
    assert len(calls) == 1
    assert len(base) == 1 and base[0].counts == {"blocks": nb, "kernel": 0}


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _granule_stats(s: int):
    """m0 (39, s), C0 (39, s, s) in f32 and the template (s,): the f64
    statistics of 39 column blocks of 16 columns of a seeded 128-line
    synthetic granule of s bands (EMIT's 50 bands at s = 50), rounded to
    f32."""
    centers = np.arange(2122.0, 2488.0, 7.4) if s == 50 else np.linspace(2122.0, 2488.0, s)
    tmpl = generate_template_from_bands(centers, np.full_like(centers, 8.0))[:, 1]
    tmpl = np.ascontiguousarray(tmpl, np.float32)
    scene = synthetic_scene(np.random.default_rng(7), 128, 16 * 39, n_plumes=4, template=tmpl)
    m0, c0 = tk.init_stats_plain(torch.as_tensor(scene["radiance"]).double(), 39, 16)
    return m0.float(), c0.float(), torch.from_numpy(tmpl)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [5, 12, 50, 64, 128])
@pytest.mark.parametrize("nb", [1, 23, 39])
def test_kernel_against_the_f64_twin(card, nb, s):
    m0, c0, tpl = (t[:nb] if t.dim() > 1 else t for t in _granule_stats(s))
    k0, tgt0, cit0, norm0 = tk.woodbury_base(c0.to(card), m0.to(card), tpl.to(card), ALPHA)
    torch.cuda.synchronize()
    assert k0.is_contiguous() and torch.equal(k0, k0.transpose(1, 2))
    k64, t64, c64, n64 = tk.woodbury_base(c0.double(), m0.double(), tpl.double(), ALPHA)
    k32 = tk.woodbury_base(c0, m0, tpl, ALPHA)[0]
    gap, plain = _rel_gap(k0, k64), _rel_gap(k32, k64)
    cit, norm = _rel_gap(cit0, c64), _rel_gap(norm0, n64)
    print(f"S={s} nb={nb}: K0 {gap:.2e} (f32 recursion {plain:.2e}), cit0 {cit:.2e}, "
          f"norm0 {norm:.2e}")
    assert gap <= plain
    assert torch.equal(tgt0.cpu(), tpl * m0)
    assert cit <= CIT_RTOL and norm <= NORM_RTOL


@pytest.mark.cuda
def test_kernel_zero_block_and_rerun(card):
    m0, c0, tpl = (t[:23].to(card) if t.dim() > 1 else t.to(card) for t in _granule_stats(50))
    whole = tk.woodbury_base(c0, m0, tpl, ALPHA)
    c0z, m0z = c0.clone(), m0.clone()
    c0z[5], m0z[5] = 0.0, 0.0
    got = tk.woodbury_base(c0z, m0z, tpl, ALPHA)
    again = tk.woodbury_base(c0z, m0z, tpl, ALPHA)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        torch.testing.assert_close(g, a, rtol=0, atol=0, equal_nan=True)
    k0, tgt0, cit0, norm0 = got
    assert k0[5].isnan().all() and cit0[5].isnan().all() and norm0[5].isnan()
    assert tgt0[5].isfinite().all()
    live = torch.arange(23, device=card) != 5
    for g, w in zip(got, whole):
        assert torch.equal(g[live], w[live])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_one_launch_a_filter_and_no_eager_inverse(card, route, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(tk, "_woodbury_base", lambda *a: pytest.fail("the twin on the card"))
    _route_case(route, card)  # the build and first launches
    tk.reset_launch_counts()
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        nb = _route_case(route, card)
        torch.cuda.synchronize()
    assert tk.LAUNCH_COUNTS["woodbury_base"] == 1
    base = [s for s in spans() if s.name == "mag1c.base"]
    assert len(base) == 1 and base[0].counts == {"blocks": nb, "kernel": 1}
    marks = [e for e in prof.events() if e.name == "starcop.mag1c.base"]
    assert len(marks) == 1

    def inside(e):
        for c in e.cpu_children:
            yield c.name
            yield from inside(c)

    names = set(inside(marks[0]))
    assert not {"aten::bmm", "aten::cat"} & names, names
    clear_spans()
