"""The macro-list render backends and the XLA render path against the JAX
package.

- The plain versions of the four macro-list kernels (``blend_macros``
  and ``blend_macros_vjp``, as the masked walk and as the compact blend)
  against the Pallas kernels
  ``blend_macros_pallas`` / ``blend_macros_compact`` in interpret mode
  through ``jax.vjp``, on macro lists binned from a scene (one macro's
  count halved, so valid rows beyond the count must be skipped), with a
  ``k_fine`` 16 truncation for the compact kernel. Interpret mode is slow,
  so each JAX kernel runs once, in a module-scoped fixture.
- The port's ``render`` on ``"pallas"``, ``"pallas_compact"`` and
  ``"xla"`` against the JAX package's ``"xla"`` render, which equals the
  masked walk when ``k_fine >= k_macro`` and the compact blend at the same
  ``k_fine`` (tests/test_pallas.py): image, depth, opacity, a background,
  a 50x40 frame, and the gradients of test_pallas.py's loss in every map
  leaf and the pose tangent.
- ``n_touched`` of the XLA path, ``render_golden`` and ``ops/scan.py``.

Tolerances: images and opacity atol 3e-5, depth 3e-4 (tests/test_pallas.py;
the JAX kernels form the log-alpha as a [K, 6] x [6, P] product, the port's
plain versions directly); gradients rtol 2e-3, atol 2e-5 (test_pallas.py's
kernel-against-autodiff bounds); row cotangents rtol 1e-3 plus 4e-3 of the
column's largest magnitude (as tests/test_torch_mapping.py where a depth
cotangent enters); counts exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monogs_tpu.ops import scan as jscan
from monogs_tpu.ops import se3 as jse3
from monogs_tpu.render import Intrinsics as JIntr
from monogs_tpu.render import RenderConfig as JCfg
from monogs_tpu.render import pallas_blend as jpb
from monogs_tpu.render import pallas_compact as jpc
from monogs_tpu.render import renderer as jr
from monogs_tpu_torch.ops import scan as tscan
from monogs_tpu_torch.render import Intrinsics as TIntr
from monogs_tpu_torch.render import RenderConfig as TCfg
from monogs_tpu_torch.render import blend_macros as tbm
from monogs_tpu_torch.render import renderer as tr
from tests.test_torch_blend_lists import assert_per_column
from tests.test_torch_ops import blob_scene, both_gauss, npy, small_tau, t
from tests.torch_one_thread import one_torch_thread  # noqa: F401

# the smallest scene of tests/test_pallas.py
INTR = dict(fx=60.0, fy=60.0, cx=31.5, cy=23.5, width=64, height=48)
W, H = INTR["width"], INTR["height"]
CFG = dict(tile=16, macro_tiles=2, k_macro=256, k_fine=256,
           with_n_touched=False)
JI, TI = JIntr(**INTR), TIntr(**INTR)
JX = JCfg(**CFG)
LEAVES = ("xyz", "sh", "log_scale", "quat", "opa_logit")
# one compiled program per configuration and scene size (every render
# scene here has 96 Gaussians)
_jrender = jax.jit(lambda g, intr, cfg, bg=None: jr.render(
    g, jnp.eye(4), intr, cfg, bg=bg), static_argnums=(1, 2))


def assert_image(b, a):
    np.testing.assert_allclose(npy(b.image), np.asarray(a.image), atol=3e-5)
    np.testing.assert_allclose(npy(b.depth), np.asarray(a.depth), atol=3e-4)
    np.testing.assert_allclose(npy(b.opacity), np.asarray(a.opacity),
                               atol=3e-5)


def macro_inputs(seed=0, n=96):
    """(data_m, xy0, counts, pmat) of a scene binned by the port at a small
    pose, macro 0's count halved."""
    _, tg = both_gauss(blob_scene(n, seed))
    T = t(jse3.se3_exp(small_tau(seed + 1, 0.02)))
    cfg = TCfg(**CFG)
    with torch.no_grad():
        _, packed, _, aux = tr._project(tg, T, TI, cfg)
        data_m, xy0, counts = tr.macro_rows(packed, aux)
    assert float(counts[0]) > 4 and float(counts.max()) < cfg.k_macro
    counts[0] = torch.floor(counts[0] / 2)
    return data_m.contiguous(), xy0, counts, tr._tile_pmat(cfg, "cpu")


@pytest.fixture(scope="module")
def kernels():
    """The JAX Pallas kernels (interpret mode), once each: forward outputs
    and the row cotangents of a random output cotangent, for the masked
    walk and for the compact blend at k_fine 16."""
    data_m, xy0, counts, pmat = macro_inputs()
    g = np.random.default_rng(3).normal(
        0, 1, (data_m.shape[0], 4, 256, 8)).astype(np.float32)
    args = [jnp.asarray(npy(x)) for x in (data_m, xy0, counts, pmat)]
    out = {}
    for name, fn in (
            ("pallas", lambda d: jpb.blend_macros_pallas(
                d, *args[1:], 16, 2, W, H, True)),
            ("compact", lambda d: jpc.blend_macros_compact(
                d, *args[1:], 16, 2, 16, W, H, True))):
        o, vjp = jax.vjp(fn, args[0])
        out[name] = (np.asarray(o), np.asarray(vjp(jnp.asarray(g))[0]))
    return (data_m, xy0, counts, pmat, t(g)), out


def assert_outs(a, b):
    np.testing.assert_allclose(a[..., :3], b[..., :3], atol=3e-5)
    np.testing.assert_allclose(a[..., 3], b[..., 3], atol=3e-4)
    np.testing.assert_allclose(a[..., 4], b[..., 4], atol=3e-5)


@pytest.mark.parametrize("backend", ["pallas", "compact"])
def test_macro_kernel_plain_parity(kernels, backend):
    """Forward and VJP of the plain macro kernels against the Pallas
    kernels: every row of every macro list, the halved count of macro 0,
    and for the compact kernel a truncation to 16 rows per tile."""
    (data_m, xy0, counts, pmat, g), ref = kernels
    k_fine = None if backend == "pallas" else 16
    outs = tbm.blend_macros(data_m, xy0, counts, pmat, 16, 2, W, H,
                            k_fine=k_fine)
    dd = tbm.blend_macros_vjp(data_m, xy0, counts, pmat, g, 16, 2, W, H,
                              k_fine=k_fine)
    ref_o, ref_dd = ref[backend]
    assert_outs(npy(outs), ref_o)
    assert_per_column(npy(dd), ref_dd, 4e-3, "ddata")
    assert np.abs(npy(dd)).max() > 1.0
    # rows beyond a macro's count get no cotangent
    n0 = int(counts[0])
    np.testing.assert_array_equal(npy(dd)[0, n0:], 0.0)
    if backend == "compact":
        # the truncation bites: fewer rows than the masked walk blends
        full = tbm.blend_macros(data_m, xy0, counts, pmat, 16, 2, W, H)
        assert float(torch.abs(full - outs).max()) > 1e-3


def test_macro_functions_backward():
    """The Function's backward (the VJP wrapper) equals autograd through
    the plain forward versions, for the masked walk and the compact
    blend."""
    data_m, xy0, counts, pmat = macro_inputs(seed=4)
    w = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (data_m.shape[0], 4, 256, 8)).astype(np.float32))
    cases = ((None, tbm.blend_macros_plain, ()),
             (24, tbm.blend_compact_plain, (24,)))
    for k_fine, plain, extra in cases:
        grads = []
        for f, tail, kw in ((tbm.blend_macros_fn, (), dict(k_fine=k_fine)),
                            (plain, extra, {})):
            x = data_m.clone().requires_grad_(True)
            torch.sum(f(x, xy0, counts, pmat, 16, 2, W, H, *tail, **kw)
                      * w).backward()
            grads.append(npy(x.grad))
        assert_per_column(grads[0], grads[1], 1e-4, f"k_fine {k_fine}")
        assert np.abs(grads[0]).max() > 0


def test_macro_counts_are_a_prefix():
    """The macro lists hold their valid rows first (so the count is the row
    mask the macro kernels take), in depth order with margin 0; some lists
    overflow k_macro."""
    _, tg = both_gauss(blob_scene(200, 6, spread=1.5))
    cfg = TCfg(**CFG)._replace(k_macro=32)
    for margin in (0.0, 4.0):
        _, aux = tr.build_tile_lists(tg, torch.eye(4), TI, cfg,
                                     margin=margin, with_aux=True)
        counts = aux.vld_m.sum(1)
        assert bool(torch.equal(
            aux.vld_m, torch.arange(cfg.k_macro)[None] < counts[:, None]))
        assert int(counts.max()) == cfg.k_macro
        if margin == 0.0:
            step = aux.sel_m[:, 1:] - aux.sel_m[:, :-1]
            assert bool(torch.all((step > 0) | ~aux.vld_m[:, 1:]))


# ------------------------------------------------------------ the render

@pytest.mark.parametrize("backend", ["pallas", "pallas_compact", "xla"])
def test_render_backends_match_xla(backend):
    """Image, depth and opacity of a 96-Gaussian scene, and of another on a
    background colour."""
    for seed, bg in ((0, None), (2, [0.3, 0.1, 0.6])):
        jg, tg = both_gauss(blob_scene(96, seed))
        a = _jrender(jg, JI, JX, None if bg is None else jnp.asarray(bg))
        b = tr.render(tg, torch.eye(4), TI, TCfg(**CFG, backend=backend),
                      bg=None if bg is None else torch.tensor(bg))
        assert b.image.shape == (3, H, W)
        assert_image(b, a)
        np.testing.assert_array_equal(npy(b.radii), np.asarray(a.radii))


@pytest.mark.parametrize("backend", ["pallas", "pallas_compact", "xla"])
def test_render_backends_nondivisible_frame(backend):
    intr = dict(fx=60.0, fy=60.0, cx=24.5, cy=19.5, width=50, height=40)
    jg, tg = both_gauss(blob_scene(96, 5))
    a = _jrender(jg, JIntr(**intr), JX)
    b = tr.render(tg, torch.eye(4), TIntr(**intr),
                  TCfg(**CFG, backend=backend))
    assert b.image.shape == (3, 40, 50)
    assert_image(b, a)


def test_render_compact_truncation_matches_xla_sort():
    """At k_fine 16 the compact blend keeps each tile's 16 nearest
    overlapping rows, as the XLA "sort" fine stage; the masked walk keeps
    them all."""
    jg, tg = both_gauss(blob_scene(96, 7))
    a = _jrender(jg, JI, JX._replace(k_fine=16))
    tc = TCfg(**CFG)._replace(k_fine=16)
    b = tr.render(tg, torch.eye(4), TI, tc._replace(backend="pallas_compact"))
    np.testing.assert_allclose(npy(b.image), np.asarray(a.image), atol=3e-5)
    c = tr.render(tg, torch.eye(4), TI, tc._replace(backend="pallas"))
    assert float(torch.abs(c.image - b.image).max()) > 1e-3


def _jax_grads(jg, target, cfg):
    def loss(leaves, tau):
        g = jr.GaussianArrays(*leaves, active=jg.active)
        out = jr.render(g, jnp.eye(4), JI, cfg, tau=tau)
        return (jnp.mean(jnp.abs(out.image - target))
                + 0.1 * jnp.mean(out.depth) + 0.05 * jnp.mean(out.opacity))

    leaves = tuple(getattr(jg, k) for k in LEAVES)
    return jax.jit(jax.grad(loss, argnums=(0, 1)))(leaves, jnp.zeros(6))


@pytest.fixture(scope="module")
def grad_ref():
    jg, tg = both_gauss(blob_scene(96, 3))
    target = _jrender(jg, JI, JX).image * 0.9
    return tg, npy(target), _jax_grads(jg, target, JX)


@pytest.mark.parametrize("backend", ["pallas", "pallas_compact", "xla"])
def test_render_backends_gradients(grad_ref, backend):
    """test_pallas_backward_matches_xla's loss: gradients in every map leaf
    and in the pose tangent against the JAX XLA render's."""
    tg, target, (ga, ta) = grad_ref
    leaves = [getattr(tg, k).clone().requires_grad_(True) for k in LEAVES]
    tau = torch.zeros(6, requires_grad=True)
    g = tr.GaussianArrays(*leaves, active=tg.active)
    out = tr.render(g, torch.eye(4), TI, TCfg(**CFG, backend=backend),
                    tau=tau)
    loss = (torch.mean(torch.abs(out.image - t(target)))
            + 0.1 * torch.mean(out.depth) + 0.05 * torch.mean(out.opacity))
    loss.backward()
    np.testing.assert_allclose(npy(tau.grad), np.asarray(ta), rtol=2e-3,
                               atol=1e-6)
    for x, r, name in zip(leaves, ga, LEAVES):
        np.testing.assert_allclose(npy(x.grad), np.asarray(r), rtol=2e-3,
                                   atol=2e-5, err_msg=name)
    assert np.abs(npy(leaves[0].grad)).max() > 0


@pytest.mark.parametrize("macro_chunk", [0, 1])
def test_xla_n_touched_exact(macro_chunk):
    """The XLA path's n_touched, with the tiles in one checkpointed pass and
    in chunks of one macro tile (the JAX package's counts do not depend on
    the chunking); "pallas" and "pallas_compact" take the XLA path with
    n_touched, as in the JAX package."""
    jg, tg = both_gauss(blob_scene(96, 8))
    a = _jrender(jg, JI, JX._replace(with_n_touched=True))
    for backend in ("xla", "pallas", "pallas_compact"):
        b = tr.render(tg, torch.eye(4), TI, TCfg(**CFG)._replace(
            with_n_touched=True, macro_chunk=macro_chunk, backend=backend))
        np.testing.assert_array_equal(npy(b.n_touched),
                                      np.asarray(a.n_touched))
        assert_image(b, a)
    assert int(np.asarray(a.n_touched).sum()) > 0


def test_render_golden_parity():
    jg, tg = both_gauss(blob_scene(24, 9))
    tau = small_tau(10, 0.02)
    a = jr.render_golden(jg, jnp.eye(4), JI, tau=jnp.asarray(tau),
                         bg=jnp.asarray([0.2, 0.4, 0.1]))
    b = tr.render_golden(tg, torch.eye(4), TI, tau=t(tau),
                         bg=torch.tensor([0.2, 0.4, 0.1]))
    assert_image(b, a)
    np.testing.assert_array_equal(npy(b.n_touched), np.asarray(a.n_touched))
    assert int(npy(b.n_touched).sum()) > 0


@pytest.mark.parametrize("axis,block", [(0, 16), (1, 8)])
def test_blocked_cumprod_excl(axis, block):
    x = np.random.default_rng(11).uniform(0.2, 1.0, (64, 48)).astype(
        np.float32)
    ja, jb = jax.jit(jscan.blocked_cumprod_excl, static_argnums=(1, 2))(
        jnp.asarray(x), axis, block)
    ta, tb = tscan.blocked_cumprod_excl(t(x), axis=axis, block=block)
    np.testing.assert_allclose(npy(ta), np.asarray(ja), rtol=1e-6)
    np.testing.assert_allclose(npy(tb), np.asarray(jb), rtol=1e-6)
    with pytest.raises(ValueError, match="multiple"):
        tscan.blocked_cumprod_excl(t(x), axis=axis, block=7)


def test_wrappers_check_devices():
    """The macro wrappers run their plain versions only for CPU tensors and
    count no launch there; any other device raises."""
    data_m, xy0, counts, pmat = macro_inputs(seed=12, n=24)
    before = dict(tbm.LAUNCHES)
    tbm.blend_macros(data_m, xy0, counts, pmat, 16, 2, W, H)
    tbm.blend_macros(data_m, xy0, counts, pmat, 16, 2, W, H, k_fine=16)
    assert tbm.LAUNCHES == before
    meta = data_m.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tbm.blend_macros(meta, xy0, counts, pmat, 16, 2, W, H)
    with pytest.raises(ValueError, match="unsupported device"):
        tbm.blend_macros_vjp(meta, xy0, counts, pmat, None, 16, 2, W, H,
                             k_fine=16)
    with pytest.raises(ValueError, match="backend"):
        tr.render(tr.GaussianArrays(*(torch.zeros(1)
                                      for _ in range(6))), torch.eye(4), TI,
                  TCfg(backend="cuda"))
