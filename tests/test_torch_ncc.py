"""The port's ``match/ncc.py`` function by function, and the fused
scorer K4's plain version (``ops/ncc3.py``), against the JAX package on
the same float32 inputs made with numpy from a seed.

Tolerances (float32 on both sides; beside each, the gap measured on
these inputs and the JAX package's own float32-vs-float64 gap):
- ``ncc_score`` and the fb-weighted scores: both sides divide each patch
  by its norm and sum 64 products, in other orders.  Measured 1.8e-7,
  JAX float32-vs-float64 2.2e-7: atol 1e-6.
- FFT surface: pocketfft on both sides, values up to 1.4e5; measured
  1.7e-7 of the largest entry, JAX float32-vs-float64 1.8e-7: 2e-6 of
  the largest entry.  MOSSE filter (|H| <= 0.28) and response
  (<= 0.04): measured 2.4e-7 and 3e-8, JAX float32-vs-float64 1.2e-7
  and 8e-9: atol 2e-6.
- ``gauss2d``, ``cosine_window``: elementwise, measured <= 6e-8 on
  values <= 1: atol 1e-7.  ``peak_subpixel``: the same argmax and one
  division, atol 1e-5 on offsets within +-P/2.
- K4's plain version vs the XLA path: the same operations, measured
  9e-8 (XLA float32-vs-float64 6e-8): atol 1e-6.  Vs the Pallas kernel
  in interpret mode, which divides the dot product by the product of
  the norms instead of normalising first: measured 6e-8 on scores in
  [0, 1]: atol 2e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.image.patch import extract_patches as jextract
from invcompcamtrack_tpu.match import ncc as jncc
from invcompcamtrack_tpu.ops.ncc_pallas import ncc3_scores as jncc3
from invcompcamtrack_torch.match import ncc
from invcompcamtrack_torch.ops import ncc3
from tests.torch_helpers import t32


def j32(a):
    return jnp.asarray(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def patches():
    rng = np.random.default_rng(11)
    back, ref, fwd = (rng.uniform(0, 255, (3, 12, 8, 8)).astype(np.float32))
    ref[3] = 0.0           # a zero patch: the norm floor
    fwd[5] = 91.5          # a flat patch (not mean-removed here)
    valid = rng.uniform(size=(3, 3, 12)) > 0.25
    return back, ref, fwd, valid


def test_ncc_score_matches_jax(patches):
    back, ref, fwd, _ = patches
    got = ncc.ncc_score(t32(back), t32(ref)).numpy()
    want = np.asarray(jncc.ncc_score(j32(back), j32(ref)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[3] == 0.0 and np.all(got >= 0) and got.max() > 0.5


@pytest.mark.parametrize("fb", [(1, 1), (2, 1), (0, 3)])
def test_patch_correlation_score_and_combine_match_jax(patches, fb):
    back, ref, fwd, valid = patches
    vb, vr, vf = valid
    got = ncc.patch_correlation_score(t32(back), t32(ref), t32(fwd), torch.tensor(vb),
                                      torch.tensor(vr), torch.tensor(vf), fb).numpy()
    want = np.asarray(jncc.patch_correlation_score(
        j32(back), j32(ref), j32(fwd), jnp.asarray(vb), jnp.asarray(vr),
        jnp.asarray(vf), fb))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got == -1.0, ~vr)
    cbr, crf = np.linspace(0, 1, 12, dtype=np.float32), np.linspace(1, 0, 12, dtype=np.float32)
    got_c = ncc.patch_correlation_combine(t32(cbr), t32(crf), torch.tensor(vb),
                                          torch.tensor(vr), torch.tensor(vf), fb).numpy()
    want_c = np.asarray(jncc.patch_correlation_combine(
        j32(cbr), j32(crf), jnp.asarray(vb), jnp.asarray(vr), jnp.asarray(vf), fb))
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-7)


def test_fft_surface_and_peak_match_jax():
    rng = np.random.default_rng(12)
    tmpl = rng.uniform(0, 1, (5, 3, 16, 16)).astype(np.float32) * 40
    query = np.roll(tmpl, (2, -3), axis=(-2, -1)) + rng.normal(size=tmpl.shape).astype(np.float32)
    got = ncc.ncc_surface_fft(t32(tmpl), t32(query))
    want = np.asarray(jncc.ncc_surface_fft(j32(tmpl), j32(query)))
    assert got.shape == (5, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * want.max())
    off, val = ncc.peak_subpixel(got)
    off_j, val_j = jncc.peak_subpixel(jnp.asarray(want))
    np.testing.assert_allclose(off.numpy(), np.asarray(off_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(val.numpy(), np.asarray(val_j), rtol=2e-5, atol=0)
    # the shift is recovered: (dx, dy) = (-3, 2) within half a pixel
    assert np.all(np.abs(off.numpy() - np.array([-3.0, 2.0])) < 0.5)
    # a peak on the surface's edge clamps its neighbours; a flat one gives 0
    edge = np.zeros((2, 8, 8), np.float32)
    edge[0, 0, 7] = 1.0
    off_e, _ = ncc.peak_subpixel(t32(edge))
    off_ej, _ = jncc.peak_subpixel(j32(edge))
    np.testing.assert_allclose(off_e.numpy(), np.asarray(off_ej), rtol=0, atol=1e-6)


@pytest.mark.parametrize("psz,sigma", [(8, 1.0), (9, 2.5), (16, 0.4)])
def test_gauss_and_cosine_windows_match_jax(psz, sigma):
    np.testing.assert_allclose(ncc.gauss2d(psz, sigma).numpy(),
                               np.asarray(jncc.gauss2d(psz, sigma)), rtol=0, atol=1e-7)
    np.testing.assert_allclose(ncc.cosine_window(psz).numpy(),
                               np.asarray(jncc.cosine_window(psz)), rtol=0, atol=1e-7)
    assert abs(float(ncc.gauss2d(psz, sigma).sum()) - 1.0) < 1e-6


def test_mosse_filter_and_response_match_jax():
    rng = np.random.default_rng(13)
    tmpl = (rng.uniform(0, 1, (4, 2, 16, 16)).astype(np.float32)
            * np.asarray(jncc.cosine_window(16)))
    query = np.roll(tmpl, (1, 2), axis=(-2, -1))
    h = ncc.mosse_filter(t32(tmpl), 2.0, beta=0.1)
    h_j = jncc.mosse_filter(j32(tmpl), 2.0, beta=0.1)
    assert h.dtype == torch.complex64 and h.shape == (4, 2, 16, 16)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=0, atol=2e-6)
    got = ncc.mosse_response(h, t32(query)).numpy()
    want = np.asarray(jncc.mosse_response(h_j, j32(query)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert got.shape == (4, 16, 16) and got.max() > 0.01


# ---------------------------------------------------------------- K4


@pytest.fixture(scope="module")
def k4_case():
    """tests/test_match.py's K4 case: three random 96x144 planes (padded
    coordinates, pad 8), 37 interior centers per plane, then centers on
    and beyond the frustum border, shared by the three planes."""
    rng = np.random.default_rng(14)
    psz = pad = 8
    H, W = 96, 144
    imgs = [rng.uniform(0, 255, (H, W)).astype(np.float32) for _ in range(3)]
    imgs[2][:24, :24] = 77.25       # a flat corner in the fwd plane
    n = 37
    uvs = [np.c_[rng.uniform(pad + 6, W - pad - 6, n) - pad,
                 rng.uniform(pad + 6, H - pad - 6, n) - pad].astype(np.float32)
           for _ in range(3)]
    uvs[2][:3] = [[6.5, 5.25], [4.0, 7.5], [7.75, 4.5]]   # flat fwd patches
    w, h = W - 2 * pad, H - 2 * pad
    border = np.array([[w, h], [0.0, 0.0], [0.3, h], [w, 10.5], [-40.0, -40.0],
                       [1e9, 3.0], [3.0, -1e12]], np.float32)
    uvs = [np.r_[uv, border] for uv in uvs]
    plain = ncc3.ncc3_scores_plain(*(t32(a) for a in imgs), *(t32(a) for a in uvs),
                                   psz, pad)
    return dict(imgs=imgs, uvs=uvs, n=n, psz=psz, pad=pad,
                plain=[a.numpy() for a in plain])


def test_k4_plain_matches_xla_path(k4_case):
    c = k4_case
    pats = [jextract(j32(im), j32(uv[:c["n"]]), c["psz"], c["pad"], patch_norm=True,
                     use_pallas=False) for im, uv in zip(c["imgs"], c["uvs"])]
    want = (jncc.ncc_score(pats[0], pats[1]), jncc.ncc_score(pats[1], pats[2]))
    for got, w in zip(c["plain"], want):
        np.testing.assert_allclose(got[:c["n"]], np.asarray(w), rtol=0, atol=1e-6)
    # a flat patch has no direction: its score is the floor's 0
    assert np.all(c["plain"][1][:3] == 0.0)
    assert all(np.all(np.isfinite(a)) and a.min() >= 0 and a.max() <= 1 + 1e-6
               for a in c["plain"])


def test_k4_plain_matches_pallas_interior(k4_case):
    c = k4_case
    n = c["n"]
    cbr, crf = jncc3(*(j32(a) for a in c["imgs"]), *(j32(uv[:n]) for uv in c["uvs"]),
                     psz=c["psz"], padding=c["pad"], interpret=True)
    np.testing.assert_allclose(c["plain"][0][:n], np.asarray(cbr), rtol=0, atol=2e-6)
    np.testing.assert_allclose(c["plain"][1][:n], np.asarray(crf), rtol=0, atol=2e-6)


def test_k4_wrapper_on_cpu_is_the_plain_version(k4_case):
    c = k4_case
    before = dict(ncc3.launches)
    uvs = [t32(uv).reshape(1, -1, 2) for uv in c["uvs"]]
    got = ncc3.ncc3_scores(*(t32(a) for a in c["imgs"]), *uvs, c["psz"], c["pad"])
    for g, want in zip(got, c["plain"]):
        assert g.shape == (1, len(want))
        np.testing.assert_array_equal(g[0].numpy(), want)
    assert ncc3.launches == before
    meta = [t32(a).to("meta") for a in c["imgs"]]
    with pytest.raises(ValueError, match="no kernel"):
        ncc3.ncc3_scores(*meta, *uvs, c["psz"], c["pad"])
