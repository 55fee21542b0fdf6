"""The plain versions of the gathers K5, K6 and K7
(``ops/patch_gather.py``) against the JAX package's XLA twins and
against the TPU kernels themselves, run by Pallas in interpret mode on
the CPU, and the wrappers' dispatch; on a stack of planes (the
multi-stream engine's call, K1 and K9 too) against ``jax.vmap`` of the
XLA twins.  The CUDA kernels are held against these plain versions on
the card (``tests/test_torch_cuda.py``).

One level (64x48, pad = psz) of a rendered 128x96 frame; 20 interior
centers, then centers on and beyond the frustum border; psz 8 and 6.

Tolerances:
- vs the XLA twins (``extract_patches(use_pallas=False)``,
  ``extract_patches_grad(use_pallas=False)``, ``gather_windows_any``):
  the same float operations in the same order, border included:
  0 without the patch mean (asserted exact), and 1.5e-5 to 4.6e-5 (1
  to 3 ulp of intensities below 256) with it, where the 64 or 36 pixels
  are summed in another order and divided by 36: atol 8e-5.  Windows
  are exact copies.
- vs the Pallas kernels, interior centers: the kernels blend the same 4
  taps through lane rolls; measured up to 3.1e-5: atol 4e-5, windows
  exact.  At the frustum border the Pallas kernels clip a window start
  to [0, H-1] over an edge-padded plane where the XLA twins (and the
  port) move the start back so that the window fits: the tests assert
  that the two differ there and ROADMAP.md (Queue 3) records by how much.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from invcompcamtrack_tpu.image import patch as jpatch
from invcompcamtrack_tpu.image.pyramid import build_pyramid as jbuild
from invcompcamtrack_tpu.ops import patch_pallas as jpallas
from invcompcamtrack_tpu.ops import window_sample as jws
from invcompcamtrack_torch import convert
from invcompcamtrack_torch.image import patch as tpatch
from invcompcamtrack_torch.ops import patch_gather, patch_prefetch
from invcompcamtrack_torch.ops import window_sample as ws
from tests.torch_helpers import make_pair, t32

N_INT = 20
W, H = 64.0, 48.0


def _case(psz):
    rng = np.random.default_rng(20 + psz)
    pad = psz
    _, _, img, _, _ = make_pair(rng, 4, wh=(128, 96))
    jl = jbuild(jnp.asarray(img), 2, pad)[1]
    tl = convert.pyramid_from_numpy([[np.asarray(a) for a in jl]], "cpu")[0]
    interior = np.c_[rng.uniform(8, W - 8, N_INT), rng.uniform(8, H - 8, N_INT)]
    border = np.array([[W, H], [0.2, H], [W, 20.5], [13.7, H], [0.0, 0.0],
                       [0.0, 31.25], [17.5, 0.0], [90.0, 70.0]])
    centers = np.r_[interior, border].astype(np.float32)
    win = psz + 8
    origins = np.asarray(jws.window_origin(jnp.asarray(centers), psz, win, pad))
    return dict(psz=psz, pad=pad, win=win, jl=jl, tl=tl, centers=centers, origins=origins)


@pytest.fixture(scope="module", params=[8, 6], ids=["psz8", "psz6"])
def case(request):
    return _case(request.param)


@pytest.fixture(scope="module")
def case8():
    return _case(8)


def _np(x):
    return [np.asarray(a) for a in (x if isinstance(x, (tuple, list)) else (x,))]


@pytest.mark.parametrize("patch_norm", [False, True])
def test_k5_plain_matches_xla_twin(case, patch_norm):
    c = case
    got = patch_gather.gather_patches_plain(c["tl"].img, t32(c["centers"]), c["psz"],
                                            c["pad"], patch_norm).numpy()
    want = np.asarray(jpatch.extract_patches(c["jl"].img, jnp.asarray(c["centers"]),
                                             c["psz"], c["pad"], patch_norm,
                                             use_pallas=False))
    assert got.shape == (len(c["centers"]), c["psz"], c["psz"])
    np.testing.assert_allclose(got, want, rtol=0, atol=8e-5 if patch_norm else 0.0)


@pytest.mark.parametrize("patch_norm", [False, True])
def test_k6_plain_matches_xla_twin(case, patch_norm):
    c = case
    got = patch_gather.gather_patches_grad_plain(
        c["tl"].img, c["tl"].dx, c["tl"].dy, t32(c["centers"]), c["psz"], c["pad"],
        patch_norm)
    want = jpatch.extract_patches_grad(c["jl"].img, c["jl"].dx, c["jl"].dy,
                                       jnp.asarray(c["centers"]), c["psz"], c["pad"],
                                       patch_norm, use_pallas=False)
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=8e-5 if patch_norm and k == 0 else 0.0)


def test_k7_plain_matches_xla_twin(case):
    c = case
    got = patch_gather.gather_windows_plain(c["tl"].img, torch.tensor(c["origins"]),
                                            c["win"], c["win"]).numpy()
    want = np.asarray(jws.gather_windows_any(c["jl"].img, jnp.asarray(c["origins"]),
                                             c["win"]))
    np.testing.assert_array_equal(got, want)
    # rectangular windows: the rule per axis
    rect = patch_gather.gather_windows_plain(c["tl"].img, torch.tensor(c["origins"]),
                                             3, c["win"]).numpy()
    np.testing.assert_array_equal(rect[:N_INT], want[:N_INT, :3, :])


def test_k5_k6_k7_plain_match_pallas_interior_and_differ_at_the_border(case8):
    """One interpret-mode run of each TPU kernel over all centers (psz 8:
    an interpret-mode run takes seconds)."""
    c = case8
    jc, jo = jnp.asarray(c["centers"]), jnp.asarray(c["origins"])
    from jax.experimental.pallas import tpu as pltpu

    with pltpu.force_tpu_interpret_mode():
        k5 = _np(jax.block_until_ready(jpallas.gather_patches(
            c["jl"].img, jc, c["psz"], c["pad"])))
        k6 = _np(jax.block_until_ready(jpallas.gather_patches_grad(
            c["jl"].img, c["jl"].dx, c["jl"].dy, jc, c["psz"], c["pad"])))
        k7 = _np(jax.block_until_ready(jpallas.gather_windows(
            c["jl"].img, jo, c["win"], c["win"])))
    tc, to = t32(c["centers"]), torch.tensor(c["origins"])
    p5 = _np(patch_gather.gather_patches_plain(c["tl"].img, tc, c["psz"], c["pad"]))
    p6 = _np(patch_gather.gather_patches_grad_plain(c["tl"].img, c["tl"].dx, c["tl"].dy,
                                                    tc, c["psz"], c["pad"]))
    p7 = _np(patch_gather.gather_windows_plain(c["tl"].img, to, c["win"], c["win"]))
    n = N_INT
    for got, want in zip(p5 + p6, k5 + k6):
        np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=4e-5)
    np.testing.assert_array_equal(p7[0][:n], k7[0][:n])
    # border and outside centers: the patch supports still fit the plane
    # (pad = psz), so K5 and K6 agree; the windows of centers with
    # v = sho, or outside, end past the plane and differ by whole
    # intensity steps
    gaps = {"K5": np.abs(p5[0][n:] - k5[0][n:]).max(axis=(1, 2)),
            "K6": np.max([np.abs(a[n:] - b[n:]).max(axis=(1, 2)) for a, b in zip(p6, k6)], 0),
            "K7": np.abs(p7[0][n:] - k7[0][n:]).max(axis=(1, 2))}
    print({k: np.round(v, 4).tolist() for k, v in gaps.items()})
    assert gaps["K5"][:-1].max() <= 4e-5 and gaps["K6"][:-1].max() <= 4e-5
    assert gaps["K7"][:2].max() > 1.0


def test_wrappers_on_cpu_are_the_plain_versions_and_check_their_inputs(case):
    c = case
    tl, psz, pad, win = c["tl"], c["psz"], c["pad"], c["win"]
    tc = t32(c["centers"]).reshape(2, -1, 2)
    to = torch.tensor(c["origins"]).reshape(2, -1, 2)
    before = dict(patch_gather.launches)
    np.testing.assert_array_equal(
        tpatch.extract_patches(tl.img, tc, psz, pad, True).numpy(),
        patch_gather.gather_patches_plain(tl.img, tc, psz, pad, True).numpy())
    for g, w in zip(tpatch.extract_patches_grad(tl.img, tl.dx, tl.dy, tc, psz, pad),
                    patch_gather.gather_patches_grad_plain(tl.img, tl.dx, tl.dy, tc,
                                                           psz, pad)):
        assert g.shape == (2, len(c["centers"]) // 2, psz, psz)
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    np.testing.assert_array_equal(
        ws.gather_windows_any(tl.img, to, win).numpy(),
        patch_gather.gather_windows_plain(tl.img, to, win, win).numpy())
    assert patch_gather.launches == before
    meta = tl.img.to("meta")
    for call in (lambda: patch_gather.gather_patches(meta, tc, psz, pad),
                 lambda: patch_gather.gather_patches_grad(meta, meta, meta, tc, psz, pad),
                 lambda: patch_gather.gather_windows(meta, to, win, win)):
        with pytest.raises(ValueError, match="no kernel"):
            call()


def test_sample_from_windows_matches_jax(case):
    """The resample of the non-fused window cache: centers moved by up
    to +-5 px from the window's entry position (beyond the slack the
    offsets clamp), with and without the patch mean."""
    c = case
    rng = np.random.default_rng(3)
    n = N_INT
    moved = (c["centers"][:n] + rng.uniform(-5, 5, (n, 2))).astype(np.float32)
    wins = jws.gather_windows_any(c["jl"].img, jnp.asarray(c["origins"][:n]), c["win"])
    for pn in (False, True):
        want = np.asarray(jws.sample_from_windows(
            wins, jnp.asarray(c["origins"][:n]), jnp.asarray(moved), c["psz"], c["pad"],
            patch_norm=pn))
        got = ws.sample_from_windows(t32(np.asarray(wins)), torch.tensor(c["origins"][:n]),
                                     t32(moved), c["psz"], c["pad"], patch_norm=pn).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-5)


@pytest.fixture(scope="module")
def stack_case():
    """P = 2 planes (level 1 of the two frames of a 128x96 pair) with 14
    interior and 4 border centres each, and the window origins."""
    rng = np.random.default_rng(41)
    _, _, img_a, img_b, _ = make_pair(rng, 4, wh=(128, 96))
    out = {}
    for psz in (8, 6):
        jl = [jbuild(jnp.asarray(im), 2, psz)[1] for im in (img_a, img_b)]
        jst = type(jl[0])(*(jnp.stack([lv[k] for lv in jl]) for k in range(3)))
        tst = convert.pyramid_from_numpy([[np.asarray(a) for a in jst]], "cpu")[0]
        cs = np.stack([np.r_[np.c_[rng.uniform(8, W - 8, 14), rng.uniform(8, H - 8, 14)],
                             [[W, H], [0.2, H], [0.0, 0.0], [W, 20.5]]]
                       for _ in range(2)]).astype(np.float32)
        win = psz + 8
        origins = np.asarray(jws.window_origin(
            jnp.asarray(cs + rng.uniform(-2, 2, cs.shape).astype(np.float32)), psz, win, psz))
        out[psz] = dict(jst=jst, tst=tst, centers=cs, origins=origins, win=win)
    return out


@pytest.mark.parametrize("psz", [8, 6])
@pytest.mark.parametrize("patch_norm", [False, True])
def test_plain_gathers_on_a_stack_match_vmapped_xla_twins(stack_case, psz, patch_norm):
    """K5, K6, K7 and the dual gather of K1 and K9 (psz 8) on a stack of
    P = 2 planes, centres (2, 18, 2): the plain versions against
    ``jax.vmap`` of the JAX package's XLA twins over the planes.  The
    tolerances of the single-plane tests above: exact, 8e-5 for the
    patch mean."""
    c = stack_case[psz]
    js, ts, win = c["jst"], c["tst"], c["win"]
    jc, jo = jnp.asarray(c["centers"]), jnp.asarray(c["origins"])
    tc, to = t32(c["centers"]), torch.tensor(c["origins"])
    atol = 8e-5 if patch_norm else 0.0
    want5 = jax.vmap(lambda im, ce: jpatch.extract_patches(
        im, ce, psz, psz, patch_norm, use_pallas=False))(js.img, jc)
    np.testing.assert_allclose(patch_gather.gather_patches_plain(ts.img, tc, psz, psz,
                                                                 patch_norm).numpy(),
                               np.asarray(want5), rtol=0, atol=atol)
    want6 = jax.vmap(lambda im, dx, dy, ce: jpatch.extract_patches_grad(
        im, dx, dy, ce, psz, psz, patch_norm, use_pallas=False))(js.img, js.dx, js.dy, jc)
    got6 = patch_gather.gather_patches_grad_plain(ts.img, ts.dx, ts.dy, tc, psz, psz,
                                                  patch_norm)
    for k, (g, w) in enumerate(zip(got6, want6)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=atol if k == 0 else 0.0)
    want7 = jax.vmap(lambda im, o: jws.gather_windows_any(im, o, win))(js.img, jo)
    np.testing.assert_array_equal(patch_gather.gather_windows_plain(ts.img, to, win, win)
                                  .numpy(), np.asarray(want7))
    if psz != 8:
        return
    query = ts.img.flip(0).contiguous()        # each plane's partner as the query
    for plain in (patch_gather.gather_ref_grad_windows_plain,
                  patch_prefetch.gather_ref_grad_windows_prefetch_plain):
        got = plain(ts, query, tc, to, psz, psz, win, patch_norm)
        for k, (g, w) in enumerate(zip(got[:3], want6)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=atol if k == 0 else 0.0)
        want_q = jax.vmap(lambda im, o: jws.gather_windows_any(im, o, win))(
            js.img[::-1], jo)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want_q))
        # and each plane's points as a call on that plane alone
        for p in range(2):
            lvl = type(ts)(*(a[p] for a in ts))
            one = plain(lvl, query[p], tc[p], to[p], psz, psz, win, patch_norm)
            for g, w in zip(got, one):
                assert torch.equal(g[p], w)
