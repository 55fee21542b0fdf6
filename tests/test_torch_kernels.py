"""The port's kernel modules (K1 ``ops/patch_gather.py``, K2/K3
``ops/icgn_iter.py``): their plain versions against the TPU kernels
themselves, run by Pallas in interpret mode on the CPU, and the wrappers'
dispatch.  The CUDA kernels are held against
its plain version on the card (``tests/test_torch_cuda.py``, which
imports no JAX so that it runs on the card's machine).

Tolerances:
- K1 reference patches: the Pallas kernel blends the 4 taps in the same
  order but reaches them through lane rolls; measured gap 0 to 2 ulp of
  intensities below 256, asserted at 4e-5.  Windows are exact copies.
- K1 at the frustum border follows the JAX package's XLA twins
  (``extract_patches_grad`` + ``gather_windows_any``) exactly; the
  Pallas kernel does not (see ``test_k1_border_follows_xla_twin``).
- K2/K3: the Pallas resample adds the taps pairwise ((w00 a + w10 c) +
  (w01 b + w11 d)) and sums the 64 pixels in another order, so the gap
  is relative to the magnitudes summed: 1e-5 of sum |p_dx * pdiff| for
  (gx, gy), 4e-5 absolute on the error image (values below 256).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from invcompcamtrack_tpu.image import patch as jpatch
from invcompcamtrack_tpu.image.pyramid import build_pyramid as jbuild
from invcompcamtrack_tpu.ops import icgn_iter_pallas as jiter
from invcompcamtrack_tpu.ops import window_sample as jws
from invcompcamtrack_tpu.ops.patch_pallas import gather_ref_grad_and_windows
from invcompcamtrack_torch import convert
from invcompcamtrack_torch.image.pyramid import PyramidLevel, build_pyramid
from invcompcamtrack_torch.ops import icgn_iter, patch_gather
from invcompcamtrack_torch.ops import window_sample as ws
from tests.torch_helpers import make_pair, t32

PSZ, PAD, WIN = 8, 8, 16
N_INTERIOR = 24


@pytest.fixture(scope="module")
def k1_case():
    """Level 1 (64x48) of the JAX pyramids of a 128x96 pair, carried into
    the port; interior centers, then centers on the frustum border.  The
    Pallas kernel runs once, in interpret mode, over all of them."""
    rng = np.random.default_rng(4)
    _, _, img_ref, img_new, _ = make_pair(rng, 4, wh=(128, 96))
    jr, jn = jbuild(jnp.asarray(img_ref), 2, PAD)[1], jbuild(jnp.asarray(img_new), 2, PAD)[1]
    tr, tn = convert.pyramid_from_numpy([[np.asarray(a) for a in lvl] for lvl in (jr, jn)])
    w, h = 64.0, 48.0
    interior = np.c_[rng.uniform(6, w - 6, N_INTERIOR), rng.uniform(6, h - 6, N_INTERIOR)]
    border = np.array([[w, h], [0.2, h], [w, 20.5], [13.7, h], [0.0, 0.0],
                       [0.0, 31.25], [17.5, 0.0]])
    centers = np.r_[interior, border].astype(np.float32)
    entry = (centers + rng.uniform(-1.5, 1.5, centers.shape)).astype(np.float32)
    entry[N_INTERIOR:] = centers[N_INTERIOR:]
    origins = np.asarray(jws.window_origin(jnp.asarray(entry), PSZ, WIN, PAD))
    with pltpu.force_tpu_interpret_mode():
        pallas = jax.block_until_ready(gather_ref_grad_and_windows(
            jr.img, jn.img, jnp.asarray(centers), jnp.asarray(origins), PSZ, PAD,
            WIN, patch_norm=True))
    twin = jpatch.extract_patches_grad(jr.img, jr.dx, jr.dy, jnp.asarray(centers),
                                       PSZ, PAD, patch_norm=True, use_pallas=False)
    twin = tuple(twin) + (jws.gather_windows_any(jn.img, jnp.asarray(origins), WIN),)
    plain = patch_gather.gather_ref_grad_windows_plain(
        tr, tn.img, t32(centers), torch.tensor(origins), PSZ, PAD, WIN, patch_norm=True)
    return dict(tr=tr, tn=tn, centers=centers, origins=origins,
                pallas=[np.asarray(a) for a in pallas],
                twin=[np.asarray(a) for a in twin], plain=[a.numpy() for a in plain])


def test_k1_plain_matches_pallas_interior(k1_case):
    n = N_INTERIOR
    for name, got, want in zip(("p_img", "p_dx", "p_dy", "qwin"), k1_case["plain"],
                               k1_case["pallas"]):
        atol = 0.0 if name == "qwin" else 4e-5
        np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=atol, err_msg=name)


def test_k1_border_follows_xla_twin(k1_case):
    for got, want in zip(k1_case["plain"], k1_case["twin"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=4e-5)
    np.testing.assert_array_equal(k1_case["plain"][3], k1_case["twin"][3])
    # The TPU kernel clips a window origin to [0, H-1] and reads an
    # edge-padded plane; the XLA twin (and the port) move a window that
    # would leave the plane back inside it.  For centers with v = sho
    # the 16x16 window ends one row past the padded plane, so the two
    # disagree by whole intensity steps there.
    n = N_INTERIOR
    gap = np.abs(k1_case["plain"][3][n:n + 2] - k1_case["pallas"][3][n:n + 2])
    assert gap.max() > 1.0, gap.max()


def test_k1_wrapper_on_cpu_is_the_plain_version(k1_case):
    before = dict(patch_gather.launches)
    got = patch_gather.gather_ref_grad_windows(
        k1_case["tr"], k1_case["tn"].img, t32(k1_case["centers"]).reshape(1, -1, 2),
        torch.tensor(k1_case["origins"]).reshape(1, -1, 2), PSZ, PAD, WIN,
        patch_norm=True)
    for g, want in zip(got, k1_case["plain"]):
        assert g.shape[0] == 1
        np.testing.assert_array_equal(g[0].numpy(), want)
    assert patch_gather.launches == before


@pytest.fixture(scope="module")
def k2_inputs():
    """Realistic K2 operands: windows and patches gathered from a
    rendered pair, tap offsets across [0, 7]^2, some invalid points."""
    rng = np.random.default_rng(5)
    _, _, img_ref, img_new, _ = make_pair(rng, 4, wh=(128, 96))
    lvl = build_pyramid(t32(img_ref), 1, PAD)[0]
    qimg = build_pyramid(t32(img_new), 1, PAD)[0].img
    M = 32
    centers = t32(np.c_[rng.uniform(8, 120, M), rng.uniform(8, 88, M)])
    origins = ws.window_origin(centers, PSZ, WIN, PAD)
    p_img, p_dx, p_dy, qwin = patch_gather.gather_ref_grad_windows_plain(
        lvl, qimg, centers, origins, PSZ, PAD, WIN)
    moved = centers + t32(rng.uniform(-4.5, 4.5, (M, 2)))
    row_w, col_w, wts = ws.window_taps(moved, origins, PSZ, PAD, WIN)
    valid = t32(rng.uniform(size=M) > 0.15)
    return dict(qwin=qwin.reshape(M, -1), ref=p_img.reshape(M, -1),
                pdx=p_dx.reshape(M, -1), pdy=p_dy.reshape(M, -1), row_w=row_w,
                col_w=col_w, wts=wts, valid=valid)


def _stored(k, bf16):
    """The K2 operands in their storage type (and the f32 values that
    the Pallas kernel is given, which round to the same bf16)."""
    dt = torch.bfloat16 if bf16 else torch.float32
    return {n: (v.to(dt).contiguous() if n in ("qwin", "ref", "pdx", "pdy") else v)
            for n, v in k.items()}


def _strided(x):
    return jiter.to_strided(jnp.asarray(x.float().numpy()).reshape(-1, PSZ, PSZ))


def _pallas_args(s, bf16):
    cast = (lambda a: a.astype(jnp.bfloat16)) if bf16 else (lambda a: a)
    return ([cast(jnp.asarray(s["qwin"].float().numpy()))]
            + [cast(_strided(s[n])) for n in ("ref", "pdx", "pdy")]
            + [jnp.asarray(s[n].numpy()) for n in ("row_w", "col_w", "wts", "valid")])


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("patch_norm", [False, True])
def test_k2_plain_matches_pallas(k2_inputs, bf16, patch_norm):
    s = _stored(k2_inputs, bf16)
    got = icgn_iter.fused_resample_project_plain(
        s["qwin"], s["ref"], s["pdx"], s["pdy"], s["row_w"], s["col_w"], s["wts"],
        s["valid"], patch_norm).numpy()
    qw, ref, pdx, pdy, rw, cw, wts, valid = _pallas_args(s, bf16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jiter.fused_resample_project(
            qw, ref, pdx, pdy, rw, cw, wts, valid, patch_norm=patch_norm))
    pdiff = icgn_iter.fused_resample_pdiff_plain(
        s["qwin"], s["ref"], s["row_w"], s["col_w"], s["wts"], s["valid"], patch_norm)
    scale = torch.stack([(s["pdx"].float() * pdiff).abs().sum(-1),
                         (s["pdy"].float() * pdiff).abs().sum(-1)], -1).numpy()
    assert np.all(np.abs(got - want) <= 1e-5 * scale + 1e-6), np.abs(got - want).max()
    assert np.any(got != 0) and np.all(got[s["valid"].numpy() == 0] == 0)


@pytest.mark.parametrize("patch_norm", [False, True])
def test_k3_plain_matches_pallas(k2_inputs, patch_norm):
    s = k2_inputs
    got = icgn_iter.fused_resample_pdiff_plain(
        s["qwin"], s["ref"], s["row_w"], s["col_w"], s["wts"], s["valid"],
        patch_norm).numpy()
    qw, ref, _, _, rw, cw, wts, valid = _pallas_args(s, False)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jiter.fused_resample_pdiff(qw, ref, rw, cw, wts, valid,
                                                     patch_norm=patch_norm))
    want = want.reshape(-1, PSZ, WIN)[:, :, :PSZ].reshape(-1, PSZ * PSZ)
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-5)


def test_k2_k3_wrappers_on_cpu_are_the_plain_versions(k2_inputs):
    s = k2_inputs
    args = (s["row_w"], s["col_w"], s["wts"], s["valid"])
    before = dict(icgn_iter.launches)
    np.testing.assert_array_equal(
        icgn_iter.fused_resample_project(s["qwin"], s["ref"], s["pdx"], s["pdy"], *args,
                                         patch_norm=True).numpy(),
        icgn_iter.fused_resample_project_plain(s["qwin"], s["ref"], s["pdx"], s["pdy"],
                                               *args, patch_norm=True).numpy())
    np.testing.assert_array_equal(
        icgn_iter.fused_resample_pdiff(s["qwin"], s["ref"], *args).numpy(),
        icgn_iter.fused_resample_pdiff_plain(s["qwin"], s["ref"], *args).numpy())
    assert icgn_iter.launches == before


def test_kernel_input_checks_raise(k2_inputs):
    s = k2_inputs
    planes = (s["ref"], s["pdx"], s["pdy"])
    args = (s["row_w"], s["col_w"], s["wts"], s["valid"])
    assert not icgn_iter._check_inputs("k2", s["qwin"], planes, *args)
    with pytest.raises(TypeError):
        icgn_iter._check_inputs("k2", s["qwin"].double(), planes, *args)
    with pytest.raises(TypeError):
        icgn_iter._check_inputs("k2", s["qwin"], planes, s["row_w"].long(), *args[1:])
    with pytest.raises(ValueError):
        icgn_iter._check_inputs("k2", s["qwin"][:, :128], planes, *args)
    with pytest.raises(ValueError):
        icgn_iter._check_inputs("k2", s["qwin"], (s["ref"].t().contiguous().t(),) + planes[1:],
                                *args)
    meta = s["qwin"].to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        icgn_iter.fused_resample_pdiff(meta, s["ref"], *args)
    lvl = PyramidLevel(*(torch.zeros(32, 32, device="meta") for _ in range(3)))
    with pytest.raises(ValueError, match="no kernel"):
        patch_gather.gather_ref_grad_windows(lvl, lvl.img, s["wts"][:, :2], s["row_w"],
                                             PSZ, PAD, WIN)
