"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and ``nvcc`` and skips elsewhere.
The file imports no JAX, so that it runs on a machine with the card and
without JAX, and nothing of ``tests/`` (an installed top-level ``tests``
package can shadow this directory there):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances (kernel vs plain version, same inputs, both on the card):
- K1: the kernel performs the plain version's float operations in the
  same order (support starts, weights, taps and gradient differences
  through the non-contracting _rn intrinsics): bit-exact, also at
  integer, near-integer, negative and NaN centres (NaN where the plain
  version gives NaN).
- K2: the 64-pixel sums of the mean and of (gx, gy) run in a warp
  butterfly: 1e-5 of sum |p_d * pdiff|.  K3: exact without the mean,
  4e-5 (about 1 ulp of intensities below 256) with it.
- K5, K6: the plain version's float operations in its order, the
  support starts and weights included (the kernels take the centres);
  K7: a copy.  Bit-exact, at psz 8, 4, 6 and 16, at border, far-outside,
  integer, near-integer, negative and NaN centers (NaN where the plain
  version gives NaN); K5 also at psz 18 and 32 (the descriptors' and the
  flow benchmark's sides, compiled as the others) and 20 (any other side:
  one warp per point); K6 refuses them: it has no caller beyond 16.
- K8: the plain version's float operations in its order, through the
  non-contracting _rn intrinsics: bit-exact for every flow (smooth, a
  step, leaving the image, integer, infinite, NaN).
- K9: K1's own device functions on the same floats: equal to K1 and to
  the plain version bit for bit; the tracker's poses with
  ``gather_prefetch=True`` equal those without it bit for bit.
- K1, K5, K6, K7, K9 on a stack of planes (the multi-stream engine's
  call): the same operations per point, on the point's own plane: equal
  to the plain version and to one call per plane, bit for bit.
- ``dense_flow_lk``, card vs CPU: measured 0.0 px at every pixel on an
  H100 (torch 2.11, CUDA 12.8: the card's and the CPU's box convolutions
  sum in one order); another convolution algorithm need not, so the
  limits are those of two float32 runs of one flow: 1e-3 px on every
  pixel, 1e-5 px at the median.  Descriptors: 2e-6 on unit vectors.
- K4: three butterfly sums per patch and one division: 2e-5 of
  sum|p_a p_b| / (n_a n_b), plus 8 MEAN_EPS (1/n_a + 1/n_b) for the
  other summation order of the patch mean (MEAN_EPS = 6.2e-5, 2 ulp of
  256), which decides the score of a flat patch; scores stay in [0, 1].
  At the edge centres too; a centre that is not finite gives NaN in the
  scores it enters, in both versions.
- The tracker and the verifier, card vs CPU: other summation orders in
  H, rhs and (gx, gy), iterated; 1e-4 on the pose coefficients, 5e-3 on
  the correlations.
"""

import numpy as np
import pytest
import torch

from invcompcamtrack_torch import ICGNParams, synthetic
from invcompcamtrack_torch.cli import track_pair
from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.image.pyramid import PyramidLevel, build_pyramid
from invcompcamtrack_torch.match import dense_flow, descriptors
from invcompcamtrack_torch.ops import icgn_iter, ncc3, patch_gather, patch_prefetch, warp
from invcompcamtrack_torch.ops import window_sample as ws
from invcompcamtrack_torch.solver import chain, icgn
from invcompcamtrack_torch.utils import io

torch.set_num_threads(1)  # tier-1 runs several xdist workers on a few cores
pytestmark = pytest.mark.requires_cuda
PSZ, PAD, WIN = 8, 8, 16


def t32(a, device="cpu"):
    return torch.tensor(np.asarray(a, np.float32), device=device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pair():
    """The tests/test_icgn.py scene (320x240 plane, small random pose)."""
    rng = np.random.default_rng(7)
    scene = synthetic.make_scene(rng, wh=(320, 240))
    p_gt = np.r_[rng.normal(size=3) * 0.02, rng.normal(size=3) * 0.01]

    def render(p):
        G = lie.se3_exp(torch.tensor(p, dtype=torch.float64)).numpy()
        return synthetic.render(scene, G).astype(np.float32)

    X = synthetic.sample_plane_points(scene, rng, 32).astype(np.float32)
    return scene, p_gt, render(np.zeros(6)), render(p_gt), X


def _k1_inputs(pair, dev):
    _, _, img_ref, img_new, _ = pair
    lvl = build_pyramid(t32(img_ref, dev), 2, PAD)[1]
    qimg = build_pyramid(t32(img_new, dev), 2, PAD)[1].img
    rng = np.random.default_rng(8)
    w, h = 160.0, 120.0
    centers = np.r_[np.c_[rng.uniform(0, w, 200), rng.uniform(0, h, 200)],
                    [[w, h], [0.2, h], [w, 3.5], [0, 0], [0, h], [w, 0]]]
    entry = centers + rng.uniform(-2, 2, centers.shape)
    origins = ws.window_origin(t32(entry, dev), PSZ, WIN, PAD)
    return lvl, qimg, t32(centers, dev), origins


@pytest.mark.parametrize("patch_norm", [False, True])
def test_k1_kernel_matches_plain(pair, cuda_device, patch_norm, monkeypatch):
    lvl, qimg, centers, origins = _k1_inputs(pair, cuda_device)
    # and the centres where the reference's rule bites, with the window
    # origins of their neighbours (NaN patches at the non-finite ones)
    edge = t32(_edge_centers(160.0, 120.0), cuda_device)
    centers = torch.cat([centers, edge])
    origins = torch.cat([origins, origins[:len(edge)]])
    want = patch_gather.gather_ref_grad_windows_plain(lvl, qimg, centers, origins, PSZ,
                                                      PAD, WIN, patch_norm=patch_norm)
    assert bool(want[0].isnan().any())
    n0 = patch_gather.launches["gather_ref_grad_windows"]
    with monkeypatch.context() as mp:
        # K1 takes the centres and origins: no index or weight is made in torch
        for helper in ("bilinear_base", "clamp_to_fit"):
            mp.setattr(patch_gather, helper, None)
        got = patch_gather.gather_ref_grad_windows(lvl, qimg, centers, origins, PSZ, PAD,
                                                   WIN, patch_norm=patch_norm)
    torch.cuda.synchronize()
    assert patch_gather.launches["gather_ref_grad_windows"] == n0 + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


def test_k1_rejects_what_it_does_not_take(pair, cuda_device):
    lvl, qimg, centers, origins = _k1_inputs(pair, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        patch_gather.gather_ref_grad_windows(lvl, qimg, centers.double(), origins,
                                             PSZ, PAD, WIN)
    with pytest.raises(ValueError, match="int32"):
        patch_gather.gather_ref_grad_windows(lvl, qimg, centers, origins.long(),
                                             PSZ, PAD, WIN)
    with pytest.raises(NotImplementedError):
        patch_gather.gather_ref_grad_windows(lvl, qimg, centers, origins, 6, PAD, 14)
    cpu_level = PyramidLevel(*(a.cpu() for a in lvl))
    with pytest.raises(ValueError, match="is on"):
        patch_gather.gather_ref_grad_windows(lvl, cpu_level.img, centers, origins,
                                             PSZ, PAD, WIN)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_k2_k3_kernels_match_plain(pair, cuda_device, bf16):
    lvl, qimg, centers, origins = _k1_inputs(pair, cuda_device)
    M = centers.shape[0]
    p_img, p_dx, p_dy, qwin = patch_gather.gather_ref_grad_windows_plain(
        lvl, qimg, centers, origins, PSZ, PAD, WIN)
    dt = torch.bfloat16 if bf16 else torch.float32
    planes = [a.reshape(M, -1).to(dt).contiguous() for a in (qwin, p_img, p_dx, p_dy)]
    rng = np.random.default_rng(9)
    moved = centers + t32(rng.uniform(-4.5, 4.5, (M, 2)), cuda_device)
    row_w, col_w, wts = ws.window_taps(moved, origins, PSZ, PAD, WIN)
    valid = t32(rng.uniform(size=M) > 0.2, cuda_device)
    taps = (row_w.contiguous(), col_w.contiguous(), wts.contiguous(), valid)
    for pn in (False, True):
        n0 = dict(icgn_iter.launches)
        got = icgn_iter.fused_resample_project(*planes, *taps, patch_norm=pn)
        want = icgn_iter.fused_resample_project_plain(*planes, *taps, patch_norm=pn)
        d = icgn_iter.fused_resample_pdiff_plain(*planes[:2], *taps, pn)
        scale = torch.stack([(planes[2].float() * d).abs().sum(-1),
                             (planes[3].float() * d).abs().sum(-1)], -1)
        assert bool(torch.all((got - want).abs() <= 1e-5 * scale + 1e-6))
        got3 = icgn_iter.fused_resample_pdiff(*planes[:2], *taps, patch_norm=pn)
        torch.testing.assert_close(got3, d, rtol=0, atol=4e-5 if pn else 0.0)
        torch.cuda.synchronize()
        assert icgn_iter.launches == {"project": n0["project"] + 1,
                                      "pdiff": n0["pdiff"] + 1}
    with pytest.raises(TypeError):
        icgn_iter.fused_resample_project(planes[0].double(), *planes[1:], *taps)
    with pytest.raises(ValueError):
        icgn_iter.fused_resample_project(*planes, row_w[:-1].contiguous(), *taps[1:])


def test_track_pose_batch_on_card_matches_cpu(pair, cuda_device):
    sc, p_gt, img_ref, img_new, X = pair
    Xb = np.stack([X, X[::-1]])
    cfg = ICGNParams(lv_f=1, lv_l=0, psz=8, maxiter=10, normdp_ratio=0.01)
    out = {}
    for dev in ("cpu", cuda_device):
        cam = CameraPyramid.create(sc.fc, sc.cc, sc.wh, 2, 8, device=dev)
        n1 = patch_gather.launches["gather_ref_grad_windows"]
        n2 = icgn_iter.launches["project"]
        out[str(dev)] = icgn.track_pose_batch(
            build_pyramid(t32(img_ref, dev), 2, 8), build_pyramid(t32(img_new, dev), 2, 8),
            t32(Xb, dev), torch.zeros((2, 6), device=dev), cam, cfg).cpu()
        launched = (patch_gather.launches["gather_ref_grad_windows"] - n1,
                    icgn_iter.launches["project"] - n2)
        assert launched == ((0, 0) if str(dev) == "cpu" else (2, 20))
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0, atol=1e-4)


def _edge_centers(w, h):
    """Centres where the reference's rule bites: on integers, within 1e-5
    below one (first column from ceil(x + 1e-5), weights from x - floor(x)),
    just above one, at negative fractions, and NaN or infinite."""
    out = []
    for k in (0.0, 1.0, 7.0, 50.0, w - 1.0, w):
        for d in (0.0, -5e-6, 1e-5, -1e-5, 2e-5, -0.25):
            out.append([k + d, min(0.5 * k + d, h)])
    nan, inf = float("nan"), float("inf")
    return out + [[-0.3, -0.7], [-1.5, 3.25], [-2.0, -3.0], [nan, 5.0], [5.0, nan],
                  [nan, nan], [inf, 3.0], [3.0, -inf]]


@pytest.mark.parametrize("psz", [8, 4, 6, 16, 18, 20, 32])
def test_k5_k6_k7_kernels_match_plain(pair, cuda_device, psz, monkeypatch):
    _, _, img_ref, _, _ = pair
    lvl = build_pyramid(t32(img_ref, cuda_device), 2, psz)[1]
    rng = np.random.default_rng(10)
    w, h = 160.0, 120.0
    centers = t32(np.r_[np.c_[rng.uniform(0, w, 300), rng.uniform(0, h, 300)],
                        [[w, h], [0.2, h], [w, 3.5], [0, 0], [0, h], [w, 0],
                         [-40, -40], [1e9, 5], [5, -1e12]]], cuda_device)
    c56 = torch.cat([centers, t32(_edge_centers(w, h), cuda_device)])
    win = psz + 8
    origins = ws.window_origin(centers + 1.25, psz, win, psz)
    n0 = dict(patch_gather.launches)
    k6 = psz <= patch_gather.MAX_PSZ
    want5 = {pn: patch_gather.gather_patches_plain(lvl.img, c56, psz, psz, pn)
             for pn in (False, True)}
    want6 = {pn: patch_gather.gather_patches_grad_plain(lvl.img, lvl.dx, lvl.dy, c56,
                                                        psz, psz, pn)
             for pn in (False, True) if k6}
    assert bool(want5[False].isnan().any()) and not bool(want5[False][:len(centers)]
                                                         .isnan().any())
    with monkeypatch.context() as mp:
        # K5 and K6 take the centres: no index or weight is made in torch,
        # and a call without the patch mean is its launch alone
        for helper in ("bilinear_base", "clamp_to_fit"):
            mp.setattr(patch_gather, helper, None)
        for pn in (False, True):
            n5 = patch_gather.launches["gather_patches"]
            got = patch_gather.gather_patches(lvl.img, c56, psz, psz, pn)
            assert patch_gather.launches["gather_patches"] == n5 + 1
            torch.testing.assert_close(got, want5[pn], rtol=0, atol=0, equal_nan=True)
            if not k6:                              # K6 has no caller beyond 16
                with pytest.raises(NotImplementedError, match="gather_patches takes"):
                    patch_gather.gather_patches_grad(lvl.img, lvl.dx, lvl.dy, c56, psz, psz)
                continue
            got = patch_gather.gather_patches_grad(lvl.img, lvl.dx, lvl.dy, c56, psz, psz, pn)
            for g, w_ in zip(got, want6[pn]):
                torch.testing.assert_close(g, w_, rtol=0, atol=0, equal_nan=True)
    for wh, ww in ((win, win), (3, win), (win, 5)):
        got = patch_gather.gather_windows(lvl.img, origins, wh, ww)
        want = patch_gather.gather_windows_plain(lvl.img, origins, wh, ww)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.cuda.synchronize()
    assert patch_gather.launches == {
        "gather_ref_grad_windows": n0["gather_ref_grad_windows"],
        "gather_patches": n0["gather_patches"] + 2,
        "gather_patches_grad": n0["gather_patches_grad"]
        + (2 if psz <= patch_gather.MAX_PSZ else 0),
        "gather_windows": n0["gather_windows"] + 3}
    with pytest.raises(NotImplementedError):
        patch_gather.gather_patches(lvl.img, centers, 7, psz)
    with pytest.raises(ValueError, match="float32"):
        patch_gather.gather_patches_grad(lvl.img.double(), lvl.dx, lvl.dy, centers, psz, psz)
    with pytest.raises(ValueError, match="int32"):
        patch_gather.gather_windows(lvl.img, origins.long(), win, win)


@pytest.mark.parametrize("psz", [8, 4, 16])
def test_k4_kernel_matches_plain(pair, cuda_device, psz):
    _, _, img_ref, img_new, _ = pair
    pad = psz
    planes = [build_pyramid(t32(im, cuda_device), 1, pad)[0].img
              for im in (img_ref, img_new, img_ref[::-1].copy())]
    planes[2][:40, :40] = 77.25                      # a flat corner
    rng = np.random.default_rng(11)
    w, h = 320.0, 240.0
    base = np.r_[np.c_[rng.uniform(0, w, 400), rng.uniform(0, h, 400)],
                 [[w, h], [0.0, 0.0], [0.3, h], [-60, -60], [1e9, 3.0], [3.0, -1e12]]]
    uvs = [t32(base + rng.uniform(-1.5, 1.5, base.shape) * (k != 1), cuda_device)
           for k in range(3)]
    uvs[2][:3] = t32([[6.5, 5.25], [4.0, 7.5], [7.75, 4.5]], cuda_device)   # flat fwd
    # the centres where the reference's rule bites, in all three planes
    edge = t32(_edge_centers(w, h), cuda_device)
    uvs = [torch.cat([uv, edge]) for uv in uvs]
    n_pts = len(base) + len(edge)
    n0 = ncc3.launches["ncc3_scores"]
    got = ncc3.ncc3_scores(*planes, *uvs, psz, pad)
    torch.cuda.synchronize()
    assert ncc3.launches["ncc3_scores"] == n0 + 1
    want = ncc3.ncc3_scores_plain(*planes, *uvs, psz, pad)
    pats = [patch_gather.gather_patches_plain(im, uv, psz, pad, patch_norm=True)
            .reshape(n_pts, -1) for im, uv in zip(planes, uvs)]
    nrm = [torch.clamp(torch.linalg.vector_norm(p, dim=-1), min=1e-15) for p in pats]
    finite = torch.isfinite(edge).all(-1)
    for (a, b), g, w_ in zip(((0, 1), (1, 2)), got, want):
        # NaN exactly at the non-finite centres, in both versions
        assert torch.equal(torch.isnan(g), torch.isnan(w_))
        assert torch.equal(torch.isnan(g)[len(base):], ~finite)
        ok = ~torch.isnan(w_)
        scale = (pats[a] * pats[b]).abs().sum(-1) / (nrm[a] * nrm[b])
        tol = 2e-5 * scale + 8 * 6.2e-5 * (1 / nrm[a] + 1 / nrm[b])
        assert bool(torch.all((g - w_).abs()[ok] <= tol[ok]))
        assert bool(torch.isfinite(g[ok]).all()) and 0.0 <= float(g[ok].min())
        assert float(g[ok].max()) <= 1.0 + 1e-5
    assert bool((nrm[2][:3] < 1e-3).all())           # the flat patches are flat
    with pytest.raises(ValueError, match="is on"):
        ncc3.ncc3_scores(planes[0].cpu(), *planes[1:], *uvs, psz, pad)
    with pytest.raises(NotImplementedError):
        ncc3.ncc3_scores(*planes, *uvs, 5, pad)


@pytest.mark.parametrize("kw,want", [
    (dict(psz=4), dict(gather_patches_grad=2, gather_windows=2)),
    (dict(psz=8, window_cache=False), dict(gather_patches_grad=2, gather_patches=20)),
], ids=["psz4", "psz8-nocache"])
def test_non_fused_tracker_on_card_matches_cpu(pair, cuda_device, kw, want):
    sc, _, img_ref, img_new, X = pair
    Xb = np.stack([X, X[::-1]])
    cfg = ICGNParams(lv_f=1, lv_l=0, maxiter=10, normdp_ratio=0.01, **kw)
    out = {}
    for dev in ("cpu", cuda_device):
        cam = CameraPyramid.create(sc.fc, sc.cc, sc.wh, 2, cfg.psz, device=dev)
        n0 = dict(patch_gather.launches)
        out[str(dev)] = icgn.track_pose_batch(
            build_pyramid(t32(img_ref, dev), 2, cfg.psz),
            build_pyramid(t32(img_new, dev), 2, cfg.psz),
            t32(Xb, dev), torch.zeros((2, 6), device=dev), cam, cfg).cpu()
        launched = {k: v - n0[k] for k, v in patch_gather.launches.items() if v != n0[k]}
        assert launched == ({} if str(dev) == "cpu" else want)
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=0, atol=1e-4)


def test_track_nposes_on_card_matches_cpu(pair, cuda_device):
    sc, p_gt, img_ref, img_new, X = pair
    rng = np.random.default_rng(12)
    hyp = t32(np.r_[[np.zeros(6)], rng.normal(size=(2, 6)) * 3e-4,
                    [[0.6, -0.5, 0.3, 0.25, -0.2, 0.15]]])
    masks = torch.tensor(rng.uniform(size=(4, len(X))) < 0.8)
    cfg = ICGNParams(lv_f=1, lv_l=0, psz=8, maxiter=10, normdp_ratio=0.01)
    res = {}
    for dev in ("cpu", cuda_device):
        cam = CameraPyramid.create(sc.fc, sc.cc, sc.wh, 2, 8, device=dev)
        pyrs = [build_pyramid(t32(im, dev), 2, 8) for im in (img_new, img_ref, img_new)]
        n4 = ncc3.launches["ncc3_scores"]
        res[str(dev)] = chain.track_nposes(pyrs, hyp.to(dev), t32(X, dev), masks.to(dev),
                                           cam, cfg, fb_frames=(1, 1))
        assert ncc3.launches["ncc3_scores"] - n4 == (0 if str(dev) == "cpu" else 1)
    a, b = res["cuda"], res["cpu"]
    torch.testing.assert_close(a.pose_tracks[:3].cpu(), b.pose_tracks[:3], rtol=0, atol=1e-4)
    assert bool(((a.correlations.cpu() == -1) == (b.correlations == -1))[:3].all())
    torch.testing.assert_close(a.correlations[:3].cpu(), b.correlations[:3], rtol=0, atol=5e-3)
    assert int(chain.select_best(a, torch.ones(4, dtype=torch.bool, device=cuda_device))[0]) < 3


@pytest.mark.parametrize("psz,want", [
    (8, dict(gather_ref_grad_windows=2, project=20)),
    (4, dict(gather_patches_grad=2, gather_windows=2)),
], ids=["psz8", "psz4"])
def test_cli_track_pair_run_on_card_matches_cpu(pair, cuda_device, psz, want):
    """The pair tracker's ``run`` (it asks the tracker for its aux: the
    Hessian's map-back through ``jacfwd``) on the card by default."""
    sc, p_gt, img_ref, img_new, X = pair
    data = io.PointCamFile(pose=np.zeros(6), fc=np.asarray(sc.fc, np.float32),
                           cc=np.asarray(sc.cc, np.float32),
                           wh=np.asarray(sc.wh, np.uint32), pt3d=X.astype(np.float64),
                           pt2d=np.zeros((len(X), 2), np.float32))
    cfg = track_pair.parse_cfg(["1", "0", str(psz), "10", "0.01", "1", "0", "32", "0"])
    counts = (patch_gather.launches, icgn_iter.launches)
    n0 = {k: v for c in counts for k, v in c.items()}
    on_card = track_pair.run(cfg, data, [img_ref, img_new])
    launched = {k: v - n0[k] for c in counts for k, v in c.items() if v != n0[k]}
    assert launched == want
    on_cpu = track_pair.run(cfg, data, [img_ref, img_new], device="cpu")
    assert on_card.shape == (6,) and on_card.dtype == np.float64
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=1e-4)
    np.testing.assert_allclose(on_card, p_gt, rtol=0, atol=5e-3)


def _flows(H, W, dev):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    smooth = np.stack([1.3 * np.sin(yy / 17.0) + 0.7 * np.cos(xx / 43.0) + 4.0,
                       1.1 * np.cos(yy / 13.0) - 0.9 * np.sin(xx / 39.0) - 6.0], -1)
    step = smooth.copy()
    step[:, W // 2:, 0] += 10.0
    leaves = smooth.copy()
    leaves[:6] -= 40.0
    leaves[-6:] += 55.0
    leaves[:, :5, 0] -= 300.0
    leaves[:, -5:, 0] += 1e6
    integer = np.zeros((H, W, 2), np.float32)
    integer[..., 0], integer[..., 1] = 3.0, -2.0
    flows = dict(smooth=smooth, step=step, leaves=leaves, integer=integer)
    if min(H, W) > 8:
        flows["nonfinite"] = smooth.copy()
        flows["nonfinite"][3, 4, 0] = np.inf
        flows["nonfinite"][5, 6, 1] = -np.inf
        flows["nonfinite"][7, 8, 0] = np.nan
    return {k: t32(v, dev) for k, v in flows.items()}


@pytest.mark.parametrize("shape", [(240, 320), (45, 80), (2, 2)])
def test_k8_kernel_matches_plain(cuda_device, shape):
    H, W = shape
    rng = np.random.default_rng(13)
    img = t32(rng.uniform(0, 255, (H, W)), cuda_device)
    for kind, flow in _flows(H, W, cuda_device).items():
        n0 = warp.launches["warp_image"]
        got = warp.warp_image(img, flow)
        torch.cuda.synchronize()
        assert warp.launches["warp_image"] == n0 + 1
        want = warp.warp_image_plain(img, flow)
        assert torch.equal(torch.nan_to_num(got, nan=-1.0), torch.nan_to_num(want, nan=-1.0)), kind
        # the CPU's plain version gives the same floats
        assert torch.equal(torch.nan_to_num(got.cpu(), nan=-1.0),
                           torch.nan_to_num(warp.warp_image_plain(img.cpu(), flow.cpu()),
                                            nan=-1.0)), kind
    # a view (a level stripped of its padding) is taken as it is
    big = t32(rng.uniform(0, 255, (H + 6, W + 6)), cuda_device)
    view = big[3:-3, 3:-3]
    flow = _flows(H, W, cuda_device)["smooth"]
    assert torch.equal(warp.warp_image(view, flow), warp.warp_image_plain(view, flow))
    with pytest.raises(ValueError, match="float32"):
        warp.warp_image(img.double(), flow)
    with pytest.raises(ValueError, match="flow must be"):
        warp.warp_image(img, flow[:, :-1])
    with pytest.raises(ValueError, match="is on"):
        warp.warp_image(img, flow.cpu())


@pytest.mark.parametrize("patch_norm", [False, True])
def test_k9_kernel_equals_k1_and_plain(pair, cuda_device, patch_norm):
    lvl, qimg, centers, origins = _k1_inputs(pair, cuda_device)
    # enough points that every warp of the persistent grid walks several
    reps = 40
    centers = centers.repeat(reps, 1) + t32(
        np.random.default_rng(14).uniform(-1, 1, (len(centers) * reps, 2)), cuda_device)
    origins = ws.window_origin(centers + 1.5, PSZ, WIN, PAD)
    # and the centres where the reference's rule bites (NaN patches at the
    # non-finite ones), in the middle of the strips
    edge = t32(_edge_centers(160.0, 120.0), cuda_device)
    at = len(centers) // 2
    centers = torch.cat([centers[:at], edge, centers[at:]])
    origins = torch.cat([origins[:at], origins[:len(edge)], origins[at:]])
    n0 = patch_prefetch.launches["gather_ref_grad_windows_prefetch"]
    n1 = patch_gather.launches["gather_ref_grad_windows"]
    got = patch_prefetch.gather_ref_grad_windows_prefetch(
        lvl, qimg, centers, origins, PSZ, PAD, WIN, patch_norm=patch_norm)
    torch.cuda.synchronize()
    assert patch_prefetch.launches["gather_ref_grad_windows_prefetch"] == n0 + 1
    assert patch_gather.launches["gather_ref_grad_windows"] == n1
    k1 = patch_gather.gather_ref_grad_windows(lvl, qimg, centers, origins, PSZ, PAD, WIN,
                                              patch_norm=patch_norm)
    plain = patch_prefetch.gather_ref_grad_windows_prefetch_plain(
        lvl, qimg, centers, origins, PSZ, PAD, WIN, patch_norm=patch_norm)
    assert bool(plain[0].isnan().any())
    for g, a, b in zip(got, k1, plain):
        torch.testing.assert_close(g, a, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(g, b, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(NotImplementedError):
        patch_prefetch.gather_ref_grad_windows_prefetch(lvl, qimg, centers, origins, 6,
                                                        PAD, 14)
    # one point, and fewer points than one block's warps
    for m in (1, 5):
        got = patch_prefetch.gather_ref_grad_windows_prefetch(
            lvl, qimg, centers[:m], origins[:m], PSZ, PAD, WIN)
        for g, a in zip(got, (t[:m] for t in k1)):
            if not patch_norm:
                assert torch.equal(g, a)


def test_tracker_with_gather_prefetch_on_card_equals_k1_run(pair, cuda_device):
    sc, _, img_ref, img_new, X = pair
    Xb = t32(np.stack([X, X[::-1]]), cuda_device)
    cfg = ICGNParams(lv_f=1, lv_l=0, psz=8, maxiter=10, normdp_ratio=0.01)
    cam = CameraPyramid.create(sc.fc, sc.cc, sc.wh, 2, 8)
    pr, pn_ = build_pyramid(t32(img_ref, cuda_device), 2, 8), build_pyramid(t32(img_new, cuda_device), 2, 8)
    p0 = torch.zeros((2, 6), device=cuda_device)
    base = icgn.track_pose_batch(pr, pn_, Xb, p0, cam, cfg)
    n9 = patch_prefetch.launches["gather_ref_grad_windows_prefetch"]
    n1 = patch_gather.launches["gather_ref_grad_windows"]
    pre = icgn.track_pose_batch(pr, pn_, Xb, p0, cam,
                                ICGNParams(lv_f=1, lv_l=0, psz=8, maxiter=10,
                                           normdp_ratio=0.01, gather_prefetch=True))
    assert patch_prefetch.launches["gather_ref_grad_windows_prefetch"] == n9 + 2
    assert patch_gather.launches["gather_ref_grad_windows"] == n1
    assert torch.equal(pre, base)


def test_dense_flow_and_descriptors_on_card_match_cpu(pair, cuda_device):
    _, _, img_ref, img_new, _ = pair
    L, pad, iters = 3, 8, 4
    out = {}
    for dev in ("cpu", cuda_device):
        n0 = warp.launches["warp_image"]
        p0 = build_pyramid(t32(img_ref, dev), L, pad)
        p1 = build_pyramid(t32(img_new, dev), L, pad)
        out[str(dev)] = dense_flow.dense_flow_lk(p0, p1, pad, iters=iters).cpu()
        assert warp.launches["warp_image"] - n0 == (0 if str(dev) == "cpu" else L * iters)
    gap = (out["cuda"] - out["cpu"]).abs()
    assert float(gap.max()) <= 1e-3 and float(gap.median()) <= 1e-5
    rng = np.random.default_rng(15)
    centers = t32(np.c_[rng.uniform(20, 300, 64), rng.uniform(20, 220, 64)])
    n5 = patch_gather.launches["gather_patches"]
    on_card = descriptors.sift_like_descriptors(
        build_pyramid(t32(img_ref, cuda_device), 1, 12)[0].img, centers.to(cuda_device), 12)
    assert patch_gather.launches["gather_patches"] == n5 + 1        # K5 at psz 18
    on_cpu = descriptors.sift_like_descriptors(build_pyramid(t32(img_ref), 1, 12)[0].img,
                                               centers, 12)
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=0, atol=2e-6)
    idx, ok = descriptors.ratio_match(on_card, on_card.flip(0))
    assert torch.equal(idx.cpu(), torch.arange(63, -1, -1))


def test_vo_engine_on_card_matches_cpu(cuda_device):
    """The VO engine, bootstrap + 6 frames at 320x240 (the scene and motion
    of examples/run_kitti_vo_torch.py's fallback, bootstrapped from the
    true poses), on the card against the port's CPU run; K1 and K2 launched
    per frame and K6 and K7 per keyframe.  The first tracker call of this
    set-up (a plane at one depth, in the tracker's normalised coordinates)
    is float32-sensitive: JAX f32 sits 9.3e-5 from JAX f64, the port on the
    CPU 1.2e-4 on the other side (tests/test_torch_icgn.py::
    test_track_pose_float32_sensitivity_on_a_plane), and the card 2.0e-4
    from the CPU and 4e-7 from JAX f32; the engine carries that gap into
    every later frame (measured 1.8e-4 to 3.4e-4 over the 6 frames, H100,
    torch 2.11).  Limits: the median frame 1e-3 (5 x the first call's
    gap), the worst frame 5e-3 (REPRO_TOL of chip_smoke.py)."""
    from invcompcamtrack_torch.vo import engine

    rng = np.random.default_rng(0)
    scene = synthetic.make_scene(rng, wh=(320, 240), fc=(300.0, 302.0), freq_range=(0.8, 8.0))
    poses = [np.zeros(6)]
    for _ in range(1, 8):
        poses.append(poses[-1] + np.r_[0.015, 0.006, -0.02, rng.normal(size=3) * 0.001])
    imgs = [synthetic.render(scene, lie.se3_exp(torch.tensor(p, dtype=torch.float64)).numpy())
            .astype(np.float32) for p in poses]
    seeds = synthetic.sample_plane_points(scene, rng, 200, margin=24)
    tr = ICGNParams(lv_f=3, lv_l=0, psz=8, maxiter=8)
    cfg = engine.VOConfig(tracker=tr, max_landmarks=256, window=4, keyframe_stride=2,
                          corners_per_kf=256, min_parallax_px=0.5)
    out = {}
    for dev in ("cpu", cuda_device):
        cam = CameraPyramid.create(scene.fc, scene.cc, scene.wh, tr.num_levels, tr.psz,
                                   device=dev)
        vo = engine.VisualOdometry(cam, scene.fc, scene.cc, cfg, device=dev)
        vo.bootstrap(imgs[0], imgs[1], poses[0], poses[1], seeds)
        n1 = patch_gather.launches["gather_ref_grad_windows"]
        n2 = icgn_iter.launches["project"]
        n6 = patch_gather.launches["gather_patches_grad"]
        n7 = patch_gather.launches["gather_windows"]
        out[str(dev)] = np.stack([vo.process_frame(im) for im in imgs[2:]])
        on_card = str(dev) != "cpu"
        L = tr.num_levels
        assert patch_gather.launches["gather_ref_grad_windows"] - n1 == on_card * 6 * L
        assert icgn_iter.launches["project"] - n2 == on_card * 6 * L * tr.maxiter
        assert patch_gather.launches["gather_patches_grad"] - n6 == on_card * 3 * 4 * L
        assert patch_gather.launches["gather_windows"] - n7 == on_card * 3 * 4 * L
        assert np.isfinite(np.stack(vo.trajectory)).all()
    gaps = np.abs(out["cuda"] - out["cpu"]).max(axis=1)
    assert np.median(gaps) <= 1e-3 and gaps.max() <= 5e-3, gaps


@pytest.mark.parametrize("patch_norm", [False, True])
def test_gathers_on_a_plane_stack_match_plain_and_single_planes(pair, cuda_device,
                                                                 patch_norm):
    """K1, K9, K5, K6 and K7 on a stack of P = 3 planes (levels 1 of three
    images), 206 points per plane with the edge centres on the first: one
    launch each, equal bit for bit to the plain version on the stack and to
    P calls on one plane each."""
    _, _, img_ref, img_new, _ = pair
    dev = cuda_device
    imgs = torch.stack([t32(img_ref, dev), t32(img_new, dev), t32(img_ref, dev).flip(-1)])
    lvl = build_pyramid(imgs, 2, PAD)[1]
    query = lvl.img.flip(0).contiguous()
    rng = np.random.default_rng(12)
    w, h = 160.0, 120.0
    centers = np.stack([np.r_[np.c_[rng.uniform(0, w, 200), rng.uniform(0, h, 200)],
                              [[w, h], [0.2, h], [w, 3.5], [0, 0], [0, h], [w, 0]]]
                        for _ in range(3)])
    centers = torch.cat([t32(centers, dev), t32(_edge_centers(w, h), dev)[None].expand(
        3, -1, 2)], dim=1).contiguous()
    origins = ws.window_origin(centers + 1.5, PSZ, WIN, PAD)
    calls = {
        "gather_ref_grad_windows": (
            lambda L, q, c, o: patch_gather.gather_ref_grad_windows(
                L, q, c, o, PSZ, PAD, WIN, patch_norm),
            lambda L, q, c, o: patch_gather.gather_ref_grad_windows_plain(
                L, q, c, o, PSZ, PAD, WIN, patch_norm)),
        "gather_ref_grad_windows_prefetch": (
            lambda L, q, c, o: patch_prefetch.gather_ref_grad_windows_prefetch(
                L, q, c, o, PSZ, PAD, WIN, patch_norm),
            lambda L, q, c, o: patch_prefetch.gather_ref_grad_windows_prefetch_plain(
                L, q, c, o, PSZ, PAD, WIN, patch_norm)),
        "gather_patches": (
            lambda L, q, c, o: patch_gather.gather_patches(L.img, c, PSZ, PAD, patch_norm),
            lambda L, q, c, o: patch_gather.gather_patches_plain(L.img, c, PSZ, PAD,
                                                                 patch_norm)),
        "gather_patches_grad": (
            lambda L, q, c, o: patch_gather.gather_patches_grad(L.img, L.dx, L.dy, c, PSZ,
                                                                PAD, patch_norm),
            lambda L, q, c, o: patch_gather.gather_patches_grad_plain(L.img, L.dx, L.dy, c,
                                                                      PSZ, PAD, patch_norm)),
        "gather_windows": (
            lambda L, q, c, o: patch_gather.gather_windows(q, o, WIN, WIN),
            lambda L, q, c, o: patch_gather.gather_windows_plain(q, o, WIN, WIN)),
    }
    for name, (kern, plain) in calls.items():
        counts = (patch_prefetch.launches if name.endswith("prefetch")
                  else patch_gather.launches)
        n0 = counts[name]
        got = kern(lvl, query, centers, origins)
        assert counts[name] == n0 + 1
        want = plain(lvl, query, centers, origins)
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for p in range(3):
            one = kern(PyramidLevel(*(a[p] for a in lvl)), query[p], centers[p], origins[p])
            one = one if isinstance(one, tuple) else (one,)
            for g, o in zip(got, one):
                torch.testing.assert_close(g[p], o, rtol=0, atol=0, equal_nan=True)
        for g, w_ in zip(got, want):
            assert g.shape[:2] == (3, centers.shape[1])
            torch.testing.assert_close(g, w_, rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError, match="takes points"):
        patch_gather.gather_patches(lvl.img, centers[:2], PSZ, PAD)


def test_feature_descriptors_one_k5_launch_on_card(cuda_device):
    """``vo/features_dnn.py::feature_patch_descriptors`` on the card: one
    K5 launch on the stack of C padded maps, equal bit for bit to C
    one-plane launches and to the plain version (the CPU's result)."""
    from invcompcamtrack_torch.vo import features_dnn

    rng = np.random.default_rng(13)
    dev = cuda_device
    mod = features_dnn.init_features(torch.Generator().manual_seed(0), device=dev)
    img = t32(rng.uniform(0, 255, (96, 128)), dev)
    feat = features_dnn.extract_feature_maps(mod, img)[0].contiguous()
    C, H, W = feat.shape
    cen = t32(np.c_[rng.uniform(-2, W + 1, 300), rng.uniform(-2, H + 1, 300)], dev)
    n0 = patch_gather.launches["gather_patches"]
    desc = features_dnn.feature_patch_descriptors(feat, cen)
    assert patch_gather.launches["gather_patches"] == n0 + 1
    planes = torch.nn.functional.pad(feat[None], (PSZ,) * 4, mode="replicate")[0].contiguous()
    one = torch.stack([patch_gather.gather_patches(planes[c].contiguous(), cen, PSZ, PSZ)
                       for c in range(C)], dim=-1)
    torch.testing.assert_close(desc, one, rtol=0, atol=0)
    cpu = features_dnn.feature_patch_descriptors(feat.cpu(), cen.cpu())
    torch.testing.assert_close(desc.cpu(), cpu, rtol=0, atol=0)


def test_fit_camera_ransac_on_card_matches_cpu(pair, cuda_device):
    """``sfm/ransac.py::fit_camera_ransac`` (S = 64 six-point samples of 60
    plane points, 12 of them outliers) on the card against the CPU: the
    same valid flags but for the few hypotheses whose refit rests on a
    handful of points (their float32 eigensolvers part), G within the
    float32 eigensolvers' spread at the median, and the hypothesis with
    the most inliers at the CPU's camera centre."""
    from invcompcamtrack_torch.sfm.epipolar import sample_indices
    from invcompcamtrack_torch.sfm.ransac import fit_camera_ransac

    scene, p_gt, _, _, X = pair
    rng = np.random.default_rng(14)
    X = np.r_[X, synthetic.sample_plane_points(scene, rng, 28).astype(np.float32)]
    G = lie.se3_exp(torch.tensor(p_gt, dtype=torch.float64)).numpy()
    Xc = X @ G[:, :3].T + G[:, 3]
    uv = Xc[:, :2] / Xc[:, 2:] * np.asarray(scene.fc) + np.asarray(scene.cc)
    uv += rng.normal(size=uv.shape) * 0.3
    uv[:12] += rng.uniform(30, 120, size=(12, 2))
    idx = sample_indices(len(X), 64, k=6, generator=torch.Generator().manual_seed(0))
    thresh = float(np.hypot(*scene.wh)) / 100.0
    out = {d: fit_camera_ransac(idx, t32(uv, d), t32(X, d), scene.fc, scene.cc,
                                inl_thresh=thresh) for d in ("cpu", cuda_device)}
    card, cpu = out[cuda_device], out["cpu"]
    assert int((card.valid.cpu() != cpu.valid).sum()) <= 6
    both = card.valid.cpu() & cpu.valid
    assert int(both.sum()) >= 5
    gap = (card.G.cpu() - cpu.G).abs().amax((1, 2))[both]
    assert float(gap.median()) <= 1e-3, gap
    def most_inliers_centre(res):
        best = int(torch.argmax(torch.where(res.valid, res.num_inliers,
                                            torch.full_like(res.num_inliers, -1))))
        return lie.camera_center(res.G[best].cpu().double()).numpy()

    c_card, c_cpu = most_inliers_centre(card), most_inliers_centre(cpu)
    c_gt = -G[:, :3].T @ G[:, 3]
    assert float(np.linalg.norm(c_card - c_cpu)) < 5e-3
    # (a 320x240 plane at fc 300 with 0.3 px noise: a loose accuracy bound)
    assert float(np.linalg.norm(c_cpu - c_gt)) < 0.1
    assert bool(torch.isfinite(card.poses[card.valid]).all())
