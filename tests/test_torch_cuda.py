"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and ``nvcc`` and skips elsewhere.
The file imports no JAX, so that it runs on a machine with the card and
without JAX, and nothing of ``tests/`` (an installed top-level ``tests``
package can shadow this directory there):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances (kernel vs plain version, same inputs, both on the card):
- K1: the kernel performs the plain version's float operations in the
  same order (taps and gradient differences through the non-contracting
  _rn intrinsics): bit-exact.
- K2: the 64-pixel sums of the mean and of (gx, gy) run in a warp
  butterfly: 1e-5 of sum |p_d * pdiff|.  K3: exact without the mean,
  4e-5 (about 1 ulp of intensities below 256) with it.
- The tracker, card vs CPU: other summation orders in H, rhs and
  (gx, gy), iterated; 1e-4 on the pose coefficients.
"""

import numpy as np
import pytest
import torch

from invcompcamtrack_torch import ICGNParams, synthetic
from invcompcamtrack_torch.core import lie
from invcompcamtrack_torch.core.camera import CameraPyramid
from invcompcamtrack_torch.image.pyramid import PyramidLevel, build_pyramid
from invcompcamtrack_torch.ops import icgn_iter, patch_gather
from invcompcamtrack_torch.ops import window_sample as ws
from invcompcamtrack_torch.solver import icgn

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
def test_k1_kernel_matches_plain(pair, cuda_device, patch_norm):
    lvl, qimg, centers, origins = _k1_inputs(pair, cuda_device)
    n0 = patch_gather.launches["gather_ref_grad_windows"]
    got = patch_gather.gather_ref_grad_windows(lvl, qimg, centers, origins, PSZ, PAD,
                                               WIN, patch_norm=patch_norm)
    torch.cuda.synchronize()
    assert patch_gather.launches["gather_ref_grad_windows"] == n0 + 1
    want = patch_gather.gather_ref_grad_windows_plain(lvl, qimg, centers, origins, PSZ,
                                                      PAD, WIN, patch_norm=patch_norm)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


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
