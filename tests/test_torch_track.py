"""The port's corner detector and track table (``match/features.py``,
``match/track.py``, ``convert.track_table_*``) and the point-tracking
loop as a whole against the JAX package on the same seeded inputs, on
the CPU.

Tolerances, from measurements on these very inputs:
- ``shi_tomasi_response``: 3x3 box means of gradient products
  (``F.conv2d`` vs XLA's convolution): measured 1.5e-3 to 2.0e-3 on
  responses whose maximum is 4.4e3 to 7.7e3, 2.5e-7 to 4.4e-7 of it;
  RESP_RTOL = 1e-6 of the maximum.
- ``shi_tomasi_corners``: the corners are compared as sets (``top_k``
  orders ties differently); on these images both packages pick the same
  pixels.
- ``transfer_points``: the same float operations in the same order:
  exact.
- ``advance_tracks`` / ``point_pairs``: every field of the table equal
  (positions are sums of the same floats; the gate's comparisons are not
  near their thresholds on these inputs), except ``total_move``, a norm
  that XLA rounds differently in the last bit (measured 2.4e-7 on moves
  of ~3 px): MOVE_ATOL = 1e-6.
- The loop as a whole (pyramids -> dense flow both ways -> corners ->
  table): the flows differ by ~1e-5 px (``tests/test_torch_flow.py``), the
  tracked positions with them (measured 1.5e-5 px after three frames):
  LOOP_ATOL = 1e-4 px; masks and ages equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from invcompcamtrack_tpu.image.pyramid import build_pyramid as jbuild
from invcompcamtrack_tpu.match import dense_flow as jflow
from invcompcamtrack_tpu.match import features as jfeat
from invcompcamtrack_tpu.match import track as jtrack
from invcompcamtrack_torch import convert
from invcompcamtrack_torch.image.pyramid import build_pyramid
from invcompcamtrack_torch.match import dense_flow, features, track
from tests.torch_helpers import t32

RESP_RTOL = 1e-6
MOVE_ATOL = 1e-6
LOOP_ATOL = 1e-4
FIELDS = ("xy", "alive", "age", "total_move", "birth_xy", "head", "frame")


def _texture(rng, H, W):
    return (gaussian_filter(rng.normal(size=(H, W)), 1.5) * 300 + 128
            ).clip(0, 255).astype(np.float32)


def _corner_set(xy, valid):
    xy, valid = np.asarray(xy), np.asarray(valid)
    return {(float(x), float(y)) for (x, y), v in zip(xy, valid) if v}


@pytest.mark.parametrize("shape,max_corners,branch", [
    ((96, 128), 400, "flat"), ((96, 128), 60, "tiled"), ((90, 125), 40, "tiled"),
    ((48, 64), 300, "flat"),
], ids=["flat-400", "tiled-60", "tiled-odd-40", "flat-more-than-peaks"])
def test_shi_tomasi_corners_match_jax(rng, shape, max_corners, branch):
    H, W = shape
    assert (H * W > 64 * max_corners) == (branch == "tiled")
    img = _texture(rng, H, W)
    resp_j = np.asarray(jfeat.shi_tomasi_response(jnp.asarray(img)))
    resp = features.shi_tomasi_response(t32(img)).numpy()
    assert np.abs(resp - resp_j).max() <= RESP_RTOL * np.abs(resp_j).max()
    xy_j, valid_j = jfeat.shi_tomasi_corners(jnp.asarray(img), max_corners=max_corners)
    xy, valid = features.shi_tomasi_corners(t32(img), max_corners=max_corners)
    assert xy.shape == (max_corners, 2) and valid.shape == (max_corners,)
    assert xy.dtype == torch.float32 and valid.dtype == torch.bool
    got, want = _corner_set(xy, valid), _corner_set(xy_j, valid_j)
    assert got == want and len(got) == int(valid.sum()) > 10
    if shape == (48, 64):
        assert len(got) < max_corners            # the mask is in use
    xs, ys = np.array(sorted(got)).T
    assert xs.min() >= 8 and xs.max() < W - 8 and ys.min() >= 8 and ys.max() < H - 8


def test_transfer_points_matches_jax(rng):
    H, W = 40, 50
    flow = (rng.normal(size=(H, W, 2)) * 3).astype(np.float32)
    xy = np.r_[rng.uniform(-3, 53, size=(60, 2)),
               [[0.0, 0.0], [48.0, 38.0], [48.5, 10.0], [49.0, 10.0], [10.0, 39.0],
                [np.nan, 5.0], [5.0, np.inf], [-0.5, 3.0]]].astype(np.float32)
    want, ok_j = jtrack.transfer_points(jnp.asarray(xy), jnp.asarray(flow))
    got, ok = track.transfer_points(t32(xy), t32(flow))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))   # NaN where invalid
    assert ok.numpy()[-8:].tolist() == [True, True, True, False, False, False, False,
                                        False]
    assert 20 < int(ok.sum()) < 68
    # a coordinate beyond int32: the JAX package's conversion saturates and
    # its x0 + 1 wraps around, so it calls such a point valid; the port
    # clamps in float first and calls it invalid, on the CPU and the card
    far, ok_far = track.transfer_points(t32([[1e12, 3.0], [3.0, -1e12]]), t32(flow))
    assert not bool(ok_far.any()) and bool(torch.isnan(far).all())


def _assert_tables_equal(tab, tab_j, atol=0.0):
    got = convert.track_table_to_numpy(tab)
    for k in FIELDS:
        want = np.asarray(getattr(tab_j, k))
        assert got[k].dtype == want.dtype and got[k].shape == want.shape, k
        if got[k].dtype == np.float32 and (atol or k == "total_move"):
            np.testing.assert_allclose(got[k], want, rtol=0, atol=atol or MOVE_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want, err_msg=k)


def test_advance_tracks_matches_jax_over_four_frames(rng):
    """Capacity 24 with 40 candidates per frame: more candidates than free
    slots on every frame; a flow pair that breaks the gate in one image
    half kills tracks there, whose slots are recycled."""
    H, W, C = 60, 80, 24
    tab_j = jtrack.make_track_table(C, 3)
    tab = track.make_track_table(C, 3, device="cpu")
    _assert_tables_equal(tab, tab_j)
    seen_recycled = False
    for frame in range(4):
        flow_f = (gaussian_filter(rng.normal(size=(H, W, 2)), (6, 6, 0)) * 8
                  + [1.5, -0.8]).astype(np.float32)
        flow_b = -flow_f
        flow_b[:, : W // 2] += rng.choice([0.0, 0.7, 2.5], size=(H, 1, 1)).astype(np.float32)
        new_xy = rng.uniform(2, [W - 3, H - 3], size=(40, 2)).astype(np.float32)
        new_valid = rng.uniform(size=40) < 0.8
        if frame == 2:
            new_valid[:] = False                   # no candidates at all
            new_valid[[3, 17]] = True
        alive_before = convert.track_table_to_numpy(tab)["alive"]
        tab_j = jtrack.advance_tracks(tab_j, jnp.asarray(flow_f), jnp.asarray(flow_b),
                                      jnp.asarray(new_xy), jnp.asarray(new_valid))
        tab = track.advance_tracks(tab, t32(flow_f), t32(flow_b), t32(new_xy),
                                   torch.tensor(new_valid))
        _assert_tables_equal(tab, tab_j)
        now = convert.track_table_to_numpy(tab)
        seen_recycled |= bool((alive_before & now["alive"] & (now["age"] == 0)).any())
        pairs_j, pv_j = jtrack.point_pairs(tab_j, min_move=0.5)
        pairs, pv = track.point_pairs(tab, min_move=0.5)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(pv_j))
        np.testing.assert_array_equal(pairs.numpy(), np.asarray(pairs_j))
        if frame == 0:
            assert int(now["alive"].sum()) == C and not bool(pv.any())
    assert seen_recycled and int(pv.sum()) > 0
    assert int(now["frame"]) == 4 and int(now["head"]) == 4 % 3
    # the JAX package's table carried into the port and back
    carried = convert.track_table_from_numpy(tab_j, "cpu")
    _assert_tables_equal(carried, tab_j)
    assert [getattr(carried, k).dtype for k in FIELDS] == [getattr(tab, k).dtype for k in FIELDS]


def test_point_tracking_loop_matches_jax(rng):
    """The loop of examples/run_of_point_track.py over four 128x96 frames:
    pyramids, dense flow both ways, corners, table, pairs."""
    H, W, L, pad, C = 96, 128, 3, 8, 64
    base = gaussian_filter(rng.normal(size=(H + 12, W + 12)), 2.0) * 100 + 128
    frames = [base[6 + k:6 + k + H, 6 - 2 * k:6 - 2 * k + W].astype(np.float32)
              for k in range(4)]                    # content moves by (+2, -1) px
    jp = [jbuild(jnp.asarray(f), L, pad) for f in frames]
    tp = [build_pyramid(t32(f), L, pad) for f in frames]
    tab_j = jtrack.make_track_table(C, 6)
    tab = track.make_track_table(C, 6, device="cpu")
    for i in range(3):
        ff_j = jflow.dense_flow_lk(jp[i], jp[i + 1], pad, iters=4)
        fb_j = jflow.dense_flow_lk(jp[i + 1], jp[i], pad, iters=4)
        xy_j, v_j = jfeat.shi_tomasi_corners(jp[i + 1][0].img[pad:-pad, pad:-pad],
                                             max_corners=C, border=pad)
        tab_j = jtrack.advance_tracks(tab_j, ff_j, fb_j, xy_j, v_j)
        ff = dense_flow.dense_flow_lk(tp[i], tp[i + 1], pad, iters=4)
        fb = dense_flow.dense_flow_lk(tp[i + 1], tp[i], pad, iters=4)
        xy, v = features.shi_tomasi_corners(tp[i + 1][0].img[pad:-pad, pad:-pad],
                                            max_corners=C, border=pad)
        # the same corners, maybe in another order: seed both tables alike
        assert _corner_set(xy, v) == _corner_set(xy_j, v_j)
        tab = track.advance_tracks(tab, ff, fb, t32(np.asarray(xy_j)),
                                   torch.tensor(np.asarray(v_j)))
        _assert_tables_equal(tab, tab_j, atol=LOOP_ATOL)
    pairs, pv = track.point_pairs(tab)
    pairs_j, pv_j = jtrack.point_pairs(tab_j)
    np.testing.assert_array_equal(pv.numpy(), np.asarray(pv_j))
    step = (pairs[:, 1] - pairs[:, 0])[pv].numpy()
    assert len(step) >= 10
    np.testing.assert_allclose(np.median(step, axis=0), [2.0, -1.0], atol=0.25)


def test_make_track_table_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            track.make_track_table(8, 3)
    tab = track.make_track_table(8, 3, device="cpu")
    assert tab.xy.shape == (8, 3, 2) and bool(torch.isnan(tab.xy).all())
    assert tab.head.dim() == 0 and tab.head.dtype == torch.int32
