"""The JAX package's superseded and uncalled functions against their ports.

The detector of both packages runs the dense path; the compact decode, the
patch and gather refinements, the host refinements and four helpers that
nothing calls are ported all the same, each held here against the JAX
function on the same seeded inputs: two 512x512 frames rendered by the
port on the CPU, their detected tag corners perturbed by seeded noise as
the quad list.

Tolerances: gathers, bit packing and id decisions are exact; float32 sums
(blur, window sums, refinement) differ by their order and by XLA's fused
multiply-adds, so sharpened pixels agree within 1e-3 gray levels and
refined corners within ``PX_TOL`` = 2e-3 px; the host refinements run the
same C++ and agree within 1e-5 px; the float64 pose init within 1e-8.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.calib.single import init_frame_poses as jax_init_frame_poses
from ccrs_tpu.detect import assist as jax_assist
from ccrs_tpu.detect import decode as jax_decode
from ccrs_tpu.detect import get_family as jax_get_family
from ccrs_tpu.detect import patches as jax_patches
from ccrs_tpu.detect import quads as jax_quads
from ccrs_tpu.detect import refine as jax_refine
from ccrs_tpu.detect.threshold import adaptive_threshold_packed2 as jax_packed2
from ccrs_tpu.models import GenericModel as JaxModel
from ccrs_tpu.solve.homography import lift as jax_lift
from ccrs_tpu_torch.board import create_default_6x6_board
from ccrs_tpu_torch.calib.single import init_frame_poses
from ccrs_tpu_torch.detect import TagDetector, get_family
from ccrs_tpu_torch.detect import assist, decode, patches, quads, refine
from ccrs_tpu_torch.detect.threshold import adaptive_threshold_packed2
from ccrs_tpu_torch.interop import frame_batch_from_ref
from ccrs_tpu_torch.models import GenericModel
from ccrs_tpu_torch.solve.homography import lift
from ccrs_tpu_torch.testdata import default_sequence_poses, render_frames_device
from synthetic import make_synthetic_batch

torch.set_num_threads(2)

GT = [190.9, 190.87, 254.94, 256.86, 0.628, 1.046]
PX_TOL = 2e-3


@pytest.fixture(scope="module")
def scene():
    """Two frames, their detections, and a compact quad list (corners off
    by 0.6 px of seeded noise) with frame indices."""
    board = create_default_6x6_board()
    poses = default_sequence_poses(2, board, seed=7)
    imgs = render_frames_device(
        GenericModel("eucm", GT, 512, 512), board, get_family("t36h11"), poses,
        noise=1.5, generator=torch.Generator().manual_seed(7), device="cpu",
    )
    dets = TagDetector(device="cpu", track=False).detect_batch(None, board, dev_images=imgs)
    rng = np.random.default_rng(3)
    truth, ids, qframe = [], [], []
    for f, d in enumerate(dets):
        for tid in sorted(d):
            # a detection's corners are in the tag's canonical order; the
            # decoder takes image-order quads: undo the Kalibr permutation
            truth.append(d[tid][[1, 0, 3, 2]])
            ids.append(tid)
            qframe.append(f)
    assert len(truth) > 50
    truth = np.asarray(truth, np.float32)
    quads = (truth + rng.normal(size=truth.shape) * 0.6).astype(np.float32)
    return dict(board=board, imgs=imgs.numpy().astype(np.float32), dets=dets, truth=truth,
                ids=np.asarray(ids), quads=quads, qframe=np.asarray(qframe, np.int32))


def test_unsharp_matches(scene):
    got = decode.unsharp(torch.as_tensor(scene["imgs"])).numpy()
    want = np.asarray(jax_decode.unsharp(jnp.asarray(scene["imgs"])))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    assert np.abs(got - scene["imgs"]).max() > 10  # it does sharpen


@pytest.mark.parametrize("as_u8", [False, True])
def test_extract_patches_matches(scene, as_u8):
    corners = scene["quads"].reshape(-1, 2)
    cframe = np.repeat(scene["qframe"], 4)
    # some corners at the image border: the patch origin clamps
    corners = np.concatenate([corners, [[1.0, 2.0], [510.5, 509.0], [3.2, 508.7]]]).astype(np.float32)
    cframe = np.concatenate([cframe, [0, 1, 1]]).astype(np.int32)
    got = patches.extract_patches(
        torch.as_tensor(scene["imgs"]), torch.as_tensor(corners), torch.as_tensor(cframe),
        as_u8=as_u8,
    )
    want = jax_patches.extract_patches(
        jnp.asarray(scene["imgs"]), jnp.asarray(corners), jnp.asarray(cframe), as_u8=as_u8
    )
    assert got[0].shape == (len(corners), patches.PATCH, patches.PATCH)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("fn", ["refine_patches", "refine_patches_2stage"])
def test_refine_patches_matches(scene, fn):
    corners = scene["quads"].reshape(-1, 2)
    cframe = np.repeat(scene["qframe"], 4)
    p, local, _ = patches.extract_patches(
        torch.as_tensor(scene["imgs"]), torch.as_tensor(corners), torch.as_tensor(cframe)
    )
    got = getattr(refine, fn)(p, local).numpy()
    want = np.asarray(getattr(jax_refine, fn)(jnp.asarray(p.numpy()), jnp.asarray(local.numpy())))
    np.testing.assert_allclose(got, want, rtol=0, atol=PX_TOL)
    assert np.abs(got - local.numpy()).max() > 0.3  # the corners moved


def test_refine_corners_matches(scene):
    per_frame = [scene["quads"][scene["qframe"] == f].reshape(-1, 2) for f in (0, 1)]
    M = min(len(c) for c in per_frame)
    corners = np.stack([c[:M] for c in per_frame])
    got = refine.refine_corners(torch.as_tensor(scene["imgs"]), torch.as_tensor(corners)).numpy()
    want = np.asarray(jax_refine.refine_corners(jnp.asarray(scene["imgs"]), jnp.asarray(corners)))
    np.testing.assert_allclose(got, want, rtol=0, atol=PX_TOL)
    # and the truth: the detections the noise was added to
    truth = np.stack(
        [scene["truth"][scene["qframe"] == f].reshape(-1, 2)[:M] for f in (0, 1)]
    )
    assert np.median(np.abs(got - truth)) < 0.05


def _same_decode(got, want):
    for k in ("tag_id", "rotation", "hamming", "valid", "contrast_ok"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    return got["valid"].numpy()


def test_decode_quads_compact_matches(scene):
    fam, jfam = get_family("t36h11"), jax_get_family("t36h11")
    truth, ids = scene["truth"], scene["ids"]
    qvalid = np.ones(len(truth), bool)
    qvalid[::7] = False  # padding rows
    sharp = decode.unsharp(torch.as_tensor(scene["imgs"]))
    got = decode.decode_quads_compact(
        fam, sharp, torch.as_tensor(truth), torch.as_tensor(scene["qframe"]),
        torch.as_tensor(qvalid),
    )
    want = jax_decode.decode_quads_compact(
        jfam, jnp.asarray(sharp.numpy()), jnp.asarray(truth), jnp.asarray(scene["qframe"]),
        jnp.asarray(qvalid),
    )
    valid = _same_decode(got, want)
    np.testing.assert_array_equal(got["corners"].numpy(), np.asarray(want["corners"]))
    assert valid[qvalid].mean() > 0.9 and not valid[~qvalid].any()
    np.testing.assert_array_equal(got["tag_id"].numpy()[valid], ids[valid])


@pytest.mark.parametrize("do_refine", [True, False])
def test_refine_decode_fused_matches(scene, do_refine):
    fam, jfam = get_family("t36h11"), jax_get_family("t36h11")
    qvalid = np.ones(len(scene["quads"]), bool)
    u8 = scene["imgs"].astype(np.uint8)
    got = decode.refine_decode_fused(
        fam, torch.as_tensor(u8), torch.as_tensor(scene["quads"]),
        torch.as_tensor(scene["qframe"]), torch.as_tensor(qvalid), do_refine=do_refine,
    )
    want = jax_decode.refine_decode_fused(
        jfam, jnp.asarray(u8), jnp.asarray(scene["quads"]), jnp.asarray(scene["qframe"]),
        jnp.asarray(qvalid), do_refine=do_refine,
    )
    np.testing.assert_allclose(got["sharp"].numpy(), np.asarray(want["sharp"]), rtol=0, atol=1e-3)
    # ids: equal wherever both decode the quad with margin; a corner that
    # the two refinements leave 1e-3 px apart can flip a bit on the edge
    g_valid, w_valid = got["valid"].numpy(), np.asarray(want["valid"])
    assert (g_valid != w_valid).mean() <= 0.02
    both = g_valid & w_valid
    np.testing.assert_array_equal(got["tag_id"].numpy()[both], np.asarray(want["tag_id"])[both])
    np.testing.assert_array_equal(got["rotation"].numpy()[both], np.asarray(want["rotation"])[both])
    np.testing.assert_allclose(
        got["corners"].numpy()[both], np.asarray(want["corners"])[both], rtol=0, atol=PX_TOL
    )
    if do_refine:
        assert both.mean() > 0.8
    # a second decode of the chunk reuses the sharpened frames
    again = decode.refine_decode_fused(
        fam, torch.as_tensor(u8), torch.as_tensor(scene["quads"]),
        torch.as_tensor(scene["qframe"]), torch.as_tensor(qvalid), do_refine=do_refine,
        sharp=got["sharp"],
    )
    assert again["sharp"] is got["sharp"]
    np.testing.assert_array_equal(again["tag_id"].numpy(), got["tag_id"].numpy())


def test_native_refinements_match(scene):
    per_frame = [scene["quads"][scene["qframe"] == f].reshape(-1, 2) for f in (0, 1)]
    M = min(len(c) for c in per_frame)
    corners = np.stack([c[:M] for c in per_frame])
    got = quads.refine_corners_native(scene["imgs"], corners)
    want = jax_quads.refine_corners_native(scene["imgs"], corners)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(got - corners).max() > 0.3
    counts = np.array([M // 8, M // 4 - 3])
    got_c = quads.refine_corners_native(scene["imgs"], corners, counts=counts, group=4)
    want_c = jax_quads.refine_corners_native(scene["imgs"], corners, counts=counts, group=4)
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_c[0, counts[0] * 4 :], corners[0, counts[0] * 4 :])

    flat = scene["quads"].reshape(-1, 2)
    p, local, offset = patches.extract_patches(
        torch.as_tensor(scene["imgs"]), torch.as_tensor(flat),
        torch.as_tensor(np.repeat(scene["qframe"], 4)),
    )
    got_p = quads.refine_corners_patches_native(p.numpy(), local.numpy())
    want_p = jax_quads.refine_corners_patches_native(p.numpy(), local.numpy())
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-5)
    # patch-local == full-image refinement (tests/test_detector.py:256-274)
    full = quads.refine_corners_native(
        scene["imgs"], np.stack([flat, flat])
    )[np.repeat(scene["qframe"], 4), np.arange(len(flat))]
    np.testing.assert_allclose(got_p + offset.numpy(), full, rtol=0, atol=1e-4)


def test_adaptive_threshold_packed2_matches(scene):
    u8 = scene["imgs"].astype(np.uint8)
    got = adaptive_threshold_packed2(torch.as_tensor(u8)).numpy()
    want = np.asarray(jax_packed2(jnp.asarray(u8)))
    assert got.shape == (2, 2, 512, 64) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    lvl = np.unpackbits(got, axis=-1)
    assert (lvl[:, 1] >= lvl[:, 0]).all() and (lvl[:, 1] != lvl[:, 0]).any()  # one more dilation


def test_recover_missing_tags_matches(scene):
    board, jboard = scene["board"], jax_board()
    rng = np.random.default_rng(9)

    def thinned():
        out = []
        for d in scene["dets"]:
            keep = sorted(d)
            drop = set(rng.choice(keep, size=6, replace=False).tolist())
            out.append({t: d[t].copy() for t in keep if t not in drop})
        return out

    rng = np.random.default_rng(9)
    mine = thinned()
    rng = np.random.default_rng(9)
    theirs = thinned()
    u8 = scene["imgs"].astype(np.uint8)
    n_got = assist.recover_missing_tags(get_family("t36h11"), board, torch.as_tensor(u8), mine)
    n_want = jax_assist.recover_missing_tags(
        jax_get_family("t36h11"), jboard, jnp.asarray(u8), theirs
    )
    assert n_got == n_want >= 8
    for a, b, full in zip(mine, theirs, scene["dets"]):
        assert sorted(a) == sorted(b)
        for t in a:
            np.testing.assert_allclose(a[t], b[t], rtol=0, atol=PX_TOL)
            np.testing.assert_allclose(a[t], full[t], rtol=0, atol=0.1)


def test_init_frame_poses_matches():
    jb = jax_board()
    batch, poses = make_synthetic_batch(JaxModel("eucm", GT, 512, 512), jb, n_frames=6,
                                        seed=2, px_noise=0.2)
    batch.mask[3, 20:] = False  # fewer than 10 unprojectable points -> masked
    batch.mask[3, :15] = False
    model = JaxModel("eucm", np.asarray(GT) * 1.01, 512, 512)
    want_p, want_v = jax_init_frame_poses(jb, batch, model)
    got_p, got_v = init_frame_poses(
        create_default_6x6_board(), frame_batch_from_ref(batch),
        GenericModel("eucm", np.asarray(GT) * 1.01, 512, 512), device="cpu",
    )
    np.testing.assert_array_equal(got_v, np.asarray(want_v))
    assert got_v[3] == 0 and got_v.sum() == 5
    ok = got_v > 0
    np.testing.assert_allclose(got_p[ok], np.asarray(want_p)[ok], rtol=0, atol=1e-8)
    np.testing.assert_allclose(got_p[ok], poses[ok], rtol=0, atol=0.05)


def test_lift_matches():
    rng = np.random.default_rng(1)
    p = rng.normal(size=(5, 7, 2))
    got = lift(torch.as_tensor(p), -0.37).numpy()
    want = np.asarray(jax_lift(jnp.asarray(p), -0.37))
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    assert got.shape == (5, 7, 3)
    np.testing.assert_array_equal(got[..., :2], p)
