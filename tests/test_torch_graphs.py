"""The port's graph layer (``ccrs_tpu_torch/detect/graphs.py``) and the JAX
shape discipline that keys it, on the CPU (no card, so nothing is
captured here; ``tests/test_torch_cuda.py`` holds the captured graphs).

- The quad ladder ``_quad_rung`` equals the JAX package's, and after the
  same detection the port's sticky buckets (``_mq``, ``_wave_rows``,
  ``_wave_rows_small``) and the wave shapes (rows, and the resweep wave
  count) equal the JAX detector's, as the buckets do after the same
  warm-up (which captures no graph): exact.
- Padding changes no result bit: the decode at the ladder's quad count
  against each chunk's own, ``wave_advance`` with padded inactive rows,
  and the JAX accelerator plan's padded frames against natural chunks,
  also through the graphed code paths (``graphs.active`` patched to take
  the CPU, where ``graphs.get`` hands out its eager stand-in): exact.
- ``graphs.eager()`` nests and restores its state; a CPU tensor never
  reaches a capture; a bound tensor must be a graph's buffer; the cache
  key holds every part a graph depends on.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccrs_tpu.board import create_default_6x6_board as jax_board
from ccrs_tpu.detect import TagDetector as JaxDetector
from ccrs_tpu.detect import detector as JD
from ccrs_tpu.detect import track as JT
from ccrs_tpu_torch.detect import TagDetector, graphs, sample
from ccrs_tpu_torch.detect import detector as TD
from ccrs_tpu_torch.detect import track as TT
from ccrs_tpu_torch.detect import tracked as TTR
from ccrs_tpu_torch.interop import board_from_ref
from test_torch_tracked import bench_like_frames, video_frames
from torch_jax_pin import assert_same_detections, fresh_jax_traces  # noqa: F401 (autouse)

torch.set_num_threads(2)

CORNER_TOL = 1e-3  # px, the port against the JAX package (float32, another sum order)
BUCKETS = ("_mq", "_wave_rows", "_wave_rows_small")
#: the JAX detector's defaults for the buckets it has not set yet
JAX_DEFAULTS = {"_mq": 8, "_wave_rows": 0, "_wave_rows_small": 8}


def jax_buckets(det):
    return {k: getattr(det, k, JAX_DEFAULTS[k]) for k in BUCKETS}


def port_buckets(det):
    return {k: getattr(det, k) for k in BUCKETS}


@pytest.fixture
def graphed(monkeypatch):
    """The graphed code paths on the CPU: ``graphs.active`` takes every
    device, so the detector pads to the JAX buckets; ``graphs.get`` still
    hands a CPU tensor the eager stand-in (no capture)."""
    def no_capture(*a, **k):
        raise AssertionError("a CPU tensor reached a capture")

    monkeypatch.setattr(graphs, "active", lambda where: not graphs._eager)
    monkeypatch.setattr(graphs, "_capture", no_capture)


def exact(got, want):
    assert len(got) == len(want)
    for f, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w), f"frame {f}"
        for t in g:
            np.testing.assert_array_equal(g[t], w[t], err_msg=f"frame {f} tag {t}")


def test_quad_rung_matches_jax():
    for need in range(3001):
        assert TD._quad_rung(need) == JD._quad_rung(need), need


def record_jax_wave_shapes(monkeypatch):
    """(waves, rows) of every wave stack the JAX detector builds."""
    shapes = []
    real = JD._stack_outs
    monkeypatch.setattr(JD, "_stack_outs", lambda outs: shapes.append(
        (len(outs), int(outs[0][0].shape[0]))) or real(outs))
    return shapes


def record_port_wave_shapes(monkeypatch):
    shapes = []
    real = TTR._run_waves
    monkeypatch.setattr(TTR, "_run_waves", lambda det, dev_all, bxy, first, frame_of, *a: (
        shapes.append(tuple(frame_of.shape)) or real(det, dev_all, bxy, first, frame_of, *a)))
    return shapes


@pytest.mark.parametrize("name", ["video", "bench_like"])
def test_buckets_after_detect_batch_match_jax(name, monkeypatch):
    """The same frames through the JAX tracked detector and the port's:
    ``_mq``, ``_wave_rows`` and ``_wave_rows_small`` equal, eagerly and
    graphed; graphed, every wave stack has the JAX package's (waves, rows),
    the resweeps' wave count rounded up to 4 included (the 14-frame video
    audits and resweeps).  Detections: the port graphed equals the port
    eager bit for bit, and the JAX package within 1e-3 px."""
    if name == "video":
        imgs, port_imgs = video_frames()
    else:
        imgs = port_imgs = bench_like_frames()
    jb = jax_board()
    jdet = JaxDetector("t36h11", track=True)
    jshapes = record_jax_wave_shapes(monkeypatch)
    want = jdet.detect_batch(imgs, board=jb)
    board = board_from_ref(jb)
    eager = TagDetector("t36h11", device="cpu")
    got_eager = eager.detect_batch(port_imgs, board=board)
    assert port_buckets(eager) == jax_buckets(jdet)
    with monkeypatch.context() as m:
        m.setattr(graphs, "active", lambda where: not graphs._eager)
        pshapes = record_port_wave_shapes(m)
        det = TagDetector("t36h11", device="cpu")
        got = det.detect_batch(port_imgs, board=board)
    assert port_buckets(det) == jax_buckets(jdet)
    assert pshapes == jshapes and jshapes
    if name == "video":
        assert det.stats.get("resweeps", 0) > 0 and len(jshapes) > 1
    assert det.stats == eager.stats == jdet.stats
    exact(got, got_eager)
    assert_same_detections(got, want, CORNER_TOL)


def stub_jax_device_stages(monkeypatch):
    """The JAX warm-up's device calls answered with zeros of their shapes
    (its buckets do not depend on them)."""
    def decode(family, images, quads, qvalid, do_refine=True, sharp=None, maps=None):
        C, M = quads.shape[:2]
        return {"valid": jnp.zeros((C, M), bool), "sharp": jnp.zeros(1), "maps": jnp.zeros(1)}

    def wave(family, imgs, bxy, first, carry, act):
        z = jnp.zeros(imgs.shape[0])
        return carry, (z, z, z, z)

    monkeypatch.setattr(JD, "refine_decode_fused_dense", decode)
    monkeypatch.setattr(JT, "wave_advance", wave)
    monkeypatch.setattr(JD, "_stack_outs",
                        lambda outs: tuple(jnp.zeros(len(outs)) for _ in range(4)))


@pytest.mark.parametrize("n_frames", [None, 8, 150, 534])
@pytest.mark.parametrize("with_board", [True, False])
def test_prewarm_buckets_match_jax(n_frames, with_board, monkeypatch):
    """After ``prewarm``, ``_mq`` and ``_wave_rows`` equal the JAX
    detector's, so the first detection captures its graphs at the shapes
    the JAX package warms (its device stages stubbed here: only the
    buckets are compared).  The warm-up itself captures nothing, even with
    graphs on: a capture on its thread would fail a device-wide
    synchronize on any other thread."""
    jb = jax_board()
    board = board_from_ref(jb) if with_board else None
    jdet = JaxDetector("t36h11", track=True)
    jdet.chunk, jdet.cold_chunk = 4, 2
    stub_jax_device_stages(monkeypatch)
    jdet.prewarm(64, 64, jb if with_board else None, n_frames=n_frames)

    def no_graph(*a, **k):
        raise AssertionError("the warm-up reached the graph layer")

    monkeypatch.setattr(graphs, "active", lambda where: not graphs._eager)
    for name in ("get", "ensure", "run", "_capture"):
        monkeypatch.setattr(graphs, name, no_graph)
    det = TagDetector("t36h11", device="cpu")
    det.chunk, det.cold_chunk = 4, 2
    det.prewarm(64, 64, board, n_frames=n_frames)
    assert port_buckets(det) == jax_buckets(jdet)
    assert det.stats == {} and det._tstate is None


@pytest.fixture(scope="module")
def chunk_case():
    """The args of the primary and the assist decode of one cold chunk of
    4 video frames, and of the first wave of the tracked run."""
    _, imgs = video_frames()
    board = board_from_ref(jax_board())
    calls = {"decode": [], "wave": []}
    real_decode, real_wave = TD.refine_decode_fused_dense, TTR.wave_advance

    def decode(*a, **k):
        calls["decode"].append((a, k))
        return real_decode(*a, **k)

    def wave(*a):
        calls["wave"].append(a)
        return real_wave(*a)

    mp = pytest.MonkeyPatch()
    mp.setattr(TD, "refine_decode_fused_dense", decode)
    mp.setattr(TTR, "wave_advance", wave)
    try:
        TagDetector("t36h11", track=False, device="cpu").detect_batch(imgs[:4], board)
        TagDetector("t36h11", device="cpu").detect_batch(imgs, board)
    finally:
        mp.undo()
    return calls


def test_decode_at_the_ladder_rung_is_bit_equal(chunk_case):
    """The primary decode of a chunk with its quads padded from the
    chunk's largest count up to the next rungs (the padding slots
    invalid), and with a padding frame: the real quads' outputs equal."""
    (fam, images, quads, qvalid), kw = chunk_case["decode"][0]
    assert kw.get("maps") is None
    want = TD.refine_decode_fused_dense(fam, images, quads, qvalid, **kw)
    B, M = quads.shape[:2]
    for Mq in (TD._quad_rung(M), TD._quad_rung(TD._quad_rung(M) + 1)):
        qq = torch.zeros((B + 1, Mq, 4, 2))
        qq[:B, :M] = quads
        qv = torch.zeros((B + 1, Mq), dtype=torch.bool)
        qv[:B, :M] = qvalid
        imgs = torch.cat([images, images[-1:]])
        got = TD.refine_decode_fused_dense(fam, imgs, qq, qv, **kw)
        for k in ("tag_id", "rotation", "hamming", "valid", "contrast_ok", "corners"):
            assert torch.equal(got[k][:B, :M], want[k]), (Mq, k)
        assert not got["valid"][:, M:].any() and not got["valid"][B:].any()


def test_assist_graph_form_is_bit_equal(chunk_case):
    """``_assist_graph`` (the sharpened frames in place of the frames)
    gives the bits of the detector's eager assist call."""
    (fam, images, quads, qvalid), kw = next(
        c for c in chunk_case["decode"] if c[1].get("maps") is not None)
    want = TD.refine_decode_fused_dense(fam, images, quads, qvalid, **kw)
    got = TD._assist_graph(fam, kw["do_refine"], kw["sharp"], kw["maps"], quads, qvalid)
    for k in ("tag_id", "hamming", "valid", "corners"):
        assert torch.equal(got[k], want[k]), k


def test_wave_with_padded_rows_is_bit_equal(chunk_case):
    """``wave_advance`` with 5 padding rows (inactive, zero carry) after
    the real ones: the real rows' outputs and carry equal.  ``wave_step``,
    the graphed form, updates its carry in place to the same bits."""
    fam, imgs, bxy, first, carry, act = chunk_case["wave"][0]
    want_carry, want = TT.wave_advance(fam, imgs, bxy, first, carry, act)
    R, k = imgs.shape[0], 5
    pad_imgs = torch.cat([imgs, imgs[:1].expand(k, -1, -1)])
    pad_carry = tuple(torch.cat([c, torch.zeros((k,) + c.shape[1:], dtype=c.dtype)])
                      for c in carry)
    pad_act = torch.cat([act, torch.zeros(k, dtype=torch.bool)])
    got_carry, got = TT.wave_advance(fam, pad_imgs, bxy, first, pad_carry, pad_act)
    for g, w in zip(got + got_carry, want + want_carry):
        assert torch.equal(g[:R], w)
    assert not got[1][R:].any() and not got[2][R:].any()
    buffers = tuple(c.clone() for c in pad_carry)
    outs = TT.wave_step(fam, first, pad_imgs, bxy, pad_act, *buffers)
    for g, w in zip(outs + buffers, got + got_carry):
        assert torch.equal(g, w)


@pytest.mark.parametrize("B,idx", [(13, None), (13, [12, 0, 7, 3, 9, 1, 5]), (8, None)])
def test_accelerator_plan_padding_is_bit_equal(B, idx, graphed):
    """The cold detector graphed on the CPU (the JAX plan: ``chunk=8``,
    ``cold_chunk=4``; 13 frames as 8 + 4 + 1 decoded as 8 + 4 + 4, the
    last frame repeated) against natural chunks: ids and corners equal."""
    _, imgs = video_frames()
    board = board_from_ref(jax_board())
    frames = torch.as_tensor(imgs[:B])
    det = TagDetector("t36h11", track=False, device="cpu")
    det.chunk, det.cold_chunk = 8, 4
    plan = det._plan(len(idx) if idx else B)
    assert [C for _, _, C in plan] == JD._chunk_plan(len(idx) if idx else B, 8, 4, cpu=False)
    got = det._detect_batch_cold(frames, board, idx=idx)
    with graphs.eager():
        assert all(n == C for _, n, C in det._plan(B))
        want = det._detect_batch_cold(frames, board, idx=idx)
    exact(got, want)
    assert sum(len(g) for g in got) > 10 * len(got)


def test_eager_nests_and_restores():
    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert graphs.active(card) and graphs.active("cuda:0") and not graphs.active(cpu)
    with graphs.eager():
        assert not graphs.active(card)
        with graphs.eager(False):
            assert graphs.active(card)
            with graphs.eager():
                assert not graphs.active(card)
            assert graphs.active(card)
        assert not graphs.active(card)
    assert graphs.active(card)
    with pytest.raises(KeyError):
        with graphs.eager():
            raise KeyError("restored on the way out")
    assert graphs.active(card) and not graphs.active(cpu)


def test_cpu_tensor_never_reaches_capture(monkeypatch):
    """On the CPU ``get`` and ``run`` call the function eagerly: no capture,
    no graph, no count, and the stand-in's buffers work as a graph's."""
    def boom(*a, **k):
        raise AssertionError("capture reached")

    monkeypatch.setattr(graphs, "_capture", boom)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", boom)
    before = graphs.counts()
    x = torch.arange(6.0).reshape(2, 3)
    out = graphs.run(lambda k, a: {"y": a * k}, (3.0,), (x,))
    assert torch.equal(out["y"], x * 3)
    g = graphs.get(lambda a: a + 1, (), (x,), slot=1)
    assert g.graph is None and g.inputs[0].shape == x.shape and g.inputs[0] is not x
    g.inputs[0].copy_(x)
    assert torch.equal(g.replay(), x + 1)
    assert graphs.counts() == before


def test_graphed_tracked_detection_on_the_cpu_captures_nothing(graphed):
    """The graphed tracked path on the CPU (stand-ins only) equals eager."""
    _, imgs = video_frames()
    board = board_from_ref(jax_board())
    got = TagDetector("t36h11", device="cpu").detect_batch(imgs, board)
    with graphs.eager():
        want = TagDetector("t36h11", device="cpu").detect_batch(imgs, board)
    exact(got, want)


def test_bound_tensor_must_be_a_graph_buffer():
    with pytest.raises(ValueError, match="static buffer"):
        graphs._capture(lambda b, a: a, (), (torch.zeros(2),), (torch.zeros(3),), None)


def test_key_holds_every_part():
    """Function, static args, shapes, dtypes, slot, sampling branch and the
    identity of a bound tensor each change the key."""
    x, q = torch.zeros(2, 8, 8), torch.zeros(2, 4)
    fn, other = TD._decode_graph, TD._assist_graph

    def key(fn, args, inputs, bound, slot):
        return graphs._key(fn, args, "cpu", graphs._specs(inputs), bound, slot)

    base = key(fn, ("a",), (x, q), (), 0)
    assert base == key(fn, ("a",), (x.clone(), q.clone()), (), 0)
    assert base == graphs._key(fn, ("a",), torch.device("cpu"),
                               (((2, 8, 8), torch.float32), ((2, 4), torch.float32)), (), 0)
    variants = [
        key(other, ("a",), (x, q), (), 0),
        key(fn, ("b",), (x, q), (), 0),
        key(fn, ("a",), (x, torch.zeros(2, 5)), (), 0),
        key(fn, ("a",), (x.to(torch.uint8), q), (), 0),
        key(fn, ("a",), (x, q), (), 1),
        key(fn, ("a",), (x, q), (x,), 0),
        key(fn, ("a",), (x, q), (x.clone(),), 0),
    ]
    with sample.matmul_branch(True):
        variants.append(key(fn, ("a",), (x, q), (), 0))
    assert len(set(variants + [base])) == len(variants) + 1
