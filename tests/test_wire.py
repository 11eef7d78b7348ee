"""Packed THRESHOLD wire format: device pack, host twins, engine + serve."""

import threading

import numpy as np
import jax.numpy as jnp
import pytest

from dips.models import DiPsEngine
from dips.ops import wire
from dips.properties import DiPsProperties, OutputMode
from dips.serve import DiPsClient, DiPsServer
from tests.conftest import make_clip


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    mask = (rng.integers(0, 2, (3, 2, 16, 128), np.uint8)) * 255
    packed = np.asarray(wire.pack_mask(jnp.asarray(mask)))
    # packed along the ROW axis: minor dim keeps its 128-aligned width
    assert packed.shape == (3, 2, 2, 128) and packed.dtype == np.uint8
    np.testing.assert_array_equal(wire.unpack_mask(packed), mask)


def test_host_pack_matches_device():
    rng = np.random.default_rng(1)
    mask = (rng.integers(0, 2, (4, 8, 256), np.uint8)) * 255
    np.testing.assert_array_equal(
        np.asarray(wire.pack_mask(jnp.asarray(mask))),
        wire.pack_mask_host(mask))


def test_engine_packed_wire_transparent():
    props = DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=2)
    clip = list(make_clip(n=6, h=24, w=40, seed=4))
    plain = DiPsEngine(props, 24, 40, batch=3)
    packed = DiPsEngine(props, 24, 40, batch=3, packed_wire=True)
    out_a, st_a = plain.process_frames(clip)
    out_b, st_b = packed.process_frames(clip)
    np.testing.assert_array_equal(out_a, out_b)
    np.testing.assert_allclose(st_a, st_b, atol=1e-6)
    assert set(np.unique(out_b)) <= {0, 255}


def test_engine_packed_wire_requires_threshold():
    with pytest.raises(ValueError, match="THRESHOLD"):
        DiPsEngine(DiPsProperties(), 24, 40, packed_wire=True)


@pytest.fixture()
def threshold_server():
    props = DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=2)
    srv = DiPsServer(props, 24, 40, port=0, batch=1, packed_wire=True)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()


def test_serve_packed_payload(threshold_server):
    clip = make_clip(n=5, h=24, w=40, seed=5)
    a, b = DiPsClient(threshold_server.port), None
    outs_packed, stats_packed = a.process_many(clip, packed=True)
    a.close()

    eng = DiPsEngine(DiPsProperties(output=OutputMode.THRESHOLD,
                                    temporal_size=2), 24, 40, batch=1)
    exp_out, exp_stats = eng.process_frames(list(clip))
    np.testing.assert_array_equal(outs_packed, exp_out)
    np.testing.assert_allclose(stats_packed, exp_stats, atol=1e-6)

    # single-frame path too; the pooled engine keeps the first session's
    # state, so reset it first
    b = DiPsClient(threshold_server.port)
    b.reset()
    o1, _ = b.process(clip[0], packed=True)
    np.testing.assert_array_equal(o1, exp_out[0])
    b.close()


@pytest.mark.parametrize("packed_wire", [False, True])
def test_serve_packed_h_not_multiple_of_8(packed_wire):
    """H=25: the host packer zero-pads the row axis to a byte boundary and
    the client crops with count=H (packed_wire=False), or the device-packed
    padded planes (Hp=32) arrive verbatim and the client crops (True)."""
    props = DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=2)
    srv = DiPsServer(props, 25, 40, port=0, batch=2,
                     packed_wire=packed_wire)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=4, h=25, w=40, seed=8)
        cli = DiPsClient(srv.port)
        outs, stats = cli.process_many(clip, packed=True)
        cli.close()
        eng = DiPsEngine(props, 25, 40, batch=2)
        exp_out, exp_stats = eng.process_frames(list(clip))
        np.testing.assert_array_equal(outs, exp_out)
        np.testing.assert_allclose(stats, exp_stats, atol=1e-6)
    finally:
        srv.shutdown()


def test_stream_dips_packed_wire(tmp_path):
    from dips.app import DiPsJob, stream_dips
    from dips.io import moving_square_clip, write_clip
    path = str(tmp_path / "in.avi")
    write_clip(moving_square_clip(n=10, height=48, width=64, seed=7), path,
               fps=20)
    props = DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=2)

    def run(packed):
        job = DiPsJob(properties=props, video_path=path, batch=4,
                      packed_wire=packed)
        return [o for _, _, o, _ in stream_dips(job)]

    plain, packed = run(False), run(True)
    assert len(plain) == len(packed) == 10
    np.testing.assert_array_equal(np.stack(plain), np.stack(packed))


def test_multistream_packed_wire():
    from dips.parallel import MultiStreamEngine, stream_mesh
    props = DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=2)
    mesh = stream_mesh(4)
    feeds = [[f for f in make_clip(n=4, h=16, w=24, seed=10 + s)]
             for s in range(4)]
    plain = MultiStreamEngine(props, 16, 24, n_streams=4, batch=4, mesh=mesh)
    packed = MultiStreamEngine(props, 16, 24, n_streams=4, batch=4,
                               mesh=mesh, packed_wire=True)
    out_a, st_a, gm_a = plain.process_batch(feeds)
    out_b, st_b, gm_b = packed.process_batch(feeds)
    np.testing.assert_array_equal(out_a, out_b)
    np.testing.assert_allclose(st_a, st_b, atol=1e-6)
    assert gm_a == gm_b

    with pytest.raises(ValueError, match="THRESHOLD"):
        MultiStreamEngine(DiPsProperties(), 16, 24, n_streams=4,
                          packed_wire=True)


def test_process_reply_forwards_device_packed():
    """A packed_wire engine + packed request must forward the device-packed
    padded planes verbatim (no host unpack/repack on the serving path)."""
    from dips.serve import _process_reply
    props = DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=2)
    eng = DiPsEngine(props, 24, 40, batch=2, packed_wire=True)
    frame = make_clip(n=1, h=24, w=40, seed=9)[0]
    hdr, body = _process_reply(eng, [frame], {"packed": True})
    assert hdr["padded"] == [eng.hp, eng.wp]
    assert len(body) == (eng.hp // 8) * eng.wp  # padded plane, not H*W


def test_collect_packed_requires_packed_wire():
    props = DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=2)
    eng = DiPsEngine(props, 24, 40, batch=2)
    with pytest.raises(ValueError, match="packed_wire"):
        eng.process_batch([make_clip(n=1, h=24, w=40)[0]], packed=True)


def test_packed_wire_fuzz_geometries():
    """packed_wire must be output-transparent for arbitrary geometries
    (odd heights/widths exercise the pad-then-crop path)."""
    rng = np.random.default_rng(11)
    props = DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=2)
    for _ in range(6):
        h = int(rng.integers(9, 70))
        w = int(rng.integers(17, 150))
        clip = [rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(4)]
        a = DiPsEngine(props, h, w, batch=3)
        b = DiPsEngine(props, h, w, batch=3, packed_wire=True)
        oa, sa = a.process_frames(clip)
        ob, sb = b.process_frames(clip)
        np.testing.assert_array_equal(oa, ob, err_msg=f"{h}x{w}")
        np.testing.assert_allclose(sa, sb, atol=1e-6)


def test_serve_packed_ignored_for_colorize():
    srv = DiPsServer(DiPsProperties(temporal_size=2), 24, 40, port=0,
                     batch=1)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        cli = DiPsClient(srv.port)
        clip = make_clip(n=2, h=24, w=40, seed=6)
        out, _ = cli.process(clip[0], packed=True)  # flag must be a no-op
        assert out.shape == (24, 40, 3)
        cli.close()
    finally:
        srv.shutdown()
