"""The port's DeviceMeshNet and wire codecs against the reference's.

``DeviceMeshNet``: every (src, dst) pair at 2, 4 and 8 ranks is bitwise
the reference's single-pair ``ppermute`` on 8 fake CPU devices.
Codecs: the port's fp8 rides ``torch.float8_e4m3fn`` where the reference
rides ``ml_dtypes``; encode/decode are byte for byte equal at the
boundaries (|scaled| at and above 448, ties, subnormals, fp32 and fp64,
inf/nan refusals), and out of range, where torch saturates and
``ml_dtypes`` gives NaN, the difference is pinned and shown unreachable
through the per-frame scale. ``FP8_ROUNDTRIP_SHA256`` is what
``chip_smoke.py`` checks on the card's machine, which has no ml_dtypes.
"""

import dataclasses
import hashlib

import ml_dtypes
import numpy as np
import pytest
import torch

from rocnrdma_tpu.runtime.mesh import rank_mesh as ref_rank_mesh
from rocnrdma_tpu.transport import codec as RC
from rocnrdma_tpu.transport.plugin import DeviceMeshNet as RefNet
from rocnrdma_tpu_torch.runtime.mesh import rank_mesh
from rocnrdma_tpu_torch.transport import codec as PC
from rocnrdma_tpu_torch.transport.faults import FaultNet, FaultSchedule
from rocnrdma_tpu_torch.transport.plugin import DeviceMeshNet

# sha256 of the fp8 frame of default_rng(0).standard_normal(65536) * 150
# (fp32), encoded by the reference with ml_dtypes; the port's must match
FP8_ROUNDTRIP_SHA256 = (
    "b798f439b8a8c7cf330b2ad8fb4d5aff11b89e1532ea7834f87231a633c11a96")


def fp8_roundtrip_frame(codec) -> bytes:
    x = (np.random.default_rng(0).standard_normal(65536) * 150).astype(np.float32)
    return bytes(codec.encode(x))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_device_mesh_net_every_pair_equals_reference(devices, n):
    ref, port = RefNet(ref_rank_mesh(n)), DeviceMeshNet(rank_mesh(n, "cpu"))
    ref.init()
    port.init()
    assert dataclasses.astuple(port.get_properties(1)) == \
        dataclasses.astuple(ref.get_properties(1))
    assert port.devices() == ref.devices() == n
    x = np.random.default_rng(n).standard_normal((n, 24)).astype(np.float32)
    rmr, pmr = ref.reg_mr((0, 1), x), port.reg_mr((0, 1), x)
    assert isinstance(pmr, torch.Tensor) and pmr.device == torch.device("cpu")
    for src in range(n):
        for dst in range(n):
            if src == dst:
                continue
            rh, rl = ref.listen(dst)
            ph, pl = port.listen(dst)
            assert (ph, pl) == (rh, rl)
            rs, ps = ref.connect(src, rh), port.connect(src, ph)
            assert ps == rs == (src, dst)
            assert port.accept(pl) == ref.accept(rl) == dst
            rreq = ref.irecv(dst, ref.isend(rs, rmr))
            preq = port.irecv(dst, port.isend(ps, pmr))
            done, nbytes = port.test(preq)
            assert done and nbytes == x.nbytes  # complete at once on the CPU
            want = np.asarray(rreq.wait())
            got = preq.wait()
            assert got.numpy().tobytes() == want.tobytes(), (src, dst)


def test_device_mesh_net_contracts():
    net = DeviceMeshNet(rank_mesh(4, "cpu"))
    net.init()
    with pytest.raises(ValueError, match="leading dim"):
        net.reg_mr((0, 1), np.zeros((3, 4), np.float32))
    with pytest.raises(ValueError, match="outside"):
        net.isend((0, 4), net.reg_mr((0, 1), np.zeros((4, 2), np.float32)))
    with pytest.raises(ValueError, match="1-D rank mesh"):
        from rocnrdma_tpu_torch.runtime.mesh import slice_mesh
        DeviceMeshNet(slice_mesh(2, 2, "cpu"))
    assert not net.get_properties(0).byte_oriented
    assert not net.get_properties(0).one_sided
    t = torch.arange(8.0).reshape(4, 2)
    assert net.reg_mr((0, 1), t) is t  # a tensor on the mesh's device stays


def test_fault_net_wraps_device_mesh_net():
    net = FaultNet(DeviceMeshNet(rank_mesh(4, "cpu")), FaultSchedule(seed=3))
    net.init()
    x = np.arange(16, dtype=np.float32).reshape(4, 4)
    out = net.isend(net.connect(1, net.listen(3)[0]), net.reg_mr((1, 3), x)).wait()
    assert torch.equal(out[3], torch.from_numpy(x[1]))
    assert not out[[0, 1, 2]].any()


def test_device_mesh_net_default_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceMeshNet()


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------


def _frames(dtype):
    rng = np.random.default_rng(7)
    yield "normal", (rng.standard_normal(4099) * 150).astype(dtype)
    yield "tiny", (rng.standard_normal(513) * 1e-30).astype(dtype)
    # |scaled| exactly 448 at scale 1: the top code on both sides
    yield "top", np.array([448.0, -448.0, 1.0, -3.5, 0.0, -0.0], dtype)
    # maxabs just above 448: the scale doubles, nothing passes 448
    yield "just_above", np.array([448.0 * (1 + 2e-7), 447.0, -1.0], dtype)
    # ties between adjacent e4m3 values (round half to even), scale 1
    yield "ties", np.array([448.0, 1.0625, 1.1875, -1.0625, 3.0 + 0.125,
                            13.0, 15.0, 0.0], dtype)
    # subnormals at scale 1 (e4m3 subnormals: k * 2^-9), ties among them
    yield "subnormal", np.array([448.0, 2.0**-10, 3 * 2.0**-10, 1.5 * 2.0**-9,
                                 2.0**-12, 2.0**-6 - 2.0**-10, -(2.0**-10)],
                                dtype)
    yield "zeros", np.zeros(300, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_codec_bytes_equal_reference(name, dtype):
    ref, port = RC.get(name), PC.get(name)
    for label, x in _frames(dtype):
        rf, pf = bytes(ref.encode(x)), bytes(port.encode(x))
        assert pf == rf, label
        frame = np.frombuffer(rf, np.uint8)  # read-only, as off a wire
        for combine in (None, np.add, np.maximum):
            rd = np.linspace(-1, 1, x.size).astype(dtype)
            pd = rd.copy()
            ref.decode_fold(frame, rd.view(np.uint8), dtype, combine)
            port.decode_fold(frame, pd.view(np.uint8), dtype, combine)
            assert pd.tobytes() == rd.tobytes(), (label, combine)
        rc, pc = np.empty_like(x), np.empty_like(x)
        ref.encode(x, commit=rc)
        port.encode(x, commit=pc)
        assert pc.tobytes() == rc.tobytes(), label
        assert port.roundtrip(x).tobytes() == ref.roundtrip(x).tobytes(), label


@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_codec_error_feedback_equals_reference(name):
    ref, port = RC.get(name), PC.get(name)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(20000).astype(np.float32)
    res = rng.standard_normal(20000).astype(np.float32) * 1e-3
    outs = []
    for codec in (ref, port):
        q, r = np.empty_like(x), np.empty_like(x)
        payload = codec.ef_update(x, res, q, r, want_payload=True)
        outs.append((q.tobytes(), r.tobytes(), payload))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fp8_quantize_matches_ml_dtypes_up_to_464_and_saturates_above(dtype):
    port = PC.get("fp8")
    inside = np.array([448.0, np.nextafter(dtype(448), dtype(500)), 455.9, 456.0,
                       463.9, 464.0, -464.0, 1.0625, 1.1875, 2.0**-10,
                       3 * 2.0**-10, 2.0**-12, 0.0, -0.0], dtype)
    want = inside.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    assert port._quantize(inside.copy()).tobytes() == want.tobytes()
    # out of range: ml_dtypes gives NaN (0x7f/0xff), torch saturates to
    # +-448 (0x7e/0xfe) -- the known difference, pinned
    beyond = np.array([465.0, 480.0, 1e6, -470.0], dtype)
    assert list(beyond.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)) == \
        [0x7f, 0x7f, 0x7f, 0xff]
    assert list(port._quantize(beyond.copy())) == [0x7e, 0x7e, 0x7e, 0xfe]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fp8_frames_never_reach_the_range_where_the_two_differ(dtype):
    """The per-frame power-of-two scale keeps every scaled value within
    +-448 (so never past 464), for maxabs at, just below and just above
    every power of two times 448."""
    for e in range(-20, 21):
        for f in (1.0, 1 - 2.0**-20, 1 + 2.0**-20, 0.75, 1.5):
            maxabs = dtype(448.0 * 2.0**e * f)
            scale = PC._pow2_scale(float(maxabs), PC.get("fp8").qmax)
            assert abs(maxabs * dtype(1.0 / scale)) <= 448.0, (e, f)


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_codec_refuses_non_finite_like_the_reference(name, bad):
    x = np.array([1.0, bad, 2.0], np.float32)
    for codec in (RC.get(name), PC.get(name)):
        with pytest.raises(ValueError, match="non-finite"):
            codec.encode(x)


def test_fp8_nan_codes_decode_to_the_references_bytes():
    codes = np.arange(256, dtype=np.uint8)
    for dtype in (np.float32, np.float64):
        want = codes.view(ml_dtypes.float8_e4m3fn).astype(dtype)
        got = PC.get("fp8")._payload_values(codes, dtype)
        assert got.tobytes() == want.tobytes()


def test_fp8_roundtrip_hash_is_pinned():
    """The smoke checks this hash on the card's machine (no ml_dtypes)."""
    ref = fp8_roundtrip_frame(RC.get("fp8"))
    assert hashlib.sha256(ref).hexdigest() == FP8_ROUNDTRIP_SHA256
    assert fp8_roundtrip_frame(PC.get("fp8")) == ref


def test_fp8_resolves_without_ml_dtypes(tmp_path):
    """``get("fp8")`` resolves where ml_dtypes cannot be imported."""
    import os
    import subprocess
    import sys
    (tmp_path / "ml_dtypes.py").write_text("raise ImportError('absent')\n")
    code = ("import hashlib, sys\n"
            "from rocnrdma_tpu_torch.transport import codec\n"
            "sys.path.insert(0, %r)\n"
            "c = codec.get('fp8')\n"
            "import numpy as np\n"
            "x = (np.random.default_rng(0).standard_normal(65536) * 150)"
            ".astype(np.float32)\n"
            "print(hashlib.sha256(bytes(c.encode(x))).hexdigest())\n"
            "print('ml_dtypes' in sys.modules and sys.modules['ml_dtypes'] is not None)\n"
            ) % str(tmp_path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=str(tmp_path) + os.pathsep + repo)
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    digest, loaded = r.stdout.split()
    assert digest == FP8_ROUNDTRIP_SHA256 and loaded == "False"


def test_unknown_codec_refuses_named():
    with pytest.raises(ValueError, match="unknown codec"):
        PC.get("zstd")
