"""The port's wire codec, TUM files, PNG codec, sensor.yaml reader and
EuRoC reader/writer against `cvids_tpu.io` (and PIL / PyYAML) on the CPU.

The wire format is the contract between the packages: a packet encoded by
either codec decodes in the other to the same arrays. The port reads and
writes its own PNGs and reads its own `sensor.yaml` (the card's machine has
neither PIL nor PyYAML), held here against PIL and `yaml.safe_load`. Both
packages' `write_euroc_sequence` write one tiny rendered sequence (160x120,
0.5 s at 20 Hz, test_full_topology.py's room and nuisances): the CSVs and
YAML files are byte-equal; the PNGs are >= PNG_AGREE equal pixel for pixel
and no pixel more than 1 level apart (the body rotation is built in numpy
float32 in the port, through XLA in the JAX package, and a few pixels sit on
a rounding edge of the 8-bit quantization).
"""

import io
import os
import struct
import zlib

import numpy as np
import pytest
import yaml
from PIL import Image

from cvids_tpu.io import codec as jcodec
from cvids_tpu.io import euroc as jeuroc
from cvids_tpu.io import euroc_synth as jsynth
from cvids_tpu.io import msgs as jmsgs
from cvids_tpu.io import synthetic as jsyn
from cvids_tpu.io import tum as jtum
from cvids_tpu.utils import config as jconfig
from cvids_tpu_torch import interop
from cvids_tpu_torch.io import codec, euroc, euroc_synth, png, sensor_yaml, synthetic, tum
from cvids_tpu_torch.io.msgs import KeyframePacket
from cvids_tpu_torch.utils import config as tconfig

PNG_AGREE = 0.999       # share of equal pixels between the packages' PNGs [measured 0.99999]
SCENE = dict(floor_z=0.0, wall_y=3.0, box_lo=np.array([1.9, 0.6, 0.0]),
             box_hi=np.array([2.9, 1.6, 0.9]))
PHOTOMETRIC = dict(flicker=0.15, vignette=0.3, noise_std=1.5, shot_noise=0.3, exposure_time=0.008)

# a sensor.yaml in EuRoC's own layout (MH_01's cam0): header comment, the
# multi-line T_BS list, comments after values
EUROC_CAM_YAML = """# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""
EUROC_IMU_YAML = """#Default imu sensor yaml file
sensor_type: imu
comment: VI-Sensor IMU (ADIS16448)
T_BS:
  cols: 4
  rows: 4
  data: [1.0, 0.0, 0.0, 0.0,
         0.0, 1.0, 0.0, 0.0,
         0.0, 0.0, 1.0, 0.0,
         0.0, 0.0, 0.0, 1.0]
rate_hz: 200

# inertial sensor noise model parameters (static)
gyroscope_noise_density: 1.6968e-04     # [ rad / s / sqrt(Hz) ]   ( gyro "white noise" )
gyroscope_random_walk: 1.9393e-05       # [ rad / s^2 / sqrt(Hz) ] ( gyro bias diffusion )
accelerometer_noise_density: 2.0000e-3  # [ m / s^2 / sqrt(Hz) ]   ( accel "white noise" )
accelerometer_random_walk: 3.0000e-3    # [ m / s^3 / sqrt(Hz) ].  ( accel bias diffusion )
"""


def _packet(cls, rng, image=True):
    """test_extras.py's codec packet, as either package's class."""
    return cls(
        client_id=2, timestamp=12.5,
        p_wb=rng.normal(size=3).astype(np.float32),
        q_wb=np.array([1, 0, 0, 0], np.float32),
        r_cb=np.eye(3, dtype=np.float32), p_bc=np.zeros(3, np.float32),
        win_pts3d=rng.normal(size=(5, 3)).astype(np.float32),
        win_uv=rng.normal(size=(5, 2)).astype(np.float32),
        win_ids=np.arange(5, dtype=np.int64),
        win_desc=rng.integers(0, 2 ** 32, (5, 8), dtype=np.uint32),
        win_valid=np.ones(5, bool),
        ext_uv=rng.normal(size=(7, 2)).astype(np.float32),
        ext_desc=rng.integers(0, 2 ** 32, (7, 8), dtype=np.uint32),
        ext_valid=np.ones(7, bool),
        image=rng.uniform(0, 255, (10, 12)).astype(np.float32) if image else None)


def assert_same_packet(a, b):
    for f in ("client_id", "timestamp"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("p_wb", "q_wb", "r_cb", "p_bc", "win_pts3d", "win_uv", "win_ids", "win_desc",
              "win_valid", "ext_uv", "ext_desc", "ext_valid", "image"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_descriptor_wire_roundtrip(rng):
    d = rng.integers(0, 2 ** 32, (17, 8), dtype=np.uint32)
    wire = codec.desc_to_int64(d)
    assert wire.shape == (17, 4) and wire.dtype == np.int64
    np.testing.assert_array_equal(wire, jcodec.desc_to_int64(d))
    np.testing.assert_array_equal(codec.desc_from_int64(wire), d)


@pytest.mark.parametrize("image", [True, False], ids=["image", "no_image"])
@pytest.mark.parametrize("direction", ["port", "jax_to_port", "port_to_jax"])
def test_packet_codec_crosses_packages(rng, direction, image):
    """test_extras.py's codec round trip in the port, and a packet encoded
    by either package decoded by the other: the same arrays, bit for bit."""
    enc, dec, cls, out_cls = {
        "port": (codec.encode_packet, codec.decode_packet, KeyframePacket, KeyframePacket),
        "jax_to_port": (jcodec.encode_packet, codec.decode_packet, jmsgs.KeyframePacket,
                        KeyframePacket),
        "port_to_jax": (codec.encode_packet, jcodec.decode_packet, KeyframePacket,
                        jmsgs.KeyframePacket)}[direction]
    pkt = _packet(cls, rng, image)
    d = enc(pkt)
    ref = (jcodec if direction == "port_to_jax" else codec).encode_packet(pkt)
    assert sorted(d) == sorted(ref)
    back = dec(d)
    assert isinstance(back, out_cls)
    assert_same_packet(back, pkt)


def test_tum_roundtrip_and_files_equal(tmp_path, rng):
    """test_utils.py's TUM round trip on the port; the port writes the JAX
    package's bytes and each reads the other's file."""
    rows = np.concatenate([
        rng.uniform(0, 100, (5, 4)),
        rng.normal(size=(5, 4)) / np.linalg.norm(rng.normal(size=(5, 4)), axis=1, keepdims=True),
    ], axis=1)
    pt, pj = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    tum.write_tum(pt, rows)
    jtum.write_tum(pj, rows)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    np.testing.assert_allclose(tum.read_tum(pt), rows, atol=1e-8)
    np.testing.assert_array_equal(tum.read_tum(pj), jtum.read_tum(pt))


# ---------- PNG ----------


def _png_with_filters(img: np.ndarray, filters) -> bytes:
    """An 8-bit PNG of `img` ((H, W) gray or (H, W, C)) whose row y uses
    filter `filters[y % len(filters)]` (the PNG specification's filters)."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, w * c).astype(np.int64)
    out, prior = bytearray(), np.zeros(w * c, np.int64)
    for y in range(h):
        kind, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - prior
        elif kind == 3:
            f = cur - (left + prior) // 2
        else:
            p = left + prior - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - up_left)
            f = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, up_left))
        out += bytes([kind]) + (f % 256).astype(np.uint8).tobytes()
        prior = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
    color = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


def _textured(rng, h=37, w=53):
    y, x = np.mgrid[0:h, 0:w]
    smooth = 128 + 100 * np.sin(x / 5.0) * np.cos(y / 7.0)
    return np.clip(smooth + rng.normal(0, 20, (h, w)), 0, 255).astype(np.uint8)


def test_png_write_read_against_pil(tmp_path, rng):
    """The port writes what PIL reads, and reads PIL's gray PNGs (PIL's
    own adaptive row filters) and RGB/RGBA ones, pixel for pixel."""
    img = _textured(rng)
    p = str(tmp_path / "port.png")
    png.write_png(p, img)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    np.testing.assert_array_equal(png.read_png(p), img)
    for name, arr, mode in (("gray", img, "L"), ("flat", np.full((9, 11), 77, np.uint8), "L"),
                            ("rgb", np.stack([img, img[::-1], 255 - img], -1), "RGB"),
                            ("rgba", np.stack([img, img[::-1], 255 - img, img], -1), "RGBA")):
        q = str(tmp_path / f"pil_{name}.png")
        Image.fromarray(arr, mode).save(q)
        np.testing.assert_array_equal(png.read_png(q), np.asarray(Image.open(q)), err_msg=name)
    # EurocSequence.load_image averages a color file's channels, as the JAX
    # package's reader does
    seq = euroc.EurocSequence(*([None] * 3), None, [str(tmp_path / "pil_rgb.png")], None, None,
                              None)
    jseq = jeuroc.EurocSequence(*([None] * 3), None, [str(tmp_path / "pil_rgb.png")], None,
                                None, None)
    np.testing.assert_array_equal(seq.load_image(0), jseq.load_image(0))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_reads_every_row_filter(tmp_path, rng, channels):
    """Rows written with each of the five filters (None, Sub, Up, Average,
    Paeth) in turn decode to what PIL decodes."""
    img = _textured(rng)
    if channels > 1:
        img = np.stack([np.roll(img, k, axis=1) for k in range(channels)], -1)
    p = tmp_path / "filters.png"
    p.write_bytes(_png_with_filters(img, (0, 1, 2, 3, 4, 4, 3, 2, 1)))
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    np.testing.assert_array_equal(png.read_png(str(p)), img)


def test_png_rejects_what_it_does_not_read(tmp_path):
    img = np.arange(48, dtype=np.uint8).reshape(6, 8)
    for name, im in (("palette.png", Image.fromarray(img).convert("P")),
                     ("deep.png", Image.fromarray(img.astype(np.uint16) * 257))):
        p = str(tmp_path / name)
        im.save(p)
        with pytest.raises(ValueError, match=name):
            png.read_png(p)
    with pytest.raises(ValueError, match="uint8"):
        png.write_png(str(tmp_path / "f.png"), img.astype(np.float32))


# ---------- sensor.yaml and the EuRoC writers and readers ----------


def _jax_cfg(mod, **kw):
    cam = mod.CameraConfig(fx=115.25, fy=114.9, cx=80.5, cy=60.25, k1=-0.28, k2=0.07, p1=0.0001,
                           p2=-0.0002, width=160, height=120)
    return mod.AgentConfig(camera=cam, fast_threshold=12.0, min_feature_dist=16, equalize=True,
                           keyframe_freq=2.5, **kw)


def _write_tiny(root, pkg):
    synth, syn, cfg_mod = ((euroc_synth, synthetic, tconfig) if pkg == "port"
                           else (jsynth, jsyn, jconfig))
    traj = syn.Trajectory.circle(radius=1.5, omega=0.5, height_amp=0.15, center=(0.0, 0.0, 1.3),
                                 speed_mod=0.3, speed_mod_freq=0.9)
    return synth.write_euroc_sequence(
        str(root), cfg=_jax_cfg(cfg_mod), trajectory=traj, duration=0.5, cam_rate=20.0,
        imu_rate=200.0, num_landmarks=200, seed=21, world_seed=7, scene=SCENE,
        gyr_noise=2e-4, acc_noise=0.005, photometric=PHOTOMETRIC)


@pytest.fixture(scope="module")
def tiny_roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("euroc")
    return {pkg: _write_tiny(base / pkg, pkg) for pkg in ("port", "jax")}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_write_euroc_sequence_matches_jax(tiny_roots):
    port, jax_root = tiny_roots["port"], tiny_roots["jax"]
    files = _files(port)
    assert files == _files(jax_root)
    pngs = [f for f in files if f.endswith(".png")]
    assert len(pngs) == 11
    for f in files:
        if not f.endswith(".png"):
            a = open(os.path.join(port, f), "rb").read()
            assert a == open(os.path.join(jax_root, f), "rb").read(), f
    a = np.stack([png.read_png(os.path.join(port, f)) for f in pngs]).astype(np.int16)
    b = np.stack([np.asarray(Image.open(os.path.join(jax_root, f))) for f in pngs]).astype(np.int16)
    assert a.shape == b.shape == (11, 120, 160)
    assert np.abs(a - b).max() <= 1
    assert (a == b).mean() >= PNG_AGREE


@pytest.mark.parametrize("which", ["port_cam", "port_imu", "jax_cam", "jax_imu", "euroc_cam",
                                   "euroc_imu"])
def test_sensor_yaml_matches_pyyaml(tiny_roots, which):
    """The port's reader gives `yaml.safe_load`'s mapping on both packages'
    written files and on EuRoC's own layout, with the header and tag
    stripped as `cvids_tpu/io/euroc.py` strips them."""
    src, sensor = which.split("_")
    if src == "euroc":
        text = EUROC_CAM_YAML if sensor == "cam" else EUROC_IMU_YAML
    else:
        path = os.path.join(tiny_roots[src], "mav0", f"{sensor}0", "sensor.yaml")
        text = open(path).read()
    want = yaml.safe_load(text.replace("%YAML:1.0", "").replace("!!opencv-matrix", ""))
    assert sensor_yaml.loads(text) == want
    opencv = text.replace("T_BS:", "T_BS: !!opencv-matrix")
    assert sensor_yaml.loads("%YAML:1.0\n" + opencv if src == "euroc" else opencv) == want


def test_sensor_yaml_scalars_and_errors():
    text = ("a: 5e-05\nb: 5.0e-05\nc: 0.0001\nd: yes\ne: ~\nf: 'quoted # not a comment'\n"
            "g: 010\nh: .inf\ni: -3\nj: [1, 2.5, x]\nk:\n  l: 1\nm: \n")
    assert sensor_yaml.loads(text) == yaml.safe_load(text)
    for bad in ("a:\n  - 1\n", "a: &x 1\n", "a: [1, 2\n"):
        with pytest.raises(ValueError):
            sensor_yaml.loads(bad)


def test_load_agent_config_matches_jax(tiny_roots):
    """Each package's loader on each package's files: the same config."""
    for root in tiny_roots.values():
        got = euroc.load_agent_config(root)
        want = jeuroc.load_agent_config(root)
        assert interop.agent_config_to_dict(got) == interop.agent_config_to_dict(
            interop.agent_config_to_torch(want))
    assert euroc.load_agent_config(str(tiny_roots["port"]) + "_missing") is None


def test_load_agent_config_floats_the_distortion(tmp_path):
    """The departure: YAML 1.1 reads an exponent without a dot (Python
    prints 5e-05 so) as a string, which the JAX loader passes on into the
    camera config; the port's loader makes it the float."""
    root = str(tmp_path / "rig")
    cfg = tconfig.AgentConfig(camera=tconfig.CameraConfig(p1=5e-05))
    euroc_synth.write_sequence_files(
        root, cfg, [np.zeros((480, 752), np.uint8)], np.zeros(1), np.zeros(2),
        np.zeros((2, 3)), np.zeros((2, 3)),
        dict(p=np.zeros((1, 3)), q=np.array([[1.0, 0, 0, 0]]), v=np.zeros((1, 3)),
             bg=np.zeros(3), ba=np.zeros(3)), 20.0, 200.0, 2e-4, 0.005)
    assert jeuroc.load_agent_config(root).camera.p1 == "5e-05"
    got = euroc.load_agent_config(root)
    assert got.camera.p1 == 5e-05 and got.camera == cfg.camera


def test_euroc_write_load_roundtrip(tmp_path):
    """test_euroc.py's case on the port's writer and reader."""
    small = tconfig.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=120.0, k1=0.0, k2=0.0, p1=0.0,
                                 p2=0.0, width=320, height=240)
    root = str(tmp_path / "seq0")
    cfg = tconfig.AgentConfig(camera=small)
    euroc_synth.write_euroc_sequence(root, cfg=cfg, duration=2.0, cam_rate=2.0, imu_rate=100.0,
                                     num_landmarks=60, seed=3)
    assert euroc.available(root)
    seq = euroc.load_euroc(root)
    assert len(seq.cam_t) == 5
    assert np.allclose(np.diff(seq.cam_t), 0.5, atol=1e-6)
    assert np.allclose(np.diff(seq.imu_t), 0.01, atol=1e-6)
    assert abs(np.linalg.norm(seq.acc, axis=1).mean() - 9.81) < 1.0
    img = seq.load_image(2)
    assert img.shape == (240, 320) and img.max() > 50
    traj = synthetic.Trajectory.circle(radius=4.0, omega=0.35, height_amp=0.2)
    p_ref, _, _ = traj.pose(seq.gt_t)
    assert np.abs(seq.gt_p - p_ref).max() < 1e-6
    assert np.allclose(np.linalg.norm(seq.gt_q, axis=1), 1.0, atol=1e-6)
    loaded = euroc.load_agent_config(root)
    assert loaded is not None
    assert loaded.camera.fx == 200.0 and loaded.camera.width == 320
    assert np.allclose(np.asarray(loaded.r_cb), np.asarray(cfg.r_cb))
    assert abs(loaded.imu.gyr_n - 5e-4) < 1e-12
    # the JAX package reads the port's sequence to the same arrays
    jseq = jeuroc.load_euroc(root)
    for f in ("imu_t", "gyr", "acc", "cam_t", "gt_t", "gt_p", "gt_q"):
        np.testing.assert_array_equal(getattr(seq, f), getattr(jseq, f), err_msg=f)
    assert seq.cam_files == jseq.cam_files
    np.testing.assert_array_equal(img, jseq.load_image(2))


def test_io_modules_load_no_optional_library():
    """The port's readers, writers, transport, viewers and apps import
    neither JAX nor the JAX package, PIL, imageio, PyYAML or matplotlib."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import cvids_tpu_torch.io.transport, cvids_tpu_torch.io.euroc, "
            "cvids_tpu_torch.io.euroc_synth, cvids_tpu_torch.utils.viewer, "
            "cvids_tpu_torch.utils.visualization, cvids_tpu_torch.apps.run_euroc, "
            "cvids_tpu_torch.apps.run_synthetic, cvids_tpu_torch.apps.agent_process, "
            "cvids_tpu_torch.entry, cvids_tpu_torch.native\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'cvids_tpu', 'PIL', 'imageio', 'yaml', 'matplotlib')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_codec_dict_survives_npz(rng, tmp_path):
    """The transport's payload is `np.savez` of the codec dict: the dict
    comes back bit for bit."""
    d = codec.encode_packet(_packet(KeyframePacket, rng))
    buf = io.BytesIO()
    np.savez(buf, **d)
    back = dict(np.load(io.BytesIO(buf.getvalue()), allow_pickle=False))
    assert sorted(back) == sorted(d)
    assert_same_packet(codec.decode_packet(back), codec.decode_packet(d))
