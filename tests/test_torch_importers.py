"""The port's NYU and ICVL importers against the JAX package's, bit for bit.

Mini-datasets at the real camera shapes (NYU 640 x 480 RGB frames that
pack the depth as ``(G << 8) | B`` with ``joint_data.mat``; ICVL 320 x 240
16-bit gray frames with a label file per sequence), written as
``tests/test_realdata_readiness.py`` writes them, with a blank frame, a
label without a file and, for ICVL, a rotated subsequence beside the
originals.  Each field of the imported ``FrameArrays`` equals the JAX
importer's, with and without ``nmax``, ``shuffle``, ``sub_seq`` and
``docom``; both packages name the cache file alike and read each other's
cache in the uint16 and the float32 form; the baseline readers agree.
The fixtures are shared with ``tests/test_torch_host_augment.py`` and
``tests/test_torch_cli_realdata.py``.
"""

import os

import numpy as np
import pytest
import scipy.io
from PIL import Image

from lsps_tpu.data import importers as jimp
from lsps_tpu_torch.data import importers as pimp
from lsps_tpu_torch.data.camera import Camera
from lsps_tpu_torch.data.synthetic import render_hand_depth

FIELDS = ("dpt", "gtorig", "gtcrop", "M", "gt3Dorig", "gt3Dcrop", "com",
          "dpt_vstar")


def write_nyu_png(path, dpt):
    d = np.asarray(dpt).astype(np.int32)
    arr = np.stack([np.zeros_like(d, np.uint8), (d >> 8).astype(np.uint8),
                    (d & 0xFF).astype(np.uint8)], -1)
    Image.fromarray(arr, "RGB").save(path)


def write_nyu(root, n_train=6, n_test=4, seed=7):
    """NYU layout: ``train/`` with ``depth_1_*`` and ``synthdepth_1_*``
    frames, ``test/``, each with ``joint_data.mat`` (one label more than
    there are frames; frame 3 of each split is blank)."""
    cam = Camera.nyu()
    gen = np.random.RandomState(seed)
    for sub, n in (("train", n_train), ("test", n_test)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        uvd = np.zeros((n + 1, 36, 3))
        xyz = np.zeros((n + 1, 36, 3))
        for i in range(n + 1):
            com3d = np.array([gen.uniform(-80, 80), gen.uniform(-60, 60),
                              gen.uniform(650, 900)], np.float32)
            dpt, joints3d = render_hand_depth(cam, com3d, 36, gen)
            if i == 2:
                dpt[:] = 0
            uv = cam.to_img(joints3d)
            uvd[i], xyz[i] = uv, cam.img_to_3d(uv)
            if i == n:
                continue  # a label without a frame
            write_nyu_png(os.path.join(root, sub, f"depth_1_{i + 1:07d}.png"),
                          dpt)
            if sub == "train":
                synth, _ = render_hand_depth(cam, com3d, 36, gen)
                write_nyu_png(os.path.join(
                    root, sub, f"synthdepth_1_{i + 1:07d}.png"), synth)
        scipy.io.savemat(os.path.join(root, sub, "joint_data.mat"),
                         {"joint_xyz": [xyz], "joint_uvd": [uvd]})
    return root


def write_icvl(root, n_train=6, n_test=3, n_rotated=2, seed=8):
    """ICVL layout: ``Depth/`` 16-bit frames and ``train.txt``,
    ``test_seq_1.txt``, ``test_seq_2.txt``.  The originals sit in
    ``sequence0/`` (a name longer than 6 characters, subsequence '0'),
    ``n_rotated`` training frames in ``201/``."""
    cam = Camera.icvl()
    gen = np.random.RandomState(seed)
    for d in ("sequence0", "201"):
        os.makedirs(os.path.join(root, "Depth", d), exist_ok=True)
    for name, n in (("train", n_train), ("test_seq_1", n_test),
                    ("test_seq_2", n_test)):
        lines = []
        for i in range(n + (n_rotated if name == "train" else 0)):
            com3d = np.array([gen.uniform(-60, 60), gen.uniform(-40, 40),
                              gen.uniform(350, 500)], np.float32)
            dpt, joints3d = render_hand_depth(cam, com3d, 16, gen)
            sub = "sequence0" if i < n else "201"
            fname = f"{sub}/{name}_{i}.png"
            Image.fromarray(dpt.astype(np.uint16)).save(
                os.path.join(root, "Depth", fname))
            uv = cam.to_img(joints3d)
            lines.append(fname + " " + " ".join(f"{v:.3f}"
                                                for v in uv.reshape(-1)))
        with open(os.path.join(root, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def nyu_root(tmp_path_factory):
    return write_nyu(str(tmp_path_factory.mktemp("nyu")))


@pytest.fixture(scope="module")
def icvl_root(tmp_path_factory):
    return write_icvl(str(tmp_path_factory.mktemp("icvl")))


def assert_arrays_equal(got, want, what=""):
    for k in FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        if b is None:
            assert a is None, (what, k)
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")
    assert got.name == want.name and got.config == want.config, what
    assert got.file_names == want.file_names, what


def _nyu(pkg, root, cache_dir=None, **kw):
    mod = pimp if pkg == "port" else jimp
    return mod.NYUImporter(root, use_cache=cache_dir is not None,
                           cache_dir=cache_dir or "unused", **kw)


def _icvl(pkg, root, cache_dir=None):
    mod = pimp if pkg == "port" else jimp
    return mod.ICVLImporter(root, use_cache=cache_dir is not None,
                            cache_dir=cache_dir or "unused")


NYU_OPTIONS = {"plain": {}, "nmax": {"nmax": 3},
               "shuffle": {"shuffle": True}, "docom": {"docom": True},
               "cube": {"cube": (250, 250, 250)}}


@pytest.mark.parametrize("option", sorted(NYU_OPTIONS))
@pytest.mark.parametrize("seq,all_joints",
                         [("train", True), ("train_synth", True),
                          ("test", False)])
def test_nyu_sequence_matches_jax(nyu_root, seq, all_joints, option):
    kw = NYU_OPTIONS[option]
    got = _nyu("port", nyu_root, all_joints=all_joints).load_sequence(
        seq, rng=np.random.RandomState(3), **kw)
    want = _nyu("jax", nyu_root, all_joints=all_joints).load_sequence(
        seq, rng=np.random.RandomState(3), **kw)
    assert_arrays_equal(got, want, f"{seq} {option}")
    # frame 3 of depth_1_* is blank: the crop step drops it
    frames = {"train": 5, "train_synth": 6, "test": 3}[seq]
    assert len(got) == (3 if option == "nmax" else frames)


ICVL_OPTIONS = {"plain": {}, "sub0": {"sub_seq": ["0"]},
                "sub201": {"sub_seq": ["201"]}, "nmax": {"nmax": 4},
                "shuffle": {"shuffle": True, "sub_seq": ["0"]},
                "docom": {"docom": True}}


@pytest.mark.parametrize("seq,option", [
    (seq, option) for seq in ("train", "test_seq_1")
    for option in sorted(ICVL_OPTIONS)
    if seq == "train" or option != "sub201"])
def test_icvl_sequence_matches_jax(icvl_root, seq, option):
    kw = ICVL_OPTIONS[option]
    got = _icvl("port", icvl_root).load_sequence(
        seq, rng=np.random.RandomState(4), **kw)
    want = _icvl("jax", icvl_root).load_sequence(
        seq, rng=np.random.RandomState(4), **kw)
    assert_arrays_equal(got, want, f"{seq} {option}")


def test_icvl_sub_seq_must_be_a_list(icvl_root):
    with pytest.raises(TypeError, match="sub_seq"):
        _icvl("port", icvl_root).load_sequence("train", sub_seq="0")


@pytest.mark.parametrize("kind", ["NYU", "ICVL"])
def test_cache_paths_match_jax(nyu_root, icvl_root, kind, tmp_path):
    for docom, sub, cube in ((False, None, (300, 300, 300)),
                             (True, ["0"], (250, 250, 250))):
        if kind == "NYU":
            p = _nyu("port", nyu_root, str(tmp_path), all_joints=True,
                     com_idx=34)
            j = _nyu("jax", nyu_root, str(tmp_path), all_joints=True,
                     com_idx=34)
            sub = None
        else:
            p, j = (_icvl(k, icvl_root, str(tmp_path))
                    for k in ("port", "jax"))
        got = p._cache_path("train", sub, docom, cube)
        assert got == j._cache_path("train", sub, docom, cube)
        assert os.path.basename(got).startswith(f"{kind}Importer_train")


@pytest.mark.parametrize("form", ["u16", "f32"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_caches_cross_load(nyu_root, icvl_root, writer, form, tmp_path,
                           monkeypatch):
    """A cache written by one package is what the other reads, under the
    same file name, in the uint16 and the float32 form (LSPS_CACHE_F32 at
    save); the reader takes it and does not decode a frame."""
    reader = "jax" if writer == "port" else "port"
    if form == "f32":
        monkeypatch.setenv("LSPS_CACHE_F32", "1")
    else:
        monkeypatch.delenv("LSPS_CACHE_F32", raising=False)
    cache = str(tmp_path / "cache")
    fresh_n = _nyu(writer, nyu_root, cache, all_joints=True).load_sequence(
        "train")
    fresh_i = _icvl(writer, icvl_root, cache).load_sequence(
        "train", sub_seq=["0"])
    names = sorted(os.listdir(cache))
    assert len(names) == 2
    z = np.load(os.path.join(cache, names[0]), allow_pickle=True)
    assert ("dpt_u16" in z) == (form == "u16")
    monkeypatch.delenv("LSPS_CACHE_F32", raising=False)

    r_nyu = _nyu(reader, nyu_root, cache, all_joints=True)
    r_icvl = _icvl(reader, icvl_root, cache)
    for imp in (r_nyu, r_icvl):
        monkeypatch.setattr(imp, "load_depth_map", _no_decode)
    got_n = r_nyu.load_sequence("train", rng=np.random.RandomState(5),
                                shuffle=True)
    got_i = r_icvl.load_sequence("train", sub_seq=["0"], nmax=3)
    assert sorted(os.listdir(cache)) == names
    want_n = fresh_n.shuffled(np.random.RandomState(5))
    want_i = fresh_i.take(np.arange(3))
    if form == "u16":
        assert got_n.dpt.dtype == np.uint16
    for got, want, what in ((got_n, want_n, "NYU"), (got_i, want_i,
                                                      "ICVL")):
        np.testing.assert_array_equal(got.dpt_mm(), want.dpt_mm(), what)
        for k in FIELDS[1:-1]:
            np.testing.assert_array_equal(getattr(got, k),
                                          getattr(want, k), f"{what} {k}")
            assert getattr(got, k).dtype == getattr(want, k).dtype
        assert got.file_names == want.file_names


def _no_decode(filename):
    raise AssertionError(f"decoded {filename} although the cache holds it")


def test_port_reads_u16_cache_as_f32_under_lsps_cache_f32(nyu_root, tmp_path,
                                                          monkeypatch):
    monkeypatch.delenv("LSPS_CACHE_F32", raising=False)
    cache = str(tmp_path)
    _nyu("jax", nyu_root, cache, all_joints=True).load_sequence("test")
    monkeypatch.setenv("LSPS_CACHE_F32", "1")
    got = _nyu("port", nyu_root, cache, all_joints=True).load_sequence(
        "test")
    want = _nyu("jax", nyu_root, cache, all_joints=True).load_sequence(
        "test")
    assert got.dpt.dtype == np.float32 and got.dpt_vstar is None
    assert_arrays_equal(got, want, "LSPS_CACHE_F32")


def test_nyu_baselines_match_jax(nyu_root, tmp_path):
    rs = np.random.RandomState(6)
    txt = tmp_path / "baseline.txt"
    rows = rs.uniform(50, 600, (3, 14 * 3))
    txt.write_text("\n".join(" ".join(f"{v:.4f}" for v in r) for r in rows)
                   + "\n\n")
    p = _nyu("port", nyu_root)
    j = _nyu("jax", nyu_root)
    for a, b in zip(p.load_baseline(str(txt)), j.load_baseline(str(txt))):
        np.testing.assert_array_equal(a, b)
    # the .mat form reads depth from the frames beside it
    test_dir = os.path.join(nyu_root, "test")
    mat = os.path.join(test_dir, "pred.mat")
    pred = np.zeros((1, 4, 20, 3))
    pred[0, :, :, 0] = rs.uniform(100, 500, (4, 20))
    pred[0, :, :, 1] = rs.uniform(100, 400, (4, 20))
    pred[0, :, :, 2] = 1.0
    pred[0, :, 5] = 0.0  # a joint the baseline did not predict
    scipy.io.savemat(mat, {"pred_joint_uvconf": pred,
                           "conv_joint_names": np.zeros((1, 19))})
    gt = rs.uniform(500, 900, (4, 19, 3)).astype(np.float32)
    got, want = p.load_baseline(mat, gt=gt), j.load_baseline(mat, gt=gt)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    os.remove(mat)


@pytest.mark.parametrize("first_name", [False, True])
def test_icvl_baselines_match_jax(icvl_root, tmp_path, first_name):
    rs = np.random.RandomState(7)
    txt = tmp_path / "icvl_baseline.txt"
    rows = rs.uniform(50, 300, (3, 16 * 3))
    lead = "frame.png " if first_name else ""
    txt.write_text("\n".join(lead + " ".join(f"{v:.4f}" for v in r)
                             for r in rows) + "\n")
    p, j = _icvl("port", icvl_root), _icvl("jax", icvl_root)
    for fn in ("load_baseline", "load_baseline_2d"):
        got = getattr(p, fn)(str(txt), first_name=first_name)
        want = getattr(j, fn)(str(txt), first_name=first_name)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_depth_maps_of_the_wrong_kind_raise(nyu_root, icvl_root):
    nyu_frame = os.path.join(nyu_root, "test", "depth_1_0000001.png")
    icvl_frame = os.path.join(icvl_root, "Depth", "sequence0",
                              "train_0.png")
    with pytest.raises(ValueError, match="gray"):
        _icvl("port", icvl_root).load_depth_map(nyu_frame)
    with pytest.raises(ValueError, match="RGB"):
        _nyu("port", nyu_root).load_depth_map(icvl_frame)
    np.testing.assert_array_equal(
        _nyu("port", nyu_root).load_depth_map(nyu_frame),
        _nyu("jax", nyu_root).load_depth_map(nyu_frame))
    np.testing.assert_array_equal(
        _icvl("port", icvl_root).load_depth_map(icvl_frame),
        _icvl("jax", icvl_root).load_depth_map(icvl_frame))


def test_importers_are_registered():
    from lsps_tpu_torch.registry import lookup

    assert lookup("importer", "NYUImporter") is pimp.NYUImporter
    assert lookup("importer", "ICVLImporter") is pimp.ICVLImporter
