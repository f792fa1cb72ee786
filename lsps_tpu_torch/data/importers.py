"""Dataset importers: the base, NYU, ICVL, MSRA15 and POST (host numpy).

The port's copy of ``lsps_tpu/data/importers.py``: the camera passthroughs,
the per-frame crop step, the ``.npz`` sequence cache with its uint16 crops,
and the NYU and ICVL importers that the configs ``exps/nnyu.yaml`` and
``exps/nicvl.yaml`` select.  Sequences load into :class:`FrameArrays`; every
field, and the cache's file name and keys, are the JAX package's bit for
bit, so a cache written by either package loads in the other.

Depth maps are PNGs, read with :func:`lsps_tpu_torch.data.png.read_png`
where the JAX package uses PIL: NYU packs 16-bit depth into the green and
blue bytes of RGB frames, ICVL stores 16-bit gray frames.  Labels come from
``joint_data.mat`` (``scipy.io.loadmat``) and from per-sequence text files.
MSRA15 frames are ``.bin`` patches behind a bounding-box header.  POST
pairs 16-bit depth PNGs with part-label PNGs (synthetic frames) or with
colour label images, read as cv2 reads them and segmented by hue
(:mod:`lsps_tpu_torch.data.color`; real frames).
"""

from __future__ import annotations

import glob
import os
import struct
from typing import List

import numpy as np

from lsps_tpu_torch.data.basetypes import (DepthFrame, FrameArrays,
                                           NamedImgSequence, decode_dpt_u16,
                                           encode_dpt_u16)
from lsps_tpu_torch.data.camera import Camera
from lsps_tpu_torch.data.color import bgr_to_hsv, imread_color, in_range
from lsps_tpu_torch.data.detector import HandDetector
from lsps_tpu_torch.data.png import read_png
from lsps_tpu_torch.data.transformations import transform_points_2d
from lsps_tpu_torch.registry import register


class DepthImporter:
    """Base: camera projection + sequence loading skeleton
    (reference importers.py:50-188)."""

    num_joints = 0
    crop_joint_idx = 0

    def __init__(self, camera: Camera, basepath: str = "", use_cache=True,
                 cache_dir="./cache/", hand=None, refine_net=None):
        self.camera = camera
        self.basepath = basepath
        self.use_cache = use_cache
        self.cache_dir = cache_dir
        self.hand = hand
        self.refine_net = refine_net  # CoM refinement hook (docom)
        self.default_cubes = {}
        self.sides = {}

    # camera passthroughs (reference importers.py:73-150)
    @property
    def fx(self):
        return self.camera.fx

    @property
    def fy(self):
        return self.camera.fy

    @property
    def ux(self):
        return self.camera.ux

    @property
    def uy(self):
        return self.camera.uy

    @property
    def depth_map_size(self):
        return self.camera.depth_map_size

    def joint_img_to_3d(self, uvd):
        return self.camera.img_to_3d(np.asarray(uvd, np.float32))

    def joint_3d_to_img(self, xyz):
        return self.camera.to_img(np.asarray(xyz, np.float32))

    # reference-name aliases
    jointImgTo3D = joint_img_to_3d
    jointsImgTo3D = joint_img_to_3d
    joint3DToImg = joint_3d_to_img
    joints3DToImg = joint_3d_to_img

    def get_camera_intrinsics(self):
        return self.camera.intrinsics()

    def get_camera_projection(self):
        return self.camera.projection()

    def depth_to_pcl(self, dpt, T, background_val=0.0):
        return self.camera.depth_to_pcl(dpt, T, background_val)

    # ------------------------------------------------------------------
    def _cache_path(self, seq_name, sub_seq, docom, cube) -> str:
        """The JAX package's cache file name for this sequence."""
        mode = HandDetector.detection_mode_to_string(
            docom, self.refine_net is not None)
        sub = "" if sub_seq is None else "_" + "".join(sub_seq)
        extra = self._cache_extra()
        return os.path.join(
            self.cache_dir,
            f"{type(self).__name__}_{seq_name}{sub}_{self.hand}_{extra}"
            f"{mode}_{int(cube[0])}.npz")

    def _cache_extra(self) -> str:
        return ""

    def _load_cached(self, path, shuffle, rng, nmax):
        if not (self.use_cache and os.path.isfile(path)):
            return None
        z = np.load(path, allow_pickle=True)
        if "dpt_u16" in z:
            # the half-size raw-mm form: the codes stay resident (the batch
            # paths decode per batch), unless LSPS_CACHE_F32 asks for mm
            dpt, vstar = z["dpt_u16"], z["dpt_vstar"]
            if os.environ.get("LSPS_CACHE_F32"):
                dpt, vstar = decode_dpt_u16(dpt, vstar), None
        else:
            dpt, vstar = z["dpt"], None
        arrays = FrameArrays(
            name=str(z["name"]), dpt=dpt, gtorig=z["gtorig"],
            gtcrop=z["gtcrop"], M=z["M"], gt3Dorig=z["gt3Dorig"],
            gt3Dcrop=z["gt3Dcrop"], com=z["com"],
            config={"cube": tuple(z["cube"])},
            file_names=list(z["file_names"]) if "file_names" in z else None,
            dpt_vstar=vstar)
        if shuffle and rng is not None:
            arrays = arrays.shuffled(rng)
        if np.isfinite(nmax):
            arrays = arrays.take(np.arange(min(int(nmax), len(arrays))))
        return arrays

    def _save_cache(self, path, arrays: FrameArrays):
        if not self.use_cache:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        common = dict(
            name=arrays.name, gtorig=arrays.gtorig,
            gtcrop=arrays.gtcrop, M=arrays.M, gt3Dorig=arrays.gt3Dorig,
            gt3Dcrop=arrays.gt3Dcrop, com=arrays.com,
            cube=np.asarray(arrays.config["cube"], np.float32),
            file_names=np.asarray(arrays.file_names or [], dtype=object))
        if arrays.dpt.dtype == np.uint16:
            enc = (arrays.dpt, arrays.dpt_vstar)
        else:
            # uint16 codes where lossless (half the bytes; encode_dpt_u16
            # checks the round trip), float32 under LSPS_CACHE_F32
            enc = (None if os.environ.get("LSPS_CACHE_F32")
                   else encode_dpt_u16(arrays.dpt))
        # written aside and renamed into place: the ranks of a
        # data-parallel run import the same sequence at once
        tmp = f"{path}.{os.getpid()}.partial.npz"
        if enc is not None:
            np.savez_compressed(tmp, dpt_u16=enc[0], dpt_vstar=enc[1],
                                **common)
        else:
            np.savez_compressed(tmp, dpt=arrays.dpt, **common)
        os.replace(tmp, path)

    def _crop_frame(self, dpt, gtorig, gt3Dorig, cube, docom, fname):
        """Shared per-frame crop step (reference importers.py:391-411)."""
        hd = HandDetector(dpt, self.fx, self.fy, importer=self,
                          refine_net=self.refine_net)
        if not hd.check_image(1):
            return None
        try:
            dpt_c, M, com = hd.crop_area_3d(
                com=gtorig[self.crop_joint_idx], size=cube, docom=docom)
        except UserWarning:
            return None
        com3d = self.joint_img_to_3d(com)
        gt3Dcrop = gt3Dorig - com3d
        gtcrop = transform_points_2d(gtorig, M)
        return DepthFrame(dpt_c.astype(np.float32), gtorig, gtcrop,
                          M.astype(np.float32), gt3Dorig, gt3Dcrop,
                          com3d, fname, "", "right", {})

    def load_sequence(self, seq_name, **kw) -> FrameArrays:
        raise NotImplementedError

    # reference-compatible wrapper returning NamedImgSequence of DepthFrames
    def loadSequence(self, seq_name, *a, **kw) -> NamedImgSequence:
        arrays = self.load_sequence(seq_name, **kw)
        frames = [arrays.frame(i) for i in range(len(arrays))]
        return NamedImgSequence(arrays.name, frames, arrays.config)


# ---------------------------------------------------------------------------
@register("importer", "NYUImporter")
class NYUImporter(DepthImporter):
    """NYU hand dataset (reference importers.py:948-1383).

    Depth PNGs pack 16-bit depth into (G << 8) | B; labels come from
    ``joint_data.mat``; synthetic frames live in the same directory with a
    ``synthdepth_`` prefix; per-subset crop cubes of 300/250 mm.
    """

    restricted_joints_eval = [0, 3, 6, 9, 12, 15, 18, 21, 24, 25, 27, 30,
                              31, 32]  # importers.py:984

    def __init__(self, basepath, use_cache=True, cache_dir="./cache/",
                 all_joints=False, hand=None, com_idx=32, cube_size=300):
        super().__init__(Camera.nyu(), basepath, use_cache, cache_dir, hand)
        self.all_joints = all_joints
        self.num_joints = 36
        self.crop_joint_idx = com_idx if all_joints else 13
        self.default_cubes = {
            "train": (300, 300, 300), "test_1": (300, 300, 300),
            "test_2": (250, 250, 250), "test": (300, 300, 300),
            "train_synth": (300, 300, 300), "test_synth_1": (300, 300, 300),
            "test_synth_2": (250, 250, 250), "test_synth": (300, 300, 300)}
        self.sides = {k: "right" for k in self.default_cubes}

    def _cache_extra(self):
        return f"{self.all_joints}_{self.crop_joint_idx}_"

    def load_depth_map(self, filename) -> np.ndarray:
        """Unpack (G << 8) | B 16-bit depth (importers.py:987-1004)."""
        arr = read_png(filename)
        if arr.ndim != 3 or arr.shape[2] != 3:
            raise ValueError(f"{filename}: an NYU depth map is RGB, got "
                             f"shape {arr.shape}")
        arr = arr.astype(np.int32)
        dpt = (arr[..., 1] << 8) | arr[..., 2]
        return dpt.astype(np.float32)

    loadDepthMap = load_depth_map

    def get_depth_map_nv(self):
        return 32001  # importers.py:1006-1011

    def load_sequence(self, seq_name, nmax=float("inf"), shuffle=False,
                      rng=None, docom=False, cube=None) -> FrameArrays:
        import scipy.io

        config = {"cube": tuple(cube) if cube is not None
                  else self.default_cubes[seq_name]}
        cache = self._cache_path(seq_name, None, docom, config["cube"])
        hit = self._load_cached(cache, shuffle, rng, nmax)
        if hit is not None:
            return hit

        objdir = os.path.join(self.basepath,
                              "train" if "train" in seq_name else seq_name)
        mat = scipy.io.loadmat(os.path.join(objdir, "joint_data.mat"))
        joints3d = mat["joint_xyz"][0]
        joints2d = mat["joint_uvd"][0]
        eval_idxs = (np.arange(36) if self.all_joints
                     else np.asarray(self.restricted_joints_eval))
        self.num_joints = len(eval_idxs)

        prefix = "synthdepth_" if "synth" in seq_name else "depth_"
        frames: List[DepthFrame] = []
        for line in range(joints3d.shape[0]):
            fname = os.path.join(objdir, f"{prefix}1_{line + 1:07d}.png")
            if not os.path.isfile(fname):
                continue
            dpt = self.load_depth_map(fname)
            gtorig = joints2d[line][eval_idxs].astype(np.float32)
            gt3Dorig = joints3d[line][eval_idxs].astype(np.float32)
            f = self._crop_frame(dpt, gtorig, gt3Dorig, config["cube"],
                                 docom, fname)
            if f is not None:
                frames.append(f)
            if len(frames) >= nmax:
                break

        arrays = FrameArrays.from_frames(seq_name, frames, config)
        self._save_cache(cache, arrays)
        if shuffle and rng is not None:
            arrays = arrays.shuffled(rng)
        return arrays

    def load_baseline(self, filename, gt=None):
        """3rd-party prediction reader (importers.py:1152-1218): with
        ``gt``, a ``.mat`` of (u, v, confidence) predictions whose depth is
        read from the depth maps beside it; else a text file of (u, v, d)
        rows."""
        import scipy.io

        if gt is not None:
            mat = scipy.io.loadmat(filename)
            joints = mat["pred_joint_uvconf"][0]
            self.num_joints = mat["conv_joint_names"][0].shape[0]
            data = []
            for dat in range(min(joints.shape[0], gt.shape[0])):
                fname = os.path.join(os.path.split(filename)[0],
                                     f"depth_1_{dat + 1:07d}.png")
                if not os.path.isfile(fname):
                    continue
                dm = self.load_depth_map(fname)
                ev = np.zeros((self.num_joints, 3), np.float32)
                jt = 0
                for i in range(joints.shape[1]):
                    if np.count_nonzero(joints[dat, i, :]) == 0:
                        continue
                    ev[jt, 0] = joints[dat, i, 0]
                    ev[jt, 1] = joints[dat, i, 1]
                    ev[jt, 2] = dm[int(ev[jt, 1]), int(ev[jt, 0])]
                    jt += 1
                bad = np.abs(ev[:, 2] - gt[dat, 13, 2]) > 150.0
                ev[bad, 2] = gt[dat, bad, 2]
                data.append(self.joint_img_to_3d(ev))
            return data
        data = []
        with open(filename) as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                vals = np.asarray(line.split(" "), np.float32)
                data.append(self.joint_img_to_3d(vals.reshape(-1, 3)))
        return data


# ---------------------------------------------------------------------------
@register("importer", "ICVLImporter")
class ICVLImporter(DepthImporter):
    """ICVL dataset (reference importers.py:191-595).

    Single-channel 16-bit depth PNGs + a label txt per sequence.  Frames
    are mirrored horizontally and u-coordinates flipped
    (importers.py:381-383); crop around joint 0.
    """

    def __init__(self, basepath, use_cache=True, cache_dir="./cache/",
                 hand=None):
        super().__init__(Camera.icvl(), basepath, use_cache, cache_dir, hand)
        self.num_joints = 16
        self.crop_joint_idx = 0
        self.default_cubes = {"train": (250, 250, 250),
                              "test_seq_1": (250, 250, 250),
                              "test_seq_2": (250, 250, 250)}
        self.sides = {"train": "right", "test_seq_1": "right",
                      "test_seq_2": "right"}

    def load_depth_map(self, filename) -> np.ndarray:
        arr = read_png(filename)
        if arr.ndim != 2:
            raise ValueError(f"{filename}: an ICVL depth map is gray, got "
                             f"shape {arr.shape}")
        return arr.astype(np.float32)

    loadDepthMap = load_depth_map

    def get_depth_map_nv(self):
        return 32001

    def load_sequence(self, seq_name, sub_seq=None, nmax=float("inf"),
                      shuffle=False, rng=None, docom=False,
                      cube=None) -> FrameArrays:
        if sub_seq is not None and not isinstance(sub_seq, list):
            raise TypeError("sub_seq must be None or list")
        config = {"cube": tuple(cube) if cube is not None
                  else self.default_cubes[seq_name]}
        cache = self._cache_path(seq_name, sub_seq, docom, config["cube"])
        hit = self._load_cached(cache, shuffle, rng, nmax)
        if hit is not None:
            return hit

        objdir = os.path.join(self.basepath, "Depth")
        labels = os.path.join(self.basepath, f"{seq_name}.txt")
        frames: List[DepthFrame] = []
        with open(labels) as f:
            for line in f:
                if len(frames) >= nmax:
                    break
                part = line.split(" ")
                # subsequence filter (importers.py:342-360): directories
                # with names longer than 6 characters are the unrotated
                # originals ('0')
                if sub_seq is not None:
                    p0 = part[0].split("/")[0]
                    is_orig = len(p0) > 6
                    if is_orig and "0" not in sub_seq:
                        continue
                    if not is_orig and p0 not in sub_seq:
                        continue
                fname = os.path.join(objdir, part[0])
                if not os.path.isfile(fname):
                    continue
                dpt = self.load_depth_map(fname)
                gtorig = np.asarray(part[1:1 + self.num_joints * 3],
                                    np.float32).reshape(self.num_joints, 3)
                # horizontal flip (importers.py:381-383)
                dpt = np.fliplr(dpt).copy()
                gtorig[:, 0] = self.depth_map_size[0] - gtorig[:, 0]
                gt3Dorig = self.joint_img_to_3d(gtorig)
                fr = self._crop_frame(dpt, gtorig, gt3Dorig, config["cube"],
                                      docom, fname)
                if fr is not None:
                    frames.append(fr)

        arrays = FrameArrays.from_frames(seq_name, frames, config)
        self._save_cache(cache, arrays)
        if shuffle and rng is not None:
            arrays = arrays.shuffled(rng)
        return arrays

    def load_baseline(self, filename, first_name=False):
        """Baseline txt reader (importers.py:431-465)."""
        off = 1 if first_name else 0
        data = []
        with open(filename) as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                part = line.strip().split(" ")
                vals = np.asarray(part[off:off + self.num_joints * 3],
                                  np.float32).reshape(self.num_joints, 3)
                data.append(self.joint_img_to_3d(vals))
        return data

    def load_baseline_2d(self, filename, first_name=False):
        """2D baseline reader (importers.py:467-493)."""
        off = 1 if first_name else 0
        data = []
        with open(filename) as f:
            for line in f:
                line = line.rstrip()
                if not line:
                    continue
                part = line.split(" ")
                ev = np.zeros((self.num_joints, 2), np.float32)
                for j in range(self.num_joints):
                    ev[j, 0] = float(part[j * 3 + off])
                    ev[j, 1] = float(part[j * 3 + 1 + off])
                data.append(ev)
        return data


# ---------------------------------------------------------------------------
@register("importer", "MSRA15Importer")
class MSRA15Importer(DepthImporter):
    """MSRA 2015 dataset (reference importers.py:599-946).

    Binary ``.bin`` depth patches with a 6-int bbox header; 21 joints with
    z negated; per-subject cube sizes; crop around joint 5.
    """

    def __init__(self, basepath, use_cache=True, cache_dir="./cache/",
                 refine_net=None, hand=None):
        super().__init__(Camera.msra(), basepath, use_cache, cache_dir,
                         hand, refine_net)
        self.num_joints = 21
        self.crop_joint_idx = 5
        self.default_cubes = {
            "P0": (240,) * 3, "P1": (240,) * 3, "P2": (240,) * 3,
            "P3": (220,) * 3, "P4": (220,) * 3, "P5": (220,) * 3,
            "P6": (210,) * 3, "P7": (200,) * 3, "P8": (190,) * 3}
        self.sides = {f"P{i}": "right" for i in range(9)}

    def load_depth_map(self, filename) -> np.ndarray:
        """Binary patch format with bbox header (importers.py:640-658):
        width, height, left, top, right, bottom as int32, then the
        float32 patch."""
        with open(filename, "rb") as f:
            width, height, left, top, right, bottom = struct.unpack(
                "6i", f.read(24))
            patch = np.fromfile(f, dtype="float32")
        img = np.zeros((height, width), np.float32)
        img[top:bottom, left:right] = patch.reshape(bottom - top,
                                                    right - left)
        return img

    loadDepthMap = load_depth_map

    def get_depth_map_nv(self):
        return 32001

    def load_sequence(self, seq_name, sub_seq=None, nmax=float("inf"),
                      shuffle=False, rng=None, docom=False,
                      cube=None) -> FrameArrays:
        config = {"cube": tuple(cube) if cube is not None
                  else self.default_cubes[seq_name]}
        cache = self._cache_path(seq_name, sub_seq, docom, config["cube"])
        hit = self._load_cached(cache, shuffle, rng, nmax)
        if hit is not None:
            return hit

        objdir = os.path.join(self.basepath, seq_name)
        subdirs = sorted(d for d in os.listdir(objdir)
                         if os.path.isdir(os.path.join(objdir, d)))
        frames: List[DepthFrame] = []
        for subdir in subdirs:
            if sub_seq is not None and subdir not in sub_seq:
                continue
            labels = os.path.join(objdir, subdir, "joint.txt")
            with open(labels) as f:
                n_imgs = int(f.readline())
                for i in range(n_imgs):
                    if len(frames) >= nmax:
                        break
                    part = f.readline().split(" ")
                    fname = os.path.join(objdir, subdir,
                                         f"{i:06d}_depth.bin")
                    if not os.path.isfile(fname):
                        continue
                    dpt = self.load_depth_map(fname)
                    gt3Dorig = np.asarray(
                        part[:self.num_joints * 3],
                        np.float32).reshape(self.num_joints, 3)
                    gt3Dorig[:, 2] *= -1.0  # importers.py:758
                    gtorig = self.joint_3d_to_img(gt3Dorig)
                    fr = self._crop_frame(dpt, gtorig, gt3Dorig,
                                          config["cube"], docom, fname)
                    if fr is not None:
                        frames.append(fr)

        arrays = FrameArrays.from_frames(seq_name, frames, config)
        self._save_cache(cache, arrays)
        if shuffle and rng is not None:
            arrays = arrays.shuffled(rng)
        return arrays


def _read_gray(path) -> np.ndarray:
    """A gray PNG as float32, as ``np.float32(cv2.imread(path,
    IMREAD_UNCHANGED))`` gives it."""
    arr = read_png(path)
    if arr.ndim != 2:
        raise ValueError(f"{path}: a POST depth or part-label map is gray, "
                         f"got shape {arr.shape}")
    return arr.astype(np.float32)


# ---------------------------------------------------------------------------
@register("importer", "POSTImporter")
class POSTImporter(DepthImporter):
    """POST full-body dataset (reference importers.py:1386-1853).

    18 "joints" (body-part centers), 2000 mm crop cubes.  Synthetic
    frames pair a depth PNG (``dmaps/*_d_*.png``, invalid = 10000) with a
    part-label map (``lmaps/*_l_*.png``); ground truth is the per-part
    center of mass with the part's mean depth.  Real frames carry a
    colour label image instead: the subject is segmented by hue, the
    floor removed by point-cloud height, and a single CoM "pose" is
    produced.  As in the JAX package, the reference's debug popups and
    per-frame ``.pkl`` side-dumps are left out; everything metric is kept.
    """

    # synthetic part-label ids (reference importers.py:1448)
    LBL_IDS = [1, 2, 3, 4, 6, 7, 8, 9, 12, 16, 17, 18, 19, 20, 24, 25,
               26, 27]

    def __init__(self, basepath, use_cache=True, cache_dir="./cache/",
                 refine_net=None, hand=None):
        super().__init__(Camera.post(), basepath, use_cache, cache_dir,
                         hand, refine_net)
        self.num_joints = 18
        self.default_cubes = {"train": (2000, 2000, 2000),
                              "synth": (2000, 2000, 2000),
                              "test": (2000, 2000, 2000)}
        self.sides = {"train": "right", "synth": "right", "test": "right"}

    def get_depth_map_nv(self):
        return 32001  # importers.py:1443

    def load_depth_map(self, filename, synth=True):
        """(depth, label) pair (importers.py:1414-1436): synthetic label
        maps live beside the depth maps (dmaps->lmaps, _d_->_l_); real
        labels are a colour image converted to HSV."""
        dpt = _read_gray(filename)
        if synth:
            lbl = _read_gray(
                filename.replace("dmaps", "lmaps").replace("_d_", "_l_"))
        else:
            lbl = bgr_to_hsv(imread_color(
                filename.replace("dmaps", "lmaps")))
        return dpt, lbl

    loadDepthMap = load_depth_map

    def point_cloud(self, depth):
        """Dense per-pixel back-projection; invalid depth -> NaN z
        (importers.py:1816-1833)."""
        rows, cols = depth.shape
        c, r = np.meshgrid(np.arange(cols), np.arange(rows), sparse=True)
        valid = (depth > 0) & (depth < 255)
        z = np.where(valid, depth / 256.0, np.nan)
        x = np.where(valid, z * (c - self.ux) / self.fx, 0)
        y = np.where(valid, z * (r - self.uy) / self.fy, 0)
        return np.dstack((x, y, z))

    def prepare_samples(self, dpt, lbl, synth=True):
        """(dpt, gtorig, gt3Dorig) from a depth/label pair
        (importers.py:1443-1475)."""
        from scipy import ndimage

        if synth:
            dpt = dpt.copy()
            dpt[dpt == 10000] = 0.0
            # per-part center of mass in (row, col) -> flip to (u, v)
            com_rc = np.array(ndimage.center_of_mass(lbl, lbl,
                                                     self.LBL_IDS))
            gtorig = np.fliplr(np.floor(com_rc))
            with np.errstate(invalid="ignore"):
                zs = np.array([np.nanmean(np.where(lbl == i, dpt, np.nan))
                               for i in self.LBL_IDS])
            gtorig = np.floor(np.concatenate(
                (gtorig, zs[:, None]), axis=1)).astype(np.float32)
            return dpt, gtorig, self.joint_img_to_3d(gtorig)

        dpt = dpt / 5.0
        lower = np.array([169, 150, 150], dtype=np.uint8)
        upper = np.array([189, 255, 255], dtype=np.uint8)
        mask = in_range(lbl, lower, upper)
        pc = self.point_cloud(1 + (dpt / 6500.0) * 254)
        dpt[pc[:, :, 1] > 0.125] = 0.0  # floor removal
        com_rc = ndimage.center_of_mass(mask)
        zs = dpt[mask != 0]
        com = np.array(list(reversed(list(com_rc)))
                       + [np.mean(zs[zs != 0])], np.float32)[None]
        # gtorig is image-space (u, v, z); the 3D labels go through the
        # camera model as in the synthetic branch
        return dpt, com, self.joint_img_to_3d(com)

    def load_sequence(self, seq_name, nmax=float("inf"), shuffle=False,
                      rng=None, docom=False, cube=None) -> FrameArrays:
        config = {"cube": tuple(cube) if cube is not None
                  else self.default_cubes[seq_name]}
        cache = self._cache_path(seq_name, None, docom, config["cube"])
        hit = self._load_cached(cache, shuffle, rng, nmax)
        if hit is not None:
            return hit

        synth = "synth" in seq_name
        files: List[str] = []
        for d in sorted(glob.glob(os.path.join(self.basepath,
                                               seq_name + "*/"))):
            files += [os.path.join(d, f) for f in sorted(os.listdir(d))]

        frames: List[DepthFrame] = []
        n_skipped = 0
        for fname in files:
            if not os.path.isfile(fname):
                continue
            dpt, lbl = self.load_depth_map(fname, synth)
            dpt, gtorig, gt3Dorig = self.prepare_samples(dpt, lbl, synth)

            com_guess = np.floor(np.nanmean(gtorig, axis=0))
            if not np.isfinite(com_guess).all():
                n_skipped += 1
                continue  # empty mask / missing part label on this frame
            hd = HandDetector(dpt, self.fx, self.fy, importer=self,
                              refine_net=self.refine_net)
            try:
                dpt_c, M, com = hd.crop_area_3d(
                    com=com_guess, size=config["cube"], docom=docom)
            except (UserWarning, ValueError):
                # bad frame data: skipped.  A TypeError is a coding
                # fault, not a data fault, and is not swallowed
                n_skipped += 1
                continue
            com3d = self.joint_img_to_3d(com)
            frames.append(DepthFrame(
                dpt_c.astype(np.float32), gtorig,
                transform_points_2d(gtorig, M), M.astype(np.float32),
                gt3Dorig, gt3Dorig - com3d, com3d, fname, "",
                self.sides[seq_name], {}))
            if len(frames) >= nmax:
                break

        if n_skipped and not frames:
            # every frame was skipped: a systematic data problem, and
            # caching an empty sequence would make the failure sticky
            raise RuntimeError(
                f"POST sequence {seq_name!r}: all {n_skipped} readable "
                "frames failed preprocessing (empty masks or crop "
                "errors); refusing to cache an empty dataset")
        arrays = FrameArrays.from_frames(seq_name, frames, config)
        self._save_cache(cache, arrays)
        if shuffle and rng is not None:
            arrays = arrays.shuffled(rng)
        return arrays
