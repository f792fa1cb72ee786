"""Training/eval datasets over imported sequences (host numpy).

The port's copy of ``lsps_tpu/data/datasets.py`` (reference:
src/data/dataset_hand2.py:125-415): normalization, the per-sample augment,
NYU joint-subset remapping with y-flip, pose-only mode, ``sample_poses``
pre-generation, ``set_nmax`` label-fraction capping, the batched augment
paths the loader calls (``fast_batch`` and ``raw_fast_batch``), and the
four registered datasets of ``exps/nnyu.yaml`` and ``exps/nicvl.yaml``:
``dataset_hand_NYU``, ``dataset_hand_NYU_test``, ``dataset_hand_ICVL`` and
``dataset_hand_ICVL_test``.  ``__getitem__`` returns numpy; batching is
done by :class:`lsps_tpu_torch.data.loader.DataLoader`.  Each item, and
each random draw on the dataset's ``RandomState``, is the JAX package's.

The NYU contract lives in :class:`NYUContractDataset`, which the NYU
dataset and the synthetic dataset (``data/synthetic.py``) inherit.  The
cache directory is the spec's ``cacheDir`` or ``cache_dir``.
"""

from __future__ import annotations

import numpy as np

from lsps_tpu_torch.data.augment import (AUG_MODES_DEFAULT, augment_crop,
                                         normalize)
from lsps_tpu_torch.data.detector import HandDetector
from lsps_tpu_torch.data.importers import ICVLImporter, NYUImporter
from lsps_tpu_torch.registry import register

# NYU -> MSRA / ICVL joint-subset index maps (dataset_hand2.py:278-287)
NYU_TO_MSRA = np.asarray([29, 23, 22, 20, 18, 17, 16, 14, 12, 11, 10,
                          8, 6, 5, 4, 2, 0, 28, 27, 25, 24], dtype=np.int32)
NYU_TO_ICVL = np.asarray([34, 28, 26, 24, 22, 20, 18, 16, 14, 12, 10,
                          8, 6, 4, 2, 0], dtype=np.int32)


def cache_dir_of(specs) -> str:
    """The spec's cache directory: ``cacheDir`` (the configs' key) or
    ``cache_dir``, else ``./cache/``."""
    return specs.get("cacheDir", specs.get("cache_dir", "./cache/"))


class _HandDatasetBase:
    """Shared behavior: pose sampling, nmax capping, augmentation."""

    def __init__(self, specs):
        self.rng = np.random.RandomState(specs["seed"])
        self.sampled_poses = None
        self.pose_only = False
        self.nmax = np.inf
        self.augment = specs.get("augment", False)
        self.num_sample_poses = specs.get("sample_poses", 0)
        self.joint_subset = specs.get("joint_subset", None)
        self.aug_modes = list(AUG_MODES_DEFAULT)
        self.flip_y = False

    def _init_detector(self):
        """Build the augmentation HandDetector from frame 0
        (dataset_hand2.py:150-156)."""
        cube = self.seq.cube
        com = self.seq.com[0]
        img = normalize(self.seq.dpt_mm(0), com, cube)
        self.hd = HandDetector(img, abs(self.di.fx), abs(self.di.fy),
                               importer=self.di)
        self.num = len(self.seq)

    def sample_poses(self):
        """Pre-generate ``num_sample_poses`` augmented poses
        (dataset_hand2.py:159-169, 314-324), vectorized."""
        cube = np.repeat(self.seq.cube[None], self.num, 0)
        self.sampled_poses = HandDetector.sample_random_poses(
            self.di, self.rng, self.seq.gt3Dcrop, self.seq.com, cube,
            self.num_sample_poses, self.nmax, self.aug_modes)
        self.num = self.sampled_poses.shape[0]
        self.nmax = self.sampled_poses.shape[0]

    def set_nmax(self, frac):
        """Cap labeled-real sample count (dataset_hand2.py:202-204)."""
        self.nmax = int(self.num * frac)

    def __len__(self):
        return int(np.minimum(self.num, self.nmax))

    # -- batched augmentation ------------------------------------------
    def enable_fast_augment(self, backend: str = "step",
                            device=None) -> bool:
        """Switch the loader to the batched augment
        (``data/fast_augment.py``): ``'native'``, the port's build of the
        C++ host library (built on first use; a failed build raises),
        ``'jax'``, the image work on ``device`` in the loader (the name of
        the JAX package's device backend, kept so that scripts run
        unchanged against either package), or ``'step'``, the warp
        parameters only, the image work inside the training step
        (``trainer.pretrain_update_raw``).  ``device=None`` is the card.
        Returns False where the dataset's mode takes no augment."""
        from lsps_tpu_torch.data import fast_augment

        if backend not in ("native", "jax", "step"):
            raise ValueError(f"batched augment backend {backend!r}: one of "
                             "'native', 'jax' and 'step'")
        if not (getattr(self, "augment", False)
                and not getattr(self, "pose_only", False)):
            return False
        self._fast_augmenter = fast_augment.FastAugmenter(self, backend,
                                                          device=device)
        return True

    def _fix_labels(self, labels):
        n = labels.shape[0]
        lab = labels.reshape(n, -1, 3)
        if isinstance(self.joint_subset, np.ndarray):
            lab = lab[:, self.joint_subset].copy()
        if self.flip_y:
            lab[:, :, 1] *= -1
        return lab.reshape(n, -1)

    def fast_batch(self, idxs):
        """One augmented batch in this dataset's tuple contract."""
        imgs, labels, coms, Ms, cubes = self._fast_augmenter.batch(idxs)
        return self._batch_tuple(imgs, self._fix_labels(labels), coms, Ms,
                                 cubes)

    def raw_fast_batch(self, idxs):
        """One batch of augment parameters (no image work): ``(raw,
        labels, coms, Ms, cubes)`` for the fused-in-step augment."""
        raw, labels, coms, Ms, cubes = self._fast_augmenter.raw_batch(idxs)
        return raw, self._fix_labels(labels), coms, Ms, cubes

    def _batch_tuple(self, imgs, labels, coms, Ms, cubes):
        return imgs, labels, coms, Ms, cubes

    # -- per-sample items ------------------------------------------------
    @staticmethod
    def _frame(seq, i):
        """(cube, com3D, M, gt3Dcrop, normalized crop) of frame ``i``."""
        cube = seq.cube
        com = seq.com[i].astype(np.float32)
        return (cube, com, seq.M[i].astype(np.float32),
                seq.gt3Dcrop[i].astype(np.float32),
                normalize(seq.dpt_mm(i), com, cube))

    def _augmented(self, img, gt3d, com, cube, M):
        """One draw of the per-sample augment (``augment_crop``) on the
        dataset's RandomState: (img, gt3d label, com3D, M, cube)."""
        img, _, gt3d, cube, com2d, M, _ = augment_crop(
            img, gt3d, self.di.joint_3d_to_img(com), cube, M,
            self.aug_modes, self.hd, rng=self.rng)
        return img, gt3d, self.di.joint_img_to_3d(com2d), M, cube


class NYUContractDataset(_HandDatasetBase):
    """The NYU training dataset's contract (dataset_hand2.py:256-373):
    an image-mode item is a 6-tuple with the cube twice
    (dataset_hand2.py:352, 366), so loops can unpack a trailing ``_``;
    labels take ``joint_subset`` and, with ``flip_y``, a negated y.
    Subclasses set ``di``, ``seq`` and ``joint_subset``."""

    def _batch_tuple(self, imgs, labels, coms, Ms, cubes):
        return imgs, labels, coms, Ms, cubes, cubes

    def __getitem__(self, i):
        if self.pose_only and self.sampled_poses is not None:
            pos = self.sampled_poses[i][self.joint_subset].copy()
            if self.flip_y:
                pos[:, 1] *= -1
            return pos.reshape(-1)

        cube, com, M, gt3d, img = self._frame(self.seq, i)
        if not self.augment:
            gt3d = gt3d[self.joint_subset]
            if self.flip_y:
                gt3d[:, 1] *= -1
            if self.pose_only:
                return gt3d.reshape(-1) / (cube[2] / 2.0)
            return (img[None], gt3d.reshape(-1) / (cube[2] / 2.0), com, M,
                    cube, cube)

        img, gt3d, com, M, cube = self._augmented(img, gt3d, com, cube, M)
        gt3d = gt3d[self.joint_subset]
        if self.flip_y:
            gt3d[:, 1] *= -1
        if self.pose_only:
            return gt3d.reshape(-1)
        return (img[None], gt3d.reshape(-1).astype(np.float32), com, M,
                cube, cube)


@register("dataset", "dataset_hand_ICVL")
class DatasetHandICVL(_HandDatasetBase):
    """ICVL training dataset (dataset_hand2.py:125-207).

    __getitem__ (image mode): (1x128x128 img, flat pose / (cube_z/2),
    com3D, M, cube).
    """

    def __init__(self, specs):
        super().__init__(specs)
        self.di = ICVLImporter(specs["root"], cache_dir=cache_dir_of(specs))
        self.seq = self.di.load_sequence(specs["subset"], sub_seq=["0"],
                                         rng=self.rng, shuffle=True,
                                         docom=specs.get("docom", False))
        self._init_detector()

    def __getitem__(self, i):
        if self.pose_only and self.sampled_poses is not None:
            return self.sampled_poses[i].reshape(-1)

        cube, com, M, gt3d, img = self._frame(self.seq, i)
        if not self.augment:
            if self.pose_only:
                return gt3d.reshape(-1) / (cube[2] / 2.0)
            return (img[None], gt3d.reshape(-1) / (cube[2] / 2.0), com, M,
                    cube)

        img, gt3d, com, M, cube = self._augmented(img, gt3d, com, cube, M)
        if self.pose_only:
            return gt3d.reshape(-1)
        return (img[None], gt3d.reshape(-1).astype(np.float32), com, M,
                cube)


@register("dataset", "dataset_hand_ICVL_test")
class DatasetHandICVLTest(_HandDatasetBase):
    """ICVL test dataset over both test sequences
    (dataset_hand2.py:210-249)."""

    def __init__(self, specs):
        self.rng = np.random.RandomState(specs["seed"])
        self.pose_only = False
        self.augment = False  # test sets are never augmented
        self.di = ICVLImporter(specs["root"], cache_dir=cache_dir_of(specs))
        subset = specs["subset"]
        self.seq1 = self.di.load_sequence(subset,
                                          docom=specs.get("docom", False))
        self.seq2 = self.di.load_sequence(subset.replace("1", "2"),
                                          docom=specs.get("docom", False))
        self.num = len(self.seq1) + len(self.seq2)
        self.len_seq1 = len(self.seq1)

    def __getitem__(self, i):
        seq, j = ((self.seq1, i) if i < self.len_seq1
                  else (self.seq2, i - self.len_seq1))
        cube, com, M, gt3d, img = self._frame(seq, j)
        return (img[None], gt3d.reshape(-1) / (cube[2] / 2.0), com, M, cube)

    def __len__(self):
        return self.num


@register("dataset", "dataset_hand_NYU")
class DatasetHandNYU(NYUContractDataset):
    """NYU training dataset (dataset_hand2.py:256-373), with the MSRA and
    ICVL joint-subset remaps (the ICVL one with the y-flip and a 350 mm
    cube for synth subsets)."""

    def __init__(self, specs):
        super().__init__(specs)
        js = specs.get("joint_subset", "NYU") or "NYU"
        com_idx, cube_size = 32, 300
        if "MSRA" in js:
            self.joint_subset = NYU_TO_MSRA
            com_idx = 17
        elif "ICVL" in js:
            self.joint_subset = NYU_TO_ICVL
            self.flip_y = True
            com_idx = 34
            cube_size = 350
        else:
            self.joint_subset = np.arange(36)

        self.di = NYUImporter(specs["root"], all_joints=True,
                              com_idx=com_idx, cache_dir=cache_dir_of(specs))
        subset = specs["subset"]
        if "synth" in subset:
            self.di.default_cubes[subset] = (cube_size,) * 3
        self.seq = self.di.load_sequence(subset, rng=self.rng, shuffle=True,
                                         docom=specs.get("docom", False))
        self._init_detector()


@register("dataset", "dataset_hand_NYU_test")
class DatasetHandNYUTest(NYUContractDataset):
    """NYU test dataset (dataset_hand2.py:377-412); no shuffle, no
    augment; the 6-tuple contract."""

    def __init__(self, specs):
        self.rng = np.random.RandomState(specs["seed"])
        self.pose_only = False
        self.augment = False  # test sets are never augmented
        self.sampled_poses = None
        self.joint_subset = np.arange(36)
        self.flip_y = False
        self.di = NYUImporter(specs["root"], all_joints=True,
                              cache_dir=cache_dir_of(specs))
        self.seq = self.di.load_sequence(specs["subset"], shuffle=False,
                                         rng=self.rng,
                                         docom=specs.get("docom", False))
        self.num = len(self.seq)
        self.nmax = np.inf

    def __len__(self):
        return self.num
