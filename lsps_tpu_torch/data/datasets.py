"""Training/eval datasets over imported sequences (host numpy).

The port's copy of ``_HandDatasetBase`` and of the NYU 6-tuple contract of
``DatasetHandNYU`` from ``lsps_tpu/data/datasets.py``
(reference: src/data/dataset_hand2.py:125-415): normalization, NYU
joint-subset remapping with y-flip, pose-only mode, ``sample_poses``
pre-generation, ``set_nmax`` label-fraction capping, and the batched
augment paths the loader calls (``fast_batch`` and ``raw_fast_batch``).
``__getitem__`` returns numpy; batching is done by
:class:`lsps_tpu_torch.data.loader.DataLoader`.

The contract lives in :class:`NYUContractDataset`, which the synthetic
dataset (``data/synthetic.py``) inherits.  Not ported here
(``ROADMAP.md``): the NYU and ICVL datasets, which wait with their
importers, and the per-sample augment of an image-mode ``__getitem__``,
which needs the cv2 warps of the host augment backend; the training
loaders take the batched augment instead.
"""

from __future__ import annotations

import numpy as np

from lsps_tpu_torch.data.augment import AUG_MODES_DEFAULT, normalize
from lsps_tpu_torch.data.detector import HandDetector
from lsps_tpu_torch.data.loader import DEFERRED_AUGMENT


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
        (``data/fast_augment.py``): ``'jax'``, the image work on
        ``device`` in the loader (the name of the JAX package's device
        backend, kept so that scripts run unchanged against either
        package), or ``'step'``, the warp parameters only, the image work
        inside the training step (``trainer.pretrain_update_raw``).
        ``device=None`` is the card.  Returns False where the dataset's mode takes no augment."""
        from lsps_tpu_torch.data import fast_augment

        if backend not in ("jax", "step"):
            raise ValueError(f"augment backend {backend!r}: the port has "
                             "'jax' and 'step'")
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

        if self.augment:
            raise NotImplementedError(
                "a per-sample augmented item needs "
                + DEFERRED_AUGMENT["host"] + ", which is not ported yet "
                "(ROADMAP.md, queue 1 #14); the loaders take the batched "
                "augment (LSPS_AUGMENT=step or jax)")
        cube = self.seq.cube
        com = self.seq.com[i].astype(np.float32)
        M = self.seq.M[i].astype(np.float32)
        gt3d = self.seq.gt3Dcrop[i].astype(np.float32)
        img = normalize(self.seq.dpt_mm(i), com, cube)
        gt3d = gt3d[self.joint_subset]
        if self.flip_y:
            gt3d[:, 1] *= -1
        if self.pose_only:
            return gt3d.reshape(-1) / (cube[2] / 2.0)
        return (img[None], gt3d.reshape(-1) / (cube[2] / 2.0), com, M,
                cube, cube)
