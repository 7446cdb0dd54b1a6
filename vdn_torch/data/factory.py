"""YAML-driven dataset factory, split, sampling, and batching
(vdn/data/factory.py).

Re-design of the reference factory (reference data/dataset_factory.py:18-161):
the torch DataLoader/WeightedRandomSampler machinery becomes a numpy
weighted sampler + a thread-pool prefetching batch iterator producing NHWC
numpy batches, the same draws as vdn's for a seed and an epoch;
``prefetch_to_device`` keeps the next batches' host -> card copies in
flight behind the current step.  A config path ending in ``.json`` is read
with ``json.load``, any other with PyYAML (imported where it is read).
"""

from __future__ import annotations

import concurrent.futures
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

from vdn_torch.core.config import load_config_file
from vdn_torch.data.datasets import DATASET_REGISTRY

__all__ = ["create_datasets", "ConcatDataset", "WeightedSampler",
           "BatchLoader", "Subset", "load_config", "prefetch_to_device"]


def load_config(config_path: str) -> Dict[str, Any]:
    return load_config_file(config_path)


class Subset:
    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, i):
        k = int(np.searchsorted(self._offsets, i, side="right") - 1)
        return self.datasets[k][i - int(self._offsets[k])]


def create_datasets(dataset_names: Sequence[str], config_file_path: str,
                    split: str = "train", random_seed: int = 42
                    ) -> List[Subset]:
    """Deterministic per-dataset train/val split (reference
    dataset_factory.py:44-109)."""
    config = load_config(config_file_path)
    common = config["dataset_common"]
    valid_keys = {"sequence_length", "output_size", "use_random_crop",
                  "sequence_stride"}
    common = {k: v for k, v in common.items() if k in valid_keys}
    if split == "val":
        common["use_random_crop"] = False

    out = []
    for name in dataset_names:
        dcfg = config["datasets"][name]
        cls = DATASET_REGISTRY[name + "Dataset"]
        params = dict(dcfg.get("params", {}))
        for key in ("envs", "difficulties", "cameras", "data_types",
                    "exclude_scenes", "sequence_length", "sequence_stride"):
            if key in dcfg:
                params[key] = dcfg[key]
        full = cls(**{**common, **params})
        train_size = int(dcfg["train_split"] * len(full))
        val_size = len(full) - train_size
        if (split == "train" and train_size == 0) or (
                split == "val" and val_size == 0):
            continue
        perm = np.random.default_rng(random_seed).permutation(len(full))
        subset = (perm[:train_size] if split == "train"
                  else perm[train_size:])
        out.append(Subset(full, subset))
    if not out:
        raise ValueError(f"no datasets created for split '{split}'")
    return out


class WeightedSampler:
    """1/len(dataset) per-sample weights over a ConcatDataset, sampled with
    replacement (reference dataset_factory.py:111-139)."""

    def __init__(self, concat: ConcatDataset, seed: int = 0):
        weights = []
        for d in concat.datasets:
            if len(d):
                weights.extend([1.0 / len(d)] * len(d))
        w = np.asarray(weights)
        self._p = w / w.sum()
        self._n = len(w)
        self._seed = seed
        self._rng = np.random.default_rng(seed)

    def sample(self, count: int, epoch: Optional[int] = None) -> np.ndarray:
        """With ``epoch`` the draw is a pure function of (seed, epoch) —
        resuming training at an epoch boundary replays the identical data
        stream (deterministic restart)."""
        rng = (np.random.default_rng((self._seed, epoch))
               if epoch is not None else self._rng)
        return rng.choice(self._n, size=count, replace=True, p=self._p)


class BatchLoader:
    """Threaded prefetching batch iterator -> dict of stacked numpy arrays
    (replaces the torch DataLoader; drop_last=True semantics)."""

    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[WeightedSampler] = None,
                 shuffle: bool = False, num_workers: int = 4,
                 seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.drop_last = drop_last
        self._seed = seed
        self._rng = np.random.default_rng(seed)
        self._epoch: Optional[int] = None

    def set_epoch(self, epoch: int):
        """Make the next iteration's order a pure function of (seed, epoch)
        — torch DistributedSampler.set_epoch semantics, required for
        deterministic checkpoint resume."""
        self._epoch = int(epoch)

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def _epoch_indices(self) -> np.ndarray:
        if self.sampler is not None:
            return self.sampler.sample(len(self.dataset), self._epoch)
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = (np.random.default_rng((self._seed, self._epoch))
                   if self._epoch is not None else self._rng)
            rng.shuffle(idx)
        return idx

    @staticmethod
    def _collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, Any]:
        batch: Dict[str, Any] = {}
        for key in items[0]:
            if key.endswith("_paths"):
                batch[key] = [it[key] for it in items]
            else:
                batch[key] = np.stack([it[key] for it in items], axis=0)
        return batch

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        indices = self._epoch_indices()
        n_batches = len(self)
        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as ex:
            futures = []
            for b in range(n_batches):
                chunk = indices[b * self.batch_size:(b + 1)
                                * self.batch_size]
                futures.append(ex.submit(
                    lambda c: self._collate([self.dataset[int(i)]
                                             for i in c]), chunk))
            for fut in futures:
                yield fut.result()


def prefetch_to_device(iterator, size: int = 2, device="cuda"):
    """Wrap a batch iterator with an N-deep queue of host -> ``device``
    copies (vdn's ``jax.device_put`` queue): each numpy array goes through
    pinned host memory and is copied with ``non_blocking=True``, so the
    next ``size`` batches' copies overlap the current step's compute (the
    caching host allocator keeps a pinned block until its copy is done).
    Non-array leaves (e.g. *_paths lists) pass through on the host.  On
    the CPU each array becomes the tensor that shares its memory."""
    import collections
    import itertools

    import torch

    device = torch.device(device)

    def move(value):
        if not isinstance(value, np.ndarray):
            return value
        t = torch.from_numpy(value)
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    def put(batch):
        return {k: move(v) for k, v in batch.items()}

    queue = collections.deque()
    it = iter(iterator)

    def enqueue(n):
        for batch in itertools.islice(it, n):
            queue.append(put(batch))

    enqueue(size)
    while queue:
        yield queue.popleft()
        enqueue(1)
