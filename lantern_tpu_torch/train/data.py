"""Finetune data pipeline: JSONL meta-datasets + length-clustered sampling.

The port's own copy of ``lantern_tpu/train/data.py`` (numpy only; the port
imports nothing of the JAX package), the equivalent of the reference's
xllmx data stack (models/base_models/lumina_mgpt/xllmx/data/dataset.py:
22-160, sampler.py:14-214, data_reader.py): a meta-config lists several
annotation files with a task ``type`` and sampling ``ratio``; the sampler
builds per-rank index streams where

- every global batch contains items of a single task type,
- items are length-clustered (sort by token length, then *mild-shuffle*
  within a neighborhood) so padded batches waste little compute,
- batch order is shuffled per epoch with a deterministic seed,
- iteration can resume mid-epoch from ``start_iter`` (checkpoint/resume).

For one seed the index streams equal the JAX module's.  ``h5py`` (the
on-disk annotation cache) is imported only when that cache is asked for.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


def read_jsonl(path: str) -> List[dict]:
    items = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                items.append(json.loads(line))
    return items


def read_annotations(path: str) -> List[dict]:
    if path.endswith(".jsonl"):
        return read_jsonl(path)
    if path.endswith(".pkl"):
        import pickle

        with open(path, "rb") as f:
            data = pickle.load(f)
        assert isinstance(data, list)
        return data
    if path.endswith(".pth"):
        import torch

        data = torch.load(path, weights_only=False)
        assert isinstance(data, list)
        return list(data)
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("annotations", data.get("data", []))
    return list(data)


class MetaDataset:
    """Several annotation files behind one index space.

    ``meta_config`` is a path to a JSON list (or the list itself) of entries
    ``{"path": ..., "type": "text"|"image_text"|..., "ratio": 1.0}``
    (reference dataset.py:47-96). Item token length is taken from a
    ``len``/``num_tokens`` field when present, else ``len(item["tokens"])``,
    else the whitespace token count of ``item["text"]``.
    """

    def __init__(self, meta_config, cache_on_disk: bool = False,
                 cache_dir: Optional[str] = None, rank: int = 0,
                 cache_timeout_s: float = 600.0):
        if isinstance(meta_config, str):
            base = os.path.dirname(os.path.abspath(meta_config))
            with open(meta_config) as f:
                metas = json.load(f)
            for m in metas:
                if not os.path.isabs(m["path"]):
                    m["path"] = os.path.join(base, m["path"])
        else:
            metas = list(meta_config)
        self._h5 = None
        self._anns = None
        if cache_on_disk:
            # the reference's h5 annotation cache (xllmx/data/dataset.py:
            # 97-146): rank 0 serializes every annotation list into
            # ``data.h5`` vlen-str datasets plus the meta json and drops a
            # ``ready`` marker; other ranks wait for the marker and read
            # lazily — annotations never fully materialize in RAM
            if cache_dir is None:
                raise ValueError("cache_on_disk needs cache_dir")
            self._init_from_cache(metas, cache_dir, rank,
                                  timeout_s=cache_timeout_s)
            return
        self.meta_collection: List[Dict] = []
        self.items: List[dict] = []
        for m in metas:
            ann = read_annotations(m["path"])
            self.meta_collection.append({
                "type": m.get("type", "default"),
                "ratio": float(m.get("ratio", 1.0)),
                "len": len(ann),
                "item_len_list": [self._item_len(a) for a in ann],
            })
            self.items.extend(ann)

    def _init_from_cache(self, metas, cache_dir: str, rank: int,
                         timeout_s: float = 600.0):
        import time as _time

        import h5py

        h5_path = os.path.join(cache_dir, "data.h5")
        ready = os.path.join(cache_dir, "ready")
        if rank == 0 and not (os.path.exists(h5_path)
                              and os.path.exists(ready)):
            os.makedirs(cache_dir, exist_ok=True)
            metas_out = []
            with h5py.File(h5_path, "w") as f:
                dt = h5py.vlen_dtype(str)
                for i, m in enumerate(metas):
                    ann = read_annotations(m["path"])
                    ds = f.create_dataset(f"ann{i}", (len(ann),), dtype=dt)
                    ds[:] = [json.dumps(a) for a in ann]
                    metas_out.append({
                        "type": m.get("type", "default"),
                        "ratio": float(m.get("ratio", 1.0)),
                        "len": len(ann),
                        "item_len_list": [self._item_len(a) for a in ann],
                    })
                f.create_dataset("meta_collection",
                                 data=json.dumps(metas_out))
            with open(ready, "w") as f:
                f.write("ready")
        t0 = _time.time()
        while not os.path.exists(ready):
            if rank == 0 or _time.time() - t0 > timeout_s:
                raise FileNotFoundError(f"h5 cache never became ready under "
                                        f"{cache_dir}")
            _time.sleep(1.0)
        self._h5 = h5py.File(h5_path, "r")
        self.meta_collection = json.loads(
            self._h5["meta_collection"].asstr()[()])
        self._anns = [self._h5[f"ann{i}"]
                      for i in range(len(self.meta_collection))]
        self.items = None  # lazy: __getitem__ decodes from h5 on access

    @staticmethod
    def _item_len(item: dict) -> int:
        for key in ("len", "num_tokens", "length"):
            if key in item:
                return int(item[key])
        if "tokens" in item:
            return len(item["tokens"])
        if "input_ids" in item:
            return len(item["input_ids"])
        if "text" in item:
            return len(str(item["text"]).split())
        return 1

    def __len__(self):
        if self.items is not None:
            return len(self.items)
        return sum(m["len"] for m in self.meta_collection)

    def __getitem__(self, idx):
        if self.items is not None:
            return self.items[idx]
        if idx < 0:
            idx += len(self)
        for i, m in enumerate(self.meta_collection):
            if idx < m["len"]:
                return json.loads(self._anns[i][idx])
            idx -= m["len"]
        raise IndexError(idx)


def mild_shuffle(indices: Sequence[int], shuffle_factor: float,
                 rng: np.random.Generator) -> List[int]:
    """Shuffle each item within +-``shuffle_factor * len`` of its position.

    Preserves the global length ordering approximately (reference
    sampler.py:14-47) so neighboring batches stay similar in length while
    batch composition still varies across epochs.
    """
    n = len(indices)
    radius = max(1, int(n * shuffle_factor))
    # noisy-key sort: |noise| <= radius bounds every displacement by 2*radius
    keys = np.arange(n) + rng.uniform(-radius, radius, n)
    return [indices[int(i)] for i in np.argsort(keys, kind="stable")]


class LengthClusteredSampler:
    """Per-rank batch index iterator with single-type, length-clustered
    global batches (reference FinetuneDistSampler, sampler.py:50-214)."""

    def __init__(
        self,
        dataset: MetaDataset,
        num_replicas: int,
        rank: int,
        batch_size: int,
        acc_grad: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        length_clustering: bool = True,
        shuffle_factor: float = 0.05,
    ):
        if not (0 <= rank < num_replicas):
            raise ValueError(f"invalid rank {rank} / {num_replicas}")
        self.dataset = dataset
        self.num_replicas = num_replicas
        self.rank = rank
        self.batch_size = batch_size
        self.acc_grad = acc_grad
        self.shuffle = shuffle
        self.seed = seed
        self.length_clustering = length_clustering
        self.shuffle_factor = shuffle_factor
        self.epoch = 0
        self.start_iter = 0

        global_bsz_acc = batch_size * num_replicas * acc_grad
        per_type: Dict[str, int] = {}
        for m in dataset.meta_collection:
            per_type[m["type"]] = per_type.get(m["type"], 0) + int(
                m["len"] * m["ratio"])
        # same grouping as _global_batches: same-type metas pool their
        # samples before truncating to the accumulation multiple
        total = sum(n // global_bsz_acc * global_bsz_acc
                    for n in per_type.values())
        self.total_size = total
        self.num_samples = total // num_replicas

    def set_epoch(self, epoch: int, start_iter: int = 0):
        """``start_iter`` counts RAW global batches and must sit on an
        accumulation-window boundary — resuming mid-window would mix task
        types inside one gradient accumulation."""
        if start_iter % self.acc_grad:
            raise ValueError(
                f"start_iter {start_iter} not a multiple of acc_grad "
                f"{self.acc_grad}")
        self.epoch = epoch
        self.start_iter = start_iter

    def _global_batches(self) -> List[List[int]]:
        gbs = self.batch_size * self.num_replicas
        global_bsz_acc = gbs * self.acc_grad
        rng = np.random.default_rng(self.seed + self.epoch)

        groups: Dict[str, List[List[int]]] = {}
        start = 0
        for m in self.dataset.meta_collection:
            idx_len = [[start + i, m["item_len_list"][i]]
                       for i in range(m["len"])]
            start += m["len"]
            if m["ratio"] != 1.0:
                n_keep = int(m["len"] * m["ratio"])
                keep = rng.choice(len(idx_len), n_keep,
                                  replace=n_keep > len(idx_len))
                idx_len = [idx_len[int(i)] for i in keep]
            groups.setdefault(m["type"], []).extend(idx_len)

        batches: List[List[int]] = []
        for _, idx_len in sorted(groups.items()):
            idx_len = idx_len[: len(idx_len) // global_bsz_acc * global_bsz_acc]
            if not idx_len:
                continue
            if self.shuffle and self.length_clustering:
                idx_len.sort(key=lambda x: x[1])
                indices = mild_shuffle([x[0] for x in idx_len],
                                       self.shuffle_factor, rng)
            elif self.shuffle:
                indices = [x[0] for x in idx_len]
                rng.shuffle(indices)
            else:
                indices = [x[0] for x in idx_len]
            batches.extend(indices[i : i + gbs]
                           for i in range(0, len(indices), gbs))
        if self.shuffle:
            # keep acc_grad-consecutive batches together so every
            # accumulation window sees one task type
            blocks = [batches[i : i + self.acc_grad]
                      for i in range(0, len(batches), self.acc_grad)]
            rng.shuffle(blocks)
            batches = [b for blk in blocks for b in blk]
        return batches

    def __iter__(self) -> Iterator[List[int]]:
        for it, batch in enumerate(self._global_batches()):
            if it < self.start_iter:
                continue
            yield batch[self.rank * self.batch_size
                        : (self.rank + 1) * self.batch_size]

    def __len__(self):
        return self.num_samples // self.batch_size


def pad_batch(seqs: Sequence[Sequence[int]], pad_id: int = 0,
              multiple: int = 128):
    """Right-pad to the batch max rounded up to ``multiple`` (a handful of
    bucket shapes across batches)."""
    max_len = max(len(s) for s in seqs)
    max_len = (max_len + multiple - 1) // multiple * multiple
    out = np.full((len(seqs), max_len), pad_id, np.int32)
    mask = np.zeros((len(seqs), max_len), np.bool_)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
        mask[i, : len(s)] = True
    return out, mask
