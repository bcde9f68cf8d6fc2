"""The port's copy of the data pipeline against ``lantern_tpu`` on the CPU.

- ``read_jsonl`` / ``read_annotations`` (jsonl, json, pkl, pth) return the
  same items;
- ``MetaDataset`` has the same items and ``meta_collection``, in memory and
  through the h5 cache (built by rank 0, read by rank 1 without the
  sources);
- ``mild_shuffle`` and ``LengthClusteredSampler``: the index streams are
  identical for one seed across replicas, ranks, gradient accumulation,
  shuffle modes, epochs and a resumed ``start_iter``;
- ``pad_batch`` equal;
- the drafter's ``batch_iterator`` yields the same batches as JAX's for a
  seed, shuffled and not, with truncation and padding.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from lantern_tpu.train import data as jdata
from lantern_tpu.train import drafter_train as jdt
from lantern_tpu_torch.train import data as tdata
from lantern_tpu_torch.train import drafter_train as tdt


@pytest.fixture
def meta(tmp_path):
    a = tmp_path / "text.jsonl"
    with open(a, "w") as f:
        for i in range(40):
            f.write(json.dumps({"tokens": list(range(i + 1)), "id": f"t{i}"})
                    + "\n")
    b = tmp_path / "imgs.json"
    with open(b, "w") as f:
        json.dump([{"len": 100 + i, "id": f"i{i}"} for i in range(24)], f)
    c = tmp_path / "words.pkl"
    c.write_bytes(pickle.dumps([{"text": "a b " * (i % 5 + 1), "id": f"w{i}"}
                                for i in range(18)]))
    cfg = tmp_path / "meta.json"
    with open(cfg, "w") as f:
        json.dump([
            {"path": "text.jsonl", "type": "text"},
            {"path": "imgs.json", "type": "image_text", "ratio": 0.5},
            {"path": "words.pkl", "type": "text", "ratio": 1.5},
        ], f)
    return str(cfg)


def test_read_annotations_match_jax(tmp_path):
    ann = [{"text": "a b c"}, {"text": "d", "len": 7}]
    (tmp_path / "x.jsonl").write_text(
        json.dumps(ann[0]) + "\n\n" + json.dumps(ann[1]) + "\n")
    (tmp_path / "x.json").write_text(json.dumps({"annotations": ann}))
    (tmp_path / "x.pkl").write_bytes(pickle.dumps(ann))
    torch.save(ann, str(tmp_path / "x.pth"))
    for name in ("x.jsonl", "x.json", "x.pkl", "x.pth"):
        p = str(tmp_path / name)
        assert tdata.read_annotations(p) == jdata.read_annotations(p) == ann
    p = str(tmp_path / "x.jsonl")
    assert tdata.read_jsonl(p) == jdata.read_jsonl(p)


def test_meta_dataset_matches_jax(meta):
    dj, dt_ = jdata.MetaDataset(meta), tdata.MetaDataset(meta)
    assert len(dt_) == len(dj) == 82
    assert dt_.meta_collection == dj.meta_collection
    assert [dt_[i] for i in range(len(dt_))] == [dj[i] for i in range(len(dj))]


def test_h5_cache_matches_jax(meta, tmp_path):
    pytest.importorskip("h5py")
    dt_ = tdata.MetaDataset(meta, cache_on_disk=True,
                            cache_dir=str(tmp_path / "c"), rank=0)
    dj = jdata.MetaDataset(meta)
    assert dt_.meta_collection == dj.meta_collection
    assert [dt_[i] for i in range(len(dt_))] == [dj[i] for i in range(len(dj))]
    assert dt_[-1] == dj[len(dj) - 1]
    again = tdata.MetaDataset([], cache_on_disk=True,
                              cache_dir=str(tmp_path / "c"), rank=1)
    assert len(again) == len(dj) and again[5] == dj[5]
    with pytest.raises(FileNotFoundError):
        tdata.MetaDataset([], cache_on_disk=True,
                          cache_dir=str(tmp_path / "none"), rank=1,
                          cache_timeout_s=0.5)


def test_mild_shuffle_and_pad_batch_match_jax():
    for factor in (0.01, 0.05, 0.3):
        a = tdata.mild_shuffle(list(range(100)), factor,
                               np.random.default_rng(4))
        b = jdata.mild_shuffle(list(range(100)), factor,
                               np.random.default_rng(4))
        assert a == b
    for mult in (1, 4, 128):
        ot, mt = tdata.pad_batch([[1, 2, 3], [4], []], pad_id=9,
                                 multiple=mult)
        oj, mj = jdata.pad_batch([[1, 2, 3], [4], []], pad_id=9,
                                 multiple=mult)
        np.testing.assert_array_equal(ot, oj)
        np.testing.assert_array_equal(mt, mj)
        assert ot.dtype == oj.dtype and mt.dtype == mj.dtype


SAMPLERS = [
    dict(num_replicas=1, rank=0, batch_size=4),
    dict(num_replicas=2, rank=1, batch_size=4, seed=1),
    dict(num_replicas=2, rank=0, batch_size=2, acc_grad=2, seed=2),
    dict(num_replicas=1, rank=0, batch_size=3, length_clustering=False,
         seed=5),
    dict(num_replicas=3, rank=2, batch_size=2, shuffle=False),
    dict(num_replicas=1, rank=0, batch_size=8, shuffle_factor=0.2, seed=7),
]


@pytest.mark.parametrize("kw", SAMPLERS)
def test_sampler_index_streams_match_jax(meta, kw):
    st = tdata.LengthClusteredSampler(tdata.MetaDataset(meta), **kw)
    sj = jdata.LengthClusteredSampler(jdata.MetaDataset(meta), **kw)
    assert (len(st), st.total_size, st.num_samples) == (
        len(sj), sj.total_size, sj.num_samples)
    acc = kw.get("acc_grad", 1)
    for epoch, start in ((0, 0), (1, 0), (3, 2 * acc)):
        st.set_epoch(epoch, start_iter=start)
        sj.set_epoch(epoch, start_iter=start)
        got, want = list(st), list(sj)
        assert got == want and got
    if acc > 1:
        with pytest.raises(ValueError):
            st.set_epoch(0, start_iter=1)
    with pytest.raises(ValueError):
        tdata.LengthClusteredSampler(tdata.MetaDataset(meta), 2, 2, 4)


def test_drafter_batch_iterator_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    paths = []
    for i, T in enumerate((9, 14, 5, 12, 7)):
        p = str(tmp_path / f"sample_{i:06d}.npz")
        np.savez_compressed(
            p, tokens=rng.integers(0, 64, (T,)).astype(np.int32),
            hidden=rng.normal(size=(T, 6)).astype(np.float32),
            target=rng.normal(size=(T, 6)).astype(np.float32),
            loss_mask=(rng.random(T) > 0.3).astype(np.float32))
        paths.append(p)
    for shuffle in (True, False):
        got = list(tdt.batch_iterator(paths, 2, 10, np.random.default_rng(3),
                                      shuffle=shuffle))
        want = list(jdt.batch_iterator(paths, 2, 10, np.random.default_rng(3),
                                       shuffle=shuffle))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].dtype == w[k].dtype
    t = tdt.to_device(got[0], "cpu")
    assert t["tokens"].dtype == torch.int32 and t["hidden"].shape == (2, 10, 6)
