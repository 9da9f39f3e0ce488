"""The port's ImageNet DET and Visual Genome imdbs (`data/imagenet.py`,
`data/vg.py`) and their factory names against the JAX package.

Each fixture is written once by the port's `synthetic.make_vg_dataset` /
`make_imagenet_devkit` and copied, so each package reads the same files
under a root of its own (the imdbs cache their index and roidb under the
root). Roidbs (synonyms, split caps and bases, attributes and their cap of
16, deduplicated relations, the degenerate-box fallback, the flat
vocabulary and bare-id split lines) and every AP (`vg_eval`,
`evaluate_attributes`, ImageNet's `evaluate_detections`) are held exactly:
both packages run the same numpy on the same parsed values.
"""

import os
import pickle
import shutil

import numpy as np
import pytest

from rlobjectdetection_tpu.data import factory as jax_factory
from rlobjectdetection_tpu.data import vg as jax_vg_mod
from rlobjectdetection_tpu.data.imagenet import imagenet as jax_imagenet
from rlobjectdetection_tpu.data.vg import vg as jax_vg
from rlobjectdetection_tpu.data.vg import vg_eval as jax_vg_eval
from rlobjectdetection_tpu_torch.data import factory, synthetic
from rlobjectdetection_tpu_torch.data import vg as vg_mod
from rlobjectdetection_tpu_torch.data.imagenet import imagenet
from rlobjectdetection_tpu_torch.data.vg import vg, vg_eval
from test_torch_data import data_dir
import torch_threads  # noqa: F401  (xdist workers share the cores)

VERSION = "150-50-20"


def _twin(tmp_path_factory, name, make):
    """(port root, JAX root): one fixture, written once, copied."""
    port = tmp_path_factory.mktemp(f"{name}_port")
    make(str(port))
    jax_root = tmp_path_factory.mktemp(f"{name}_jax")
    shutil.copytree(port, jax_root, dirs_exist_ok=True)
    return port, jax_root


@pytest.fixture(scope="module")
def vg_roots(tmp_path_factory):
    return _twin(tmp_path_factory, "vg", lambda r: synthetic.make_vg_dataset(
        r, num_images=6, image_size=(96, 128), version=VERSION,
        splits=("train", "val", "test"), max_attributes=20))


@pytest.fixture(scope="module")
def vg_flat_roots(tmp_path_factory):
    """The flat `objects_vocab_<N>.txt` and bare image ids on the split
    lines, no attribute or relation vocabulary."""
    def make(root):
        synthetic.make_vg_dataset(root, num_images=4, image_size=(80, 96), version="150-50-20",
                                  splits=("val",))
        g = os.path.join(root, "genome")
        shutil.move(os.path.join(g, "150-50-20", "objects_vocab.txt"),
                     os.path.join(g, "objects_vocab_150.txt"))
        shutil.rmtree(os.path.join(g, "150-50-20"))
        for k, name in enumerate(sorted(os.listdir(os.path.join(root, "vg", "VG_100K")))):
            os.makedirs(os.path.join(g, "images"), exist_ok=True)
            shutil.copy(os.path.join(root, "vg", "VG_100K", name), os.path.join(g, "images"))
        with open(os.path.join(g, "val.txt")) as f:
            ids = [ln.split()[1].split("/")[1][:-4] for ln in f if ln.strip()]
        with open(os.path.join(g, "minival.txt"), "w") as f:
            f.write("\n".join(ids) + "\n")
    return _twin(tmp_path_factory, "vg_flat", make)


@pytest.fixture(scope="module")
def imagenet_roots(tmp_path_factory):
    return _twin(tmp_path_factory, "imagenet", lambda r: synthetic.make_imagenet_devkit(
        r, num_images=6, image_size=(90, 120), num_synsets=12))


def _same_roidb(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


def _relative(paths, root):
    return [os.path.relpath(p, root) for p in paths]


def _build(cls, root, *args, **kw):
    with data_dir(root):
        db = cls(*args, **kw)
        return db, db.gt_roidb()


@pytest.mark.parametrize("split", ["val", "minival", "test"])
def test_vg_roidb_matches_jax(vg_roots, split, monkeypatch):
    """minival runs on val.txt capped (the cap set to 4 in both packages
    here, so the 6-image fixture is cut); test has a split file of its own."""
    monkeypatch.setitem(vg_mod.SPLIT_CAPS, "minival", 4)
    monkeypatch.setitem(jax_vg_mod.SPLIT_CAPS, "minival", 4)
    port, jroot = vg_roots
    db, got = _build(vg, port, VERSION, split)
    jdb, want = _build(jax_vg, jroot, VERSION, split)
    assert db.num_images == jdb.num_images == (4 if split == "minival" else 6)
    assert db.classes == jdb.classes and len(db.classes) == 151
    assert db.attributes == jdb.attributes and db.relations == jdb.relations
    assert db._class_to_ind == jdb._class_to_ind and "object3syn" in db._class_to_ind
    assert db.image_index == jdb.image_index
    assert _relative([db.image_path_at(i) for i in range(db.num_images)], port) == \
        _relative([jdb.image_path_at(i) for i in range(jdb.num_images)], jroot)
    assert "VG_100K_2" in db.image_path_at(1)
    _same_roidb(got, want)
    assert any((e["boxes"][:, 2] - e["boxes"][:, 0] == 127).any() for e in got)  # fallback
    assert max(int((e["gt_attributes"] > 0).sum(1).max()) for e in got) == 16
    assert all(len(e["gt_relations"]) == 1 for e in got)


def test_vg_index_cache_is_read_back(vg_roots):
    """A second imdb of the same split reads the cached index and id→dir map."""
    port, _ = vg_roots
    first, _ = _build(vg, port, VERSION, "val")
    again, _ = _build(vg, port, VERSION, "val")
    assert again.image_index == first.image_index and again._id_to_dir == first._id_to_dir


def test_vg_flat_vocab_and_bare_ids_match_jax(vg_flat_roots):
    port, jroot = vg_flat_roots
    db, got = _build(vg, port, "150-50-20", "minival")
    jdb, want = _build(jax_vg, jroot, "150-50-20", "minival")
    assert db.classes == jdb.classes and len(db.classes) == 151
    assert db.attributes == jdb.attributes == ["__no_attribute__"]
    assert db.image_index == jdb.image_index and db.num_images == 4
    assert _relative([db.image_path_at(i) for i in range(4)], port) == \
        _relative([jdb.image_path_at(i) for i in range(4)], jroot)
    _same_roidb(got, want)


def _detections(roidb, num_classes, rng, classes_of):
    """all_boxes[c][i]: each gt of class c as a detection (jittered by a
    pixel or two, scores spread), and false positives in random classes."""
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in roidb] for _ in range(num_classes)]
    for i, e in enumerate(roidb):
        for b, cs in zip(e["boxes"].astype(np.float32), classes_of(e)):
            for c in cs:
                d = np.r_[b + rng.randint(-2, 3, 4), rng.rand()].astype(np.float32)
                all_boxes[c][i] = np.vstack([all_boxes[c][i], d])
        for c in rng.randint(1, num_classes, 3):
            x, y = rng.randint(0, 60, 2)
            d = np.array([[x, y, x + 20, y + 15, rng.rand()]], np.float32)
            all_boxes[c][i] = np.vstack([all_boxes[c][i], d])
    return all_boxes


def _pr_tables(out_dir, classes):
    out = {}
    for c in classes[1:]:
        with open(os.path.join(out_dir, c + "_pr.pkl"), "rb") as f:
            out[c] = pickle.load(f)
    return out


def test_vg_eval_and_attributes_match_jax(vg_roots, tmp_path):
    port, jroot = vg_roots
    db, roidb = _build(vg, port, VERSION, "val")
    jdb, _ = _build(jax_vg, jroot, VERSION, "val")
    rng = np.random.RandomState(5)
    dets = _detections(roidb, db.num_classes, rng, lambda e: [[c] for c in e["gt_classes"]])
    atts = _detections(roidb, len(db.attributes), rng,
                       lambda e: [[a for a in row if a] for row in e["gt_attributes"]])
    for name, boxes, classes, port_fn, jax_fn in (
            ("det", dets, db.classes, db.evaluate_detections, jdb.evaluate_detections),
            ("att", atts, db.attributes, db.evaluate_attributes, jdb.evaluate_attributes)):
        pd, jd = str(tmp_path / f"{name}_port"), str(tmp_path / f"{name}_jax")
        with data_dir(port):
            got = port_fn(boxes, pd)
        with data_dir(jroot):
            want = jax_fn(boxes, jd)
        assert got == want and 0.0 < got < 1.0
        for c, w in _pr_tables(jd, classes).items():
            g = _pr_tables(pd, [None, c])[c]
            assert g["ap"] == w["ap"] and g["npos"] == w["npos"], c
            for k in ("rec", "prec", "scores"):
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{c} {k}")
        kind = "object" if name == "det" else "attribute"
        assert open(os.path.join(pd, f"{kind}_thresholds_val.txt")).read() == \
            open(os.path.join(jd, f"{kind}_thresholds_val.txt")).read()
    det_file = os.path.join(str(tmp_path / "det_port"), f"detections_val_{db.classes[5]}.txt")
    for a, b in zip(vg_eval(det_file, roidb, db.image_index, 5),
                    jax_vg_eval(det_file, roidb, db.image_index, 5)):
        np.testing.assert_array_equal(a, b)


def test_vg_gt_as_detections_gives_mean_ap_1(vg_roots, tmp_path):
    port, _ = vg_roots
    db, roidb = _build(vg, port, VERSION, "val")
    all_boxes = [[np.zeros((0, 5), np.float32) for _ in roidb] for _ in range(db.num_classes)]
    for i, e in enumerate(roidb):
        for b, c in zip(e["boxes"], e["gt_classes"]):
            all_boxes[c][i] = np.vstack([all_boxes[c][i], np.r_[b, 0.9].astype(np.float32)])
    with data_dir(port):
        assert vg_mod.vg_eval_all(db, all_boxes, str(tmp_path)) == 1.0


def test_imagenet_roidb_and_ap_match_jax(imagenet_roots, tmp_path):
    port, jroot = imagenet_roots
    db, got = _build(imagenet, port, "val")
    jdb, want = _build(jax_imagenet, jroot, "val")
    assert db.classes == jdb.classes and db.num_classes == 13
    assert db._wnid == jdb._wnid and db.image_index == jdb.image_index
    assert _relative([db.image_path_at(i) for i in range(6)], port) == \
        _relative([jdb.image_path_at(i) for i in range(6)], jroot)
    _same_roidb(got, want)
    dets = _detections(got, db.num_classes, np.random.RandomState(6),
                       lambda e: [[c] for c in e["gt_classes"]])
    with data_dir(port):
        ap = db.evaluate_detections(dets, str(tmp_path / "port"))
    with data_dir(jroot):
        assert ap == jdb.evaluate_detections(dets, str(tmp_path / "jax"))
    assert 0.0 < ap < 1.0
    gt = [[np.zeros((0, 5), np.float32) for _ in got] for _ in range(db.num_classes)]
    for i, e in enumerate(got):
        for b, c in zip(e["boxes"], e["gt_classes"]):
            gt[c][i] = np.vstack([gt[c][i], np.r_[b, 0.9].astype(np.float32)])
    with data_dir(port):
        assert db.evaluate_detections(gt, None) == 1.0


def test_factory_names_equal_jax(imagenet_roots):
    names = factory.list_imdbs()
    assert names == jax_factory.list_imdbs()
    assert sum(n.startswith("vg_") for n in names) == 42
    assert [n for n in names if n.startswith("imagenet_")] == [
        f"imagenet_{s}" for s in ("train", "val", "val1", "val2", "test")]
    with data_dir(imagenet_roots[0]):
        assert factory.get_imdb("imagenet_val").num_images == 6
    with pytest.raises(KeyError):
        factory.get_imdb("vg_1600-400-20_nosuchsplit")
