"""The port's pre-packed input (`data/packed.py`) against its live loader
and the JAX package's pack and packed loader, and `--packed_input` in both
CLIs.

The fixture is the JAX package's `tests/test_packed.py` roidb: tall, wide,
extreme (a crop either way) and square images, every other one flipped, at
scales 100 and 140. Held exactly: the pack's keys, `pack_index.json`, each
`.npy` header, and every batch (the port's packed loader against its live
loader over several epochs, against JAX's packed loader on the same pack,
and JAX's packed loader reading the port's pack). The pixels of the two
packages' packs are each package's resize: cv2's INTER_LINEAR in JAX, a
numpy INTER_LINEAR in the port, which rounds in another order; they are
held to `test_torch_ops.py::test_prep_im_for_blob_matches_jax`'s bound
for that resize (rtol 1e-4, atol 1e-3).
"""

import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from rlobjectdetection_tpu.data.packed import PackedRoiBatchLoader as JaxPackedRoiBatchLoader
from rlobjectdetection_tpu.data.packed import pack_roidb as jax_pack_roidb
from rlobjectdetection_tpu_torch.data import synthetic
from rlobjectdetection_tpu_torch.data.imdb import rank_roidb_ratio
from rlobjectdetection_tpu_torch.data.loader import RoiBatchLoader
from rlobjectdetection_tpu_torch.data.packed import (PackedImageStore, PackedRoiBatchLoader,
                                                     pack_roidb)
from rlobjectdetection_tpu_torch.engine import test_net, trainval_net
from test_torch_data import VOC_CLASSES, data_dir
import torch_threads  # noqa: F401  (xdist workers share the cores)

SCALES = (100, 140)
KEYS = ("data", "im_info", "gt_boxes", "num_boxes")
RESIZE_RTOL, RESIZE_ATOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(roidb, port pack root, JAX pack root)."""
    root = tmp_path_factory.mktemp("packed")
    rng = np.random.RandomState(7)
    roidb = []
    shapes = [(200, 160), (160, 200), (100, 400), (400, 100), (240, 240),
              (120, 300), (300, 120), (180, 220)]
    for i, (h, w) in enumerate(shapes):
        p = str(root / f"i{i}.jpg")
        Image.fromarray(rng.randint(0, 255, (h, w, 3), dtype=np.uint8)).save(p)
        roidb.append({"image": p, "flipped": i % 2 == 1,
                      "boxes": np.array([[5, 5, w // 2, h // 2]], dtype=np.uint16),
                      "gt_classes": np.array([1], dtype=np.int32),
                      "width": w, "height": h,
                      "need_crop": int(max(h, w) / min(h, w) > 2)})
    port, jax_root = str(root / "port_pack"), str(root / "jax_pack")
    pack_roidb(roidb, SCALES, port, verbose=False)
    jax_pack_roidb(roidb, SCALES, jax_root, verbose=False)
    return roidb, port, jax_root


def _loader(cls, roidb, training, batch_size=4, **kw):
    ratio_list, ratio_index = rank_roidb_ratio(roidb)
    return cls(roidb, ratio_list, ratio_index, batch_size, scales=SCALES, max_num_gt=5,
               seed=11, training=training, **kw)


def _same_batches(a, b, epochs=(1, 2, 3)):
    n = 0
    for epoch in epochs:
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        for x, y in zip(a, b):
            for k in KEYS:
                assert x[k].dtype == y[k].dtype, k
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            n += 1
    assert n >= len(epochs)


def _header(path):
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        np.lib.format._read_array_header(f, version)
        return f.tell(), open(path, "rb").read(f.tell())


def test_pack_index_and_headers_match_jax(fixture):
    roidb, port, jax_root = fixture
    with open(os.path.join(port, "pack_index.json"), "rb") as a, \
            open(os.path.join(jax_root, "pack_index.json"), "rb") as b:
        assert a.read() == b.read()
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(jax_root)) and len(names) == 2 * len(roidb) + 1
    for name in names:
        if not name.endswith(".npy"):
            continue
        mine, theirs = os.path.join(port, name), os.path.join(jax_root, name)
        assert _header(mine) == _header(theirs)
        assert os.path.getsize(mine) == os.path.getsize(theirs)
        np.testing.assert_allclose(np.load(mine), np.load(theirs), rtol=RESIZE_RTOL,
                                   atol=RESIZE_ATOL)


@pytest.mark.parametrize("training,batch_size", [(True, 4), (False, 3)])
def test_packed_batches_are_the_live_batches(fixture, training, batch_size):
    roidb, port, _ = fixture
    _same_batches(_loader(RoiBatchLoader, roidb, training, batch_size),
                  _loader(PackedRoiBatchLoader, roidb, training, batch_size, pack_root=port))


@pytest.mark.parametrize("pack", ["jax", "port"])
def test_packed_loader_gives_the_jax_packed_batches(fixture, pack):
    """Both packed loaders over one pack (JAX's, or the port's read by JAX's
    loader): the same batches after each set_epoch, crops and straddle
    squares included."""
    roidb, port, jax_root = fixture
    root = jax_root if pack == "jax" else port
    _same_batches(_loader(PackedRoiBatchLoader, roidb, True, pack_root=root),
                  _loader(JaxPackedRoiBatchLoader, roidb, True, pack_root=root))


def test_store_refuses_what_is_not_packed_and_packs_only_what_is_new(fixture, capsys):
    roidb, port, _ = fixture
    store = PackedImageStore(port)
    with pytest.raises(KeyError):
        store.get(roidb[0]["image"], bool(roidb[0]["flipped"]), 999)
    arr, im_scale = store.get(roidb[0]["image"], bool(roidb[0]["flipped"]), SCALES[0])
    assert im_scale > 0
    with pytest.raises(ValueError):
        arr[0, 0, 0] = 1.0                          # a read-only mmap view
    pack_roidb(roidb, SCALES, port)
    assert "packed 0 new arrays" in capsys.readouterr().out


# -- the CLIs at `tiny` on the CPU ------------------------------------------------

SET = ["TRAIN.RPN_PRE_NMS_TOP_N", "256", "TRAIN.RPN_POST_NMS_TOP_N", "64",
       "TRAIN.BATCH_SIZE", "32", "TRAIN.SCALES", "[96]", "TEST.RPN_PRE_NMS_TOP_N", "128",
       "TEST.RPN_POST_NMS_TOP_N", "32", "TEST.SCALES", "[96]", "TEST.MAX_DETS_PER_IMAGE", "10",
       "ANCHOR_SCALES", "(2,3,5)", "DTYPE", "float32", "NMS_TILE", "64"]


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("packed_voc")
    synthetic.make_voc_devkit(str(root), num_images=4, image_size=(72, 112),
                              classes=VOC_CLASSES)
    return root


def _in(work, root, fn, argv):
    cwd = os.getcwd()
    os.makedirs(work, exist_ok=True)
    os.chdir(work)
    try:
        with data_dir(root):
            return fn(argv)
    finally:
        os.chdir(cwd)


def test_trainval_net_packed_input_trains_as_the_live_loader(voc_root, tmp_path):
    """An epoch at batch 2 with flipped copies: the packed run's checkpoint
    is the live run's, tensor for tensor, to the bit."""
    states = []
    for name, extra in (("live", []), ("packed", ["--packed_input", str(tmp_path / "pack")])):
        out = _in(tmp_path / name, voc_root, trainval_net.main, [
            "--dataset", "pascal_voc", "--net", "tiny", "--epochs", "1", "--bs", "2",
            "--nw", "2", "--save_dir", str(tmp_path / name / "models"), "--device", "cpu",
            *extra, "--set", *SET])
        assert out["step"] == 4
        states.append(torch.load(out["checkpoints"][-1], weights_only=False)["model"])
    assert sorted(os.listdir(tmp_path / "pack"))[-1] == "pack_index.json"
    assert states[0].keys() == states[1].keys()
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k


def test_test_net_packed_input_gives_the_live_detections(voc_root, tmp_path):
    boxes = []
    for name, extra in (("live", []), ("packed", ["--packed_input", str(tmp_path / "pack")])):
        mean_ap = _in(tmp_path / name, voc_root, test_net.main, [
            "--dataset", "pascal_voc", "--net", "tiny", "--device", "cpu", *extra,
            "--set", *SET])
        with open(tmp_path / name / "output" / "tiny" / "voc_2007_test" / "detections.pkl",
                  "rb") as f:
            boxes.append((pickle.load(f), mean_ap))
    (live, live_ap), (packed, packed_ap) = boxes
    assert packed_ap == live_ap
    for j in range(len(live)):
        for i in range(len(live[j])):
            np.testing.assert_array_equal(packed[j][i], live[j][i])
