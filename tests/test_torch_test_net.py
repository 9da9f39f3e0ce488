"""The port's eval entry point (`engine/test_net.py`) end to end on the CPU
against the JAX package.

A ResNet-50 detector (21 VOC classes, f32) is initialised by the JAX
package at 96 px, its frozen-BN statistics moved off the identity and its
RPN outputs scaled down (`test_torch_model._perturbed`), and written with
`save_net_npz`. The port's CLI reads it with `--load_npz` and evaluates a
synthetic VOC test split of 4 images at `TEST.SCALES [96]` with the
`--set` flags of the detector surface, at `--batch 1` and `--batch 2`.

The reference is JAX `FasterRCNN.apply` + `postprocess_detections` +
`detections_to_all_boxes`, fed the port loader's blobs (so the resize's
1e-3 gap between cv2 and the port's numpy does not blur the detector
comparison), scored by the JAX `pascal_voc.evaluate_detections` on an
identical devkit. Bounds: detections.pkl within rtol 1e-4, atol 1e-4
(`test_torch_model.py`'s bound for the detector); the AP table within
1e-6; `--batch 2` gives the `--batch 1` detections (rtol 1e-5, atol
5e-5: f32 summation order). `detect_loop` at batch 2 hands each row's
blob, im_info and detections to its own image, exactly. The same weights
as a `trainval_net` checkpoint (`--load_dir`, `--s`, `--checksession`,
`--checkepoch`) or as converted weights (`--weights`) give the `--load_npz`
run's detections, exactly; `--packed_input` still exits, naming its item.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import traverse_util

from rlobjectdetection_tpu.config import DATASET_OVERRIDES as JAX_DATASET_OVERRIDES
from rlobjectdetection_tpu.config import Config as JaxConfig
from rlobjectdetection_tpu.config import cfg_from_list as jax_cfg_from_list
from rlobjectdetection_tpu.config import cfg_update as jax_cfg_update
from rlobjectdetection_tpu.data import synthetic as jax_synthetic
from rlobjectdetection_tpu.data.pascal_voc import pascal_voc as jax_pascal_voc
from rlobjectdetection_tpu.engine.checkpoint import save_net_npz
from rlobjectdetection_tpu.engine.detect import detections_to_all_boxes as jax_all_boxes
from rlobjectdetection_tpu.engine.detect import postprocess_detections as jax_postprocess
from rlobjectdetection_tpu.models import FasterRCNN as JaxFasterRCNN
from rlobjectdetection_tpu_torch.data import synthetic
from rlobjectdetection_tpu_torch.data.imdb import combined_roidb
from rlobjectdetection_tpu_torch.data.loader import RoiBatchLoader
from rlobjectdetection_tpu_torch.engine import test_net
from test_torch_data import VOC_CLASSES, data_dir
from test_torch_model import _perturbed

# the detector surface's --set flags, at 96 px
SET = ["TEST.RPN_PRE_NMS_TOP_N", "128", "TEST.RPN_POST_NMS_TOP_N", "32", "TEST.SCALES",
       "[96]", "TEST.MAX_DETS_PER_IMAGE", "10", "ANCHOR_SCALES", "(2,3,5)", "DTYPE",
       "float32", "NMS_TILE", "64"]
DET_RTOL = DET_ATOL = 1e-4
AP_TOL = 1e-6
BATCH_RTOL, BATCH_ATOL = 1e-5, 5e-5


def _ap_table(out_dir):
    return {c: pickle.load(open(os.path.join(out_dir, c + "_pr.pkl"), "rb"))["ap"]
            for c in VOC_CLASSES}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Both devkits, the npz, and the JAX reference's all_boxes and AP table."""
    jroot, proot = tmp_path_factory.mktemp("jax_voc"), tmp_path_factory.mktemp("port_voc")
    for module, root in ((jax_synthetic, jroot), (synthetic, proot)):
        module.make_voc_devkit(str(root), num_images=4, image_size=(72, 96),
                               classes=VOC_CLASSES)
    jcfg = jax_cfg_from_list(jax_cfg_update(JaxConfig(), JAX_DATASET_OVERRIDES["pascal_voc"]),
                             SET)
    jmodel = JaxFasterRCNN(num_classes=21, backbone="resnet50", cfg=jcfg)
    variables = jax.jit(jmodel.init, static_argnames="train")(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 96, 128, 3), jnp.float32),
        jnp.asarray([[96.0, 128.0, 1.0]]), train=False)
    flat = _perturbed(variables["params"], np.random.RandomState(7))
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()},
                                          sep="/")
    npz = str(tmp_path_factory.mktemp("npz") / "res50.npz")
    save_net_npz(npz, params)

    fwd = jax.jit(lambda d, i: jmodel.apply({"params": params}, d, i, train=False))
    post = jax.jit(lambda r, c, b, i, v: jax_postprocess(
        r, c, b, i, v, num_classes=21, max_per_image=jcfg.TEST.MAX_DETS_PER_IMAGE,
        nms_thresh=jcfg.TEST.NMS, bbox_reg=jcfg.TEST.BBOX_REG,
        normalize_stds=jcfg.TRAIN.BBOX_NORMALIZE_STDS,
        normalize_means=jcfg.TRAIN.BBOX_NORMALIZE_MEANS))
    with data_dir(proot):
        _, roidb, ratio_list, ratio_index = combined_roidb(
            "voc_2007_test", training=False, use_flipped=False)
    dets = []
    for b in RoiBatchLoader(roidb, ratio_list, ratio_index, 1, scales=(96,),
                            training=False):
        out = fwd(jnp.asarray(b["data"]), jnp.asarray(b["im_info"]))
        dets.append(jax.device_get(post(out["rois"][0], out["cls_prob"][0],
                                        out["bbox_pred"][0], jnp.asarray(b["im_info"][0]),
                                        out["roi_valid"][0])))
    want_boxes = jax_all_boxes(dets, 21)
    out_dir = str(tmp_path_factory.mktemp("jax_out"))
    with data_dir(jroot):
        db = jax_pascal_voc("test", "2007")
        db.competition_mode(on=True)
        want_map = db.evaluate_detections(want_boxes, out_dir)
    return dict(proot=proot, npz=npz, want_boxes=want_boxes, want_map=want_map,
                want_ap=_ap_table(out_dir))


@pytest.fixture(scope="module")
def cli_runs(setup, tmp_path_factory):
    """batch → (all_boxes from detections.pkl, mean AP, AP table) of the
    port's CLI, each run in a working directory of its own."""
    runs = {}
    cwd = os.getcwd()
    for batch in (1, 2):
        work = tmp_path_factory.mktemp(f"cli_batch{batch}")
        os.chdir(work)
        try:
            with data_dir(setup["proot"]):
                mean_ap = test_net.main([
                    "--dataset", "pascal_voc", "--net", "res50", "--device", "cpu",
                    "--load_npz", setup["npz"], "--batch", str(batch), "--set", *SET])
        finally:
            os.chdir(cwd)
        out_dir = work / "output" / "res50" / "voc_2007_test"
        with open(out_dir / "detections.pkl", "rb") as f:
            runs[batch] = pickle.load(f), mean_ap, _ap_table(str(out_dir))
    return runs


@pytest.mark.parametrize("batch", [1, 2])
def test_test_net_matches_jax(setup, cli_runs, batch):
    all_boxes, mean_ap, ap = cli_runs[batch]
    want = setup["want_boxes"]
    assert len(all_boxes) == len(want) == 21
    n_dets = 0
    for j in range(21):
        assert len(all_boxes[j]) == len(want[j]) == 4
        for i in range(4):
            assert all_boxes[j][i].shape == want[j][i].shape, (j, i)
            np.testing.assert_allclose(all_boxes[j][i], want[j][i], rtol=DET_RTOL,
                                       atol=DET_ATOL)
            n_dets += len(all_boxes[j][i])
    assert n_dets > 0
    assert abs(mean_ap - setup["want_map"]) <= AP_TOL
    for c in VOC_CLASSES:
        assert abs(ap[c] - setup["want_ap"][c]) <= AP_TOL, c


def test_batch_2_gives_the_batch_1_detections(cli_runs):
    """The same detections, class by class; coordinates and scores within
    f32 summation order (oneDNN blocks a batch-2 convolution otherwise than
    a batch-1 one: 1.4e-5 at coordinates near 60, measured)."""
    one, two = cli_runs[1][0], cli_runs[2][0]
    for j in range(21):
        for i in range(4):
            assert two[j][i].shape == one[j][i].shape, (j, i)
            np.testing.assert_allclose(two[j][i], one[j][i], rtol=BATCH_RTOL, atol=BATCH_ATOL)


def test_detect_loop_hands_each_row_to_its_image(setup):
    """`detect_loop` at batch 2 on 3 images, so one canvas carries a
    padding row: `on_batch` sees every batch once, each image in one row;
    a row's blob and im_info are its image's own (the batch-1 assembly's,
    on the shared canvas) and its detections are the ones that row's
    outputs give, exactly; the padding row gives no image."""
    from rlobjectdetection_tpu_torch.data.imdb import rank_roidb_ratio
    from rlobjectdetection_tpu_torch.engine.checkpoint import load_net_npz
    from rlobjectdetection_tpu_torch.models import FasterRCNN

    with data_dir(setup["proot"]):
        _, roidb, _, _ = combined_roidb("voc_2007_test", training=False, use_flipped=False)
    roidb = roidb[:3]
    ratio_list, ratio_index = rank_roidb_ratio(roidb)
    cfg = test_net.build_config("pascal_voc", SET)
    model = FasterRCNN(21, "resnet50", cfg, device="cpu")
    load_net_npz(setup["npz"], model)
    seen = []
    dets, stats = test_net.detect_loop(
        model, cfg, roidb, ratio_list, ratio_index, batch=2,
        on_batch=lambda idxs, data, info, out: seen.append((list(idxs), data, info, out)))
    assert sorted(i for idxs, *_ in seen for i in idxs) == [0, 1, 2]
    assert sorted(len(idxs) for idxs, *_ in seen) == [1, 2]
    assert stats["images"] == 3 and stats["wait_s"] >= 0.0
    single = RoiBatchLoader(roidb, ratio_list, ratio_index, 1, scales=(96,), training=False)
    for idxs, data, info, out in seen:
        assert data.shape[0] == info.shape[0] == 2
        packed = test_net.postprocess_batch(model, out, info, len(idxs), cfg).numpy()
        for j, i in enumerate(idxs):
            want = single._assemble([i], 1.0)
            h, w = want["data"].shape[1:3]
            np.testing.assert_array_equal(data[j, :h, :w].numpy(), want["data"][0])
            assert not data[j, h:].any() and not data[j, :, w:].any()
            np.testing.assert_array_equal(info[j].numpy(), want["im_info"][0])
            for got, row in zip(dets[i], test_net.unpack_dets(packed[j])):
                np.testing.assert_array_equal(got, row)
        if len(idxs) == 1:
            assert not data[1].any()


@pytest.mark.parametrize("flag,item", [("--packed_input", "item 17b")])
def test_flags_not_ported_yet_exit_with_their_roadmap_item(flag, item, capsys):
    with pytest.raises(SystemExit) as e:
        test_net.main(["--dataset", "pascal_voc", flag, "x", "--device", "cpu"])
    assert e.value.code == 2 and item in capsys.readouterr().err


@pytest.mark.parametrize("flags,session,epoch", [
    (["--load_dir", "elsewhere"], 1, 1), (["--s", "2"], 2, 1),
    (["--checksession", "3"], 3, 1), (["--checkepoch", "4"], 1, 4), (["--weights"], None, None)])
def test_checkpoint_flags_load_what_they_name(setup, cli_runs, tmp_path, flags, session, epoch):
    """Each flag loads the file it names (`--load_dir` D, else `models`;
    `--s` / `--checksession` S and `--checkepoch` E, else 1:
    `D/res50/pascal_voc/faster_rcnn_S_E.pth`; `--weights` a converted state
    dict merged into the seeded weights): the npz's weights, so the
    `--load_npz` run's detections exactly; the same file elsewhere is not
    found."""
    from rlobjectdetection_tpu_torch.engine.checkpoint import (checkpoint_path, load_net_npz,
                                                                save_checkpoint, save_params)
    from rlobjectdetection_tpu_torch.models import FasterRCNN

    cfg = test_net.build_config("pascal_voc", SET)
    model = load_net_npz(setup["npz"], FasterRCNN(21, "resnet50", cfg, device="cpu"))
    if session is None:
        flags = flags + [save_params(str(tmp_path / "converted.pth"), model.state_dict())]
    else:
        load_dir = flags[1] if flags[0] == "--load_dir" else "models"
        save_checkpoint(checkpoint_path(str(tmp_path / load_dir), "res50", "pascal_voc",
                                        session, epoch), model)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with data_dir(setup["proot"]):
            test_net.main(["--dataset", "pascal_voc", "--net", "res50", "--device", "cpu",
                           *flags, "--set", *SET])
            if session is not None:
                with pytest.raises(FileNotFoundError):
                    test_net.main(["--dataset", "pascal_voc", "--net", "res50", "--device",
                                   "cpu", *flags, "--checkepoch", "9", "--set", *SET])
    finally:
        os.chdir(cwd)
    with open(tmp_path / "output" / "res50" / "voc_2007_test" / "detections.pkl", "rb") as f:
        got = pickle.load(f)
    want = cli_runs[1][0]
    for j in range(21):
        for i in range(4):
            np.testing.assert_array_equal(got[j][i], want[j][i])
