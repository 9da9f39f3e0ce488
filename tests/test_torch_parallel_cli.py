"""Data parallelism's loader, launcher rules, CLI and dry run on the CPU
(the steps themselves: `test_torch_parallel.py`).

- `HostShardLoader`'s rows against the full assembly (bitwise) and against
  the JAX package's `HostShardLoader` (plan, canvas, im_info, gt equal;
  pixels at the resize bound of `test_torch_data.py`);
- the RL CLI's `RLShardLoader` against `shard_rl_batch` of the full
  assembly (bitwise), ragged final batches included;
- `host_local_batch_slice` and the launcher-environment rule;
- `trainval_net` over two processes (`--dist_*`, gloo) against one process,
  and its rank-0 checkpoint loaded into a model outside any group; the
  same with `--packed_input` into a new directory, which one rank packs;
- `python -m rlobjectdetection_tpu_torch.parallel.dryrun 2 --device cpu`.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rlobjectdetection_tpu.data import loader as jax_loader
from rlobjectdetection_tpu.data.imdb import rank_roidb_ratio as jax_rank_roidb_ratio
from PIL import Image

from rlobjectdetection_tpu_torch.config import Config, RLConfig, TrainConfig
from rlobjectdetection_tpu_torch.data import imdb, loader, rl_coco, synthetic
from rlobjectdetection_tpu_torch.engine.checkpoint import (checkpoint_path, load_checkpoint,
                                                            read_checkpoint)
from rlobjectdetection_tpu_torch.engine.trainval_rl import (RLShardLoader, shard_rl_batch,
                                                           train_arrays)
from rlobjectdetection_tpu_torch.models import FasterRCNN
from rlobjectdetection_tpu_torch.models.rl import Action
from rlobjectdetection_tpu_torch.parallel import distributed
from rlobjectdetection_tpu_torch.parallel.dryrun import free_port
from test_torch_data import VOC_CLASSES, _assert_batches_equal, _hand_roidb
import torch_threads  # noqa: F401  (xdist workers share the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_CLASSES = 21
PARAM_REL = 1e-5
CFG = Config(TRAIN=TrainConfig(RPN_PRE_NMS_TOP_N=256, RPN_POST_NMS_TOP_N=64, BATCH_SIZE=32),
             DTYPE="float32", NMS_TILE=64, ANCHOR_SCALES=(4, 8, 16, 32))


# -- the sliced loader ---------------------------------------------------------------------


def test_host_shard_loader_rows_match_the_full_assembly_and_jax(tmp_path):
    """Batch 4 as 2 ranks × 2 over two epochs of the hand roidb (tall,
    straddle and wide blocks, need_crop images, flipped entries, two
    scales): each rank's rows are the full batch's rows to the bit, on its
    canvas; against the JAX package's HostShardLoader the plans (with the
    canvas) and batches are equal."""
    sizes = [(200, 160), (160, 200), (100, 400), (400, 100), (120, 150), (150, 120),
             (90, 300), (300, 90)]
    roidb = _hand_roidb(tmp_path, sizes)
    ratio_list, ratio_index = imdb.rank_roidb_ratio(roidb)
    jratio, jindex = jax_rank_roidb_ratio([dict(e) for e in roidb])
    kw = dict(scales=(64, 96), max_num_gt=5, seed=3)
    full = loader.RoiBatchLoader(roidb, ratio_list, ratio_index, 4, **kw)
    jfull = jax_loader.RoiBatchLoader(roidb, jratio, jindex, 4, **kw)
    for epoch in (0, 1):
        full.set_epoch(epoch)
        whole = {tuple(j[0]): full.assemble_job(j) for j in full.batch_plan()}
        for rank in (0, 1):
            start, size = distributed.host_local_batch_slice(4, 2, rank)
            shard = loader.HostShardLoader(full, start, size)
            jshard = jax_loader.HostShardLoader(jfull, start, size)
            shard.set_epoch(epoch)
            jfull.set_epoch(epoch)
            plan = shard.batch_plan()
            assert plan == jshard.batch_plan()
            for job, (idxs, batch) in zip(plan, whole.items()):
                got = shard.assemble_job(job)
                assert got["data"].shape[1:3] == job[3] == batch["data"].shape[1:3]
                for k in batch:
                    assert np.array_equal(got[k], batch[k][start:start + size]), k
                _assert_batches_equal(got, jshard.assemble_job(job))


def _rl_set(root):
    """5 synthetic COCO images, two turned upright (their json sizes
    swapped), and jittered detections of their gt, one image with 18 (two
    detection axes: 16 and 32 slots)."""
    ann = synthetic.make_coco_dataset(str(root), num_images=5, split="val", year="2014",
                                      image_size=(72, 96))
    img_dir = os.path.join(str(root), "coco", "images", "val2014")
    with open(ann) as f:
        gt = json.load(f)
    for im in gt["images"][1::2]:
        path = os.path.join(img_dir, im["file_name"])
        Image.open(path).transpose(Image.Transpose.ROTATE_90).save(path)
        im["width"], im["height"] = im["height"], im["width"]
    with open(ann, "w") as f:
        json.dump(gt, f)
    rng = np.random.RandomState(0)
    dets, many = [], gt["images"][2]["id"]
    for a in gt["annotations"]:
        copies = 18 if a["image_id"] == many else 1
        many = None if copies > 1 else many
        for _ in range(copies):
            b = np.asarray(a["bbox"]) + np.r_[rng.randn(2) * 2, 0.0, 0.0]
            dets.append({"image_id": a["image_id"], "category_id": a["category_id"],
                         "bbox": [float(v) for v in b], "score": 0.8})
    dt_file = os.path.join(str(root), "dets.json")
    with open(dt_file, "w") as f:
        json.dump(dets, f)
    cfg = RLConfig()
    return rl_coco.COCODataset(img_dir, ann, dt_file,
                               Action(list(cfg.act_delta), wtrans=cfg.act_wtrans),
                               transform_fn=rl_coco.COCOTransform([40, 64], 96, flip=True),
                               normalize_mean=cfg.normalize_mean,
                               normalize_std=cfg.normalize_std)


@pytest.mark.parametrize("size", [2, 3])
def test_rl_shard_loader_rows_match_shard_rl_batch_of_the_full_assembly(tmp_path, size):
    """Batch 4 of 5 images over two epochs (a ragged final batch of 1: a
    rank with no image steps on a zero one): each rank reads only its
    images, yet its arrays equal `shard_rl_batch` of the whole batch's to
    the bit, on the whole batch's canvas and detection axis."""
    dataset = _rl_set(tmp_path)
    full = rl_coco.COCODataLoader(dataset, 4, shuffle=True)
    slots = set()
    for epoch in (0, 1):
        full.set_epoch(epoch)
        jobs = full.batch_plan()
        whole = [train_arrays(full.assemble_job(j)) for j in jobs]
        slots.update(w["bboxes"].shape[1] for w in whole)
        for job, batch in zip(jobs, whole):
            pad_hw, max_n, num_dts = full.predict_job(job)
            assert (pad_hw, max_n) == (batch["data"].shape[1:3], batch["bboxes"].shape[1])
            assert np.array_equal(num_dts, batch["num_dts"])
        for rank in range(size):
            shard = RLShardLoader(full, rank, size)
            shard.set_epoch(epoch)
            plan = shard.batch_plan()
            assert len(plan) == len(whole) == 2
            for job, batch in zip(plan, whole):
                got, want = shard.assemble_job(job), shard_rl_batch(batch, rank, size)
                assert got.keys() == want.keys()
                for k, v in want.items():
                    assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (k, rank)
    assert slots == {16, 32}


def test_host_local_batch_slice_raises_on_a_batch_that_does_not_divide():
    assert distributed.host_local_batch_slice(6, 3, 2) == (4, 2)
    assert distributed.host_local_batch_slice(5) == (0, 5)      # no group: the whole batch
    with pytest.raises(ValueError, match="does not divide by 2"):
        distributed.host_local_batch_slice(3, 2, 0)


def test_batch_helpers_without_a_group_keep_the_whole_batch():
    batch = {"data": np.arange(12, dtype=np.float32).reshape(4, 3), "n": np.arange(4)}
    for shard in (distributed.shard_global_batch, distributed.shard_local_batch):
        got = shard(batch, torch.device("cpu"))
        assert all(torch.equal(got[k], torch.from_numpy(v)) for k, v in batch.items())
    assert distributed.fetch_scalar(torch.tensor(2.5)) == 2.5
    assert (distributed.process_count(), distributed.process_index()) == (1, 0)


@pytest.mark.parametrize("env,missing", [
    ({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1"}, "MASTER_ADDR, MASTER_PORT"),
    ({"WORLD_SIZE": "2", "MASTER_ADDR": "h", "MASTER_PORT": "1"}, "RANK, LOCAL_RANK"),
    ({"SLURM_PROCID": "0", "SLURM_NTASKS": "4", "MASTER_ADDR": "h", "MASTER_PORT": "1"},
     "SLURM_LOCALID"),
    ({"OMPI_COMM_WORLD_RANK": "0"}, "OMPI_COMM_WORLD_SIZE"),
])
def test_a_partial_launcher_environment_raises(env, missing):
    with pytest.raises(ValueError, match=missing):
        distributed.launcher_env(env)


def test_a_whole_launcher_environment_makes_a_group_and_none_makes_none():
    env = {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1", "MASTER_ADDR": "h",
           "MASTER_PORT": "29500"}
    assert distributed.launcher_env(env) == dict(rank=1, size=2, local_rank=1,
                                                 coordinator="h:29500")
    assert distributed.launcher_env({}) is None
    assert distributed.launcher_env({"SLURM_PROCID": "0", "SLURM_NTASKS": "1"}) is None
    with pytest.raises(ValueError, match="needs all of"):
        distributed.plan_group(None, 2, None, env={})


# -- the CLI and the dry run ---------------------------------------------------------------


def _cli(root, save_dir, procs, extra=()):
    env = dict(os.environ, RLOD_DATA_DIR=str(root), PYTHONPATH=REPO)
    args = [sys.executable, "-m", "rlobjectdetection_tpu_torch.engine.trainval_net",
            "--dataset", "pascal_voc", "--net", "tiny", "--epochs", "1", "--bs", "2",
            "--nw", "0", "--save_dir", str(save_dir), "--device", "cpu"]
    tail = ["--set",
            "TRAIN.SCALES", "[96]", "TRAIN.RPN_PRE_NMS_TOP_N", "256",
            "TRAIN.RPN_POST_NMS_TOP_N", "64", "TRAIN.BATCH_SIZE", "32", "DTYPE", "float32",
            "NMS_TILE", "64", "ANCHOR_SCALES", "(4,8,16,32)"]
    return [subprocess.Popen(args + list(extra) + list(p) + tail, cwd=REPO, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for p in procs]


def _wait(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def test_trainval_net_two_processes_match_one_and_the_checkpoint_loads_alone(tmp_path):
    """An epoch of the synthetic VOC trainval (4 images and their flips, 4
    steps at batch 2)
    over two `--dist_*` processes on gloo and in one process: the ranks'
    checkpoint (rank 0's) holds every parameter within 1e-5 of each
    tensor's largest of the one-process run's, and loads into a model
    outside any group."""
    root = tmp_path / "data"
    synthetic.make_voc_devkit(str(root), num_images=4, image_size=(72, 96),
                              classes=VOC_CLASSES)
    coordinator = f"localhost:{free_port()}"
    dist = [("--dist_coordinator", coordinator, "--dist_nprocs", "2", "--dist_rank", str(r))
            for r in range(2)]
    _wait(_cli(root, tmp_path / "dp", dist) + _cli(root, tmp_path / "one", [()]))
    path = lambda d: checkpoint_path(str(tmp_path / d), "tiny", "pascal_voc", 1, 1)
    two, one = read_checkpoint(path("dp")), read_checkpoint(path("one"))
    assert two["step"] == one["step"] == 4
    for k, want in one["model"].items():
        assert float((two["model"][k] - want).abs().max()) <= PARAM_REL * float(
            want.abs().max()), k
    model = FasterRCNN(NUM_CLASSES, "tiny", CFG, device="cpu")
    load_checkpoint(path("dp"), model)
    assert all(torch.equal(v, two["model"][k]) for k, v in model.state_dict().items())


def test_trainval_net_packed_input_over_two_processes_packs_once(tmp_path):
    """`--packed_input` into a new directory over two `--dist_*` processes:
    rank 0 packs while rank 1 waits (it prints no pack line), and the run
    equals the one-process live run within 1e-5 of each tensor's
    largest (the packed batches are the live ones to the bit)."""
    root = tmp_path / "data"
    synthetic.make_voc_devkit(str(root), num_images=4, image_size=(72, 96),
                              classes=VOC_CLASSES)
    coordinator = f"localhost:{free_port()}"
    dist = [("--dist_coordinator", coordinator, "--dist_nprocs", "2", "--dist_rank", str(r))
            for r in range(2)]
    procs = _cli(root, tmp_path / "dp", dist, ("--packed_input", str(tmp_path / "pack")))
    outs = _wait(procs + _cli(root, tmp_path / "one", [()]))
    assert ["pack: " in out for out in outs[:2]] == [True, False], outs[1][-2000:]
    assert not [n for n in os.listdir(tmp_path / "pack") if n.endswith(".tmp")]
    path = lambda d: checkpoint_path(str(tmp_path / d), "tiny", "pascal_voc", 1, 1)
    two, one = read_checkpoint(path("dp")), read_checkpoint(path("one"))
    assert two["step"] == one["step"] == 4
    for k, want in one["model"].items():
        assert float((two["model"][k] - want).abs().max()) <= PARAM_REL * float(
            want.abs().max()), k


def test_dryrun_two_ranks_on_the_cpu_exits_0():
    out = subprocess.run([sys.executable, "-m", "rlobjectdetection_tpu_torch.parallel.dryrun",
                          "2", "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "restores into one process" in out.stdout
