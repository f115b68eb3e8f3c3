"""Data-parallel inference of the port over a device mesh
(``parallel/mesh.py``, ``evaluate_dataset(mesh=)``, ``Predictor(mesh=)``),
the cases of ``tests/test_dp_inference.py`` held on the CPU.

A mesh here names the CPU more than once (2 or 8 replicas in one
process), as the JAX tests force 8 CPU devices. The split is JAX's mini
split (8 pairs of 160x128, one box each), the model the tiny cfg with
``yolo_strides=[8, 4]`` and JAX's ``graph.init(PRNGKey(0))`` weights.
Tolerances, and why:
  * mesh against the port's single-device run: per-image inference needs
    no collective, so the metrics agree within 1e-9 and each image's
    detections within 1e-4 px (boxes) and 1e-5 (scores), the JAX test's
    bounds; a replica's batch size differs from the single run's, which
    may move a conv's summation order;
  * against JAX's mesh run, the port's fp32 math summed in other orders:
    metrics within 1e-4, boxes within 1e-4 px, scores within 1e-5.
"""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_compile_cfg
from double_yolo_kaist_tpu.data.dataset import KaistDataset as JaxDataset
from double_yolo_kaist_tpu.eval.evaluator import \
    evaluate_dataset as jax_evaluate
from double_yolo_kaist_tpu.models import graph as JG
from double_yolo_kaist_tpu.parallel import mesh as JM
from double_yolo_kaist_torch.config.ir import compile_cfg
from double_yolo_kaist_torch.data.dataset import KaistDataset
from double_yolo_kaist_torch.eval.evaluator import evaluate_dataset
from double_yolo_kaist_torch.models import weights as TW
from double_yolo_kaist_torch.parallel import mesh as M
from double_yolo_kaist_torch.serving import Predictor
from tests.test_torch_quantize import one_thread

TINY = os.path.join(os.path.dirname(__file__), "fixtures",
                    "tiny_dyolov3.cfg")
W0, H0 = 160, 128

_one_thread = pytest.fixture(autouse=True)(one_thread)


@pytest.fixture(scope="module")
def mini_split(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_kaist")
    img_dir = root / "images" / "set00"
    lab_dir = root / "labels" / "set00"
    img_dir.mkdir(parents=True)
    lab_dir.mkdir(parents=True)
    rng = np.random.default_rng(3)
    logical = []
    for i in range(8):
        v = rng.integers(0, 256, (H0, W0, 3), dtype=np.uint8)
        l = rng.integers(0, 256, (H0, W0, 3), dtype=np.uint8)
        stem = f"I{i:05d}"
        cv2.imwrite(str(img_dir / f"{stem}_visible.jpg"), v)
        cv2.imwrite(str(img_dir / f"{stem}_lwir.jpg"), l)
        with open(lab_dir / f"{stem}.txt", "w") as f:
            f.write("0 0.5 0.5 0.25 0.4\n")
        logical.append(str(img_dir / f"{stem}.jpg"))
    split = root / "val.txt"
    split.write_text("\n".join(logical) + "\n")
    return str(split)


@pytest.fixture(scope="module")
def tiny():
    """(JAX ir, JAX variables, port ir, port variables)."""
    jir = jax_compile_cfg(TINY, yolo_strides=[8, 4])
    jv = jax.tree.map(np.asarray, JG.init(jir, jax.random.PRNGKey(0)))
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    return jir, jv, tir, TW.from_jax_variables(tir, jv)


def _same_predictions(got, want, box_tol, score_tol):
    assert set(got) == set(want)
    for k in want:
        b1, s1 = want[k]
        b2, s2 = got[k]
        assert len(b1) == len(b2), k
        np.testing.assert_allclose(b2, b1, atol=box_tol)
        np.testing.assert_allclose(s2, s1, atol=score_tol)


def test_mesh_checks_its_devices():
    """A mesh of two CPU replicas; the default mesh and a ``cuda`` entry
    raise without CUDA (nothing drops to the CPU on its own); a mesh that
    is not a Mesh is refused."""
    m = M.make_mesh(["cpu", "cpu"])
    assert m.size == 2 and m.axis_names == ("data",)
    assert [d.type for d in m.replicas] == ["cpu", "cpu"]
    shards = M.shard_batch({"x": torch.arange(12).reshape(4, 3)}, m)
    assert [s["x"].tolist() for s in shards] == [[[0, 1, 2], [3, 4, 5]],
                                                 [[6, 7, 8], [9, 10, 11]]]
    stacked = M.shard_batch({"x": torch.zeros(3, 4, 5)}, m, batch_dim=1)
    assert [tuple(s["x"].shape) for s in stacked] == [(3, 2, 5)] * 2
    with pytest.raises(ValueError, match="does not split"):
        M.shard_batch({"x": torch.zeros(3, 2)}, m)
    reps = M.replicate({"w": torch.ones(2)}, m)
    assert reps[0] is reps[1]               # one copy a device
    assert M.pad_to_multiple(torch.ones(5, 2), 4).shape == (8, 2)
    with pytest.raises(TypeError, match="Mesh"):
        M.check_mesh(object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            M.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            M.make_mesh(["cuda", "cpu"])


@pytest.mark.parametrize("n", [2, 8])
def test_evaluate_dataset_sharded_matches_single(mini_split, tiny, n):
    """batch 5 over 8 images: batches of 5 and 3, both padded to a
    multiple of the mesh size in the sharded run."""
    jir, jv, tir, tv = tiny
    kw = dict(batch_size=5, conf_thres=0.005)
    ds = KaistDataset(mini_split, img_size=64, rect=True)
    r1 = evaluate_dataset(tir, tv, ds, compute_dtype=torch.float32,
                          device="cpu", **kw)
    rn = evaluate_dataset(tir, tv, ds, compute_dtype=torch.float32,
                          mesh=M.make_mesh(["cpu"] * n), **kw)
    assert rn["ap"] == pytest.approx(r1["ap"], abs=1e-9)
    assert rn["lamr"] == pytest.approx(r1["lamr"], abs=1e-9)
    np.testing.assert_allclose(rn["coco_stats"], r1["coco_stats"], atol=1e-9)
    _same_predictions(rn["predictions"], r1["predictions"], 1e-4, 1e-5)
    assert rn["batches"] == r1["batches"] == 2

    jr = jax_evaluate(jir, jv, JaxDataset(mini_split, img_size=64, rect=True),
                      mesh=JM.make_mesh(), compute_dtype=jnp.float32, **kw)
    assert rn["ap"] == pytest.approx(jr["ap"], abs=1e-4)
    assert rn["lamr"] == pytest.approx(jr["lamr"], abs=1e-4)
    np.testing.assert_allclose(rn["coco_stats"], jr["coco_stats"], atol=1e-4)
    _same_predictions(rn["predictions"], jr["predictions"], 1e-4, 1e-5)


@pytest.mark.parametrize("how", ["int8", "unfolded"])
def test_evaluate_dataset_sharded_modes(mini_split, tiny, tmp_path, how):
    """The mesh in int8 (calibrated on the unsharded first batch, and from
    the calibration artifact it wrote) and with ``folded=False``."""
    _, _, tir, tv = tiny
    ds = KaistDataset(mini_split, img_size=64, rect=True)
    kw = dict(batch_size=4, conf_thres=0.005, compute_dtype=torch.float32)
    if how == "int8":
        kw.update(int8=True, calibration_batches=1,
                  calibration=str(tmp_path / "c.npz"))
    else:
        kw.update(folded=False)
    r1 = evaluate_dataset(tir, tv, ds, device="cpu", **kw)
    r2 = evaluate_dataset(tir, tv, ds, mesh=M.make_mesh(["cpu", "cpu"]),
                          **kw)
    np.testing.assert_allclose(r2["coco_stats"], r1["coco_stats"], atol=1e-9)
    assert r2["ap"] == pytest.approx(r1["ap"], abs=1e-9)
    _same_predictions(r2["predictions"], r1["predictions"], 1e-4, 1e-5)


def _same_detections(out_a, out_b):
    assert len(out_a) == len(out_b)
    for (b1, s1, c1), (b2, s2, c2) in zip(out_a, out_b):
        assert len(b1) == len(b2)
        np.testing.assert_allclose(b2, b1, atol=1e-4)
        np.testing.assert_allclose(s2, s1, atol=1e-5)
        np.testing.assert_array_equal(c2, c1)


def test_predictor_sharded_matches_single(tiny):
    _, _, tir, tv = tiny
    kw = dict(img_size=64, conf_thres=0.005, compute_dtype=torch.float32)
    p1 = Predictor(tir, tv, batch_buckets=(4,), device="cpu", **kw)
    p8 = Predictor(tir, tv, batch_buckets=(4,),
                   mesh=M.make_mesh(["cpu"] * 8), **kw)
    # bucket rounding: 4 -> 8 on an 8-replica mesh
    assert p8.batch_buckets == [8]
    # an off-bucket warmup snaps to the bucket: 3 frames would not split
    # over 8 replicas
    p8.warmup((96, 128), batch=3)
    assert list(p8._stages) == [(8, (96, 128))]
    assert p8._stages[(8, (96, 128))].dev[0].shape[0] == 1
    rng = np.random.default_rng(0)
    v = rng.integers(0, 256, (6, 96, 128, 3), dtype=np.uint8)
    l = rng.integers(0, 256, (6, 96, 128, 3), dtype=np.uint8)
    _same_detections(p8(v, l), p1(v, l))


def test_predictor_sharded_int8_runs(tiny):
    """int8 over the mesh: calibration on the gathered batch, the int8
    variables placed on the replicas once, and the single Predictor's
    detections."""
    _, _, tir, tv = tiny
    kw = dict(img_size=64, conf_thres=0.005, compute_dtype=torch.float32,
              int8=True, calibration_batches=1, batch_buckets=(8,))
    p1 = Predictor(tir, tv, device="cpu", **kw)
    p8 = Predictor(tir, tv, mesh=M.make_mesh(["cpu"] * 8), **kw)
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (8, 96, 128, 3), dtype=np.uint8)
    _same_detections(p8(imgs, imgs), p1(imgs, imgs))     # calibration
    assert p1.qvars is not None and p8.qvars is not None
    assert all(q is p8.qvars for q in p8._qvars_r)       # one CPU copy
    _same_detections(p8(imgs, imgs), p1(imgs, imgs))


def test_two_d_mesh_serves_one_replica_a_data_row(mini_split, tiny,
                                                   monkeypatch):
    """F5: a (data, space) mesh of shape (2, 2) serves one replica a row of
    its data axis, as JAX shards over ``mesh.axis_names[0]`` alone: the
    Predictor's buckets are JAX's, each half runs on the first device of
    its data row (the device that holds that half under JAX's
    ``P("data")``), the evaluator pads to, places on and shards over the
    same rows, and the detections equal a 1-D mesh of 2 bit for bit."""
    from double_yolo_kaist_tpu.serving import Predictor as JaxPredictor
    from jax.sharding import NamedSharding, PartitionSpec as P

    jir, jv, tir, tv = tiny
    two_d = M.make_mesh(["cpu"] * 4, axis_names=("data", "space"),
                        shape=(2, 2))
    one_d = M.make_mesh(["cpu"] * 2)
    jmesh = JM.make_mesh(jax.devices()[:4], axis_names=("data", "space"),
                         shape=(2, 2))
    assert two_d.size == len(two_d.replicas) == jmesh.shape["data"] == 2
    # replica r is the device at mesh position (r, 0); JAX puts batch
    # shard r there
    where = NamedSharding(jmesh, P("data")).devices_indices_map((4,))
    for r in range(2):
        assert two_d.replicas[r] is two_d.devices[r, 0]
        assert where[jmesh.devices[r, 0]][0] == slice(2 * r, 2 * r + 2)

    kw = dict(img_size=64, conf_thres=0.005, compute_dtype=torch.float32,
              batch_buckets=(1, 2, 4))
    p2 = Predictor(tir, tv, mesh=two_d, **kw)
    jp = JaxPredictor(jir, jv, mesh=jmesh, img_size=64, conf_thres=0.005,
                      compute_dtype=jnp.float32, batch_buckets=(1, 2, 4))
    assert p2.batch_buckets == list(jp.batch_buckets) == [2, 4]
    p1 = Predictor(tir, tv, mesh=one_d, **kw)
    rng = np.random.default_rng(5)
    v = rng.integers(0, 256, (3, 96, 128, 3), dtype=np.uint8)
    l = rng.integers(0, 256, (3, 96, 128, 3), dtype=np.uint8)
    got, want = p2(v, l), p1(v, l)
    assert list(p2._stages) == [(4, (96, 128))]
    assert p2._stages[(4, (96, 128))].dev[0].shape[0] == 2
    for (b1, s1, c1), (b2, s2, c2) in zip(want, got):
        assert np.array_equal(b1, b2) and np.array_equal(s1, s2)
        assert np.array_equal(c1, c2)

    shards = []
    shard_batch = M.shard_batch

    def recording(batch, mesh, batch_dim=0):
        out = shard_batch(batch, mesh, batch_dim)
        shards.append((len(out), mesh.replicas, out[0]["v"].shape[0]))
        return out

    monkeypatch.setattr(M, "shard_batch", recording)
    ds = KaistDataset(mini_split, img_size=64, rect=True)
    ekw = dict(batch_size=5, conf_thres=0.005, compute_dtype=torch.float32)
    r2 = evaluate_dataset(tir, tv, ds, mesh=two_d, **ekw)
    # batches of 5 and 3, padded to 6 and 4 over JAX's 2 data rows
    rows = jmesh.shape["data"]
    assert [(n, tuple(devs), b) for n, devs, b in shards] == [
        (rows, tuple(two_d.replicas), 3), (rows, tuple(two_d.replicas), 2)]
    r1 = evaluate_dataset(tir, tv, ds, mesh=one_d, **ekw)
    assert np.array_equal(r2["coco_stats"], r1["coco_stats"])
    assert r2["ap"] == r1["ap"] and r2["lamr"] == r1["lamr"]
    for k, (b1, s1) in r1["predictions"].items():
        assert np.array_equal(r2["predictions"][k][0], b1)
        assert np.array_equal(r2["predictions"][k][1], s1)
