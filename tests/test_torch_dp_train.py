"""Data-parallel training of the port: two gloo processes on the CPU, each
with half of the global batch, against one process with all of it.

  * Steps: the tiny cfg at 64x64, a global batch of 4 whose halves hold 3
    boxes and 1 box (so the ranks' match counts differ, and a rank-local
    normaliser with averaged gradients would give another step: checked
    below), float64 activations, params and optimizer state. Two SGD and
    two Adam steps, with EMA. The loss, every metric, every parameter, the
    BN running state, the EMA and the optimizer state of each rank agree
    with the one-process run within 1e-9 relative (float64 summed in
    other orders). The first step's loss agrees with JAX's
    ``make_train_step`` on the whole batch (fp32) within 1e-4 relative,
    ``tests/test_torch_train_step.py::test_steps_match_jax``'s rtol.
  * ``Trainer`` under 2 ranks, one epoch of a 4-pair split (fp32): the
    parameters are bit-equal on both ranks, rank 0 alone writes ``last``
    and ``results.txt``, both ranks report the same in-train metrics, and
    an evaluation split over the ranks (batch 1, so that both run batches)
    equals one process's ``evaluate_dataset`` of rank 0's checkpoint
    within 1e-9.

The ranks are subprocesses of this file (``python
tests/test_torch_dp_train.py <rank> <out>``), joined through a
``file://`` rendezvous (no TCP port), each with a 120 s timeout; a
failing rank kills the other.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from double_yolo_kaist_torch.config.ir import compile_cfg  # noqa: E402
from double_yolo_kaist_torch.config.parser import load_hyp  # noqa: E402
from double_yolo_kaist_torch.data.dataset import KaistDataset  # noqa: E402
from double_yolo_kaist_torch.models import graph as TG  # noqa: E402
from double_yolo_kaist_torch.models import weights as TW  # noqa: E402
from double_yolo_kaist_torch.train import loss as TLS  # noqa: E402
from double_yolo_kaist_torch.train import optim as TO  # noqa: E402
from double_yolo_kaist_torch.train import step as TS  # noqa: E402
from double_yolo_kaist_torch.utils import tree as TR  # noqa: E402

TINY = os.path.join(REPO, "tests", "fixtures", "tiny_dyolov3.cfg")


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread in this process, as its ranks run: no
    contention for the cores between pytest-xdist workers (as
    ``tests/test_torch_quantize.one_thread``, which this file's ranks do
    not import: it imports JAX)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
HYP = {"box": 3.54, "obj": 64.3, "cls": 37.4, "cls_pw": 1.0, "obj_pw": 1.0,
       "iou_t": 0.2, "fl_gamma": 0.0, "ciou": 1.0, "momentum": 0.937,
       "weight_decay": 0.05, "lr0": 0.01, "lrf": 0.1}
BOXES = (2, 1, 1, 0)          # ranks' halves: 3 boxes and 1 box
RANKS = 2
TIMEOUT = 120


def global_batch(seed):
    rng = np.random.default_rng(seed)
    t = np.zeros((len(BOXES), 4, 5), np.float32)
    m = np.zeros((len(BOXES), 4), bool)
    for b, n in enumerate(BOXES):
        t[b, :n, 1:3] = rng.uniform(0.3, 0.7, (n, 2))
        t[b, :n, 3:5] = rng.uniform(0.15, 0.5, (n, 2))
        m[b, :n] = True
    hw = (64, 64, 3)
    return {"v": rng.integers(0, 256, (len(BOXES),) + hw, dtype=np.uint8),
            "l": rng.integers(0, 256, (len(BOXES),) + hw, dtype=np.uint8),
            "targets": t, "tmask": m}


def rows(batch, rank, ranks):
    n = len(BOXES) // ranks
    return {k: torch.from_numpy(v[rank * n:(rank + 1) * n])
            for k, v in batch.items()}


def f64_state(ir, tx):
    v = TR.map_leaves(lambda t: t.to(torch.float64), TG.init(ir, 0))
    params = TR.map_leaves(lambda p: p.clone().requires_grad_(True),
                           v["params"])
    return TS.TrainState(params, v["state"], tx.init(params), 0,
                         TO.ema_init(params))


def run_steps(group, rank, ranks):
    """Two SGD and two Adam steps on the rank's rows; returns {name:
    array}: each step's metrics and the final state's leaves."""
    ir = compile_cfg(TINY, yolo_strides=[8, 4])
    out = {}
    for opt in ("sgd", "adam"):
        tx = TO.make_optimizer(HYP, TO.cosine_epoch_schedule(
            HYP["lr0"], HYP["lrf"], 3, 2), sgd=opt == "sgd")
        state = f64_state(ir, tx)
        step = TS.make_train_step(ir, HYP, tx, compute_dtype=torch.float64,
                                  group=group)
        for i in range(2):
            state, m = step(state, rows(global_batch(20 + i), rank, ranks))
            for k in TS.METRICS:
                out[f"{opt}/step{i}/{k}"] = m[k].detach().double().numpy()
        leaves = (TR.leaves(state.params) + TR.leaves(state.bn_state)
                  + TR.leaves(state.opt_state) + TR.leaves(state.ema))
        for j, t in enumerate(leaves):
            out[f"{opt}/state/{j:04d}"] = t.detach().double().numpy()
    return out


def run_trainer(out_dir, data, rank):
    """One epoch of ``Trainer`` under the group; rank r writes into
    ``out_dir/r<r>``. Returns its params, in-train metrics and a batch-1
    evaluation split over the ranks."""
    from double_yolo_kaist_torch.train.trainer import Trainer

    hyp = load_hyp(os.path.join(data, "hyp.yaml"))
    split = os.path.join(data, "s.txt")
    ir = compile_cfg(TINY, yolo_strides=[8, 4])
    tr = Trainer(ir, hyp, epochs=1, batch_size=4, img_size=64,
                 train_dataset=KaistDataset(split, 64, 4, augment=True,
                                            hyp=hyp),
                 val_dataset=KaistDataset(split, 64, 4, hyp=hyp, rect=True),
                 compute_dtype=torch.float32, device="cpu",
                 out_dir=out_dir, name=f"r{rank}")
    assert tr.ranks == 2 and tr.rank == rank
    tr.fit()
    res = tr.evaluate(batch_size=1)
    out = {f"p/{j:04d}": p.detach().numpy()
           for j, p in enumerate(TR.leaves(tr.state.params))}
    out["best_map"] = np.asarray(tr.best_map)
    out["coco"] = np.asarray(res["coco_stats"])
    out["ap"] = np.asarray(res["ap"])
    out["lamr"] = np.asarray(res["lamr"])
    out["batches"] = np.asarray(res["batches"])
    return out


def _worker(rank: int, out: str, data: str) -> None:
    from double_yolo_kaist_torch.parallel import multihost as MH

    torch.set_num_threads(1)
    assert MH.maybe_initialize_distributed(
        coordinator=f"file://{os.path.join(out, 'rendezvous')}",
        num_processes=RANKS, process_id=rank, backend="gloo")
    group = MH.data_group()
    assert group is not None and MH.process_index() == rank
    res = run_steps(group, rank, RANKS)
    res.update(run_trainer(os.path.join(out, "runs"), data, rank))
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
    torch.distributed.destroy_process_group()
    print(f"rank{rank} OK", flush=True)


def spawn_ranks(script: str, args, ranks: int = RANKS, timeout=TIMEOUT):
    """Run ``script <rank> *args`` in ``ranks`` processes; every process is
    ended before this returns, and a failure raises with their output."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, script, str(r), *args],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(ranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} rc={p.returncode}\n{text[-4000:]}"
        assert f"rank{r} OK" in text, text[-4000:]
    return outs


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results, from one run of the workers."""
    from tests.test_torch_trainer import HYP as HYP_YAML, write_split

    root = tmp_path_factory.mktemp("dp")
    data = root / "data"
    data.mkdir()
    write_split(data, n=4, hw=(64, 96), seed=5)
    (data / "hyp.yaml").write_text(HYP_YAML)
    spawn_ranks(os.path.abspath(__file__), [str(root), str(data)])
    return root, data, [dict(np.load(root / f"rank{r}.npz"))
                        for r in range(RANKS)]


def _close(a, b, rel, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err = np.abs(a - b).max() if a.size else 0.0
    assert err <= rel * max(np.abs(b).max() if b.size else 0.0, 1e-300), \
        (what, err)


def test_two_ranks_step_as_one_process(two_ranks):
    _, _, ranks = two_ranks
    one = run_steps(None, 0, 1)
    keys = [k for k in one]
    assert any("/state/" in k for k in keys)
    for r, got in enumerate(ranks):
        for k in keys:
            _close(got[k], one[k], 1e-9, f"rank {r} {k}")


def test_the_normaliser_is_global():
    """The halves' match counts differ, so averaging rank-local losses (the
    DDP default) is another loss: the test above can tell them apart."""
    ir = compile_cfg(TINY, yolo_strides=[8, 4])
    v = TR.map_leaves(lambda t: t.to(torch.float64), TG.init(ir, 0))
    specs = TLS.head_specs(ir)

    def loss(b):
        raws, _ = TG.apply(ir, v, b["v"].double() / 255, b["l"].double() / 255,
                           train=True, compute_dtype=torch.float64)
        return float(TLS.total_loss(TLS.compute_loss(
            raws, b["targets"], b["tmask"], specs, HYP)))

    b = global_batch(20)
    whole = loss(rows(b, 0, 1))
    local = np.mean([loss(rows(b, r, 2)) for r in range(2)])
    assert abs(local - whole) > 1e-3 * abs(whole)


@pytest.mark.parametrize("from_pool, snow", [(False, False), (True, True)],
                         ids=["rows-plain", "pool-snow"])
def test_rank_rows_of_the_augment(from_pool, snow):
    """Each rank's augmented rows are the one-process batch's rows: the
    randoms are drawn for the global batch and each rank keeps its
    images', mosaic partners included."""
    from double_yolo_kaist_torch.data.pipeline import make_train_augment_fn

    rng = np.random.default_rng(4)
    nb, src, s = 4, (48, 64), 64
    v = torch.from_numpy(rng.integers(0, 256, (4 * nb,) + src + (3,),
                                      dtype=np.uint8))
    l = torch.from_numpy(rng.integers(0, 256, (4 * nb,) + src + (3,),
                                      dtype=np.uint8))
    lab = torch.zeros(4 * nb, 2, 5)
    lab[:, 0, 1:] = torch.tensor([0.5, 0.5, 0.3, 0.4])
    lm = torch.zeros(4 * nb, 2, dtype=torch.bool)
    lm[:, 0] = True
    hyp = dict(HYP, hsv_h=0.0138, hsv_s=0.678, hsv_v=0.36, degrees=0.0,
               translate=0.1, scale=0.5, shear=0.0)
    args = ((v, l, torch.arange(4 * nb).flip(0), lab, lm) if from_pool
            else (v, l, lab, lm))

    def run(shard):
        fn = make_train_augment_fn(src, s, hyp, snowflake=snow,
                                   from_pool=from_pool, shard=shard)
        return fn(torch.Generator().manual_seed(9), *args)

    whole = run(None)
    for r in range(2):
        part = run((r, 2))
        for k in whole:
            assert torch.equal(part[k], whole[k][2 * r:2 * r + 2]), (r, k)


def test_first_step_loss_matches_jax(two_ranks):
    import jax
    import jax.numpy as jnp

    from double_yolo_kaist_tpu.config.ir import compile_cfg as jax_cfg
    from double_yolo_kaist_tpu.train import optim as JO
    from double_yolo_kaist_tpu.train import step as JS

    _, _, ranks = two_ranks
    jir = jax_cfg(TINY, yolo_strides=[8, 4])
    tir = compile_cfg(TINY, yolo_strides=[8, 4])
    jv = jax.tree.map(jnp.asarray, TW.to_jax_variables(TG.init(tir, 0)))
    jtx = JO.make_optimizer(HYP, JO.cosine_epoch_schedule(
        HYP["lr0"], HYP["lrf"], 3, 2), sgd=True)
    js = JS.create_train_state(jir, None, jtx, variables=jv)
    step = JS.make_train_step(jir, HYP, jtx, compute_dtype=jnp.float32,
                              donate=False)
    _, jm = step(js, {k: jnp.asarray(x) for k, x in global_batch(20).items()},
                 jax.random.PRNGKey(0))
    # the first step's loss is taken before any update: one for both
    for got in ranks:
        for opt in ("sgd", "adam"):
            np.testing.assert_allclose(float(got[f"{opt}/step0/loss"]),
                                       float(jm["loss"]), rtol=1e-4)


def test_trainer_under_two_ranks(two_ranks):
    from double_yolo_kaist_torch.eval.evaluator import evaluate_dataset
    from double_yolo_kaist_torch.utils.checkpoint import load_checkpoint

    root, data, (r0, r1) = two_ranks
    pk = sorted(k for k in r0 if k.startswith("p/"))
    assert pk and all(np.array_equal(r0[k], r1[k]) for k in pk)
    runs = root / "runs"
    assert (runs / "r0" / "last" / "manifest.json").exists()
    assert (runs / "r0" / "results.txt").exists()
    assert not (runs / "r1" / "last").exists()
    assert not (runs / "r1" / "results.txt").exists()
    for k in ("best_map", "coco", "ap", "lamr"):
        assert np.array_equal(r0[k], r1[k]), k
    # 4 batches of 1: two a rank
    assert int(r0["batches"]) == int(r1["batches"]) == 2

    ir = compile_cfg(TINY, yolo_strides=[8, 4])
    jx = TW.to_jax_variables(TG.init(ir, 0))
    ck = load_checkpoint(str(runs / "r0" / "last"),
                         {"params": jx["params"], "bn_state": jx["state"]})
    tv = TW.from_jax_variables(ir, {"params": ck["params"],
                                    "state": ck["bn_state"]})
    assert all(np.array_equal(p.numpy(), r0[k])
               for p, k in zip(TR.leaves(tv["params"]), pk))
    hyp = load_hyp(str(data / "hyp.yaml"))
    ds = KaistDataset(str(data / "s.txt"), 64, 4, hyp=hyp, rect=True)
    one = evaluate_dataset(ir, tv, ds, batch_size=1,
                           compute_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(r0["coco"], one["coco_stats"], atol=1e-9)
    assert float(r0["ap"]) == pytest.approx(one["ap"], abs=1e-9)
    assert float(r0["lamr"]) == pytest.approx(one["lamr"], abs=1e-9)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
