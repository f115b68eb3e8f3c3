"""Two processes of the port's ``parallel/multihost.py``, the case of
``tests/test_multihost_2proc.py``: two gloo CPU processes join through
``maybe_initialize_distributed`` (a ``file://`` rendezvous, no TCP port),
each gets its own ``process_index``, ``allgather_predictions`` gives every
leaf a leading process axis (numpy leaves and tensors), the
differentiable ``all_reduce_sum`` sums the ranks' values and their
gradients, and only process 0's ``save_checkpoint`` writes."""

import os
import sys

import numpy as np

from tests.test_torch_dp_train import spawn_ranks


def _worker(pid: int, out: str) -> None:
    import torch

    from double_yolo_kaist_torch.parallel import multihost as MH
    from double_yolo_kaist_torch.utils.checkpoint import save_checkpoint

    ok = MH.maybe_initialize_distributed(
        coordinator=f"file://{os.path.join(out, 'rendezvous')}",
        num_processes=2, process_id=pid)
    assert ok, "initialize returned False"
    assert torch.distributed.get_backend() == "gloo"
    assert MH.process_count() == 2 and MH.process_index() == pid
    assert MH.is_main_process() == (pid == 0)

    # non-identity allgather: every leaf gains a leading process axis
    tree = {"boxes": np.arange(4, dtype=np.float32) + 10 * pid,
            "n": np.asarray([pid + 1], np.int32),
            "valid": np.asarray([pid == 0, True]),
            "t": torch.full((2, 3), float(pid))}
    merged = MH.allgather_predictions(tree)
    a = merged["boxes"]
    assert isinstance(a, np.ndarray) and a.shape == (2, 4), a.shape
    assert np.allclose(a[0], np.arange(4)), a
    assert np.allclose(a[1], np.arange(4) + 10), a
    assert merged["n"].tolist() == [[1], [2]]
    assert merged["valid"].tolist() == [[True, True], [False, True]]
    assert merged["t"].shape == (2, 2, 3) and merged["t"][1].eq(1).all()

    # the sum, and its gradient summed over the ranks
    x = torch.tensor([1.0, 2.0], dtype=torch.float64, requires_grad=True)
    y = MH.all_reduce_sum(x * (pid + 1), MH.data_group())
    assert y.tolist() == [3.0, 6.0]
    (g,) = torch.autograd.grad((y * (pid + 1)).sum(), x)
    # d/dx of sum_r (r + 1) y with y = sum_r (r + 1) x: 3 * (pid + 1)
    assert g.tolist() == [3.0 * (pid + 1)] * 2, g

    # write gating: each process saves into its own dir; only process 0's
    # gate opens, so exactly ck0 exists afterwards
    save_checkpoint(os.path.join(out, f"ck{pid}"),
                    params={"w": torch.ones(2)}, bn_state={})
    torch.distributed.destroy_process_group()
    print(f"rank{pid} OK", flush=True)


def test_two_process_allgather_and_gating(tmp_path):
    spawn_ranks(os.path.abspath(__file__), [str(tmp_path)])
    assert (tmp_path / "ck0" / "manifest.json").exists()
    assert not (tmp_path / "ck1").exists()


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _worker(int(sys.argv[1]), sys.argv[2])
