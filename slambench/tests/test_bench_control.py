"""The comparison's control on the card: the reference computed in TF32 in
the system's place comes out not correct, on three seeds, at the small
size of the CPU tests (at the cell's own size it is ``run.py --control``)."""

import time

import pytest

from slambench import harness
from slambench.tests.tiny import tiny_bench


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed", [11, 2**31 + 7, 3_000_000_019])
def test_tf32_control_is_not_correct(tmp_path, cuda, seed):
    bench = tiny_bench(str(tmp_path))
    run = harness.Run("imap_replica.strict", seed, 8.0, False, "cuda:0", bench,
                      time.perf_counter(), control=True)
    out = run.execute()
    assert out["judged"]["complete"]
    assert out["judged"]["correct"] is False, out["judged"]["numbers"]
