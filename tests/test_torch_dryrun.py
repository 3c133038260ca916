"""The port's multi-device dry run (``metrovector_tpu_torch.parallel.
dryrun``) on the CPU: all seven checks of the JAX package's
``dryrun_multichip`` over 8 CPU shards (the two-process check's ranks
under the module's own timeout, ``WORKER_TIMEOUT``), a failed check
raising, and the card asked for where there is none raising."""

import numpy as np
import pytest
import torch

from metrovector_tpu_torch.parallel import dryrun


def test_dryrun_on_eight_cpu_shards_passes_all_seven_checks(capsys):
    got = dryrun.dryrun_multichip(8, device="cpu")
    assert got["checks"] == ["sharded exact", "filtered sharded", "sharded PQ + rerank",
                             "2-D grid", "sharded streamed", "sharded sparse",
                             "2-process gloo"]
    assert got["devices"] == ["cpu"] * 8
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 7 and all(line.endswith(" OK") for line in printed)
    assert 0 < dryrun.WORKER_TIMEOUT <= 240


def test_a_failed_check_raises(monkeypatch):
    def wrong(queries, db, k, metric, valid_mask=None):
        s = np.zeros((len(queries), k), np.float32)
        return s, np.full((len(queries), k), -2)

    monkeypatch.setattr(dryrun, "numpy_oracle", wrong)
    with pytest.raises(AssertionError, match="sharded exact top-k diverged"):
        dryrun.main(["2", "--device", "cpu"])


def test_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.dryrun_multichip(2)
