"""The fine-tune twin (``examples_torch/llm/finetune.py``) on the CPU: the
loss of the tiny f32 Llama falls, and ``--mesh 1,2`` (tp 2 over one gloo
world of two CPU processes) gives the unsharded run's losses within f32
split-sum rounding (rel 1e-5, as ``test_torch_tp_training.py``)."""

import numpy as np
import _torch_threads  # noqa: F401  (one torch thread a test process)

from examples_torch.llm import finetune


def test_finetune_loss_falls_and_tp_matches(capsys):
    one = finetune.main(["--steps", "3", "--cpu"])
    text = capsys.readouterr().out
    assert one.shape == (3,) and np.isfinite(one).all() and one[-1] < one[0]
    assert text.splitlines()[-1].endswith("(improved)")
    two = finetune.main(["--steps", "3", "--cpu", "--mesh", "1,2"])
    np.testing.assert_allclose(two, one, rtol=1e-5)
    assert capsys.readouterr().out.splitlines()[-1] == text.splitlines()[-1]


def test_finetune_remat_matches():
    np.testing.assert_allclose(finetune.main(["--steps", "2", "--cpu", "--remat"]),
                               finetune.main(["--steps", "2", "--cpu"]), rtol=1e-6)
