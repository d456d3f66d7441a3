"""More of the repo's single-process examples, unmodified, on the port:
the ones that ran before the port's API faults were repaired, and must go
on running. The runner, and the examples left out, are in
`test_torch_examples.py` (two files, so that xdist's loadfile spreads
them)."""

import pytest

from test_torch_examples import check_case

#: (example under examples/, its smallest arguments, timeout seconds, a
#: line its run prints at the end of its work)
CASES = [
    ("mlp/train_mlp.py", ["-m", "1"], 120, "final: loss="),
    ("cnn/autograd/mnist_cnn.py", ["--epochs", "1", "--max-batches", "2"],
     120, "epoch 0: loss="),
    ("rnn/imdb_classify.py", ["--epochs", "1"], 240, "val acc="),
    ("gan/vanilla.py", ["--epochs", "1", "--iters", "2"], 120,
     "epoch 0: d_loss="),
    # -v 1: the graph-mode steps past the skipped ones are fenced and
    # summarised by PrintTimeProfiling
    ("cnn/train_cnn.py", ["cnn", "digits", "-m", "1", "-v", "1"], 240,
     "time profiling: 18 steps"),
]


@pytest.mark.parametrize("example,args,timeout,expect", CASES,
                         ids=[c[0] for c in CASES])
def test_example_runs_on_the_port(example, args, timeout, expect):
    check_case(example, args, timeout, expect)
