"""More of the repo's single-process examples, unmodified, on the port:
the ones that ran before the port's API faults were repaired, and must go
on running. The runner, and the examples left out, are in
`test_torch_examples.py` (two files, so that xdist's loadfile spreads
them).

The data-parallel examples run at world size 1: `--dist` builds
`data_parallel_mesh()`, which without a process group is one rank and
carries no group, so DistOpt is the identity (as the JAX package's at
one device). `cnn/dp_worker.py`, `cnn/autograd/sparsification_mnist.py` and
`multihost/*.py` call `jax` themselves, so they stay out."""

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
    ("cnn/train_cnn.py", ["cnn", "digits", "-m", "1", "--dist",
                          "--dist-option", "sparseTopK"], 240,
     "epoch 0: eval acc="),
    ("cifar_distributed_cnn/train.py", ["cnn", "digits", "-m", "1"], 240,
     "epoch 0: eval acc="),
]


def _ids(cases):
    """Each case's example, and its arguments too where that example
    came before."""
    seen, out = set(), []
    for c in cases:
        out.append(c[0] if c[0] not in seen else f"{c[0]} {' '.join(c[1])}")
        seen.add(c[0])
    return out


@pytest.mark.parametrize("example,args,timeout,expect", CASES,
                         ids=_ids(CASES))
def test_example_runs_on_the_port(example, args, timeout, expect):
    check_case(example, args, timeout, expect)
