"""The repo's single-process examples, unmodified, on the port.

Each example runs in a subprocess through the runner below (this file run
as a script): it imports every module of `singa_tpu_torch`, registers each
under the `singa_tpu` name in `sys.modules` (so the example's
`from singa_tpu import ...` gets the port), points
`device.best_device` at the CPU unless `--device cuda` is given (the test
does this, not the package: the port's default device is the card), then
runs the example with `runpy` under its own smallest arguments.

The cases here are the five examples that the port's API faults broke
(ROADMAP.md Queue 3, faults 1-3); `test_torch_examples_more.py` holds
the ones that ran before, and `cnn/train_cnn.py`, which needed
`Device.SetVerbosity`. A case passes when the example exits 0 and prints
its last line of work.

Left out: `rnn/char_rnn.py`, which calls `jax` itself to sample
(`examples/rnn/char_rnn.py:75`), and `cnn/train_cnn.py alexnet digits`,
which fails in both packages (a 32x32 input is too small for AlexNet's
pools).

`chip_smoke.py` phase 12c runs the same runner with `--device cuda`.
"""

import importlib
import os
import pkgutil
import runpy
import signal
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.abspath(__file__)

#: (example under examples/, its smallest arguments, timeout seconds, a
#: line its run prints at the end of its work)
FAULT_CASES = [
    ("mlp/native.py", ["-m", "20"], 120, "epoch 19:"),
    ("rbm/train.py", ["--epochs", "1", "--hdim", "16"], 120,
     "validation reconstruction error"),
    ("model_selection/ms_mlp.py",
     ["--depths", "1", "--widths", "8", "--topk", "1", "--epochs", "1"], 240,
     "selected: depth=1 width=8"),
    # exits 0 even when a client process fails: the client's line counts
    ("hfl/fedavg.py", ["--clients", "2", "--rounds", "1", "--port",
                       "{port}"], 240, "[client0] round 0 local loss="),
    ("qabot/qabot_train.py", ["--epochs", "1"], 180, "top-1 retrieval acc"),
]


def alias_port(cpu: bool):
    """Register every module of singa_tpu_torch under the singa_tpu name;
    with `cpu`, make `device.best_device` return the CPU device."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import singa_tpu_torch
    mods = {"singa_tpu_torch": singa_tpu_torch}
    for info in pkgutil.walk_packages(singa_tpu_torch.__path__,
                                      "singa_tpu_torch."):
        mods[info.name] = importlib.import_module(info.name)
    for name, mod in mods.items():
        sys.modules["singa_tpu" + name[len("singa_tpu_torch"):]] = mod
    if cpu:
        dev = mods["singa_tpu_torch.device"]
        dev.best_device = dev.create_cpu_device


def run_example(example: str, args, cpu: bool = True):
    """Run examples/<example> with `args` as `__main__` on the port."""
    path = os.path.join(ROOT, "examples", example)
    alias_port(cpu)
    # as `python examples/<example>` would: the script's directory first
    sys.path[0] = os.path.dirname(path)
    sys.argv = [path] + list(args)
    runpy.run_path(path, run_name="__main__")


def run_case(example, args, timeout, device="cpu"):
    """The runner on examples/<example> in a fresh interpreter, in a
    session of its own; "{port}" in `args` becomes a free localhost port.
    Returns (returncode, stdout and stderr); past `timeout` seconds every
    process of the session (an example's own workers too) is killed and
    the returncode is None."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    args = [a.replace("{port}", port) for a in args]
    # one intra-op thread: the examples' ops are small, and beside other
    # test workers a thread pool per process oversubscribes the cores
    env = dict(os.environ, PYTHONPATH=ROOT, MPLBACKEND="Agg",
               PYTHONUNBUFFERED="1",
               OMP_NUM_THREADS=os.environ.get("OMP_NUM_THREADS", "1"))
    proc = subprocess.Popen([sys.executable, RUNNER, "--device", device,
                             example] + args, cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
        return proc.returncode, out
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        return None, out + f"\n[killed after {timeout} s]"


def check_case(example, args, timeout, expect):
    """Run one case: it must exit 0 and print `expect`."""
    rc, out = run_case(example, args, timeout)
    assert rc == 0 and expect in out, \
        f"{example} {args} exited {rc}:\n{out[-3000:]}"


if __name__ != "__main__":
    import pytest

    @pytest.mark.parametrize("example,args,timeout,expect", FAULT_CASES,
                             ids=[c[0] for c in FAULT_CASES])
    def test_example_runs_on_the_port(example, args, timeout, expect):
        check_case(example, args, timeout, expect)


if __name__ == "__main__":
    argv = sys.argv[1:]
    on_cpu = True
    if argv[:1] == ["--device"]:
        on_cpu = argv[1] == "cpu"
        argv = argv[2:]
    run_example(argv[0], argv[1:], cpu=on_cpu)
