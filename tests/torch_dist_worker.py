"""The multi-process harness of the port's data-parallel tests.

`run_job(job, world, tmp_path, inputs)` starts `world` fresh interpreters
(`subprocess` with `sys.executable`: never a fork of the test process,
which holds JAX's threads) running this file as a script: each joins one
gloo process group through a `file://` store under `tmp_path` (so xdist
workers never race for a TCP port), runs the job named `job` on the
numpy `inputs`, and writes its results to `rank<r>.npz`. The workers
import the port only. Each job has its own timeout (120 s by default):
a hang kills the job's processes and fails one test.

Run by the harness as `python torch_dist_worker.py JOB RANK WORLD STORE
INPUTS OUT`; STORE "env" makes the job join through
`distributed.init()`'s environment fallbacks instead. With `forked`,
one launcher (`torch_dist_worker.py --forked JOB WORLD STORE INPUTS
OUT`) imports torch and the port once and forks the ranks, before any
thread exists: a rank then costs its job's work, not an interpreter's
start (importing torch takes seconds of CPU).
"""

import glob
import json
import os
import signal
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.abspath(__file__)
#: the environment variable that carries run_job's `cpus` to the workers
_CPUS = "TORCH_DIST_WORKER_CPUS"


def run_job(job, world, tmp_path, inputs=None, timeout=120, env=None,
            store=None, cpus=None, forked=False):
    """Run `job` on `world` ranks; returns each rank's results, a dict of
    numpy arrays, in rank order. `env` adds environment variables (per
    rank: a callable of the rank); `store` "env" skips the file store;
    `cpus` keeps the job's processes on that many of this process's CPU
    cores (the last ones; their affinity, set before they import torch),
    so a job of many ranks loads the host no more than that; `forked`
    forks the ranks from one launcher that has imported torch and the
    port (no per-rank `env`)."""
    work = os.path.join(str(tmp_path), job)
    os.makedirs(work, exist_ok=True)
    inp = os.path.join(work, "inputs.npz")
    np.savez(inp, **(inputs or {}))
    store = store or os.path.join(work, "store")
    base = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                PYTHONUNBUFFERED="1")
    base.pop(_CPUS, None)
    if cpus is not None:
        base[_CPUS] = ",".join(map(str, sorted(os.sched_getaffinity(0))[
            -int(cpus):]))
    procs, logs = [], []
    if forked:
        if env:
            raise ValueError("a forked job takes no per-rank env")
        log = open(os.path.join(work, "launcher.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, "--forked", job, str(world), store, inp,
             work], cwd=ROOT, env=base, stdout=log,
            stderr=subprocess.STDOUT, start_new_session=True))
    for r in range(0 if forked else world):
        e = dict(base)
        for k, v in (env or {}).items():
            e[k] = str(v(r) if callable(v) else v)
        log = open(os.path.join(work, f"rank{r}.log"), "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, job, str(r), str(world), store, inp,
             work], cwd=ROOT, env=e, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True))
    deadline = time.monotonic() + timeout
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=max(0.1, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            rcs.append(None)
    for p in procs:
        if p.poll() is None:
            if forked:      # the launcher's session: its ranks too
                os.killpg(p.pid, signal.SIGKILL)
            else:
                p.kill()
            p.wait()
    for log in logs:
        log.close()
    if forked:
        path = os.path.join(work, "rcs.json")
        rcs = [None] * world
        if os.path.exists(path):
            with open(path) as f:
                rcs = json.load(f)
    if any(rc != 0 for rc in rcs):
        text = ""
        if forked:
            with open(os.path.join(work, "launcher.log")) as f:
                text += f"--- launcher ---\n{f.read()[-3000:]}"
        for r in range(world):
            path = os.path.join(work, f"rank{r}.log")
            if os.path.exists(path):
                with open(path) as f:
                    text += (f"--- rank {r} (rc {rcs[r]}) ---\n"
                             f"{f.read()[-3000:]}")
        raise AssertionError(f"job {job!r} on {world} ranks failed "
                             f"(timeout {timeout} s):\n{text}")
    out = []
    for r in range(world):
        with np.load(os.path.join(work, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


# ---- the jobs (run in the workers; they import the port only) -------------

def _mlp(model, layer, strategy):
    """The MLP of tests/test_dist.py (10 -> 16 -> 4) whose step takes
    `strategy(optimizer, loss)`."""

    class MLP(model.Model):
        def __init__(self):
            super().__init__()
            self.l1 = layer.Linear(16)
            self.relu = layer.ReLU()
            self.l2 = layer.Linear(4)
            self.loss_fn = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.l2(self.relu(self.l1(x)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            strategy(self._optimizer, loss)
            return out, loss

    return MLP()


#: the strategies of tests/test_dist.py, by name, and "threshold"
STRATEGIES = {
    "plain": lambda o, loss: o(loss),
    "half": lambda o, loss: o.backward_and_update_half(loss),
    "partial": lambda o, loss: o.backward_and_partial_update(
        loss, num_partitions=2),
    "topk": lambda o, loss: o.backward_and_sparse_update(
        loss, spars=0.25, topK=True, corr=True),
    "threshold": lambda o, loss: o.backward_and_sparse_update(
        loss, spars=0.05, topK=False, corr=True),
}
#: and the partial strategy over 4 partitions (the tag sequence)
ALL_STRATEGIES = dict(STRATEGIES, partial4=lambda o, loss:
                      o.backward_and_partial_update(loss, num_partitions=4))


def _params(m):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in m._raw_params().items()}


def _states(m):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in m._raw_states().items()}


def _listing(path):
    """The op listing of the single `step` build under `path`."""
    files = glob.glob(os.path.join(path, "step_*.ops.txt"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return f.read()


def job_topo(inp, rank, world, out):
    import torch

    from singa_tpu_torch import distributed
    from singa_tpu_torch.parallel import Communicator
    distributed.init(device="cpu")      # adopts the file-store group
    res = {"index": distributed.process_index(),
           "count": distributed.process_count(),
           "topology": [distributed.topology()[k] for k in
                        ("n_devices", "n_processes", "process_index")],
           "host": np.array(distributed.host_label())}
    gm = distributed.global_mesh()
    res["gm"] = [gm.shape["data"], gm.size]
    gm2 = distributed.global_mesh({"data": 2, "model": 2})
    res["gm2_names"] = np.array(list(gm2.axis_names))
    res["gm2_sizes"] = list(gm2.shape.values())
    res["gm2_coord"] = [gm2.coordinate("data"), gm2.coordinate("model")]
    c = Communicator(axis="model", mesh=gm2)
    res["gm2_model_sum"] = c.all_reduce(torch.tensor([float(rank)])).numpy()
    c = Communicator(axis=("data", "model"), mesh=gm2)
    res["gm2_both_sum"] = c.all_reduce(torch.tensor([float(rank)])).numpy()
    res["gm2_both_rank"] = int(c.rank())
    try:
        distributed.global_mesh({"data": 3})
        res["bad"] = np.array("")
    except ValueError as e:
        res["bad"] = np.array(str(e))
    host = np.arange(world * 4 * 2, dtype=np.float32).reshape(world * 4, 2)
    res["batch"] = distributed.global_batch(host, gm).numpy()
    try:
        distributed.global_batch(np.zeros((world * 4 + 1, 2), np.float32),
                                 gm)
        res["bad_batch"] = np.array("")
    except ValueError as e:
        res["bad_batch"] = np.array(str(e))
    rm = distributed.resume_mesh(2)
    res["resume_member"] = rm.member
    res["resume_shape"] = [rm.shape["data"]]
    if rm.member:
        c = Communicator(mesh=rm)
        res["resume_sum"] = c.all_reduce(torch.ones(1) * (rank + 1)).numpy()
    try:
        distributed.resume_mesh(world + 1)
        res["resume_bad"] = np.array("")
    except ValueError as e:
        res["resume_bad"] = np.array(str(e))
    return res


def job_env(inp, rank, world, out):
    import torch

    from singa_tpu_torch import distributed
    distributed.init(device="cpu")      # SINGA_* from the environment
    distributed.init(device="cpu")      # idempotent
    x = torch.ones(1) * (rank + 1)
    torch.distributed.all_reduce(x)
    return {"index": distributed.process_index(),
            "count": distributed.process_count(),
            "backend": np.array(torch.distributed.get_backend()),
            "sum": x.numpy()}


def job_verbs(inp, rank, world, out):
    """Every verb of the communicator on this rank's shard of the inputs
    (the rows JAX's shard_map gives device `rank`), in the order the
    test's JAX function calls them."""
    import torch

    from singa_tpu_torch import distributed, observe
    from singa_tpu_torch.parallel import Communicator, data_parallel_mesh
    distributed.init(device="cpu")
    observe.get_registry().reset()
    comm = Communicator(mesh=data_parallel_mesh(world))

    def shard(a):
        a = torch.as_tensor(a)
        n = a.shape[0] // world
        return a[rank * n:(rank + 1) * n]

    x1, xs, xt = shard(inp["x1"]), shard(inp["xs"]), shard(inp["xt"])
    res = {"all_reduce": comm.all_reduce(x1),
           "all_reduce_half": comm.all_reduce_half(x1),
           "all_gather": comm.all_gather(x1),
           "broadcast0": comm.broadcast(x1, root=0),
           "broadcast2": comm.broadcast(x1, root=2),
           "reduce_scatter": comm.reduce_scatter(xs),
           "all_reduce_max": comm.all_reduce_max(x1),
           "agree1": comm.agree_any(comm.rank() == 1).reshape(1),
           "agree0": comm.agree_any(torch.tensor(False)).reshape(1)}
    res["topk_out"], res["topk_res"] = comm.sparse_all_reduce_topk(x1, 0.25)
    res["thr_out"], res["thr_res"] = comm.sparse_all_reduce_threshold(
        xt, 0.8, capacity_frac=0.5)
    res = {k: v.numpy() for k, v in res.items()}
    reg = observe.get_registry()
    for name in ("singa_comm_bytes_total", "singa_comm_calls_total"):
        for _, labels, v in reg.get(name).samples():
            res[f"{name}|{labels}"] = np.float64(v)
    res["rank"] = int(comm.rank())
    res["x1_after"] = x1.numpy()     # every verb leaves its input as it was
    return res


def _data():
    rng = np.random.RandomState(0)
    X = rng.randn(32, 10).astype(np.float32)
    Y = np.argmax(X @ rng.randn(10, 4).astype(np.float32), 1) \
        .astype(np.int32)
    return X, Y


def job_train(inp, rank, world, out):
    """The strategies on the MLP from JAX's initial weights, DP against a
    single device, convergence, the per-tag builds, the sparse wire
    check, the Classifier's dist_options, eager mode, amp and the sparse
    residual checkpoint."""
    from singa_tpu_torch import (device, distributed, introspect, layer,
                                 model, opt, tensor, utils)
    from singa_tpu_torch.models.base import Classifier
    from singa_tpu_torch.parallel import data_parallel_mesh
    distributed.init(device="cpu")
    dev = device.create_cpu_device()
    X, Y = inp["X"], inp["Y"]
    w0 = {k[3:]: inp[k] for k in inp.files if k.startswith("w0/")}
    tx, ty = tensor.from_numpy(X, dev), tensor.from_numpy(Y, dev)
    res = {}

    def run(name, steps, lr=0.2, momentum=0.9, tags=None, hlo=None):
        m = _mlp(model, layer, ALL_STRATEGIES[name])
        d = opt.DistOpt(opt.SGD(lr=lr, momentum=momentum),
                        mesh=data_parallel_mesh(world))
        if tags is not None:
            step_tag = d.step_tag
            d.step_tag = lambda: tags.append(step_tag()) or tags[-1]
        m.set_optimizer(d)
        m.compile([tx], is_train=True, use_graph=True)
        m.set_params(w0)
        introspect.capture_hlo(hlo)
        try:
            losses = []
            for _ in range(steps):
                o, loss = m(tx, ty)
                losses.append(loss.item())
        finally:
            introspect.capture_hlo(None)
        return m, np.asarray(losses), o

    for name in STRATEGIES:
        m, losses, o = run(name, 5)
        res[f"{name}/losses"] = losses
        res[f"{name}/out_shape"] = list(o.shape)
        for k, v in _params(m).items():
            res[f"{name}/p/{k}"] = v
        if name == "partial":
            res["partial/builds"] = m._build_count
    m, losses, _ = run("plain", 3, lr=0.1, momentum=0.0)
    res["single/losses"] = losses
    for k, v in _params(m).items():
        res[f"single/p/{k}"] = v
    for name in ("plain", "half", "topk", "partial"):
        _, losses, o = run(name, 40)
        res[f"conv/{name}/losses"] = losses
        res[f"conv/{name}/out_shape"] = list(o.shape)
    # partial over 4 partitions: one build per tag, JAX's tag sequence
    tags = []
    m, _, _ = run("partial4", 8, tags=tags)
    res["partial4/tags"] = tags
    res["partial4/builds"] = m._build_count
    # the sparse wire check on the op listings
    for name in ("topk", "plain"):
        d = os.path.join(out, f"hlo_{name}_{rank}")
        run(name, 2, hlo=d)
        text = _listing(d)
        res[f"wire/{name}/dense"] = np.array(
            "|".join(utils.dense_allreduce_types(text)))
        res[f"wire/{name}/allgathers"] = np.array("\n".join(
            ln for ln in text.splitlines() if ln.startswith("c10d.allgather")))
        res[f"wire/{name}/allreduces"] = sum(
            ln.startswith("c10d.allreduce_") for ln in text.splitlines())

    class Net(Classifier):
        def __init__(self):
            super().__init__(num_classes=4)
            self.l1 = layer.Linear(16)
            self.relu = layer.ReLU()
            self.l2 = layer.Linear(4)

        def forward(self, x):
            return self.l2(self.relu(self.l1(x)))

    for option in ("plain", "half", "partialUpdate", "sparseTopK",
                   "sparseThreshold", "bogus"):
        m = Net()
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1, momentum=0.9),
                                    mesh=data_parallel_mesh(world)))
        m.compile([tx], is_train=True, use_graph=True)
        m.set_params(w0)
        try:
            losses = [m(tx, ty, option, None)[1].item() for _ in range(3)]
            res[f"cls/{option}"] = np.asarray(losses)
        except ValueError as e:
            res[f"cls/{option}"] = np.array(str(e))
    m = _mlp(model, layer, STRATEGIES["plain"])
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1),
                                mesh=data_parallel_mesh(world)))
    m.compile([tx], is_train=True, use_graph=False)
    try:
        m(tx, ty)
        res["eager"] = np.array("")
    except ValueError as e:
        res["eager"] = np.array(str(e))
    res.update(_amp(inp, world, dev))
    res.update(_sparse_ckpt(inp, rank, world, dev, inp["ckpt"].item(),
                            steps=6, save_at=3))
    res.update(_ckpt_same_job(rank, world, dev, inp["ckpt"].item()))
    res.update(_dropout(world, dev))
    return res


def _amp(inp, world, dev):
    """tests/test_amp.py's Net under DistOpt(SGD(0.05)) with bf16 amp."""
    from singa_tpu_torch import layer, model, opt, tensor
    from singa_tpu_torch.parallel import data_parallel_mesh

    class Net(model.Model):
        def __init__(self):
            super().__init__()
            self.conv = layer.Conv2d(8, 3, padding=1)
            self.bn = layer.BatchNorm2d(8)
            self.pool = layer.MaxPool2d(2, 2)
            self.flat = layer.Flatten()
            self.fc = layer.Linear(10)
            self.loss_fn = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc(self.flat(self.pool(self.bn(self.conv(x)))))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            self.optimizer(loss)
            return out, loss

    rng = np.random.RandomState(0)
    x = tensor.from_numpy(rng.rand(16, 3, 16, 16).astype(np.float32), dev)
    y = tensor.from_numpy(rng.randint(0, 10, 16).astype(np.int32), dev)
    dev.SetRandSeed(0)
    m = Net()
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.05),
                                mesh=data_parallel_mesh(world)))
    m.compile([x], is_train=True, use_graph=True, amp="bfloat16")
    return {"amp/losses": np.asarray([m(x, y)[1].item()
                                      for _ in range(10)])}


def _sparse_net(world, dev, seed=5):
    """tests/test_model.py's sparse-residual net under
    DistOpt(SGD(0.1, 0.9), sparse_residuals=True) over `world` ranks."""
    from singa_tpu_torch import layer, model, opt, tensor
    from singa_tpu_torch.parallel import data_parallel_mesh

    class N(model.Model):
        def __init__(self):
            super().__init__()
            self.fc1 = layer.Linear(8)
            self.relu = layer.ReLU()
            self.fc2 = layer.Linear(3)
            self.sce = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc2(self.relu(self.fc1(x)))

        def train_one_batch(self, x, y):
            loss = self.sce(self.forward(x), y)
            self._optimizer.backward_and_sparse_update(loss, spars=0.3,
                                                       topK=True)
            return loss

    rng = np.random.RandomState(1)
    X = rng.randn(16, 5).astype(np.float32)
    Y = rng.randint(0, 3, 16).astype(np.int32)
    dev.SetRandSeed(seed)
    m = N()
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1, momentum=0.9),
                                mesh=data_parallel_mesh(world),
                                sparse_residuals=True))
    tx, ty = tensor.from_numpy(X, dev), tensor.from_numpy(Y, dev)
    m.compile([tx], is_train=True, use_graph=True)
    return m, tx, ty


def _sparse_ckpt(inp, rank, world, dev, ckpt, steps, save_at):
    """An uninterrupted run of `steps`, and a run saved at `save_at`."""
    m, tx, ty = _sparse_net(world, dev)
    ref = [m(tx, ty).item() for _ in range(steps)]
    m, tx, ty = _sparse_net(world, dev)
    for _ in range(save_at):
        m(tx, ty)
    m.save_checkpoint(ckpt, step=save_at, async_save=False)
    res = {"ckpt/ref": np.asarray(ref)}
    for i, r in enumerate(m.optimizer._spars_order):
        res[f"ckpt/res{i}"] = m.optimizer._spars_residual[r].numpy().copy()
    return res


def _ckpt_same_job(rank, world, dev, ckpt):
    """Every rank loads, in the job that saved it, what rank 0 may still
    be writing (an async save); a save that rank 0 refuses (a complete
    checkpoint is there) raises on every rank."""
    from singa_tpu_torch import resilience
    m, tx, ty = _sparse_net(world, dev)
    for _ in range(2):
        m(tx, ty)
    want = _states(m)
    path = m.save_checkpoint(ckpt, step=2)
    fresh, _, _ = _sparse_net(world, dev, seed=11)
    fresh.load_checkpoint(path)
    got = _states(fresh)
    res = {"same/equal": all(np.array_equal(got[k], v)
                             for k, v in want.items())}
    if rank == 0:
        resilience.write_manifest(path, resilience.build_manifest(m, 2))
    try:
        m.save_checkpoint(ckpt, step=2, async_save=False)
        res["same/refused"] = np.array("")
    except (ValueError, RuntimeError) as e:
        res["same/refused"] = np.array(f"{type(e).__name__}: {e}")
    return res


def _dropout(world, dev):
    """A dropout layer under the data-parallel step, two steps. Every
    rank's rows hold the same values, so the gathered dropout output
    shows each rank's mask; a second model from the same seed repeats
    the run."""
    from singa_tpu_torch import layer, model, opt, tensor
    from singa_tpu_torch.parallel import data_parallel_mesh

    class D(model.Model):
        def __init__(self):
            super().__init__()
            self.l1 = layer.Linear(16)
            self.drop = layer.Dropout(0.5)
            self.l2 = layer.Linear(4)
            self.sce = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.l2(self.drop(self.l1(x)))

        def train_one_batch(self, x, y):
            h = self.drop(self.l1(x))
            loss = self.sce(self.l2(h), y)
            self._optimizer(loss)
            return h, loss

    rng = np.random.RandomState(3)
    tx = tensor.from_numpy(
        np.tile(rng.randn(4, 10).astype(np.float32), (world, 1)), dev)
    ty = tensor.from_numpy(
        np.tile(rng.randint(0, 4, 4).astype(np.int32), world), dev)
    res = {}
    for run in ("", "_again"):
        dev.SetRandSeed(9)
        m = D()
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1),
                                    mesh=data_parallel_mesh(world)))
        m.compile([tx], is_train=True, use_graph=True)
        outs = [m(tx, ty) for _ in range(2)]
        res[f"drop/h{run}"] = np.stack([h.numpy() for h, _ in outs])
        res[f"drop/losses{run}"] = np.array([loss.item()
                                             for _, loss in outs])
    return res


def job_resume(inp, rank, world, out):
    """A fresh job restores the sparse-residual checkpoint and takes
    three steps; on another world size the restore raises."""
    from singa_tpu_torch import device, distributed
    distributed.init(device="cpu")
    dev = device.create_cpu_device()
    m, tx, ty = _sparse_net(world, dev, seed=11)
    try:
        m.load_checkpoint(os.path.join(inp["ckpt"].item(), "step_3"))
    except ValueError as e:
        return {"error": np.array(str(e))}
    res = {"losses": np.asarray([m(tx, ty).item() for _ in range(3)])}
    for i, r in enumerate(m.optimizer._spars_order):
        res[f"res{i}"] = m.optimizer._spars_residual[r].numpy().copy()
    return res


def job_dryrun(inp, rank, world, out):
    """Step 1 of __graft_entry__.dryrun_multichip (ResNet-18, batch 2 N,
    one DistOpt(SGD(0.05, 0.9)) step from JAX's states) at 32x32 and at
    64x64, and step 1b (the sparse MLP's op listing)."""
    from singa_tpu_torch import (device, distributed, introspect, layer,
                                 model, models, opt, tensor, utils)
    from singa_tpu_torch.parallel import data_parallel_mesh
    distributed.init(device="cpu")
    dev = device.create_cpu_device()
    res = {}
    for hw in (32, 64):
        m = models.create_model("resnet18", num_channels=3)
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.05, momentum=0.9),
                                    axis="data",
                                    mesh=data_parallel_mesh(world)))
        tx = tensor.Tensor(data=inp[f"x{hw}"], device=dev)
        ty = tensor.from_numpy(inp["y"], device=dev)
        m.compile([tx], is_train=True, use_graph=True)
        pre = f"s{hw}/"
        m.set_states({k[len(pre):]: inp[k] for k in inp.files
                      if k.startswith(pre)})
        out_, loss = m(tx, ty)
        res[f"{hw}/loss"] = loss.item()
        res[f"{hw}/out_shape"] = list(out_.shape)
        for k, v in _states(m).items():
            res[f"{hw}/s/{k}"] = v

    class SparseMLP(model.Model):
        def __init__(self):
            super().__init__()
            self.l1 = layer.Linear(16)
            self.relu = layer.ReLU()
            self.l2 = layer.Linear(4)
            self.loss_fn = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.l2(self.relu(self.l1(x)))

        def train_one_batch(self, x, y):
            loss = self.loss_fn(self.forward(x), y)
            self._optimizer.backward_and_sparse_update(
                loss, spars=0.25, topK=True)
            return loss

    sm = SparseMLP()
    sm.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1),
                                 mesh=data_parallel_mesh(world)))
    sx = tensor.from_numpy(inp["sx"], dev)
    sy = tensor.from_numpy(inp["sy"], dev)
    sm.compile([sx], is_train=True, use_graph=True)
    d = os.path.join(out, f"hlo_sparse_{rank}")
    introspect.capture_hlo(d)
    try:
        res["sparse_loss"] = sm(sx, sy).item()
    finally:
        introspect.capture_hlo(None)
    text = _listing(d)
    res["sparse_dense"] = np.array("|".join(
        utils.dense_allreduce_types(text)))
    res["sparse_allreduces"] = sum(ln.startswith("c10d.allreduce_")
                                   for ln in text.splitlines())
    return res


def job_health(inp, rank, world, out):
    """The mesh cases of tests/test_health.py: a non-finite entry in one
    rank's rows skips the step on every rank (skip_step), and the
    non-finite count of a NaN batch is the single process's."""
    from singa_tpu_torch import (device, distributed, health, layer, model,
                                 opt, tensor)
    from singa_tpu_torch.parallel import data_parallel_mesh
    distributed.init(device="cpu")
    dev = device.create_cpu_device()
    X, Y = _data()
    w0 = {k[3:]: inp[k] for k in inp.files if k.startswith("w0/")}
    ty = tensor.from_numpy(Y, dev)

    def build(policy, name):
        mon = health.HealthMonitor(policy=policy,
                                   out_dir=os.path.join(out, f"{name}{rank}"))
        m = _mlp(model, layer, STRATEGIES["plain"])
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.2, momentum=0.9),
                                    mesh=data_parallel_mesh(world)))
        m.compile([tensor.from_numpy(X, dev)], is_train=True,
                  use_graph=True, health=mon)
        m.set_params(w0)
        return m, mon

    def step(m, x):
        return m(tensor.from_numpy(x, dev), ty)[1].item()

    res = {}
    m, mon = build("skip_step", "skip")
    step(m, X)
    step(m, X)
    before = [t.detach().clone() for t in (*m._raw_states().values(),
                                           *m.optimizer.state_arrays())]
    Xb = X.copy()
    Xb[9, 0] = np.inf         # batch row 9: rank 1's rows (8 a rank)
    step(m, Xb)
    res["skip/action"] = np.array(mon.last_action)
    res["skip/kept"] = all(
        bool((a == b).all()) for a, b in zip(
            before, (*m._raw_states().values(),
                     *m.optimizer.state_arrays())))
    res["skip/anomaly_steps"] = [r["step"] for r in mon.recorder.ring
                                 if r["anomaly_kinds"]]
    res["skip/next_loss"] = step(m, X)
    res["skip/next_action"] = np.array(mon.last_action)
    m, mon = build("warn", "warn")
    step(m, X)
    Xn = X.copy()
    Xn[0, 0] = np.nan
    step(m, Xn)
    bundle = health.load_flight_bundle(mon.recorder.last_bundle)
    res["count/nonfinite"] = [s["nonfinite_grads"] for s in bundle["steps"]
                              if s["anomaly_kinds"]][0]
    return res


def _rnet(world, dev, seed=7):
    """tests/test_resilience.py's Net under DistOpt(SGD(0.1, 0.9)) over
    `world` ranks, its batch from seed 7, its initial weights from
    `seed`."""
    from singa_tpu_torch import layer, model, opt, tensor
    from singa_tpu_torch.parallel import data_parallel_mesh

    class Net(model.Model):
        def __init__(self):
            super().__init__()
            self.fc1 = layer.Linear(16)
            self.relu = layer.ReLU()
            self.fc2 = layer.Linear(4)
            self.sce = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc2(self.relu(self.fc1(x)))

        def train_one_batch(self, x, y):
            loss = self.sce(self.forward(x), y)
            self.optimizer(loss)
            return loss

    rng = np.random.RandomState(7)
    X = rng.randn(16, 8).astype(np.float32)
    Y = rng.randint(0, 4, 16).astype(np.int32)
    dev.SetRandSeed(seed)
    m = Net()
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.1, momentum=0.9),
                                mesh=data_parallel_mesh(world)))
    tx, ty = tensor.from_numpy(X, dev), tensor.from_numpy(Y, dev)
    m.compile([tx], is_train=True, use_graph=True)
    return m, tx, ty


def job_kill(inp, rank, world, out):
    """An uninterrupted 8-step run, then a supervised run (a save every 3
    steps) that dies at step 7 on every rank."""
    from singa_tpu_torch import device, distributed, overlap, resilience
    distributed.init(device="cpu")
    dev = device.create_cpu_device()
    m, tx, ty = _rnet(world, dev)
    res = {"ref": np.asarray([m(tx, ty).item() for _ in range(8)])}
    m, tx, ty = _rnet(world, dev)
    resilience.install_fault_plan(
        resilience.FaultPlan().fail("step", step=7))
    try:
        resilience.TrainController(
            m, inp["ckpt"].item(), save_every_steps=3, max_restarts=0,
            handle_signals=False).fit([(tx, ty)] * 8, epochs=1)
        res["raised"] = np.array("")
    except RuntimeError as e:
        res["raised"] = np.array(str(e))
    resilience.clear_fault_plan()
    overlap.wait_for_checkpoints()
    return res


def job_resume_small(inp, rank, world, out):
    """A fresh job on `world` ranks resumes the killed run's directory."""
    from singa_tpu_torch import (device, distributed, observe, overlap,
                                 resilience)
    distributed.init(device="cpu")
    dev = device.create_cpu_device()
    observe.get_registry().reset()
    m, tx, ty = _rnet(world, dev, seed=3)
    ck = inp["ckpt"].item()
    report = resilience.TrainController(
        m, ck, save_every_steps=3, handle_signals=False).fit(
            [(tx, ty)] * 8, epochs=1)
    overlap.wait_for_checkpoints()
    distributed.barrier()
    reg = observe.get_registry()
    hist = sorted(report["history"])
    return {"status": np.array(report["status"]),
            "resumed_step": report["resumed_step"],
            "final_step": report["final_step"],
            "hist_steps": [k for k, _ in hist],
            "hist_losses": [v for _, v in hist],
            "corrupt": reg.get(
                "singa_resilience_corrupt_skipped_total").value(),
            "resumed_gauge": reg.get(
                "singa_resilience_resumed_step").value(),
            "step99": os.path.exists(os.path.join(ck, "step_99")),
            "step6": resilience.is_complete_checkpoint(
                os.path.join(ck, "step_6")),
            "mesh": np.array(json.dumps(
                (resilience.read_manifest(os.path.join(ck, "step_6"))
                 or {}).get("mesh")))}


# ---- tensor and vocab parallelism (the test_torch_tp*.py files) ------------

def tp_mesh_shape(world):
    """The {data, tp} mesh of the Model-API cases: tp 2, the rest data."""
    return {"data": world // 2, "tp": 2} if world > 2 else {"data": 1,
                                                            "tp": 2}


def dryrun_mesh_shape(world):
    """Dryrun step 2b's mesh (`__graft_entry__.py:250-252`)."""
    tp = 4 if world % 4 == 0 else 2
    return {"data": world // tp, "tp": tp}


def port_ops(inp, mesh):
    """The TP operators' forwards and gradients on this rank's blocks of
    the inputs, with `mesh` ({"tp": n}) bound: {name: array}; sharded
    results are this rank's blocks."""
    import torch

    from singa_tpu_torch import autograd
    from singa_tpu_torch.parallel import (megatron_f, megatron_g,
                                          shard_columns, shard_rows,
                                          tp_mlp)
    from singa_tpu_torch.parallel.tp import Placement
    T = torch.as_tensor
    res = {}
    cols, rows = shard_columns(mesh, "tp"), shard_rows(mesh, "tp")
    vocab = Placement(mesh, ("tp", None))
    last = Placement(mesh, (None, None, "tp"))
    with mesh.bind():
        x = T(inp["x"]).requires_grad_(True)
        Wc = cols.shard(T(inp["Wc"])).clone().requires_grad_(True)
        Wr = rows.shard(T(inp["Wr"])).clone().requires_grad_(True)
        y = megatron_g(megatron_f(x, "tp") @ Wc @ Wr, "tp")
        res["fg/y"] = y
        res["fg/dx"], res["fg/dWc"], res["fg/dWr"] = torch.autograd.grad(
            y, (x, Wc, Wr), T(inp["fg_dy"]))
        for op in ("copy", "reduce"):
            x = T(inp["x"]).requires_grad_(True)
            f = autograd.tp_copy if op == "copy" else autograd.tp_reduce
            y = f(x * (1.0 + mesh.coordinate("tp")), "tp")
            res[f"{op}/y"] = y
            res[f"{op}/dx"], = torch.autograd.grad(y, x, T(inp["x"]))
        table = vocab.shard(T(inp["table"])).clone().requires_grad_(True)
        out = autograd.vocab_parallel_embedding(T(inp["ids"]), table, "tp")
        res["emb/out"] = out
        res["emb/dtable"], = torch.autograd.grad(out, table,
                                                 T(inp["emb_dy"]))
        logits = Placement(mesh, (None, "tp")).shard(T(inp["logits"])) \
            .clone().requires_grad_(True)
        loss = autograd.vocab_parallel_sce(logits, T(inp["tgt"]), "tp",
                                           valid_vocab=13)
        res["sce/loss"] = loss
        res["sce/dx"], = torch.autograd.grad(loss, logits)
        g = last.shard(T(inp["g"])).clone().requires_grad_(True)
        full = autograd.gather_last(g, "tp")
        res["gather/y"] = full
        res["gather/dx"], = torch.autograd.grad(full, g, T(inp["g_dy"]))
        res["argmax"] = autograd.vocab_parallel_argmax(
            last.shard(T(inp["am"])), "tp", valid_vocab=13)
        for case in ("mlp", "dry"):
            res[f"{case}/y"] = tp_mlp(
                T(inp[f"{case}_x"]), cols.shard(T(inp[f"{case}_W1"])),
                Placement(mesh, ("tp",)).shard(T(inp[f"{case}_b1"])),
                rows.shard(T(inp[f"{case}_W2"])), T(inp[f"{case}_b2"]),
                "tp")
    return {k: v.detach().numpy() for k, v in res.items()}


def job_tp_ops(inp, rank, world, out):
    import torch

    from singa_tpu_torch import distributed
    from singa_tpu_torch.parallel import Communicator, make_mesh
    distributed.init(device="cpu")
    mesh = make_mesh({"tp": world})
    res = port_ops(inp, mesh)
    # a transposed view (the tied head's gradient) all-reduced by the
    # communicator comes back contiguous: NCCL takes no other layout
    comm = Communicator(axis="tp", mesh=mesh)
    t = torch.as_tensor(inp["Wc"]).t()
    for verb in ("all_reduce", "all_reduce_half", "all_reduce_max",
                 "broadcast"):
        y = getattr(comm, verb)(t)
        res[f"comm/{verb}"] = y.numpy()
        res[f"comm/{verb}/contiguous"] = y.is_contiguous()
    return res


def _tp_mlp_model(model, layer, sparse):
    """tests/test_parallel_extra.py's TPMLP (10 -> 32 -> 4, fc1 column,
    fc2 row), or with `sparse` tests/test_dist.py's TPMLPSparse (10 ->
    16 -> 4, top-K 0.25)."""

    class TPMLP(model.Model):
        def __init__(self):
            super().__init__()
            self.fc1 = layer.Linear(16 if sparse else 32, tp_axis="tp",
                                    tp_mode="column")
            self.relu = layer.ReLU()
            self.fc2 = layer.Linear(4, tp_axis="tp", tp_mode="row")
            self.loss_fn = layer.SoftMaxCrossEntropy()

        def forward(self, x):
            return self.fc2(self.relu(self.fc1(x)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.loss_fn(out, y)
            if sparse:
                self._optimizer.backward_and_sparse_update(
                    loss, spars=0.25, topK=True)
                return loss
            self._optimizer(loss)
            return out, loss

    return TPMLP()


def _global_params(m):
    return {k: v.numpy().copy() for k, v in m.get_params().items()}


def job_tp_model(inp, rank, world, out):
    """The TP MLP through the Model API and the sparse strategy over its
    TP parameters, from JAX's initial weights."""
    from singa_tpu_torch import (device, distributed, introspect, layer,
                                 memory, model, opt)
    from singa_tpu_torch import tensor
    from singa_tpu_torch.parallel import make_mesh
    distributed.init(device="cpu")
    dev = device.create_cpu_device()
    mesh = make_mesh(tp_mesh_shape(world))
    res = {}
    for case, sparse, steps in (("mlp", False, 5), ("sparse", True, 25)):
        m = _tp_mlp_model(model, layer, sparse)
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.2 if sparse else 0.1,
                                            momentum=0.9),
                                    axis="data", mesh=mesh,
                                    sparse_residuals=sparse))
        tx = tensor.from_numpy(inp[f"{case}_X"], dev)
        ty = tensor.from_numpy(inp[f"{case}_Y"], dev)
        m.compile([tx], is_train=True, use_graph=True)
        m.set_params({k[len(case) + 4:]: inp[k] for k in inp.files
                      if k.startswith(f"{case}_w0/")})
        losses = []
        for _ in range(steps):
            o = m(tx, ty)
            losses.append((o if sparse else o[1]).item())
        res[f"{case}/losses"] = losses
        for k, v in _global_params(m).items():
            res[f"{case}/p/{k}"] = v
        res[f"{case}/local_W"] = list(m.fc1.W.shape) + list(m.fc2.W.shape)
        if not sparse:
            # the ledger's and the counted step's sizes are the rank's
            fit = memory.estimate_fit(m)
            res["mlp/params_bytes"] = fit["params_bytes"]
            res["mlp/opt_bytes"] = fit["opt_state_bytes"]
            res["mlp/flops"] = introspect.last_build("step")["cost"]["flops"]
            # sharded parameters under any other optimizer raise, where
            # the layers would run the serial math on the shards
            for name, other in (("sgd", opt.SGD(lr=0.1)),
                                ("nogroup", opt.DistOpt(opt.SGD(lr=0.1)))):
                m.set_optimizer(other)
                for graph in (True, False):
                    m.graph_mode = graph
                    try:
                        m(tx, ty)
                        msg = "trained"
                    except ValueError as e:
                        msg = str(e)
                    res[f"mlp/other_opt/{name}/{graph}"] = msg
        if sparse:
            d = m.optimizer
            res["sparse/residual_specs"] = np.array([
                repr(getattr(d.opt._params_by_id[pid], "spec", None))
                for pid in d._spars_order])
            res["sparse/state_specs"] = np.array(
                [repr(s) for s in d.state_specs()])
    return res


#: the GPT cases of test_torch_tp_gpt.py: (config, mesh, optimizer lr,
#: steps); "preds" runs the config twice (gathered logits, argmax)
TP_GPT = {
    "gpt": (dict(vocab_size=50, max_seq=16, dim=32, num_heads=4,
                 num_layers=2, tp_axis="tp"), "tp", 0.05, 3),
    "gqa": (dict(vocab_size=50, max_seq=16, dim=32, num_heads=8,
                 num_kv_heads=4, num_layers=2, tp_axis="tp"), "tp", 0.05, 3),
    "vocab": (dict(vocab_size=50, max_seq=16, dim=32, num_heads=4,
                   num_layers=2, tp_axis="tp", vocab_tp=True,
                   vocab_pad_multiple=8), "tp", 0.05, 3),
    "preds": (dict(vocab_size=48, max_seq=8, dim=32, num_heads=4,
                   num_layers=1, tp_axis="tp", vocab_tp=True,
                   vocab_pad_multiple=8), "tp", 0.0, 1),
    "ckpt": (dict(vocab_size=48, max_seq=8, dim=16, num_heads=4,
                  num_layers=1, tp_axis="tp", vocab_tp=True,
                  vocab_pad_multiple=8), "tp", 0.05, 4),
    "dry2b": (dict(vocab_size=50, max_seq=8, dim=16, num_heads=4,
                   num_layers=1, tp_axis="tp", vocab_tp=True,
                   vocab_pad_multiple=8), "dryrun", 0.05, 1),
    "moe": (dict(vocab_size=50, max_seq=16, dim=32, num_heads=4,
                 num_layers=1, tp_axis="tp", moe_experts=2, moe_k=1),
            "tp", 0.05, 2),
}


def tp_gpt_mesh_shape(case, world):
    return dryrun_mesh_shape(world) if TP_GPT[case][1] == "dryrun" \
        else tp_mesh_shape(world)


def job_tp_gpt(inp, rank, world, out):
    """The TP GPT cases (`TP_GPT`) named in the input `cases`, from JAX's
    initial weights: losses,
    the last step's output, the global parameters, the local table's
    rows; the vocab-parallel checkpoint saved mid-run and resumed in a
    fresh mesh-compiled model."""
    import torch

    from singa_tpu_torch import distributed, models, opt
    from singa_tpu_torch.models import transformer
    from singa_tpu_torch.parallel import make_mesh
    distributed.init(device="cpu")
    res = {}

    def build(case, **over):
        cfg, _, lr, _ = TP_GPT[case]
        m = models.create_model("gpt", device="cpu", **dict(cfg, **over))
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=lr), axis="data",
                                    mesh=make_mesh(tp_gpt_mesh_shape(
                                        case, world))))
        ids = torch.as_tensor(inp[f"{case}_ids"])
        m.compile([ids], is_train=True, use_graph=True)
        m.set_params({k[len(case) + 4:]: inp[k] for k in inp.files
                      if k.startswith(f"{case}_w0/")})
        return m, ids, torch.as_tensor(inp[f"{case}_tgt"])

    def steps(m, ids, tgt, n):
        outs = [m(ids, tgt) for _ in range(n)]
        return outs[-1][0], [loss.item() for _, loss in outs]

    cases = [str(c) for c in inp["cases"]]
    for case in [c for c in ("gpt", "gqa", "vocab", "dry2b", "moe")
                 if c in cases]:
        m, ids, tgt = build(case)
        n = TP_GPT[case][3]
        o, res[f"{case}/losses"] = steps(m, ids, tgt, n)
        res[f"{case}/out"] = o
        for k, v in _global_params(m).items():
            res[f"{case}/p/{k}"] = v
        res[f"{case}/local_rows"] = m.tok_embed.W.shape[0]
        res[f"{case}/wq_cols"] = m.blocks[0].attn.Wq.shape[1]
        # the JAX package's initial weights into the sharded model again
        # (its get_params() dict, its save_states zip): each rank keeps
        # its blocks and the run repeats
        if case == "gpt":
            transformer.load_singa_params(m, {
                k[len("gpt_w0/"):]: inp[k] for k in inp.files
                if k.startswith("gpt_w0/")})
        elif case == "vocab":
            transformer.load_singa_states(m, inp["vocab_zip"].item())
        else:
            continue
        res[f"{case}/bridge_losses"] = steps(m, ids, tgt, n)[1]
    if "preds" in cases:
        for name, logits in (("full", True), ("pred", False)):
            m, ids, tgt = build("preds", vocab_tp_return_logits=logits)
            o, res[f"preds/{name}/losses"] = steps(m, ids, tgt, 1)
            res[f"preds/{name}/out"] = o
    if "ckpt" in cases:
        m, ids, tgt = build("ckpt")
        _, res["ckpt/ref"] = steps(m, ids, tgt, 4)
        m, ids, tgt = build("ckpt")
        steps(m, ids, tgt, 2)
        path = m.save_checkpoint(inp["ckpt"].item(), step=2)
        m, ids, tgt = build("ckpt")
        m.load_checkpoint(path)
        _, res["ckpt/got"] = steps(m, ids, tgt, 2)
        res["ckpt/local_rows"] = m.tok_embed.W.shape[0]
        from singa_tpu_torch.model import _read_states_zip
        res["ckpt/file_rows"] = _read_states_zip(
            os.path.join(path, "model.zip"))["tok_embed.W"].shape[0]
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in res.items()}


# ---- sequence parallelism (test_torch_sp.py) -------------------------------

#: the sequence-sharded GPT forwards (tests/test_attention.py:234-300):
#: learned positions, RoPE and GQA, one layer over {sp: world}
SP_GPT = {
    "learned": dict(vocab_size=50, max_seq=32, dim=32, num_heads=4,
                    num_layers=1, seq_axis="sp"),
    "rope": dict(vocab_size=50, max_seq=32, dim=32, num_heads=4,
                 num_layers=1, seq_axis="sp", pos_encoding="rope"),
    "gqa": dict(vocab_size=50, max_seq=32, dim=32, num_heads=4,
                num_kv_heads=2, num_layers=1, seq_axis="sp"),
}


def sp_dry_meshes(world):
    """The {data, sp} meshes of dryrun step 2 (`__graft_entry__.py:
    187-244`) on `world` ranks: {data 1, sp world}, and {data 2, sp 2}
    at 4."""
    out = [{"data": 1, "sp": world}]
    if world == 4:
        out.append({"data": 2, "sp": 2})
    return out


#: dryrun step 2's GPT (`__graft_entry__.py:200-201`), with max_seq 32,
#: the longest S of the meshes, on every mesh: one set of weights
SP_DRY_GPT = dict(vocab_size=50, max_seq=32, dim=32, num_heads=4,
                  num_layers=1, seq_axis="sp")


def sp_dry_data(shape):
    """Dryrun step 2's batch and sequence on a {data, sp} mesh: B 2 a
    data rank, S 8 an sp rank."""
    return 2 * shape["data"], 8 * shape["sp"]


def _block(t, dim, index, size):
    n = t.shape[dim] // size
    return t.narrow(dim, index * n, n).contiguous()


def job_sp(inp, rank, world, out):
    """Ring attention over {sp: world} on this rank's blocks (forward and
    the gradients of sum(o^2)), `ring_attention_sharded` on the global
    arrays (its output and gradients), the sequence-sharded GPT
    forwards (`SP_GPT`) and dryrun step 2's functional step on each mesh
    of `sp_dry_meshes`, all from the inputs' (JAX's) weights."""
    import torch

    from singa_tpu_torch import autograd, distributed, models, tensor
    from singa_tpu_torch.models import transformer
    from singa_tpu_torch.ops.attention import (ring_attention,
                                               ring_attention_sharded)
    from singa_tpu_torch.parallel import make_mesh
    from singa_tpu_torch.parallel.tp import _psum, _mesh_axis
    distributed.init(device="cpu")
    T = torch.as_tensor
    res = {}
    mesh = make_mesh({"sp": world})
    me = mesh.coordinate("sp")
    for causal in (False, True):
        q, k, v = (T(inp[f"ring_{c}"]) for c in "qkv")
        local = [_block(t, 2, me, world).requires_grad_(True)
                 for t in (q, k, v)]
        with mesh.bind():
            o = ring_attention(*local, "sp", causal)
        res[f"ring/{causal}/out"] = o
        for name, g in zip("qkv", torch.autograd.grad((o ** 2).sum(),
                                                      local)):
            res[f"ring/{causal}/d{name}"] = g
        full = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = ring_attention_sharded(*full, mesh, "sp", causal)
        res[f"sharded/{causal}/out"] = o
        for name, g in zip("qkv", torch.autograd.grad((o ** 2).sum(),
                                                      full)):
            res[f"sharded/{causal}/d{name}"] = g
    for case, cfg in SP_GPT.items():
        m = models.create_model("gpt", device="cpu", **cfg)
        transformer.load_singa_params(m, {
            k[len(case) + 4:]: inp[k] for k in inp.files
            if k.startswith(f"{case}_w0/")})
        with mesh.bind(), torch.no_grad():
            res[f"gpt/{case}"] = m.forward(
                _block(T(inp["gpt_ids"]), 1, me, world))
    for shape in sp_dry_meshes(world):
        key = "dry/{data}x{sp}".format(**shape)
        dm = make_mesh(shape)
        g = models.create_model("gpt", device="cpu", **SP_DRY_GPT)
        transformer.load_singa_params(g, {
            k[len("dry_w0/"):]: inp[k] for k in inp.files
            if k.startswith("dry_w0/")})
        d, sp = dm.coordinate("data"), dm.coordinate("sp")

        def rows(name):
            t = _block(T(inp[f"{key}_{name}"]), 0, d, shape["data"])
            return tensor.Tensor(data=_block(t, 1, sp, shape["sp"]),
                                 requires_grad=False)

        views = g.get_params()
        with dm.bind():
            prev = autograd.training
            autograd.training = True
            try:
                logits = g.forward(rows("ids"))
                loss = autograd.softmax_cross_entropy(
                    autograd.reshape(logits, (-1, SP_DRY_GPT["vocab_size"])),
                    autograd.reshape(rows("tgt"), (-1,)))
                grads = autograd.gradients(loss)
            finally:
                autograd.training = prev

        def pmean(x):
            for a in ("data", "sp"):
                x = _psum(x, _mesh_axis(dm, a)) / shape[a]
            return x

        for name, p in views.items():
            res[f"{key}/p/{name}"] = p.data - 0.05 * pmean(grads[p].data)
        res[f"{key}/loss"] = pmean(loss.data)
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in res.items()}


# ---- expert parallelism (test_torch_ep.py) ---------------------------------

#: moe_ffn_ep's cases at E = 4: (k, capacity factor); tests/test_moe.py:57
#: (top-2 at a capacity factor of E), and :162's top-1 at 1.0, where
#: routes drop
EP_FFN = {"top2": (2, 4.0), "top1": (1, 1.0)}
#: the MoE-GPTs through Model/DistOpt(axis=("data", "ep")): (config,
#: steps); "model" is tests/test_moe.py:85's (router losses off),
#: "dry2b" dryrun step 2b's (`__graft_entry__.py:378-395`)
EP_GPT = {
    "model": (dict(vocab_size=40, max_seq=8, dim=16, num_heads=2,
                   num_layers=2, moe_experts=4, moe_k=2, ep_axis="ep",
                   moe_capacity_factor=4.0, moe_aux_weight=0.0,
                   moe_z_weight=0.0), 3),
    "dry2b": (dict(vocab_size=50, max_seq=8, dim=16, num_heads=2,
                   num_layers=1, moe_k=2, ep_axis="ep"), 1),
}


def ep_gpt_cases(world):
    """The EP_GPT cases on `world` ranks: "model" on its {data 2, ep 2}
    at 4, dryrun 2b's at 2 and 4."""
    return ("model", "dry2b") if world == 4 else ("dry2b",)


def ep_mesh_shape(case, world):
    """{data world / 2, ep 2} for "model"; dryrun 2b's {data world / ep,
    ep} (ep 4 when 4 divides world)."""
    if case == "dry2b":
        ep = 4 if world % 4 == 0 else 2
        return {"data": world // ep, "ep": ep}
    return {"data": world // 2, "ep": 2}


def ep_gpt_config(case, world):
    cfg, steps = EP_GPT[case]
    if case == "dry2b":
        cfg = dict(cfg, moe_experts=ep_mesh_shape(case, world)["ep"])
    return cfg, steps


#: the MoE-GPT refused under a data-only DistOpt (tests/test_moe.py:139's
#: check): dryrun 2b's at 2 ranks, whose shapes JAX's side has run already
EP_REFUSED = ep_gpt_config("dry2b", 2)[0]


def job_ep(inp, rank, world, out):
    """moe_ffn_ep over {ep: world} on this rank's tokens and experts (the
    outputs and the gradients of sum(y^2) + aux / 2 + z / 10), the
    MoE-GPTs of `EP_GPT` through the Model API from the inputs' (JAX's)
    weights, and the refusal of a DistOpt that reduces over data only."""
    import torch

    from singa_tpu_torch import distributed, models, opt
    from singa_tpu_torch.parallel import make_mesh, moe_ffn_ep
    distributed.init(device="cpu")
    T = torch.as_tensor
    res = {}
    mesh = make_mesh({"ep": world})
    me = mesh.coordinate("ep")
    for case, (k, cf) in EP_FFN.items():
        args = [_block(T(inp["ffn_x"]), 0, me, world)]
        args.append(T(inp["ffn_Wg"]).clone())
        args += [_block(T(inp[f"ffn_{n}"]), 0, me, world)
                 for n in ("W1", "b1", "W2", "b2")]
        for a in args:
            a.requires_grad_(True)
        with mesh.bind():
            y, aux, (z, ovf) = moe_ffn_ep(*args, "ep", capacity_factor=cf,
                                          k=k)
        res[f"ffn/{case}/y"] = y
        res[f"ffn/{case}/stats"] = torch.stack([aux, z, ovf])
        grads = torch.autograd.grad((y ** 2).sum() + 0.5 * aux + 0.1 * z,
                                    args)
        for n, g in zip(("x", "Wg", "W1", "b1", "W2", "b2"), grads):
            res[f"ffn/{case}/d{n}"] = g
    for case in ep_gpt_cases(world):
        cfg, steps = ep_gpt_config(case, world)
        m = models.create_model("gpt", device="cpu", **cfg)
        m.set_optimizer(opt.DistOpt(
            opt.SGD(lr=0.05), axis=("data", "ep"),
            mesh=make_mesh(ep_mesh_shape(case, world))))
        ids = T(inp[f"{case}_ids"])
        m.compile([ids], is_train=True, use_graph=True)
        m.set_params({k[len(case) + 4:]: inp[k] for k in inp.files
                      if k.startswith(f"{case}_w0/")})
        tgt = T(inp[f"{case}_tgt"])
        res[f"{case}/losses"] = [m(ids, tgt)[1].item()
                                 for _ in range(steps)]
        for k, v in m.get_params().items():
            res[f"{case}/p/{k}"] = v.data
    m = models.create_model("gpt", device="cpu", **EP_REFUSED)
    m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.05), axis="data",
                                mesh=make_mesh(ep_mesh_shape("model",
                                                             world))))
    ids = T(inp["refused_ids"])
    m.compile([ids], is_train=True, use_graph=True)
    try:
        m(ids, ids.roll(-1, 1))
        res["refused"] = "trained"
    except ValueError as e:
        res["refused"] = str(e)
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in res.items()}


# ---- pipeline parallelism (test_torch_pipeline.py, test_torch_pp_gpt.py) --

def pp_tanh_stage(p, h):
    """tests/test_parallel_extra.py:662's stage: tanh(h @ W + b)."""
    import torch
    return torch.tanh(h @ p[0] + p[1])


def pp_tanh_chunk(p, h, c):
    """The interleaved stage's chunk c: p holds the stage's (V, d, d)
    weights and (V, d) biases."""
    import torch
    return torch.tanh(h @ p[0][c] + p[1][c])


def pp_square_loss(lp, y, t):
    """The 1F1B tests' last_fn: mean((y @ w - t)^2)."""
    return ((y @ lp[0] - t) ** 2).mean()


def job_pp_fn(inp, rank, world, out):
    """gpipe, gpipe_interleaved and one_f_one_b over {pp: world} on this
    rank's stage (tests/test_parallel_extra.py:666-718's inputs): the
    outputs through bcast_from_last and the gradients of their sum of
    squares, 1F1B's five results, and dryrun step 3's pp_run
    (`__graft_entry__.py:407-427`: gpipe, then last_stage_value)."""
    import torch

    from singa_tpu_torch import distributed
    from singa_tpu_torch.parallel import make_mesh
    from singa_tpu_torch.parallel import pipeline as P
    distributed.init(device="cpu")
    T = torch.as_tensor
    mesh = make_mesh({"pp": world})
    me = mesh.coordinate("pp")
    res = {}

    def grads(y, xs):
        return [torch.zeros_like(x) if g is None else g for x, g in zip(
            xs, torch.autograd.grad((y ** 2).sum(), xs, allow_unused=True))]

    with mesh.bind():
        args = [T(inp["Ws"][me]), T(inp["bs"][me]), T(inp["x"])]
        for a in args:
            a.requires_grad_(True)
        y = P.bcast_from_last("pp", P.gpipe(pp_tanh_stage, args[:2],
                                            args[2], "pp"))
        res["gpipe/out"] = y
        for k, g in zip(("dW", "db", "dx"), grads(y, args)):
            res[f"gpipe/{k}"] = g
        args = [T(inp["Wi"][:, me]), T(inp["bi"][:, me]), T(inp["x"])]
        for a in args:
            a.requires_grad_(True)
        y = P.bcast_from_last("pp", P.gpipe_interleaved(
            pp_tanh_chunk, args[:2], args[2], "pp", inp["Wi"].shape[0]))
        res["il/out"] = y
        for k, g in zip(("dW", "db", "dx"), grads(y, args)):
            res[f"il/{k}"] = g
        loss, outs, ds, dl, dx = P.one_f_one_b(
            pp_tanh_stage, pp_square_loss, (T(inp["Ws"][me]),
                                            T(inp["bs"][me])),
            (T(inp["wl"]),), T(inp["x"]), T(inp["tgt"]), "pp")
        res.update({"1f1b/loss": loss, "1f1b/outs": outs, "1f1b/dW": ds[0],
                    "1f1b/db": ds[1], "1f1b/dwl": dl[0], "1f1b/dx": dx})
        res["dry3/out"] = P.last_stage_value(P.gpipe(
            pp_tanh_stage, (T(inp["dry_Ws"][me]), T(inp["dry_bs"][me])),
            T(inp["dry_x"]), "pp"), "pp")
    return {k: v.detach().numpy() for k, v in res.items()}


#: the PipelinedGPTs of test_torch_pp_gpt.py at `world` ranks: name ->
#: (config, mesh, DistOpt axis, compile's pipeline arguments). From
#: tests/test_parallel_extra.py: "gpipe"/"1f1b" (:244-335), "gqa"
#: (:761), "rope" (:806); dryrun step 2b's (`__graft_entry__.py:272-317`,
#: num_layers world + 1, non-uniform: gpipe at n_micro 2, 1f1b at 4;
#: interleave 2 over 2 world - 1 layers at n_micro world); at 8 ranks its
#: pp x ep (:319-341) and 3-D (:352-377) meshes, and :617's vocab-parallel
#: model on a mesh without the tp axis
PP_SMALL = dict(vocab_size=40, max_seq=8, dim=16, num_heads=2,
                num_layers=4)
PP_DRY = dict(vocab_size=50, max_seq=8, dim=16, num_heads=2)
PP_VOCAB = dict(PP_DRY, tp_axis="tp", vocab_tp=True, vocab_pad_multiple=8)


def pp_gpt_cases(world):
    """The PP_GPT case names run at `world` ranks."""
    if world == 8:
        return ("ppxep", "3d", "notp")
    dry = ("dry_gpipe", "dry_1f1b", "dry_il")
    return ("gpipe", "1f1b", "gqa", "rope") + dry if world == 4 else dry


def pp_gpt_case(case, world):
    """(config, mesh, DistOpt axis, compile kwargs) of `case`."""
    pp = {"data": 1, "pp": world}
    table = {
        "gpipe": (PP_SMALL, pp, "data", dict(n_micro=4)),
        "1f1b": (PP_SMALL, pp, "data",
                 dict(n_micro=4, pipeline_schedule="1f1b")),
        "gqa": (dict(PP_SMALL, num_heads=4, num_kv_heads=2), pp, "data",
                dict(n_micro=4)),
        "rope": (dict(PP_SMALL, pos_encoding="rope"), pp, "data",
                 dict(n_micro=4, pipeline_schedule="1f1b")),
        "dry_gpipe": (dict(PP_DRY, num_layers=world + 1), pp, "data",
                      dict(n_micro=2)),
        "dry_1f1b": (dict(PP_DRY, num_layers=world + 1), pp, "data",
                     dict(n_micro=4, pipeline_schedule="1f1b")),
        "dry_il": (dict(PP_DRY, num_layers=2 * world - 1, interleave=2), pp,
                   "data", dict(n_micro=world)),
        "ppxep": (dict(PP_DRY, num_layers=3, moe_experts=4, moe_k=2,
                       ep_axis="ep"), {"data": 2, "pp": 2, "ep": 2},
                  ("data", "ep"), dict(n_micro=2)),
        "3d": (dict(PP_VOCAB, num_layers=3), {"data": 2, "pp": 2, "tp": 2},
               "data", dict(n_micro=2, pipeline_schedule="1f1b")),
        "notp": (dict(PP_VOCAB, num_layers=2), {"data": 2, "pp": 4}, "data",
                 dict(n_micro=2, pipeline_schedule="1f1b")),
    }
    return table[case]


#: the steps of every case, SGD(0.05)
PP_STEPS = 3


def pp_gpt_data(case, world):
    """(ids, targets) of `case`: B 8, S 8 (dryrun 2b's B is 2 world)."""
    seed = sum(map(ord, case))
    B = 2 * world if case.startswith("dry") else 8
    V = pp_gpt_case(case, world)[0]["vocab_size"]
    ids = np.random.RandomState(seed).randint(0, V, (B, 8))
    return ids.astype(np.int32), np.roll(ids, -1, axis=1).astype(np.int32)


def job_pp_gpt(inp, rank, world, out):
    """The PipelinedGPTs of `pp_gpt_cases(world)` through the Model API
    under DistOpt(SGD(0.05)), from the inputs' (JAX's) initial weights
    (`load_singa_params` for half the cases, `set_params` for the
    others): the losses of PP_STEPS steps, the global parameters, the
    rank's stack rows; on rank 0 the same config's serial losses (plain
    SGD, no pipeline axis) from the same weights; at 2 ranks, the
    gathered `save_states` zip of the dryrun's gpipe model (a file a
    rank)."""
    import torch

    from singa_tpu_torch import distributed, models, opt
    from singa_tpu_torch.models import transformer
    from singa_tpu_torch.parallel import make_mesh
    distributed.init(device="cpu")
    T = torch.as_tensor
    res = {}
    for i, case in enumerate(pp_gpt_cases(world)):
        cfg, mesh, axis, comp = pp_gpt_case(case, world)
        w0 = {k[len(case) + 4:]: inp[k] for k in inp.files
              if k.startswith(f"{case}_w0/")}
        ids, tgt = T(inp[f"{case}_ids"]), T(inp[f"{case}_tgt"])
        m = models.create_model("gpt_pipe", device="cpu", **cfg)
        m.set_optimizer(opt.DistOpt(opt.SGD(lr=0.05), axis=axis,
                                    mesh=make_mesh(mesh)))
        m.compile([ids], is_train=True, use_graph=True, pipeline_axis="pp",
                  **comp)
        if i % 2:
            transformer.load_singa_params(m, w0)
        else:
            m.set_params(w0)
        res[f"{case}/losses"] = [m(ids, tgt)[1].item()
                                 for _ in range(PP_STEPS)]
        res[f"{case}/rows"] = m.Wq.shape[1 if cfg.get("interleave") else 0]
        for k, v in m.get_params().items():
            res[f"{case}/p/{k}"] = v.data
        if case == "dry_gpipe" and world == 2:
            m.save_states(os.path.join(out, f"states{rank}.zip"))
        if rank == 0 and "moe_experts" not in cfg:
            s = models.create_model("gpt_pipe", device="cpu", **cfg)
            s.set_optimizer(opt.SGD(lr=0.05))
            s.compile([ids], is_train=True, use_graph=True)
            s.set_params(w0)
            res[f"{case}/serial"] = [s(ids, tgt)[1].item()
                                     for _ in range(PP_STEPS)]
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in res.items()}


JOBS = {"topo": job_topo, "env": job_env, "verbs": job_verbs,
        "train": job_train, "resume": job_resume, "dryrun": job_dryrun,
        "health": job_health, "kill": job_kill,
        "resume_small": job_resume_small, "tp_ops": job_tp_ops,
        "tp_model": job_tp_model, "tp_gpt": job_tp_gpt, "sp": job_sp,
        "ep": job_ep, "pp_fn": job_pp_fn, "pp_gpt": job_pp_gpt}


def _pin():
    """This process on run_job's `cpus` cores, when it set them."""
    if os.environ.get(_CPUS):
        os.sched_setaffinity(0, {int(c) for c in
                                 os.environ[_CPUS].split(",")})


def forked_main(argv):
    """Every rank of a job as a fork of this process, after one import of
    torch and the port (no thread exists yet: a fork copies only the
    calling thread). Rank r writes rank<r>.log; the ranks' exit codes go
    to rcs.json. Returns 0 when every rank returned 0."""
    job, world, store, inp, out = argv
    world = int(world)
    _pin()
    import threading

    import torch  # noqa: F401
    from singa_tpu_torch import distributed, models, opt, parallel  # noqa
    if threading.active_count() != 1 or \
            len(os.listdir("/proc/self/task")) != 1:
        raise RuntimeError("the launcher holds threads; it cannot fork")
    ranks = {}
    for r in range(world):
        pid = os.fork()
        if pid == 0:
            fd = os.open(os.path.join(out, f"rank{r}.log"),
                         os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            os.dup2(fd, 1)
            os.dup2(fd, 2)
            rc = 1
            try:
                rc = main([job, str(r), str(world), store, inp, out])
            except BaseException:
                traceback.print_exc()
            finally:
                sys.stdout.flush()
                sys.stderr.flush()
                os._exit(rc)
        ranks[pid] = r
    rcs = [None] * world
    for _ in range(world):
        pid, status = os.wait()
        rcs[ranks[pid]] = os.waitstatus_to_exitcode(status)
    with open(os.path.join(out, "rcs.json"), "w") as f:
        json.dump(rcs, f)
    return 0 if not any(rcs) else 1


def main(argv):
    job, rank, world, store, inp, out = argv
    rank, world = int(rank), int(world)
    _pin()
    import datetime

    import torch
    torch.set_num_threads(1)
    if store != "env":
        torch.distributed.init_process_group(
            "gloo", init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=90))
    with np.load(inp) as z:
        inputs = _Inputs({k: z[k] for k in z.files})
    res = JOBS[job](inputs, rank, world, out)
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in res.items()})
    from singa_tpu_torch import distributed
    distributed.shutdown()
    return 0


class _Inputs(dict):
    """The job's numpy inputs (`.files` lists the names, as an npz)."""

    @property
    def files(self):
        return list(self)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--forked"]:
        sys.exit(forked_main(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
