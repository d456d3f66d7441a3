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
`distributed.init()`'s environment fallbacks instead.
"""

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.abspath(__file__)


def run_job(job, world, tmp_path, inputs=None, timeout=120, env=None,
            store=None):
    """Run `job` on `world` ranks; returns each rank's results, a dict of
    numpy arrays, in rank order. `env` adds environment variables (per
    rank: a callable of the rank); `store` "env" skips the file store."""
    work = os.path.join(str(tmp_path), job)
    os.makedirs(work, exist_ok=True)
    inp = os.path.join(work, "inputs.npz")
    np.savez(inp, **(inputs or {}))
    store = store or os.path.join(work, "store")
    base = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                PYTHONUNBUFFERED="1")
    procs, logs = [], []
    for r in range(world):
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
            p.kill()
            p.wait()
    for log in logs:
        log.close()
    if any(rc != 0 for rc in rcs):
        text = ""
        for r in range(world):
            with open(os.path.join(work, f"rank{r}.log")) as f:
                text += f"--- rank {r} (rc {rcs[r]}) ---\n{f.read()[-3000:]}"
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


JOBS = {"topo": job_topo, "env": job_env, "verbs": job_verbs,
        "train": job_train, "resume": job_resume, "dryrun": job_dryrun,
        "health": job_health, "kill": job_kill,
        "resume_small": job_resume_small}


def main(argv):
    job, rank, world, store, inp, out = argv
    rank, world = int(rank), int(world)
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
    sys.exit(main(sys.argv[1:]))
