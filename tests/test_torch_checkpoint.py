"""Port parity, resumable training checkpoints on the CPU:

- resume equivalence: 3 steps, `save_checkpoint`, `load_checkpoint`
  into a fresh model (other weights, the device's generator moved on),
  3 more steps = 6 uninterrupted steps, bit for bit: losses, states, the
  optimizer's states (Adam's moments and its step counter) and the
  device generator's stream (dropout draws from it); the same holds for
  the GPT with SGD, and through `fit`;
- the directory's semantics, the JAX package's: a complete `step_N` (a
  manifest beside it) raises unless `overwrite=True`, which removes the
  stale manifest; one without a manifest is set aside as
  `step_N.reclaimed`, at most three kept;
- the async save's barrier: a pending write is waited for by the next
  save, by `load_checkpoint` and by `wait_for_checkpoints`, and a failed
  write is re-raised there, later, with its cause (no wall-clock test);
- the checkpoint's `model.zip` loads into the JAX package's model
  (`Model.load_states`), and its optimizer states carry the JAX keys."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from singa_tpu import device as jdevice
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jt
from singa_tpu_torch import _ckpt
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tl
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import opt as topt
from singa_tpu_torch import overlap
from singa_tpu_torch import tensor as tt
from singa_tpu_torch.models import transformer as ttr

torch.set_num_threads(2)
GPT_CFG = dict(vocab_size=97, max_seq=32, dim=64, num_heads=4, num_layers=2)


def _cpu():
    return tdevice.create_cpu_device()


class DropNet(tmodel.Model):
    """Linear, ReLU, dropout (the device's generator), Linear."""

    def __init__(self):
        super().__init__()
        self.fc1 = tl.Linear(16)
        self.relu = tl.ReLU()
        self.drop = tl.Dropout(0.3)
        self.fc2 = tl.Linear(4)
        self.sce = tl.SoftMaxCrossEntropy()

    def forward(self, x):
        return self.fc2(self.drop(self.relu(self.fc1(x))))

    def train_one_batch(self, x, y):
        out = self.forward(x)
        loss = self.sce(out, y)
        self.optimizer(loss)
        return out, loss


def _data():
    rng = np.random.RandomState(0)
    return (tt.from_numpy(rng.randn(12, 6).astype(np.float32),
                          device=_cpu()),
            tt.from_numpy(rng.randint(0, 4, 12).astype(np.int32),
                          device=_cpu()))


def _build(seed):
    _cpu().SetRandSeed(seed)
    m = DropNet()
    m.set_optimizer(topt.Adam(lr=0.01, weight_decay=1e-4))
    x, _ = _data()
    m.compile([x], is_train=True, use_graph=True)
    return m


def _snapshot(m):
    return ({k: v.detach().clone() for k, v in m._raw_states().items()},
            m.optimizer.get_states())


def _equal(a, b):
    (sa, oa), (sb, ob) = a, b
    return (all(torch.equal(sa[k], sb[k]) for k in sa)
            and sorted(oa) == sorted(ob)
            and all(np.array_equal(oa[k], ob[k]) for k in oa))


@pytest.mark.parametrize("async_save", [True, False])
def test_resume_is_bitwise_uninterrupted(tmp_path, async_save):
    x, y = _data()
    ref = _build(7)
    want = [float(ref(x, y)[1].data) for _ in range(6)]
    stream_after = _cpu().rng_state.clone()
    a = _build(7)
    got = [float(a(x, y)[1].data) for _ in range(3)]
    path = a.save_checkpoint(str(tmp_path / "ck"), step=3,
                             async_save=async_save)
    assert path == str(tmp_path / "ck" / "step_3")
    _cpu().SetRandSeed(123)        # the stream moves on before the resume
    b = _build(99)                 # other initial weights
    b.load_checkpoint(path)
    assert overlap.pending_checkpoints() == 0
    assert sorted(os.listdir(path)) == ["meta.json", "model.zip", "opt.npz",
                                        "rng.npy"]
    got += [float(b(x, y)[1].data) for _ in range(3)]
    assert got == want
    assert _equal(_snapshot(b), _snapshot(ref))
    assert torch.equal(_cpu().rng_state, stream_after)
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["step"] == 3


def test_gpt_resume_through_fit(tmp_path):
    rng = np.random.RandomState(3)
    batches = []
    for _ in range(3):
        ids = rng.randint(0, GPT_CFG["vocab_size"], (2, 16)).astype(np.int64)
        batches.append((torch.from_numpy(ids),
                        torch.from_numpy(np.roll(ids, -1, 1))))

    def build(seed):
        m = ttr.GPT(**GPT_CFG, device="cpu", seed=seed)
        m.set_optimizer(topt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
        m.compile([batches[0][0]], is_train=True, use_graph=True)
        return m

    full = build(1).fit(batches, epochs=2)
    a = build(1)
    first = a.fit(batches, epochs=1, prefetch_to_device=2)
    path = a.save_checkpoint(str(tmp_path), step=3)
    b = build(2)
    b.load_checkpoint(path)
    assert [first[0]] + b.fit(batches, epochs=1) == full


def test_complete_step_raises_and_overwrite_drops_manifest(tmp_path):
    x, y = _data()
    m = _build(1)
    m(x, y)
    path = m.save_checkpoint(str(tmp_path / "ck"), step=0)
    overlap.wait_for_checkpoints()
    with open(_ckpt.manifest_path(path), "w") as f:
        json.dump({"kind": "singa_ckpt_manifest", "step": 0}, f)
    assert _ckpt.is_complete_checkpoint(path)
    with pytest.raises(ValueError, match="complete"):
        m.save_checkpoint(str(tmp_path / "ck"), step=0)
    m(x, y)
    m.save_checkpoint(str(tmp_path / "ck"), step=0, overwrite=True)
    overlap.wait_for_checkpoints()
    assert not _ckpt.is_complete_checkpoint(path)
    fresh = _build(5)
    fresh.load_checkpoint(path)
    assert _equal(_snapshot(fresh), _snapshot(m))


def test_half_written_step_is_set_aside(tmp_path):
    x, y = _data()
    m = _build(1)
    m(x, y)
    stale = tmp_path / "ck" / "step_0"
    stale.mkdir(parents=True)
    (stale / "junk").write_text("half-written")
    path = m.save_checkpoint(str(tmp_path / "ck"), step=0)
    overlap.wait_for_checkpoints()
    assert not (stale / "junk").exists()
    assert (tmp_path / "ck" / "step_0.reclaimed" / "junk").exists()
    fresh = _build(5)
    fresh.load_checkpoint(path)
    assert _equal(_snapshot(fresh), _snapshot(m))
    base = str(tmp_path / "step_9")
    for i in range(5):
        os.makedirs(base)
        with open(os.path.join(base, "x"), "w") as f:
            f.write(str(i))
        os.utime(base, (1000 + i, 1000 + i))
        _ckpt.set_aside_checkpoint(base, ".reclaimed")
    aside = sorted(n for n in os.listdir(tmp_path)
                   if n.startswith("step_9.reclaimed"))
    assert len(aside) == 3
    kept = {open(tmp_path / n / "x").read() for n in aside}
    assert kept == {"2", "3", "4"}


def test_async_barrier_and_deferred_failure(tmp_path):
    """A write in flight is pending until a barrier; a failed one is
    re-raised by the next barrier (here the next save), with its cause,
    and remembered by write_failed until a new write to the path."""
    release = threading.Event()
    done = []
    overlap.start_async_save(str(tmp_path / "a"),
                             lambda: (release.wait(30), done.append(1)))
    assert overlap.pending_checkpoints() == 1 and not done
    release.set()
    overlap.wait_for_checkpoints()
    assert overlap.pending_checkpoints() == 0 and done == [1]

    def fail():
        raise OSError("disk full")

    bad = str(tmp_path / "b")
    overlap.start_async_save(bad, fail)
    x, y = _data()
    m = _build(1)
    with pytest.raises(RuntimeError, match="async checkpoint write") as e:
        m.save_checkpoint(str(tmp_path / "ck"), step=1)
    assert isinstance(e.value.__cause__, OSError)
    assert overlap.write_failed(bad)
    overlap.wait_for_checkpoints()          # the failure was raised once
    overlap.clear_write_failed(bad)
    assert not overlap.write_failed(bad)

    # load_checkpoint waits for the write of the checkpoint it reads
    release.clear()
    path = m.save_checkpoint(str(tmp_path / "ck"), step=2)
    overlap.start_async_save(str(tmp_path / "c"), lambda: release.wait(30))
    threading.Timer(0.05, release.set).start()
    fresh = _build(4)
    fresh.load_checkpoint(path)
    assert overlap.pending_checkpoints() == 0 and release.is_set()
    assert _equal(_snapshot(fresh), _snapshot(m))


def test_jax_loads_the_checkpoint_model_zip(tmp_path):
    """The checkpoint's model.zip loads into the JAX GPT; the optimizer's
    states carry the JAX keys and values after the same steps."""
    rng = np.random.RandomState(4)
    ids = rng.randint(0, GPT_CFG["vocab_size"], (2, 16)).astype(np.int32)
    tgt = np.roll(ids, -1, 1).astype(np.int32)
    jdev = jdevice.best_device()
    jdev.SetRandSeed(0)
    jm = jmodels.create_model("gpt", **GPT_CFG)
    jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9))
    jm.compile([jt.from_numpy(ids, device=jdev)], is_train=True,
               use_graph=True)
    tm = ttr.GPT(**GPT_CFG, device="cpu")
    ttr.load_singa_params(tm, {k: jt.to_numpy(v)
                               for k, v in jm.get_params().items()})
    tm.set_optimizer(topt.SGD(lr=0.1, momentum=0.9))
    tm.compile([torch.from_numpy(ids)], is_train=True, use_graph=True)
    for _ in range(2):
        jm(jt.from_numpy(ids, device=jdev), jt.from_numpy(tgt, device=jdev))
        tm(torch.from_numpy(ids), torch.from_numpy(tgt))
    path = tm.save_checkpoint(str(tmp_path), step=2, async_save=False)
    j2 = jmodels.create_model("gpt", **GPT_CFG)
    j2.compile([jt.from_numpy(ids, device=jdev)], is_train=False,
               use_graph=True)
    j2.load_states(os.path.join(path, "model.zip"))
    ts = tm.get_states()
    js = j2.get_states()
    assert sorted(js) == sorted(ts)
    for k in js:
        np.testing.assert_array_equal(jt.to_numpy(js[k]),
                                      ts[k].numpy(), err_msg=k)
    with np.load(os.path.join(path, "opt.npz")) as z:
        ours = {k: z[k] for k in z.files}
    theirs = jm.optimizer.get_states()
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_allclose(ours[k], np.asarray(theirs[k]),
                                   atol=1e-5, err_msg=k)


def test_atexit_barrier_reports_a_failed_write(tmp_path):
    """A failed async write nobody waited for is reported at interpreter
    exit, with its cause."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("from singa_tpu_torch import overlap\n"
            "def write():\n"
            "    raise OSError('no space left for the checkpoint')\n"
            f"overlap.start_async_save({str(tmp_path / 'x')!r}, write)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=120)
    assert "async checkpoint write" in r.stderr, r.stderr
    assert "no space left for the checkpoint" in r.stderr, r.stderr
