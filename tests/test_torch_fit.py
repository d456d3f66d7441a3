"""Port parity, the training loop and its data path on the CPU:

- `Model.fit`: the per-epoch mean losses of a 2-layer GPT of width 64
  against the JAX package's `fit` from the same weights (carried over
  with `load_singa_states` from a JAX `save_states` zip), rtol 1e-5, with
  and without `prefetch_to_device`; an MLP over `data.NumpyBatchIter` in
  both packages, with the prefetcher, rtol 1e-5; an empty epoch raises;
- `data.NumpyBatchIter` yields the JAX iterator's batches, equal, in the
  same order (shuffled, a partial last batch, a transform);
  `ImageBatchIter` keeps its start/next/end API and worker process;
- `overlap.DevicePrefetcher`: order and types, static arguments passed
  through, close on an early break, a source error re-raised once, a
  dead producer detected without its end marker; no thread left."""

import threading

import numpy as np
import pytest
import torch

from singa_tpu import data as jdata
from singa_tpu import device as jdevice
from singa_tpu import models as jmodels
from singa_tpu import opt as jopt
from singa_tpu import tensor as jt
from singa_tpu_torch import data as tdata
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import models as tmodels
from singa_tpu_torch import opt as topt
from singa_tpu_torch import overlap
from singa_tpu_torch import tensor as tt
from singa_tpu_torch.models import transformer as ttr

torch.set_num_threads(2)
GPT_CFG = dict(vocab_size=97, max_seq=32, dim=64, num_heads=4, num_layers=2)


def _jdev():
    return jdevice.best_device()


def _cpu():
    return tdevice.create_cpu_device()


def _no_prefetch_threads():
    return not any(t.name.startswith("torch-prefetch")
                   for t in threading.enumerate() if t.is_alive())


def _gpt_batches(n=3, B=2, S=16):
    rng = np.random.RandomState(5)
    out = []
    for _ in range(n):
        ids = rng.randint(0, GPT_CFG["vocab_size"], (B, S)).astype(np.int32)
        out.append((ids, np.roll(ids, -1, axis=1).astype(np.int32)))
    return out


@pytest.mark.parametrize("prefetch", [0, 2])
def test_fit_matches_jax_fit(tmp_path, prefetch):
    """Two epochs of fit, graph mode in both packages, from the JAX
    model's weights through a save_states zip."""
    batches = _gpt_batches()
    _jdev().SetRandSeed(0)
    jm = jmodels.create_model("gpt", **GPT_CFG)
    jm.set_optimizer(jopt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    jm.compile([jt.from_numpy(batches[0][0], device=_jdev())],
               is_train=True, use_graph=True)
    zp = str(tmp_path / "gpt.zip")
    jm.save_states(zp)
    tm = ttr.GPT(**GPT_CFG, device="cpu")
    ttr.load_singa_states(tm, zp)
    tm.set_optimizer(topt.SGD(lr=0.1, momentum=0.9, weight_decay=1e-5))
    tm.compile([torch.from_numpy(batches[0][0])], is_train=True,
               use_graph=True)
    jdata_ = [tuple(jt.from_numpy(a, device=_jdev()) for a in b)
              for b in batches]
    tdata_ = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    want = jm.fit(jdata_, epochs=2, prefetch_to_device=prefetch)
    got = tm.fit(tdata_, epochs=2, prefetch_to_device=prefetch)
    assert len(got) == 2 and all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert _no_prefetch_threads()


def test_fit_numpy_batch_iter_with_prefetch_matches_jax():
    """An MLP over NumpyBatchIter (seeded, shuffled) in both packages,
    batches moved by each package's prefetcher (numpy arrays come back
    as Tensors)."""
    rng = np.random.RandomState(7)
    x = rng.randn(40, 10).astype(np.float32)
    y = rng.randint(0, 10, 40).astype(np.int32)
    _jdev().SetRandSeed(0)
    jm = jmodels.create_model("mlp", data_size=10)
    jm.set_optimizer(jopt.SGD(lr=0.05, momentum=0.9))
    jm.compile([jt.from_numpy(x[:8], device=_jdev())], is_train=True,
               use_graph=True)
    tm = tmodels.create_model("mlp", data_size=10)
    tm.set_optimizer(topt.SGD(lr=0.05, momentum=0.9))
    tm.compile([tt.from_numpy(x[:8], device=_cpu())], is_train=True,
               use_graph=True)
    tm.set_states({k: jt.to_numpy(v) for k, v in jm.get_states().items()})
    want = jm.fit(jdata.NumpyBatchIter(x, y, 8, seed=3), epochs=3,
                  prefetch_to_device=2)
    got = tm.fit(tdata.NumpyBatchIter(x, y, 8, seed=3), epochs=3,
                 prefetch_to_device=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tm._build_count == 1


def test_fit_prefetch_equals_plain_and_empty_epoch_raises():
    batches = [tuple(torch.from_numpy(a) for a in b)
               for b in _gpt_batches()]
    runs = []
    for prefetch in (0, 3):
        tm = ttr.GPT(**GPT_CFG, device="cpu")
        tm.set_optimizer(topt.SGD(lr=0.1, momentum=0.9))
        tm.compile([batches[0][0]], is_train=True, use_graph=True)
        runs.append(tm.fit(batches, epochs=2, prefetch_to_device=prefetch))
    assert runs[0] == runs[1]
    gen = iter(batches)
    with pytest.raises(ValueError, match="re-iterable"):
        tm.fit(gen, epochs=2)      # a generator runs dry after epoch 0
    with pytest.raises(ValueError, match="no batches"):
        tm.fit([], epochs=1, prefetch_to_device=2)
    assert _no_prefetch_threads()


def test_fit_closes_the_prefetcher_when_a_step_raises():
    batches = [tuple(torch.from_numpy(a) for a in b)
               for b in _gpt_batches(n=4)]
    tm = ttr.GPT(**GPT_CFG, device="cpu")
    tm.set_optimizer(topt.SGD(lr=0.1))
    tm.compile([batches[0][0]], is_train=True, use_graph=True)
    bad = batches[:2] + [(batches[2][0][:, :8], batches[2][1])] + batches[3:]
    with pytest.raises(RuntimeError):
        tm.fit(bad, epochs=1, prefetch_to_device=2)   # shapes disagree
    assert _no_prefetch_threads()


@pytest.mark.parametrize("kw", [dict(), dict(drop_last=False),
                                dict(shuffle=False, prefetch=1)])
def test_numpy_batch_iter_matches_jax(kw):
    rng = np.random.RandomState(11)
    x = rng.randn(23, 3).astype(np.float32)
    y = np.arange(23, dtype=np.int32)
    scale = (lambda b: b * 2.0)
    j = jdata.NumpyBatchIter(x, y, 5, transform=scale, seed=4, **kw)
    t = tdata.NumpyBatchIter(x, y, 5, transform=scale, seed=4, **kw)
    assert len(t) == len(j)
    for _epoch in range(3):
        got, want = list(t), list(j)
        assert len(got) == len(want) == len(t)
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def test_numpy_batch_iter_abandoned_epoch_and_dead_producer():
    x = np.zeros((20, 2), np.float32)
    y = np.zeros(20, np.int32)
    it = tdata.NumpyBatchIter(x, y, 2)
    g = iter(it)
    next(g)
    g.close()                                   # abandoned: producer reaped
    assert all(not t.is_alive() for t in threading.enumerate()
               if t.name == "torch-data-producer")

    def bad(_b):
        raise ValueError("transform failed")

    with pytest.raises(RuntimeError, match="producer thread died"):
        list(tdata.NumpyBatchIter(x, y, 2, transform=bad))


def _ident_images(_path):
    # module level: the worker is a separate process
    return [np.full((4, 4, 3), 7, np.uint8)]


def test_image_batch_iter_start_next_end(tmp_path):
    lst = tmp_path / "list.txt"
    lst.write_text("a.png 0\nb.png 1\nc.png 2\nd.png 3\n")
    it = tdata.ImageBatchIter(str(lst), 2, _ident_images, shuffle=False)
    it.start()
    try:
        x, yb = next(it)
        assert x.shape == (2, 3, 4, 4) and x.dtype == np.float32
        assert (x == 7).all()
        np.testing.assert_array_equal(yb, np.array([0, 1], np.int32))
        x, yb = it.next()
        np.testing.assert_array_equal(yb, np.array([2, 3], np.int32))
    finally:
        it.end()
    assert not it.p.is_alive()
    with pytest.raises(StopIteration):
        next(it)
    with pytest.raises(ValueError, match="exceeds"):
        tdata.ImageBatchIter(str(lst), 8, _ident_images)


# ---- the prefetcher ----------------------------------------------------------

def test_prefetcher_order_types_and_static_args():
    src = [(np.full((4, 3), i, np.float32), np.full(4, i, np.int32),
            torch.full((2,), float(i)), tt.from_numpy(np.ones(2) * i,
                                                      device=_cpu()),
            "plain", i) for i in range(5)]
    with overlap.prefetch_to_device(iter(src), None, size=2,
                                    device=_cpu()) as it:
        got = list(it)
    assert len(got) == 5
    for i, (a, b, c, d, s, n) in enumerate(got):
        assert isinstance(a, tt.Tensor) and isinstance(b, tt.Tensor)
        assert a.data.dtype == torch.float32 and b.data.dtype == torch.int32
        assert float(a.data[0, 0]) == i and int(b.data[0]) == i
        assert torch.is_tensor(c) and float(c[0]) == i
        assert isinstance(d, tt.Tensor) and float(d.data[0]) == i
        assert s == "plain" and n == i
    assert _no_prefetch_threads()


def test_prefetcher_close_on_early_break():
    def gen():
        for i in range(100):
            yield (torch.full((2,), float(i)),)

    pf = overlap.DevicePrefetcher(gen(), device="cpu", size=2)
    th = pf._thread
    for i, _b in enumerate(pf):
        if i == 1:
            break
    pf.close()
    assert not th.is_alive()
    pf.close()                          # idempotent
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_reraises_source_error_once():
    def bad():
        yield (torch.zeros(2),)
        raise ValueError("bad source batch")

    pf = overlap.DevicePrefetcher(bad(), device="cpu")
    next(pf)
    with pytest.raises(ValueError, match="bad source batch"):
        next(pf)
    assert _no_prefetch_threads()
    with pytest.raises(StopIteration):  # raised once, then exhausted
        next(pf)


def test_prefetcher_detects_producer_death_without_end_marker(monkeypatch):
    monkeypatch.setattr(overlap.DevicePrefetcher, "_produce",
                        lambda self: None)
    pf = overlap.DevicePrefetcher(iter([(1,)]), device="cpu")
    pf._thread.join(timeout=5.0)
    assert not pf._thread.is_alive()
    with pytest.raises(RuntimeError, match=pf._thread.name):
        next(pf)
    pf.close()


def test_prefetcher_needs_a_device():
    with pytest.raises(ValueError, match="needs a model"):
        overlap.DevicePrefetcher(iter([]))
    m = tmodels.create_model("mlp", data_size=10)
    with pytest.raises(ValueError, match="compile"):
        overlap.DevicePrefetcher(iter([]), model=m)
