"""Port parity, the recurrences: `singa_tpu_torch.ops.rnn` against
`singa_tpu.ops.rnn`, and the recurrent layers against `singa_tpu.layer`,
on seeded numpy inputs at (T 7, B 3, F 5, H 8).

- lstm_scan, lstm_scan_ex (frozen carries, zero padded outputs),
  reverse_padded and gru_scan (with and without `rb`, with
  linear_before_reset True and False): forward rtol 1e-5, the gradients
  of every input rtol 1e-4 (JAX's through jax.grad of the operators'
  scan);
- the functions on Tensors are one tape node with Tensors out;
- RNN, LSTM and CudnnRNN (bidirectional, batch_first,
  return_sequences=False, seq_lengths) with JAX's weights carried over:
  outputs rtol 1e-4, parameter gradients rtol 1e-4 (atol 1e-5), names
  and shapes equal; LSTM.step alone; init_lstm_params' forget-gate
  bias;
- three SGD steps of a char-RNN (Embedding, CudnnRNN, Linear), losses
  rtol 1e-5, parameters atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from singa_tpu import autograd as jag
from singa_tpu import device as jdevice
from singa_tpu import layer as jl
from singa_tpu import model as jmodel
from singa_tpu import opt as jopt
from singa_tpu import tensor as jt
from singa_tpu.ops import rnn as jrnn
from singa_tpu_torch import autograd as tag
from singa_tpu_torch import device as tdevice
from singa_tpu_torch import layer as tl
from singa_tpu_torch import model as tmodel
from singa_tpu_torch import opt as topt
from singa_tpu_torch import tensor as tt
from singa_tpu_torch.ops import rnn as trnn

torch.set_num_threads(2)
T, B, F, H = 7, 3, 5, 8
LENGTHS = np.array([7, 3, 5], np.int32)
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _r(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _check(jfn, tfn, args, n_int=()):
    """Forward and input gradients of a scalar sum(out_i * w_i) over the
    outputs, JAX against the port; arguments at `n_int` are integer and
    carry no gradient."""
    jouts = jfn(*map(jnp.asarray, args))
    touts = tfn(*[torch.from_numpy(a) for a in args])
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    touts = touts if isinstance(touts, tuple) else (touts,)
    for j, t in zip(jouts, touts):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **FWD)
    ws = [_r(np.shape(j), 100 + i) for i, j in enumerate(jouts)]
    diff = [i for i in range(len(args)) if i not in n_int]

    def jloss(*a):
        outs = jfn(*a)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws))

    jg = jax.grad(jloss, argnums=tuple(diff))(*map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=i in diff)
             for i, a in enumerate(args)]
    outs = tfn(*targs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    loss = sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs, ws))
    tg = torch.autograd.grad(loss, [targs[i] for i in diff])
    for i, g, w in zip(diff, tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD,
                                   err_msg=f"grad of argument {i}")


def _lstm_args():
    return [_r((T, B, F), 0), _r((B, H), 1, 0.5), _r((B, H), 2, 0.5),
            _r((F, 4 * H), 3, 0.4), _r((H, 4 * H), 4, 0.4),
            _r((4 * H,), 5, 0.1)]


def test_lstm_scan_matches_jax():
    _check(jrnn._LSTMScan(H).forward, trnn.lstm_scan, _lstm_args())


def test_lstm_scan_ex_matches_jax():
    """Past a sample's length its carry freezes and its outputs are 0."""
    x, hx, cx, Wx, Wh, b = _lstm_args()
    args = [x, LENGTHS, hx, cx, Wx, Wh, b]
    _check(jrnn._LSTMScanEx(H).forward, trnn.lstm_scan_ex, args, n_int=(1,))
    ys, hy, _ = trnn.lstm_scan_ex(*[torch.from_numpy(a) for a in args])
    assert not ys[3:, 1].any() and not ys[5:, 2].any()
    np.testing.assert_array_equal(hy[1].numpy(), ys[2, 1].numpy())


def test_reverse_padded_matches_jax():
    x = _r((T, B, F), 6)
    _check(jrnn._ReversePadded().forward, trnn.reverse_padded, [x, LENGTHS],
           n_int=(1,))
    got = trnn.reverse_padded(torch.from_numpy(x),
                              torch.from_numpy(LENGTHS)).numpy()
    np.testing.assert_array_equal(got[:3, 1], x[2::-1, 1])
    np.testing.assert_array_equal(got[3:, 1], x[3:, 1])


@pytest.mark.parametrize("lbr", [True, False], ids=["lbr1", "lbr0"])
@pytest.mark.parametrize("with_rb", [False, True], ids=["b", "b_rb"])
def test_gru_scan_matches_jax(lbr, with_rb):
    args = [_r((T, B, F), 7), _r((B, H), 8, 0.5), _r((F, 3 * H), 9, 0.4),
            _r((H, 3 * H), 10, 0.4), _r((3 * H,), 11, 0.1)]
    if with_rb:
        args.append(_r((3 * H,), 12, 0.1))

    def tfn(*a):
        return trnn.gru_scan(*a[:5], rb=a[5] if with_rb else None,
                             linear_before_reset=lbr)

    _check(jrnn._GRUScan(H, lbr).forward, tfn, args)


def test_operators_on_tensors_are_one_tape_node():
    dev = tdevice.create_cpu_device()
    x, hx, cx, Wx, Wh, b = (tt.from_numpy(a, device=dev)
                            for a in _lstm_args())
    for w in (Wx, Wh, b):
        w.requires_grad = w.stores_grad = True
    prev = tag.training
    tag.training = True
    try:
        ys, hy, cy = trnn.lstm_scan(x, hx, cx, Wx, Wh, b)
        assert isinstance(ys, tt.Tensor) and ys.creator is hy.creator
        assert ys.creator.name == "LSTMScan"
        grads = tag.gradients(tag.reduce_sum(ys, keepdims=False))
        assert {id(k) for k in grads} == {id(Wx), id(Wh), id(b)}
    finally:
        tag.training = prev
    Wx2, Wh2, b2 = trnn.init_lstm_params(F, H, dev, torch.float32)
    assert Wx2.shape == (F, 4 * H) and Wh2.shape == (H, 4 * H)
    np.testing.assert_array_equal(
        b2.numpy(), np.r_[np.zeros(H), np.ones(H), np.zeros(2 * H)])


class _Train:
    """Both packages' global training switch, restored on exit."""

    def __enter__(self):
        self.prev = (jag.training, tag.training)
        jag.training = tag.training = True

    def __exit__(self, *exc):
        jag.training, tag.training = self.prev


LAYERS = {
    "rnn_tanh": (lambda m: m.RNN(H), {}),
    "rnn_relu": (lambda m: m.RNN(H, activation="relu"), {}),
    "lstm": (lambda m: m.LSTM(H), {}),
    "cudnn": (lambda m: m.CudnnRNN(H), {}),
    "cudnn_bidirectional": (lambda m: m.CudnnRNN(H, bidirectional=True),
                            {}),
    "cudnn_batch_first_last": (
        lambda m: m.CudnnRNN(H, batch_first=True, return_sequences=False),
        {}),
    "cudnn_lengths": (lambda m: m.CudnnRNN(H), {"seq_lengths": LENGTHS}),
    "cudnn_bidirectional_lengths": (
        lambda m: m.CudnnRNN(H, bidirectional=True),
        {"seq_lengths": LENGTHS}),
}


def _flat(out, ag, dev):
    """A layer's outputs as one 2-D tape value: the per-step list
    concatenated, tuples concatenated along the feature axis."""
    if isinstance(out, list):
        return ag.cat(out, axis=0)
    if isinstance(out, tuple):
        parts = [_flat(o, ag, dev) for o in out]
        parts = [ag.reshape(p, (-1, p.shape[-1])) for p in parts]
        return ag.cat(parts, axis=0)
    return ag.reshape(out, (-1, out.shape[-1]))


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_recurrent_layer_matches_jax(name):
    """Outputs and parameter gradients of a mean-square loss with JAX's
    weights carried over; parameter names and shapes equal."""
    mk, kw = LAYERS[name]
    x = _r((B, T, F) if "batch_first" in name else (T, B, F), 13)
    jdev, tdev = jdevice.best_device(), tdevice.create_cpu_device()
    j, t = mk(jl), mk(tl)
    with _Train():
        j(jt.from_numpy(x, device=jdev), **kw)
        t(tt.from_numpy(x, device=tdev), **kw)
    jp, tp = j.get_params(), t.get_params()
    assert list(tp) == list(jp)
    assert [tuple(v.shape) for v in tp.values()] \
        == [tuple(v.shape) for v in jp.values()]
    t.set_params({k: jt.to_numpy(v) for k, v in jp.items()})
    with _Train():
        jy = _flat(j(jt.from_numpy(x, device=jdev), **kw), jag, jdev)
        ty = _flat(t(tt.from_numpy(x, device=tdev), **kw), tag, tdev)
        np.testing.assert_allclose(ty.numpy(), jt.to_numpy(jy), **GRAD)
        target = _r(tuple(ty.shape), 14)
        jg = jag.gradients(jag.mse_loss(jy, jt.from_numpy(target,
                                                          device=jdev)))
        tg = tag.gradients(tag.mse_loss(ty, tt.from_numpy(target,
                                                          device=tdev)))
    jnames = {id(v): k for k, v in jp.items()}
    want = {jnames[id(p)]: jt.to_numpy(g) for p, g in jg.items()
            if id(p) in jnames}
    tnames = {id(v): k for k, v in tp.items()}
    got = {tnames[id(p)]: g.detach().numpy() for p, g in tg.items()
           if id(p) in tnames}
    assert sorted(got) == sorted(want) == sorted(jp)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD, err_msg=k)


def test_lstm_step_matches_jax():
    """LSTM.step on one (batch, feature) input from given (h, c): the new
    h and c, and the weights' gradients, with JAX's weights carried
    over."""
    x, xt = _r((T, B, F), 13), _r((B, F), 15)
    h0, c0 = _r((B, H), 16, 0.5), _r((B, H), 17, 0.5)
    jdev, tdev = jdevice.best_device(), tdevice.create_cpu_device()
    j, t = jl.LSTM(H), tl.LSTM(H)
    with _Train():
        j(jt.from_numpy(x, device=jdev))
        t(tt.from_numpy(x, device=tdev))
    jp = j.get_params()
    t.set_params({k: jt.to_numpy(v) for k, v in jp.items()})
    with _Train():
        jin = [jt.from_numpy(a, device=jdev) for a in (xt, h0, c0)]
        tin = [tt.from_numpy(a, device=tdev) for a in (xt, h0, c0)]
        jy = jag.cat(list(j.step(*jin)), axis=1)
        ty = tag.cat(list(t.step(*tin)), axis=1)
        np.testing.assert_allclose(ty.numpy(), jt.to_numpy(jy), **FWD)
        target = _r(tuple(ty.shape), 18)
        jg = jag.gradients(jag.mse_loss(jy, jt.from_numpy(target,
                                                          device=jdev)))
        tg = tag.gradients(tag.mse_loss(ty, tt.from_numpy(target,
                                                          device=tdev)))
    jnames = {id(v): k for k, v in jp.items()}
    tnames = {id(v): k for k, v in t.get_params().items()}
    want = {jnames[id(p)]: jt.to_numpy(g) for p, g in jg.items()
            if id(p) in jnames}
    got = {tnames[id(p)]: g.detach().numpy() for p, g in tg.items()
           if id(p) in tnames}
    assert sorted(got) == sorted(want) == ["Wh", "Wx", "b"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **GRAD, err_msg=k)


def _char_rnn_class(lay, mod, ag):
    class CharRNN(mod.Model):
        """examples/rnn/char_rnn.py's model."""

        def __init__(self, vocab_size, hidden_size):
            super().__init__()
            self.hidden_size = hidden_size
            self.embed = lay.Embedding(vocab_size, hidden_size)
            self.lstm = lay.CudnnRNN(hidden_size)
            self.dense = lay.Linear(vocab_size)
            self.sce = lay.SoftMaxCrossEntropy()

        def forward(self, x):
            ys, _, _ = self.lstm(self.embed(x))
            return self.dense(ag.reshape(ys, (-1, self.hidden_size)))

        def train_one_batch(self, x, y):
            out = self.forward(x)
            loss = self.sce(out, y)
            self.optimizer(loss)
            return out, loss

    return CharRNN


def test_char_rnn_three_steps_match_jax():
    V, S, NB = 13, 10, 4
    rng = np.random.RandomState(15)
    data = rng.randint(0, V, (S + 1) * NB).astype(np.int32)
    x = np.ascontiguousarray(data[:S * NB].reshape(NB, S).T)
    y = np.ascontiguousarray(data[1:S * NB + 1].reshape(NB, S).T.ravel())
    jdev, tdev = jdevice.best_device(), tdevice.create_cpu_device()
    jdev.SetRandSeed(0)
    jm = _char_rnn_class(jl, jmodel, jag)(V, 16)
    jm.set_optimizer(jopt.SGD(lr=0.5, momentum=0.9))
    jx, jy = jt.from_numpy(x, device=jdev), jt.from_numpy(y, device=jdev)
    jm.compile([jx], is_train=True, use_graph=True)
    tm = _char_rnn_class(tl, tmodel, tag)(V, 16)
    tm.set_optimizer(topt.SGD(lr=0.5, momentum=0.9))
    tx, ty = tt.from_numpy(x, device=tdev), tt.from_numpy(y, device=tdev)
    tm.compile([tx], is_train=True, use_graph=True)
    tm.set_states({k: jt.to_numpy(v) for k, v in jm.get_states().items()})
    assert list(tm.get_params()) == list(jm.get_params())
    jls, tls = [], []
    for _ in range(3):
        jls.append(float(jt.to_numpy(jm(jx, jy)[1])))
        tls.append(float(tm(tx, ty)[1].numpy()))
    np.testing.assert_allclose(tls, jls, rtol=1e-5)
    assert tls[-1] < tls[0]
    for k, v in jm.get_params().items():
        np.testing.assert_allclose(tm.get_params()[k].detach().numpy(),
                                   jt.to_numpy(v), atol=1e-5, rtol=0,
                                   err_msg=k)
